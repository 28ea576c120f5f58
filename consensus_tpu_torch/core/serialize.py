"""Canonical decided-log serialization — the byte-equivalence contract.

A copy of ``serialize_decided``, ``pack_sparse`` and ``digest`` from
``consensus_tpu/core/serialize.py`` (numpy only); the layout is::

    header:  magic "CTPU" | version u8=1 | protocol u8 | n_sweeps u32 | n_nodes u32
    body:    for sweep b, for node n (row-major, little-endian):
               count u32, then count x record { a u32, b u32 }

For raft a record is (term, value) of a committed entry, in log order; for
pbft (slot, value) of a committed slot, slots ascending (:func:`pack_sparse`).
i32 fields are packed as their u32 two's-complement bit patterns.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np

MAGIC = b"CTPU"
VERSION = 1
PROTOCOL_IDS = {"raft": 0, "pbft": 1, "paxos": 2, "dpos": 3,
                "hotstuff": 4}


def serialize_decided(protocol: str, counts: np.ndarray,
                      rec_a: np.ndarray, rec_b: np.ndarray) -> bytes:
    """Serialize per-(sweep, node) decided logs: ``counts`` [B, N] records
    per node, ``rec_a``/``rec_b`` [B, N, L] record fields of which the first
    ``counts[b, n]`` of each row are meaningful."""
    counts = np.asarray(counts)
    rec_a = np.asarray(rec_a)
    rec_b = np.asarray(rec_b)
    if counts.ndim != 2 or rec_a.ndim != 3 or rec_b.ndim != 3:
        raise ValueError("counts must be [B,N]; records [B,N,L]")
    B, N = counts.shape
    L = rec_a.shape[2]
    R = B * N
    header = MAGIC + struct.pack("<BBII", VERSION, PROTOCOL_IDS[protocol], B, N)
    if R == 0:
        return header

    c = counts.reshape(R).astype(np.int64)
    if np.any(c < 0) or np.any(c > L):
        raise ValueError("counts out of range [0, L]")
    # Row r occupies 1 + 2*c[r] u32 words starting at start[r].
    words = 1 + 2 * c
    start = np.concatenate(([0], np.cumsum(words)[:-1]))
    total = int(words.sum())

    out = np.empty(total, dtype="<u4")
    is_count = np.zeros(total, dtype=bool)
    is_count[start] = True
    out[is_count] = c

    # Record words fill the gaps between counts, in row-major record order.
    nnz = int(c.sum())
    if nnz:
        rec_off = np.concatenate(([0], np.cumsum(c)[:-1]))
        rows = np.repeat(np.arange(R, dtype=np.int64), c)
        k = np.arange(nnz, dtype=np.int64) - np.repeat(rec_off, c)
        rec = np.empty(2 * nnz, dtype="<u4")
        rec[0::2] = rec_a.reshape(R, L)[rows, k].astype(np.uint32)
        rec[1::2] = rec_b.reshape(R, L)[rows, k].astype(np.uint32)
        out[~is_count] = rec
    return header + out.tobytes()


def pack_sparse(mask: np.ndarray, vals: np.ndarray):
    """Turn dense decided arrays [B, N, S] into (counts, slots, vals) with
    slots ascending: the canonical order of pbft records. One
    ``np.nonzero``, whose row-major order is the canonical order; the
    position of each hit within its (sweep, node) row is its global rank
    minus its row's exclusive prefix count."""
    mask = np.asarray(mask, dtype=bool)
    vals = np.asarray(vals)
    B, N, S = mask.shape
    counts = mask.sum(axis=2).astype(np.uint32)
    L = int(counts.max()) if counts.size else 0
    slots = np.zeros((B, N, max(L, 1)), dtype=np.uint32)
    out_vals = np.zeros((B, N, max(L, 1)), dtype=np.uint32)

    ib, inode, islot = np.nonzero(mask)
    if ib.size:
        c_flat = counts.reshape(B * N).astype(np.int64)
        offsets = np.concatenate(([0], np.cumsum(c_flat)[:-1]))
        row = ib * N + inode
        pos = np.arange(ib.size, dtype=np.int64) - offsets[row]
        slots[ib, inode, pos] = islot
        out_vals[ib, inode, pos] = vals[ib, inode, islot]
    return counts, slots, out_vals


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()
