"""Carry state across between the JAX package and the port.

The simulator has no weights; its state plays their part. A batched JAX
carry (``numpy`` arrays with [B, ...] leaves) of the dense Raft engine
(``RaftState``), of the capped one (``RaftSparseState``) or of the PBFT
engine (``PbftState``) becomes the port's :class:`RaftState`,
:class:`RaftSparseState` or :class:`PbftState`, told apart by their
leaves, and back, with every dtype kept: uint32 seed, int32 protocol
state, uint8 match/next (``match_idx`` / ``next_idx``, ``lead_match`` /
``lead_next``), bool down and PBFT's bool slot flags (``pp_seen``,
``prepared``, ``committed``). The scan's telemetry accumulators
(``telem``, ``win``, ``lat`` of ``_chunk_jit``, int32) carry across the
same way.
"""
from __future__ import annotations

import numpy as np
import torch

from .engines.pbft import PbftState
from .engines.raft import RaftState
from .engines.raft_sparse import RaftSparseState

DTYPES = {"seed": np.uint32, "lead_match": np.uint8, "lead_next": np.uint8,
          "match_idx": np.uint8, "next_idx": np.uint8, "down": np.bool_,
          "pp_seen": np.bool_, "prepared": np.bool_, "committed": np.bool_}


def state_from_numpy(leaves: dict,
                     device="cpu") -> RaftState | RaftSparseState | PbftState:
    """The port's state from a dict of batched numpy leaves: the PBFT
    engine's when they hold ``pp_seen``, the dense Raft engine's when they
    hold ``match_idx``, else the capped engine's."""
    kind = (PbftState if "pp_seen" in leaves
            else RaftState if "match_idx" in leaves else RaftSparseState)
    out = {}
    for name in kind._fields:
        a = np.ascontiguousarray(leaves[name])
        want = DTYPES.get(name, np.int32)
        if a.dtype != want:
            raise TypeError(f"{name}: expected {np.dtype(want)}, got "
                            f"{a.dtype}")
        out[name] = torch.from_numpy(a.copy()).to(device)
    return kind(**out)


def state_to_numpy(
        st: RaftState | RaftSparseState | PbftState) -> dict[str, np.ndarray]:
    """A dict of batched numpy leaves, in the JAX carry's dtypes."""
    return {name: getattr(st, name).cpu().numpy() for name in st._fields}


def accumulators_from_numpy(telem, win=None, lat=None, device="cpu"):
    """The port's accumulators from the JAX scan's int32 ``telem`` [B, K]
    and, for the flight recorder, ``win`` [B, n_windows, K] and ``lat``
    [B, H, N_BUCKETS]: returns ``(telem, flight)`` as
    :func:`raft_sparse_round` takes them (``flight`` None without
    ``win``)."""
    out = []
    for name, a in (("telem", telem), ("win", win), ("lat", lat)):
        if a is None:
            out.append(None)
            continue
        a = np.ascontiguousarray(a)
        if a.dtype != np.int32:
            raise TypeError(f"{name}: expected int32, got {a.dtype}")
        out.append(torch.from_numpy(a.copy()).to(device))
    if (out[1] is None) != (out[2] is None):
        raise ValueError("the flight recorder takes win and lat together")
    return out[0], None if out[1] is None else (out[1], out[2])


def accumulators_to_numpy(telem, flight=None) -> tuple:
    """``(telem, win, lat)`` as numpy int32 arrays (None where absent)."""
    win, lat = flight if flight is not None else (None, None)
    return tuple(None if t is None else t.cpu().numpy()
                 for t in (telem, win, lat))
