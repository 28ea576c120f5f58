"""The batched round loop: the port of ``consensus_tpu/network/runner.py``'s
plain path (``make_seeds``, ``_init_jit``, the scan of ``_chunk_jit`` and
``run_device``).

Sweeps are the leading batch axis of every state tensor, and a Python loop
over rounds takes the place of ``lax.scan``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU they raise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import Config
from ..engines import raft_sparse


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when the
    chosen device is a GPU that is not there (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


def make_seeds(cfg: Config) -> np.ndarray:
    """Per-sweep u32 seeds; sweep b uses lo32(seed + b) (SPEC §1)."""
    return ((np.uint64(cfg.seed) + np.arange(cfg.n_sweeps, dtype=np.uint64))
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def init(cfg: Config, seeds: np.ndarray, device) -> raft_sparse.RaftSparseState:
    """A fresh batched state, one sweep per seed."""
    return raft_sparse.raft_sparse_init(
        cfg, torch.from_numpy(np.asarray(seeds, np.uint32)).to(device))


def advance(cfg: Config, st: raft_sparse.RaftSparseState, r0: int,
            n_rounds: int) -> raft_sparse.RaftSparseState:
    """Rounds r0 .. r0 + n_rounds - 1 of every sweep."""
    for r in range(r0, r0 + n_rounds):
        st = raft_sparse.raft_sparse_round(cfg, st, r)
    return st


def run_device(cfg: Config, device=None) -> raft_sparse.RaftSparseState:
    """Run ``cfg.n_rounds`` rounds from a fresh state and return the final
    state on the device, after the device has finished."""
    dev = resolve_device(device)
    st = advance(cfg, init(cfg, make_seeds(cfg), dev), 0, cfg.n_rounds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st
