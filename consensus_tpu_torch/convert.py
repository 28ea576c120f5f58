"""Carry state across between the JAX package and the port.

The simulator has no weights; its state plays their part. A batched JAX
carry of the capped engine (``RaftSparseState`` with [B, ...] leaves, as
``numpy`` arrays) becomes the port's :class:`RaftSparseState` and back, with
every dtype kept: uint32 seed, int32 protocol state, uint8 match/next and
bool down.
"""
from __future__ import annotations

import numpy as np
import torch

from .engines.raft_sparse import RaftSparseState

DTYPES = {"seed": np.uint32, "lead_match": np.uint8, "lead_next": np.uint8,
          "down": np.bool_}


def state_from_numpy(leaves: dict, device="cpu") -> RaftSparseState:
    """The port's state from a dict of batched numpy leaves."""
    out = {}
    for name in RaftSparseState._fields:
        a = np.ascontiguousarray(leaves[name])
        want = DTYPES.get(name, np.int32)
        if a.dtype != want:
            raise TypeError(f"{name}: expected {np.dtype(want)}, got "
                            f"{a.dtype}")
        out[name] = torch.from_numpy(a.copy()).to(device)
    return RaftSparseState(**out)


def state_to_numpy(st: RaftSparseState) -> dict[str, np.ndarray]:
    """A dict of batched numpy leaves, in the JAX carry's dtypes."""
    return {name: getattr(st, name).cpu().numpy()
            for name in RaftSparseState._fields}
