"""Carry state across between the JAX package and the port.

The simulator has no weights; its state plays their part. A batched JAX
carry (``numpy`` arrays with [B, ...] leaves) of the dense Raft engine
(``RaftState``), of the capped one (``RaftSparseState``), of the PBFT
engine (``PbftState``), of the Paxos engine (``PaxosState``), of the DPoS
engine or of the HotStuff engine (``HotstuffState``) becomes the port's
:class:`RaftState`, :class:`RaftSparseState`, :class:`PbftState`,
:class:`PaxosState`, :class:`DposState` or :class:`HotstuffState`, told
apart by their leaves, and back, with every dtype kept: uint32 seed, int32
protocol state, uint8 match/next (``match_idx`` / ``next_idx``,
``lead_match`` / ``lead_next``), bool down, PBFT's bool slot flags
(``pp_seen``, ``prepared``, ``committed``), Paxos's bool ``learned_mask``
and the DPoS chains' uint8, uint16 or int32 storage. The JAX DPoS carry is
the tuple ``(producers, DposState)``; its leaves here are those of the
``DposState`` with ``producers`` among them (:func:`dpos_leaves`,
:func:`dpos_carry`). The port's HotStuff state has one leaf more than the
JAX carry, ``lane`` (the kernels' words between launches): it is made from
the views (``engines/hotstuff.py`` :func:`lane_at_rest`) when the leaves
lack it, and left out on the way back; the HotStuff registers stay [B]. The scan's telemetry accumulators (``telem``,
``win``, ``lat`` of ``_chunk_jit``, int32) carry across the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from .engines.dpos import DposState
from .engines.hotstuff import JAX_LEAVES, HotstuffState, lane_at_rest
from .engines.paxos import PaxosState
from .engines.pbft import PbftState
from .engines.raft import RaftState
from .engines.raft_sparse import RaftSparseState

State = (RaftState | RaftSparseState | PbftState | PaxosState | DposState
         | HotstuffState)

DTYPES = {"seed": np.uint32, "lead_match": np.uint8, "lead_next": np.uint8,
          "match_idx": np.uint8, "next_idx": np.uint8, "down": np.bool_,
          "pp_seen": np.bool_, "prepared": np.bool_, "committed": np.bool_,
          "learned_mask": np.bool_, "lane": np.int64}
# The DPoS chains' storage (consensus_tpu/engines/raft.py _store_dtype).
CHAIN_DTYPES = (np.uint8, np.uint16, np.int32)


def _kind(leaves: dict) -> type:
    """The state whose leaves ``leaves`` are: PBFT's when they hold
    ``pp_seen``, Paxos's with ``learned_mask``, DPoS's with ``chain_r``,
    HotStuff's with ``b1_v``, the dense Raft engine's with ``match_idx``,
    else the capped one's."""
    for leaf, kind in (("pp_seen", PbftState), ("learned_mask", PaxosState),
                       ("chain_r", DposState), ("b1_v", HotstuffState),
                       ("match_idx", RaftState)):
        if leaf in leaves:
            return kind
    return RaftSparseState


def state_from_numpy(leaves: dict, device="cpu",
                     n_byzantine: int = 0) -> State:
    """The port's state from a dict of batched numpy leaves (see
    :func:`_kind`). A HotStuff state without ``lane`` gets its words at
    rest, P1's key over the honest nodes: the ids below N -
    ``n_byzantine`` (the run's Config.n_byzantine)."""
    kind = _kind(leaves)
    if kind is HotstuffState and "lane" not in leaves:
        view = torch.from_numpy(np.ascontiguousarray(leaves["view"]))
        leaves = {**leaves, "lane": lane_at_rest(
            view, view.shape[1] - n_byzantine).numpy()}
    out = {}
    for name in kind._fields:
        a = np.ascontiguousarray(leaves[name])
        want = (CHAIN_DTYPES if name in ("chain_r", "chain_p")
                else (DTYPES.get(name, np.int32),))
        if a.dtype not in want:
            raise TypeError(f"{name}: expected "
                            f"{' or '.join(str(np.dtype(w)) for w in want)}"
                            f", got {a.dtype}")
        out[name] = torch.from_numpy(a.copy()).to(device)
    return kind(**out)


def state_to_numpy(st: State) -> dict[str, np.ndarray]:
    """A dict of batched numpy leaves, in the JAX carry's dtypes: the JAX
    carry's leaves (without HotStuff's ``lane``)."""
    names = JAX_LEAVES if isinstance(st, HotstuffState) else st._fields
    return {name: getattr(st, name).cpu().numpy() for name in names}


def dpos_leaves(producers, st_leaves: dict) -> dict:
    """The leaves :func:`state_from_numpy` takes for the JAX DPoS carry
    ``(producers, DposState)``: the state's leaves with ``producers``
    ([B, E, K] int32) among them."""
    return {**st_leaves, "producers": producers}


def dpos_carry(leaves: dict) -> tuple:
    """The JAX DPoS carry's parts ``(producers, DposState leaves)`` from
    the leaves of a port's :class:`DposState` (:func:`state_to_numpy`)."""
    rest = {k: v for k, v in leaves.items() if k != "producers"}
    return leaves["producers"], rest


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
