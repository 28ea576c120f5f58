"""Multi-decree Paxos in PyTorch: SPEC §5 over an [acceptor, slot] ballot
grid.

The port of ``consensus_tpu/engines/paxos.py`` on its flat path (no crash
or switch gates, no telemetry). In round r each of the first P =
``n_proposers or n_nodes`` nodes proposes ballot r·N + p + 1 on one slot it
draws; prepares, promises, accepts, accepted responses and the decide
broadcast all ride the round's [N, N] delivery mask. Sweeps (lanes) are a
leading batch axis B on every tensor.

Two functions are wrappers of hand-written CUDA kernels, each beside its
plain PyTorch version (``<name>_plain``), which CPU tensors run; the
round's delivery mask is kernel KL (``ops/adversary.py``
:func:`~consensus_tpu_torch.ops.adversary.delivery`), as in dense Raft and
PBFT:

* :func:`paxos_promise` — kernel KY (``csrc/paxos_promise.cu``): phase 1,
  the prepares' per-slot maximum at each acceptor, and phase 2, the
  promises, their count and the highest accepted ballot they carry;
* :func:`paxos_accept_learn` — kernel KZ (``csrc/paxos_accept_learn.cu``):
  phase 3, each proposer's gate and value, phase 4, the accepts, phase 5,
  the accepted responses and decisions, and phase 6, the decide broadcast
  and learning.

On the card the round runs nothing but these launches, and no [B, N, N]
tensor of ints: the [N, N] work is done inside the kernels. No input is
changed: each phase writes fresh tensors, and the round returns a new
state. The JAX package's equality-mask reductions (phase 4's winning value,
phase 6's learned value) only keep gathers off the TPU; here they are
plain indexing, with the same values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng
from ..core.config import Config
from ..ops.adversary import bitcast_i32, delivery
from .raft import check_all

# The engine's name, as the JAX package's EngineDef names it.
NAME = "paxos"

I32_MIN = -2**31


class PaxosState(NamedTuple):
    seed: torch.Tensor          # [B] uint32
    promised: torch.Tensor      # [B, N, S] i32 (0 = none)
    acc_bal: torch.Tensor       # [B, N, S] i32
    acc_val: torch.Tensor       # [B, N, S] i32
    learned_val: torch.Tensor   # [B, N, S] i32
    learned_mask: torch.Tensor  # [B, N, S] bool
    down: torch.Tensor          # [B, N] bool (SPEC §6c; all False here)


def paxos_init(cfg: Config, seeds: torch.Tensor) -> PaxosState:
    """Fresh state for each sweep seed in ``seeds`` ([B] uint32): zeros."""
    N, S = cfg.n_nodes, cfg.log_capacity
    B, dev = seeds.shape[0], seeds.device

    def zeros(dtype=torch.int32):
        return torch.zeros((B, N, S), dtype=dtype, device=dev)
    return PaxosState(seeds, zeros(), zeros(), zeros(), zeros(),
                      zeros(torch.bool),
                      torch.zeros((B, N), dtype=torch.bool, device=dev))


def proposals(cfg: Config, seed, r: int, N: int, S: int) -> tuple:
    """Each node's proposal of round r, per lane: (is_prop [B, N] bool:
    p < P and the round's churn event did not fire; slot_p [B, N] int64:
    ``draw(VALUE, r, 1, p) mod S``; ballot [B, N] int32: r·N + p + 1,
    wrapping as the JAX round's int32 does; v_own [B, N] int32: the bit
    pattern of ``draw(VALUE, r, 0, p)``)."""
    P = cfg.n_proposers or N
    idx = torch.arange(N, dtype=torch.int64, device=seed.device)
    churn = rng.random_u32_plain(seed, rng.STREAM_CHURN, r, 0, 0) \
        < cfg.churn_cutoff                                           # [B, 1]
    is_prop = (idx < P)[None, :] & ~churn
    slot_p = rng.random_u32_plain(seed, rng.STREAM_VALUE, r, 1, idx) % S
    ballot = bitcast_i32(rng.as_u32(int(r) * N + idx + 1)).expand(
        seed.shape[0], N)
    v_own = bitcast_i32(rng.random_u32_plain(seed, rng.STREAM_VALUE, r, 0,
                                             idx))
    return is_prop, slot_p, ballot, v_own


def _at_slot(grid, slot_p) -> torch.Tensor:
    """grid[b, a, slot_p[b, p]]: [B, N, S] read at each proposer's slot,
    [B, N, P]."""
    B, A, _ = grid.shape
    return grid.gather(2, slot_p[:, None, :].expand(B, A, slot_p.shape[1]))


def _seg(values, slot_p, S: int, reduce: str, fill: int) -> torch.Tensor:
    """The per-slot segment reduction of [B, A, P] ``values`` by
    ``slot_p`` into [B, A, S], starting from ``fill`` (so that ``fill``
    clamps the result, and is the value of an empty segment)."""
    B, A, P = values.shape
    out = torch.full((B, A, S), fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(2, slot_p[:, None, :].expand(B, A, P), values,
                              reduce, include_self=True)


# --- KY: phases 1-2 ----------------------------------------------------------

def paxos_promise_plain(cfg: Config, seed, r: int, deliver, promised,
                        acc_bal):
    """Plain version of KY, SPEC §5 phases 1-2 of round r at every acceptor
    a and proposer p of each lane. ``prep_del[a, p]`` is ``deliver[p,
    a]``: p's prepare (and later accept) reached a; ``deliver[a, p]`` is
    a's response reaching p. Phase 1: ``new_promised[a, s]`` is the
    larger of ``promised[a, s]`` and the largest ballot (at least 0) of a
    proposer on slot s whose prepare reached a. Phase 2: a promises p when
    p proposes, both flights are delivered, p's ballot is above a's
    promise on p's slot and equals its new promise. ``n_prom[p]`` counts
    the promises; ``best_bal[p]`` is the largest ``acc_bal[a, slot_p]`` of
    a promising acceptor (0 standing for every other acceptor) and
    ``best_a[p]`` the lowest acceptor that holds it. Returns
    (new_promised [B, N, S], n_prom, best_bal, best_a [B, N], prep_del
    [B, N, N]): int32, and prep_del bool."""
    N, S = deliver.shape[1], promised.shape[2]
    is_prop, slot_p, ballot, _ = proposals(cfg, seed, r, N, S)
    prep_del = deliver.transpose(1, 2).contiguous()
    sent = is_prop[:, None, :] & prep_del                        # [B, A, P]
    p_max = _seg(torch.where(sent, ballot[:, None, :], 0), slot_p, S,
                 "amax", 0)
    new_promised = torch.maximum(promised, p_max)
    bal = ballot[:, None, :]
    prom = (sent & deliver & (bal > _at_slot(promised, slot_p))
            & (bal == _at_slot(new_promised, slot_p)))
    n_prom = prom.sum(1, dtype=torch.int32)
    rep_bal = torch.where(prom, _at_slot(acc_bal, slot_p), 0)
    best_bal = rep_bal.amax(1)
    a_idx = torch.arange(N, dtype=torch.int32, device=deliver.device)
    best_a = torch.where(rep_bal == best_bal[:, None, :], a_idx[:, None],
                         N).amin(1)
    return new_promised, n_prom, best_bal, best_a, prep_del


def paxos_promise(cfg: Config, seed, r: int, deliver, promised, acc_bal):
    """Kernel KY: same arguments and result as
    :func:`paxos_promise_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/paxos_promise.cu`` (each proposer's ballot
    and slot once; the mask's transpose; a block per acceptor row builds
    its prepares' slot maxima in shared memory; tiles of acceptor rows
    count the promises and keep the best accepted ballot per proposer,
    merged across tiles by integer atomics on packed keys)."""
    if deliver.device.type == "cpu":
        return paxos_promise_plain(cfg, seed, r, deliver, promised, acc_bal)
    from .. import _build
    B, N, S = promised.shape
    dev = deliver.device
    check_all(dev, (seed, torch.uint32, (B,)),
              (deliver, torch.bool, (B, N, N)),
              *((t, torch.int32, (B, N, S)) for t in (promised, acc_bal)))
    new_promised = torch.empty_like(promised)
    n_prom, best_bal, best_a = (torch.empty((B, N), dtype=torch.int32,
                                            device=dev) for _ in range(3))
    prep_del = torch.empty_like(deliver)
    props = torch.empty((B, 4, N), dtype=torch.int32, device=dev)
    keys = torch.empty((B, N), dtype=torch.int64, device=dev)
    _build.launch("paxos_promise", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  *(t.data_ptr() for t in (
                      deliver, promised, acc_bal, new_promised, n_prom,
                      best_bal, best_a, prep_del, props, keys)),
                  cfg.n_proposers or N, cfg.churn_cutoff, B, N, S)
    paxos_promise.launches += 1
    return new_promised, n_prom, best_bal, best_a, prep_del


paxos_promise.launches = 0


# --- KZ: phases 3-6 ----------------------------------------------------------

def paxos_accept_learn_plain(cfg: Config, seed, r: int, deliver, prep_del,
                             new_promised, n_prom, best_bal, best_a,
                             acc_bal, acc_val, learned_val, learned_mask):
    """Plain version of KZ, SPEC §5 phases 3-6 of round r. Phase 3: p
    proceeds when it proposes and holds a majority (N // 2 + 1) of
    promises; its value is ``acc_val[best_a, slot_p]`` when ``best_bal >
    0``, else its own draw. Phase 4: acceptor a accepts the highest ballot
    ``a_max[a, s]`` among the proceeding proposers on s whose accept
    reached it and whose ballot is at least ``new_promised[a, slot_p]``;
    where ``a_max > 0`` its accepted ballot, value and promise become that
    ballot and its value, elsewhere they keep ``acc_bal``, ``acc_val`` and
    ``new_promised``. Phase 5: p decides when it proceeds and a majority of
    acceptors accepted it and their responses reached p. Phase 6: node n
    learns slot s, where it has not, from the lowest-id decider on s whose
    decide reached it (itself included); ``learned_mask`` marks every slot
    such a decider reached. Returns (promised, acc_bal, acc_val,
    learned_val [B, N, S] int32, learned_mask [B, N, S] bool)."""
    N, S = deliver.shape[1], new_promised.shape[2]
    majority = N // 2 + 1
    dev = deliver.device
    is_prop, slot_p, ballot, v_own = proposals(cfg, seed, r, N, S)
    # Phase 3, reading acc_val before any acceptor's row changes.
    rep_val = acc_val[torch.arange(acc_val.shape[0], device=dev)[:, None],
                      best_a.to(torch.int64), slot_p]
    proceed = is_prop & (n_prom >= majority)
    v_chosen = torch.where(best_bal > 0, rep_val, v_own)
    # Phase 4.
    bal = ballot[:, None, :]
    acc_cond = (proceed[:, None, :] & prep_del
                & (bal >= _at_slot(new_promised, slot_p)))
    a_max = _seg(torch.where(acc_cond, bal, 0), slot_p, S, "amax", 0)
    win = acc_cond & (bal == _at_slot(a_max, slot_p))
    val_w = _seg(torch.where(win, v_chosen[:, None, :], I32_MIN), slot_p, S,
                 "amax", I32_MIN)
    has_acc = a_max > 0
    acc_bal2 = torch.where(has_acc, a_max, acc_bal)
    acc_val2 = torch.where(has_acc, val_w, acc_val)
    promised2 = torch.where(has_acc, a_max, new_promised)
    # Phase 5.
    n_acc = (win & deliver).sum(1, dtype=torch.int32)
    decided = proceed & (n_acc >= majority)
    # Phase 6.
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    eye = idx[:, None] == idx[None, :]
    reach = decided[:, None, :] & (prep_del | eye)               # [B, n, p]
    pmin = _seg(torch.where(reach, idx, N), slot_p, S, "amin", N)
    found = pmin < N
    learn_now = found & ~learned_mask
    lv_in = v_chosen.gather(1, pmin.clamp(max=N - 1).to(torch.int64)
                            .reshape(pmin.shape[0], -1)).reshape(pmin.shape)
    return (promised2, acc_bal2, acc_val2,
            torch.where(learn_now, lv_in, learned_val), learned_mask | found)


def paxos_accept_learn(cfg: Config, seed, r: int, deliver, prep_del,
                       new_promised, n_prom, best_bal, best_a, acc_bal,
                       acc_val, learned_val, learned_mask):
    """Kernel KZ: same arguments and result as
    :func:`paxos_accept_learn_plain`, which it runs for CPU tensors; for
    CUDA tensors it launches ``csrc/paxos_accept_learn.cu`` (each
    proposer's gate and value once; a block per acceptor row takes its
    accepts' slot maxima and winners in shared memory and writes the
    row's new state and a bit per delivered accepted response; tiles of
    rows count those bits per proposer; a block per receiver row takes
    the lowest decider of each slot and learns)."""
    if deliver.device.type == "cpu":
        return paxos_accept_learn_plain(cfg, seed, r, deliver, prep_del,
                                        new_promised, n_prom, best_bal,
                                        best_a, acc_bal, acc_val,
                                        learned_val, learned_mask)
    from .. import _build
    B, N, S = new_promised.shape
    dev = deliver.device
    check_all(dev, (seed, torch.uint32, (B,)),
              *((t, torch.bool, (B, N, N)) for t in (deliver, prep_del)),
              *((t, torch.int32, (B, N)) for t in (n_prom, best_bal, best_a)),
              *((t, torch.int32, (B, N, S)) for t in (
                  new_promised, acc_bal, acc_val, learned_val)),
              (learned_mask, torch.bool, (B, N, S)))
    promised2, acc_bal2, acc_val2, learned_val2 = (
        torch.empty_like(new_promised) for _ in range(4))
    learned_mask2 = torch.empty_like(learned_mask)
    props = torch.empty((B, 4, N), dtype=torch.int32, device=dev)
    n_acc = torch.empty((B, N), dtype=torch.int32, device=dev)
    bits = torch.empty((B, N, -(-N // 32)), dtype=torch.int32, device=dev)
    _build.launch("paxos_accept_learn", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  *(t.data_ptr() for t in (
                      deliver, prep_del, new_promised, n_prom, best_bal,
                      best_a, acc_bal, acc_val, learned_val, learned_mask,
                      promised2, acc_bal2, acc_val2, learned_val2,
                      learned_mask2, props, n_acc, bits)),
                  cfg.n_proposers or N, cfg.churn_cutoff, B, N, S)
    paxos_accept_learn.launches += 1
    return promised2, acc_bal2, acc_val2, learned_val2, learned_mask2


paxos_accept_learn.launches = 0


# --- the round ---------------------------------------------------------------

def paxos_round(cfg: Config, st: PaxosState, r: int) -> PaxosState:
    """One SPEC §5 round, as ``consensus_tpu/engines/paxos.py``
    ``paxos_round`` on its flat path: a sequence of kernel launches and
    nothing else."""
    N = cfg.n_nodes
    seed = st.seed

    # ---- The round's delivery mask (KL).
    deliver = delivery(seed, r, N, cfg.drop_cutoff, cfg.partition_cutoff)

    # ---- Phases 1-2: prepares and promises (KY).
    new_promised, n_prom, best_bal, best_a, prep_del = paxos_promise(
        cfg, seed, r, deliver, st.promised, st.acc_bal)

    # ---- Phases 3-6: gate and value, accepts, decisions, learning (KZ).
    promised, acc_bal, acc_val, learned_val, learned_mask = \
        paxos_accept_learn(cfg, seed, r, deliver, prep_del, new_promised,
                           n_prom, best_bal, best_a, st.acc_bal, st.acc_val,
                           st.learned_val, st.learned_mask)
    return PaxosState(seed, promised, acc_bal, acc_val, learned_val,
                      learned_mask, st.down)


def extract(st: PaxosState) -> dict[str, torch.Tensor]:
    """The leaves the decided-log digest and the tests read (the JAX
    package's ``_paxos_extract``)."""
    return {"learned_mask": st.learned_mask, "learned_val": st.learned_val,
            "promised": st.promised, "acc_bal": st.acc_bal,
            "acc_val": st.acc_val}
