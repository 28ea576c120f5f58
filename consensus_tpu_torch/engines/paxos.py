"""Multi-decree Paxos in PyTorch: SPEC §5 over an [acceptor, slot] ballot
grid.

The port of ``consensus_tpu/engines/paxos.py`` on its flat path and under
the SPEC §A.2 delay, the SPEC §6c crash-recover adversary and the SPEC §9
switch, with its telemetry and flight recorder. In round r each
of the first P = ``n_proposers or n_nodes`` nodes proposes ballot
r·N + p + 1 on one slot it draws; prepares, promises, accepts, accepted
responses and the decide broadcast all ride the round's [N, N] delivery
mask. Sweeps (lanes) are a leading batch axis B on every tensor.

Three functions are wrappers of hand-written CUDA kernels, each beside
its plain PyTorch version (``<name>_plain``), which CPU tensors run; the
round's delivery mask is kernel KL (``ops/adversary.py``
:func:`~consensus_tpu_torch.ops.adversary.delivery`), as in dense Raft and
PBFT:

* :func:`paxos_promise` — kernel KY (``csrc/paxos_promise.cu``): phase 1,
  the prepares' per-slot maximum at each acceptor, and phase 2, the
  promises, their count and the highest accepted ballot they carry;
* :func:`paxos_accept_learn` — kernel KZ (``csrc/paxos_accept_learn.cu``):
  phase 3, each proposer's gate and value, phase 4, the accepts, phase 5,
  the accepted responses and decisions, and phase 6, the decide broadcast
  and learning;
* :func:`paxos_telemetry` — kernel KAC (``csrc/paxos_telemetry.cu``): the
  round's PAXOS_TELEMETRY counters and PAXOS_LATENCY histogram, from
  counts that KY and KZ return with telemetry on.

On the card the round runs nothing but these launches, and no [B, N, N]
tensor of ints: the [N, N] work is done inside the kernels. With
``crash_prob > 0`` the round starts with kernel KAH (``ops/adversary.py``
``crash_transition``): KL cuts a down node's edges and KY's CRASH instance
reads a recovered acceptor's promises as 0 (its volatile reset). A down
node then neither promises, accepts, decides nor learns, since every
flight to or from it is cut and a proposer needs delivered promises, so
its state leaves KY and KZ as it entered: the JAX round's freeze
(``paxos.py:241-248``) holds without a write. On a SPEC §9 switch round
kernel KAL (``ops/aggregate.py`` ``agg_round``) runs after KAH, and the
SWITCH instances of KY and KZ carry the promises (phase 0) and accepted
responses (phase 1) over the two-hop ``up[a] & down(a(a), p)`` instead
of ``deliver[a, p]`` (``paxos.py:153-218``); the nacks still read the
flat mask. No input is
changed: each phase writes fresh tensors, and the round returns a new
state. The JAX package's equality-mask reductions (phase 4's winning value,
phase 6's learned value) only keep gathers off the TPU; here they are
plain indexing, with the same values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import knobs, rng
from ..core.config import Config
from ..ops.adversary import (AGG_TELEMETRY, CRASH_REC, CRASH_TELEMETRY,
                             bitcast_i32, crash_step, delivery,
                             delivery_args)
from ..ops.aggregate import agg_step, switch_args, switch_resp_plain
from ..ops.flight import (add_plain, bucket_counts_plain, check_recorder,
                          window_of)
from .raft import check_all

# The engine's name, as the JAX package's EngineDef names it.
NAME = "paxos"

# The Paxos engine's telemetry counters, in order: a copy of
# consensus_tpu/engines/paxos.py PAXOS_TELEMETRY (lines 74-81): delivered
# promises, delivered prepares outbid (both flights delivered, no
# promise), delivered accepted responses, proposers that decided, (node,
# slot)s newly learned; then the crash and aggregation tails (kernels KAH's
# and KAL's).
PAXOS_TELEMETRY = ("promises", "nacks", "accepts", "proposals_decided",
                   "values_learned") + CRASH_TELEMETRY + AGG_TELEMETRY
# The flight recorder's latency histogram (engines/paxos.py PAXOS_LATENCY,
# line 90): r + 1 at each (node, slot) newly learned in round r.
PAXOS_LATENCY = ("rounds_to_learn",)
# KZ's [B, KZ_ROWS, N] scratch (csrc/paxos_accept_learn.cu ROWS) and its
# row that holds the decided flags after the call (csrc/paxos.cuh
# PROP_FLAG).
KZ_ROWS = 6
PROP_FLAG = 2

I32_MIN = -2**31


class PaxosState(NamedTuple):
    seed: torch.Tensor          # [B] uint32
    promised: torch.Tensor      # [B, N, S] i32 (0 = none)
    acc_bal: torch.Tensor       # [B, N, S] i32
    acc_val: torch.Tensor       # [B, N, S] i32
    learned_val: torch.Tensor   # [B, N, S] i32
    learned_mask: torch.Tensor  # [B, N, S] bool
    down: torch.Tensor          # [B, N] bool (SPEC §6c: down at round end)


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
                        acc_bal, want_pairs: bool = False, flags=None,
                        agg=None):
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
    [B, N, N]): int32, and prep_del bool; with ``want_pairs`` also
    ``n_pair`` [B, N] int32: ``n_prom`` plus, for each proposing p, the
    acceptors with both flights delivered that did not promise (the
    telemetry's nacks are ``n_pair - n_prom``; on a flat round these are
    the acceptors with both flights delivered).
    With the round's SPEC §6c ``flags`` ([B, N] uint8, KAH), a recovered
    acceptor's ``promised`` row is read as 0 (``consensus_tpu/engines/
    paxos.py:118-122``). On a SPEC §9 switch round (``agg``, kernel KAL's
    tables) a promise travels back over the switch instead of ``deliver[a,
    p]``: a's phase-0 uplink and its aggregator's downlink to p
    (``paxos.py:153-176``); the nacks still read the flat ``deliver``
    (``paxos.py:256``)."""
    N, S = deliver.shape[1], promised.shape[2]
    if flags is not None:
        promised = torch.where(((flags & CRASH_REC) != 0)[:, :, None], 0,
                               promised)
    is_prop, slot_p, ballot, _ = proposals(cfg, seed, r, N, S)
    prep_del = deliver.transpose(1, 2).contiguous()
    sent = is_prop[:, None, :] & prep_del                        # [B, A, P]
    p_max = _seg(torch.where(sent, ballot[:, None, :], 0), slot_p, S,
                 "amax", 0)
    new_promised = torch.maximum(promised, p_max)
    bal = ballot[:, None, :]
    back = deliver if agg is None else _switch_back(cfg, seed, r, agg, 0)
    prom = (sent & back & (bal > _at_slot(promised, slot_p))
            & (bal == _at_slot(new_promised, slot_p)))
    n_prom = prom.sum(1, dtype=torch.int32)
    rep_bal = torch.where(prom, _at_slot(acc_bal, slot_p), 0)
    best_bal = rep_bal.amax(1)
    a_idx = torch.arange(N, dtype=torch.int32, device=deliver.device)
    best_a = torch.where(rep_bal == best_bal[:, None, :], a_idx[:, None],
                         N).amin(1)
    out = (new_promised, n_prom, best_bal, best_a, prep_del)
    if want_pairs:
        return (*out, n_prom + (sent & deliver & ~prom).sum(
            1, dtype=torch.int32))
    return out


def _switch_back(cfg: Config, seed, r: int, agg, phase: int):
    """[B, a, p] bool: a's response reaches p over the switch in
    ``phase`` (SPEC §9; :func:`~consensus_tpu_torch.ops.aggregate.
    switch_resp_plain` at every proposer)."""
    N = cfg.n_nodes
    idx = torch.arange(N, device=seed.device)
    return switch_resp_plain(cfg, seed, r, agg, phase,
                             idx[None, :].expand(seed.shape[0], N))


def paxos_promise(cfg: Config, seed, r: int, deliver, promised, acc_bal,
                  want_pairs: bool = False, flags=None, agg=None):
    """Kernel KY: same arguments and result as
    :func:`paxos_promise_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/paxos_promise.cu`` (each proposer's ballot
    and slot once; the mask's transpose; a block per acceptor row builds
    its prepares' slot maxima in shared memory; tiles of acceptor rows
    count the promises and keep the best accepted ballot per proposer,
    merged across tiles by integer atomics on packed keys; the pair counts
    only with ``want_pairs``, merged like the promises; its CRASH
    instance with ``flags``; its SWITCH instances with ``agg``, whose
    tiles draw each promise's downlink inline)."""
    if deliver.device.type == "cpu":
        return paxos_promise_plain(cfg, seed, r, deliver, promised, acc_bal,
                                   want_pairs, flags, agg)
    from .. import _build
    B, N, S = promised.shape
    dev = deliver.device
    check_all(dev, (seed, torch.uint32, (B,)),
              (deliver, torch.bool, (B, N, N)),
              *((t, torch.int32, (B, N, S)) for t in (promised, acc_bal)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)),
              *_agg_checks(cfg, agg, B))
    new_promised = torch.empty_like(promised)
    n_prom, best_bal, best_a = (torch.empty((B, N), dtype=torch.int32,
                                            device=dev) for _ in range(3))
    prep_del = torch.empty_like(deliver)
    n_pair = torch.empty_like(n_prom) if want_pairs else None
    props = torch.empty((B, 4, N), dtype=torch.int32, device=dev)
    keys = torch.empty((B, N), dtype=torch.int64, device=dev)
    base, table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("paxos_promise", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  *(t.data_ptr() for t in (
                      deliver, promised, acc_bal, new_promised, n_prom,
                      best_bal, best_a, prep_del)),
                  None if n_pair is None else n_pair.data_ptr(),
                  props.data_ptr(), keys.data_ptr(),
                  None if flags is None else flags.data_ptr(),
                  cfg.n_proposers or N, base.churn_cutoff, B, N, S,
                  *switch_args(base, agg), table)
    paxos_promise.launches += 1
    paxos_promise.switch_launches += agg is not None
    paxos_promise.knob_launches += table is not None
    out = (new_promised, n_prom, best_bal, best_a, prep_del)
    return (*out, n_pair) if want_pairs else out


paxos_promise.launches = 0
# Launches of its SWITCH instances (SPEC §9), also counted in ``launches``.
paxos_promise.switch_launches = 0
# Launches of its KNOBS instance (a knob batch), also counted in
# ``launches``.
paxos_promise.knob_launches = 0


def _agg_checks(cfg: Config, agg, B: int) -> tuple:
    """check_all entries of KAL's tables on a switch round (none without)."""
    if agg is None:
        return ()
    return ((agg.up, torch.bool, (B, 2, cfg.n_nodes)),
            (agg.tab, torch.int32, (B, cfg.n_aggregators)))


# --- KZ: phases 3-6 ----------------------------------------------------------

def paxos_accept_learn_plain(cfg: Config, seed, r: int, deliver, prep_del,
                             new_promised, n_prom, best_bal, best_a,
                             acc_bal, acc_val, learned_val, learned_mask,
                             want_counts: bool = False, agg=None):
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
    learned_val [B, N, S] int32, learned_mask [B, N, S] bool) and, with
    ``want_counts``, phase 5's ``n_acc`` (the delivered accepted responses
    of each proposer) and decided flags (0 or 1), both [B, N] int32. On a
    SPEC §9 switch round (``agg``, kernel KAL's tables) an accepted
    response travels over the switch in phase 1 instead of ``deliver[a,
    p]`` (``paxos.py:209-218``)."""
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
    back = deliver if agg is None else _switch_back(cfg, seed, r, agg, 1)
    n_acc = (win & back).sum(1, dtype=torch.int32)
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
    out = (promised2, acc_bal2, acc_val2,
           torch.where(learn_now, lv_in, learned_val), learned_mask | found)
    if want_counts:
        return (*out, n_acc, decided.to(torch.int32))
    return out


def paxos_accept_learn(cfg: Config, seed, r: int, deliver, prep_del,
                       new_promised, n_prom, best_bal, best_a, acc_bal,
                       acc_val, learned_val, learned_mask,
                       want_counts: bool = False, agg=None):
    """Kernel KZ: same arguments and result as
    :func:`paxos_accept_learn_plain`, which it runs for CPU tensors; for
    CUDA tensors it launches ``csrc/paxos_accept_learn.cu`` (a block per
    lane gates each proposer and buckets the proceeding ones by slot;
    blocks over acceptor rows stage a row's mask bytes in shared memory,
    walk each (row, slot)'s bucket for the accept maximum and its winner
    with 16-byte rows, and count the winners' delivered responses; blocks
    over receiver rows walk the buckets for the lowest decider and learn).
    With ``want_counts`` it also returns its count of accepted responses
    and its decided flags, which it keeps in a row of its proposer scratch
    (a strided view). Its SWITCH instance, with ``agg``, draws each
    accepted response's downlink inline."""
    if deliver.device.type == "cpu":
        return paxos_accept_learn_plain(cfg, seed, r, deliver, prep_del,
                                        new_promised, n_prom, best_bal,
                                        best_a, acc_bal, acc_val,
                                        learned_val, learned_mask,
                                        want_counts, agg)
    from .. import _build
    B, N, S = new_promised.shape
    dev = deliver.device
    check_all(dev, (seed, torch.uint32, (B,)),
              *((t, torch.bool, (B, N, N)) for t in (deliver, prep_del)),
              *((t, torch.int32, (B, N)) for t in (n_prom, best_bal, best_a)),
              *((t, torch.int32, (B, N, S)) for t in (
                  new_promised, acc_bal, acc_val, learned_val)),
              (learned_mask, torch.bool, (B, N, S)),
              *_agg_checks(cfg, agg, B))
    promised2, acc_bal2, acc_val2, learned_val2 = (
        torch.empty_like(new_promised) for _ in range(4))
    learned_mask2 = torch.empty_like(learned_mask)
    props = torch.empty((B, KZ_ROWS, N), dtype=torch.int32, device=dev)
    n_acc = torch.empty((B, N), dtype=torch.int32, device=dev)
    starts = torch.empty((B, S + 1), dtype=torch.int32, device=dev)
    base, table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("paxos_accept_learn", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  *(t.data_ptr() for t in (
                      deliver, prep_del, new_promised, n_prom, best_bal,
                      best_a, acc_bal, acc_val, learned_val, learned_mask,
                      promised2, acc_bal2, acc_val2, learned_val2,
                      learned_mask2, props, n_acc, starts)),
                  cfg.n_proposers or N, base.churn_cutoff, B, N, S,
                  *switch_args(base, agg), table)
    paxos_accept_learn.launches += 1
    paxos_accept_learn.switch_launches += agg is not None
    paxos_accept_learn.knob_launches += table is not None
    out = (promised2, acc_bal2, acc_val2, learned_val2, learned_mask2)
    return (*out, n_acc, props[:, PROP_FLAG]) if want_counts else out


paxos_accept_learn.launches = 0
# Launches of its SWITCH instance (SPEC §9), also counted in ``launches``.
paxos_accept_learn.switch_launches = 0
# Launches of its KNOBS instance (a knob batch), also counted in
# ``launches``.
paxos_accept_learn.knob_launches = 0


# --- KAC: the telemetry tail --------------------------------------------------

def paxos_telemetry_plain(cfg: Config, r: int, n_prom, n_pair, n_acc,
                          decided, learned_in, learned, t, w=None,
                          lat=None) -> None:
    """Plain version of KAC: the round's PAXOS_TELEMETRY counters, per
    lane, added into the [B, K] int32 accumulator ``t`` and, with the
    flight recorder (``w`` [B, n_windows, K] and ``lat`` [B, 1,
    N_BUCKETS], both or neither), into window ``r // cfg.telemetry_window``
    of ``w``, and the round's PAXOS_LATENCY histogram into ``lat``, as
    ``consensus_tpu/engines/paxos.py`` paxos_round's tail (lines 253-264)
    on its flat path: the sums of KY's ``n_prom``, of ``n_pair - n_prom``
    and of KZ's ``n_acc`` and ``decided`` ([B, N] int32), and the (node,
    slot)s of ``learned`` not in ``learned_in`` ([B, N, S] bool), each
    observed at r + 1; zeros for the crash and aggregation tails (KAH's
    and KAL's to add). Updates
    ``t``, ``w`` and ``lat`` in place."""
    check_recorder(cfg, w, lat)
    B = learned.shape[0]
    learn_now = (learned & ~learned_in).reshape(B, -1)
    vec = torch.zeros_like(t)
    vec[:, :5] = torch.stack([
        n_prom.sum(1, dtype=torch.int32),
        (n_pair - n_prom).sum(1, dtype=torch.int32),
        n_acc.sum(1, dtype=torch.int32),
        (decided != 0).sum(1, dtype=torch.int32),
        learn_now.sum(1, dtype=torch.int32)], 1)
    hists = ()
    if w is not None:
        hists = (bucket_counts_plain(torch.full_like(learn_now, r + 1,
                                                     dtype=torch.int32),
                                     learn_now),)
    add_plain(cfg, r, vec, t, w, lat, hists)


def paxos_telemetry(cfg: Config, r: int, n_prom, n_pair, n_acc, decided,
                    learned_in, learned, t, w=None, lat=None) -> None:
    """Kernel KAC: same arguments and in-place updates as
    :func:`paxos_telemetry_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/paxos_telemetry.cu`` (a block per 16 KB of
    a lane's masks, 16-byte loads, block sums and one integer atomic a
    block and counter). ``decided`` may be a view with a lane stride (KZ's
    flag row); its nodes must be adjacent."""
    check_recorder(cfg, w, lat)
    if t.device.type == "cpu":
        return paxos_telemetry_plain(cfg, r, n_prom, n_pair, n_acc, decided,
                                     learned_in, learned, t, w, lat)
    from .. import _build
    B, N, S = learned.shape
    dev = t.device
    check_all(dev, *((x, torch.int32, (B, N)) for x in (n_prom, n_pair,
                                                         n_acc)),
              *((x, torch.bool, (B, N, S)) for x in (learned_in, learned)),
              (t, torch.int32, (B, len(PAXOS_TELEMETRY))))
    if (decided.device != dev or decided.dtype != torch.int32
            or tuple(decided.shape) != (B, N) or decided.stride(1) != 1):
        raise ValueError("decided must be a [B, N] int32 tensor on "
                         f"{dev} with adjacent nodes")
    window, n_windows = window_of(cfg, r, t, w, lat, len(PAXOS_LATENCY))
    _build.launch("paxos_telemetry", *(x.data_ptr() for x in (
        n_prom, n_pair, n_acc, decided, learned_in, learned, t)),
        *(None if x is None else x.data_ptr() for x in (w, lat)),
        decided.stride(0), int(r), B, N, S, t.shape[1], window, n_windows)
    paxos_telemetry.launches += 1


paxos_telemetry.launches = 0


# --- the round ---------------------------------------------------------------

def paxos_round(cfg: Config, st: PaxosState, r: int, *, telem=None,
                flight=None) -> PaxosState:
    """One SPEC §5 round, as ``consensus_tpu/engines/paxos.py``
    ``paxos_round`` on its flat path: a sequence of kernel launches and
    nothing else.

    ``telem`` ([B, K] i32, the run's counter totals) switches on the
    round's telemetry and ``flight`` (the window ring and latency buckets,
    a pair of [B, n_windows, K] and [B, 1, N_BUCKETS] i32) its flight
    recorder, as the JAX round's ``telem=True`` and ``flight=True``: KY
    and KZ then also return their counts, and kernel KAC adds the round's
    counters into the accumulators in place."""
    N = cfg.n_nodes
    seed = st.seed
    # The flag that asks KY and KZ for their counts, passed only with
    # telemetry: without it the calls are those of a round without.
    on = () if telem is None else (True,)
    if flight is not None and telem is None:
        raise ValueError("the flight recorder rides the telemetry "
                         "accumulator: pass telem with flight")

    # ---- SPEC §6c crash transition (KAH).
    down, flags = st.down, None
    if cfg.crash_on:
        down, flags = crash_step(cfg, seed, r, st.down, PAXOS_TELEMETRY,
                                 telem, flight)

    # ---- SPEC §9 switch (KAL): the round's aggregator table and uplinks
    # of both phases, which KY's and KZ's SWITCH instances read.
    agg = None
    if cfg.switch_on:
        agg = agg_step(cfg, seed, r, flags, PAXOS_TELEMETRY, telem, flight)

    # ---- The round's delivery mask (KL).
    deliver = delivery(seed, r, N, *delivery_args(cfg, flags))

    # ---- Phases 1-2: prepares and promises (KY), after the §6c reset.
    if flags is not None or agg is not None:
        on = (telem is not None, flags) + (() if agg is None else (agg,))
    new_promised, n_prom, best_bal, best_a, prep_del, *pairs = paxos_promise(
        cfg, seed, r, deliver, st.promised, st.acc_bal, *on)

    # ---- Phases 3-6: gate and value, accepts, decisions, learning (KZ).
    promised, acc_bal, acc_val, learned_val, learned_mask, *counts = \
        paxos_accept_learn(cfg, seed, r, deliver, prep_del, new_promised,
                           n_prom, best_bal, best_a, st.acc_bal, st.acc_val,
                           st.learned_val, st.learned_mask, *on[:1],
                           *(() if agg is None else (agg,)))

    # ---- Telemetry and flight recorder (KAC).
    if telem is not None:
        paxos_telemetry(cfg, r, n_prom, pairs[0], *counts, st.learned_mask,
                        learned_mask, telem,
                        *(flight if flight is not None else (None, None)))
    return PaxosState(seed, promised, acc_bal, acc_val, learned_val,
                      learned_mask, down)


def extract(st: PaxosState) -> dict[str, torch.Tensor]:
    """The leaves the decided-log digest and the tests read (the JAX
    package's ``_paxos_extract``)."""
    return {"learned_mask": st.learned_mask, "learned_val": st.learned_val,
            "promised": st.promised, "acc_bal": st.acc_bal,
            "acc_val": st.acc_val}
