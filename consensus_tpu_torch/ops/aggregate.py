"""SPEC §9 switch delivery and its §9b byzantine axes, and kernel KAL.

The counterparts of ``consensus_tpu/ops/aggregate.py`` (K21) that the
count engines read: both Raft engines (election vote responses, phase 0),
Paxos (promises, phase 0; accepted responses, phase 1) and HotStuff (votes,
phase 0). K aggregator vertices split the nodes into contiguous segments
(``a(i) = i // ceil(N / K)``); a response from j reaches receiver c when
j's uplink to its aggregator is open and that aggregator's downlink to c
is open (the factorized two-hop of SPEC §9 "Counts"), so every count these
engines take stays a sum over senders of a per-sender predicate. Under
§9b (HotStuff) a poisoned aggregator that delivers counts one for every
member of its segment.

Draw keying, as in the JAX package: aggregator a of phase ph is the vertex
``g = N + ph*K + a`` of the delivery mixer, whose partition side is keyed on
``N + a``; the uplink of node i is the §2 draw ``(q, i, g)`` with the §A.2
retransmission and the partition at round ``q`` of its aggregator (``r``,
or ``r - d`` where the aggregator serves stale state); the downlink is
``(r, g, dst)`` with the delay and the partition at ``r``, masked by the
aggregator being alive. The per-(round, aggregator) fault draws are
STREAM_AGG's (c0: 0 fail, 1 stale, 2 depth), the §9b ones STREAM_POISON's
(c0: 0 a poisoned serve of vertex ``ph*K + a``, 1 a byzantine node's uplink
lie, 2 its forged value).

The functions named like the JAX package's are plain versions with a
leading lane axis (``seed`` is [B] uint32): the tests hold them against the
JAX package's (:func:`agg_draws_plain` is its ``agg_round``).
:func:`agg_round` is the wrapper of the hand-written CUDA kernel KAL
(``csrc/agg_round.cu``), which writes the round's [B, K] aggregator table
and [B, phases, N] uplink masks and adds the
:data:`AGG_TELEMETRY` tail into the run's counters; the SWITCH instances of
kernels KB, KM, KY, KZ and KAE read them and draw each downlink inline
(``ctt::agg_downlink``, ``csrc/agg.cuh``), as :func:`agg_downlink_plain`
does here. On CPU tensors :func:`agg_round` runs its plain version.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng
from ..core.config import ATTACK_STICKY
from .adversary import AGG_TELEMETRY, CRASH_DOWN, bitcast_i32

# Bits of a [B, K] aggregator table word (KAL's ``tab``, csrc/agg.cuh): the
# aggregator is alive, its partition side at round r (vertex N + a), and,
# from bit AGG_POISON0 up, whether it serves a forged combine in phase ph.
AGG_ALIVE = 1
AGG_SIDE = 2
AGG_POISON0 = 4


def n_segments(N: int, K: int) -> int:
    """Segment width ceil(N / K) (``aggregate.py:67-69``)."""
    return -(-N // K)


def agg_ids(N: int, K: int, device=None) -> torch.Tensor:
    """[N] int64: i // ceil(N / K) (``aggregate.py:72-75``)."""
    return torch.arange(N, dtype=torch.int64, device=device) \
        // n_segments(N, K)


def _draw(seed, stream: int, ctx, c0, c1) -> torch.Tensor:
    return rng.random_u32_plain(seed, stream, ctx, c0, c1)


class AggRound(NamedTuple):
    """The round's aggregator fault state (``aggregate.py:78-87``), per
    lane: ``alive`` [B, K] bool or None (no fail draw), ``q`` [B, K] int64
    the uplink round of each aggregator, ``down_count`` and ``stale_count``
    [B] int32."""
    alive: torch.Tensor | None
    q: torch.Tensor
    down_count: torch.Tensor
    stale_count: torch.Tensor


def agg_draws_plain(cfg, seed, r: int) -> AggRound:
    """``aggregate.py:93-116`` ``agg_round`` over the lanes of ``seed``."""
    K = cfg.n_aggregators
    B, dev = seed.shape[0], seed.device
    ua = torch.arange(K, dtype=torch.int64, device=dev)
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    alive, down_count = None, z
    if cfg.agg_fail_on:
        alive = ~(_draw(seed, rng.STREAM_AGG, r, 0, ua) < cfg.agg_fail_cutoff)
        down_count = (~alive).sum(1, dtype=torch.int32)
    q = torch.full((B, K), r, dtype=torch.int64, device=dev)
    stale_count = z
    if cfg.agg_stale_on:
        stale = _draw(seed, rng.STREAM_AGG, r, 1, ua) < cfg.agg_stale_cutoff
        d = 1 + _draw(seed, rng.STREAM_AGG, r, 2, ua) % cfg.agg_max_stale
        serving = stale & (r >= d)
        q = torch.where(serving, r - d, q)
        live = serving if alive is None else serving & alive
        stale_count = live.sum(1, dtype=torch.int32)
    return AggRound(alive, q, down_count, stale_count)


def agg_counts_plain(agg: AggRound | None = None, poisoned=None,
                     B: int = 1, device=None) -> torch.Tensor:
    """The [B, 3] int32 :data:`AGG_TELEMETRY` tail (``aggregate.py:
    119-127``): zeros without ``agg`` (the flat model)."""
    if agg is None:
        return torch.zeros((B, 3), dtype=torch.int32, device=device)
    pz = torch.zeros_like(agg.down_count) if poisoned is None else poisoned
    return torch.stack([agg.down_count, agg.stale_count, pz], 1)


def agg_poison_plain(cfg, seed, r: int, phase: int):
    """``aggregate.py:132-151``: [B, K] bool, the aggregators serving a
    forged combine in (round, phase), or None with the §9b knob off. The
    last ``agg_byz`` ids are byzantine."""
    if not cfg.agg_poison_on:
        return None
    K = cfg.n_aggregators
    ua = torch.arange(K, dtype=torch.int64, device=seed.device)
    byz_a = ua >= K - cfg.agg_byz
    fire = _draw(seed, rng.STREAM_POISON, r, 0, phase * K + ua) \
        < cfg.agg_poison_cutoff
    return byz_a & fire


def uplink_lies_plain(cfg, seed, r: int, byz):
    """``aggregate.py:154-178``: ``(lie, fval)``, [B, N] bool and int32,
    the byzantine senders (``byz`` [N] or [B, N] bool) that claim a vote
    this round and the value each claims; ``(None, None)`` with the knob
    off."""
    if not cfg.uplink_lies_on:
        return None, None
    N = byz.shape[-1]
    ui = torch.arange(N, dtype=torch.int64, device=seed.device)
    lie = byz & (_draw(seed, rng.STREAM_POISON, r, 1, ui)
                 < cfg.byz_uplink_cutoff)
    return lie, bitcast_i32(_draw(seed, rng.STREAM_POISON, r, 2, ui))


def seg_sum_plain(x, seg_ids, K: int) -> torch.Tensor:
    """[B, N, ...] -> [B, K, ...]: the per-segment sums of ``x``
    (``aggregate.py:216-218``), in x's dtype."""
    shape = (x.shape[0], K) + tuple(x.shape[2:])
    idx = seg_ids.reshape((1, -1) + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.zeros(shape, dtype=x.dtype, device=x.device) \
        .scatter_add(1, idx, x)


def seg_widths_plain(valid, seg_ids, K: int) -> torch.Tensor:
    """[B, K] int32 segment populations (``aggregate.py:181-187``) of the
    [B, N] ``valid`` mask."""
    return seg_sum_plain(valid.to(torch.int32), seg_ids, K)


def poison_count_plain(agg: AggRound, *masks) -> torch.Tensor:
    """``aggregate.py:190-201``: [B] int32, the poisoned serves of the
    round's phases by live aggregators (None masks skip)."""
    tot = torch.zeros_like(agg.down_count)
    for m in masks:
        if m is None:
            continue
        live = m if agg.alive is None else m & agg.alive
        tot = tot + live.sum(1, dtype=torch.int32)
    return tot


def take_seg_plain(table, seg_ids, K: int) -> torch.Tensor:
    """``table[:, seg_ids]`` for a [B, K, ...] table (``aggregate.py:
    204-213``)."""
    return table[:, seg_ids]


def _open_edge_plain(cfg, seed, q, src, dst) -> torch.Tensor:
    """§2 drop leg with the §A.2 retransmission at round(s) ``q``
    (``aggregate.py:260-267``): int64 tensors that broadcast against a
    leading lane axis, ``q`` a Python int or a tensor."""
    useed = rng.as_u32(seed).reshape((-1,) + (1,) * (max(
        torch.as_tensor(src).dim(), torch.as_tensor(dst).dim(),
        torch.as_tensor(q).dim()) - 1))
    q = torch.as_tensor(q, dtype=torch.int64, device=seed.device)
    cut = cfg.drop_cutoff
    ok = rng.delivery_u32_plain(useed, q, src, dst) >= cut
    for d in range(1, cfg.max_delay_rounds + 1):
        qd = (q - d).clamp(min=0)
        ok = ok | ((q >= d) & (rng.delivery_u32_plain(useed, qd, src, dst)
                               < cut)
                   & (rng.delay_u32_plain(useed, qd, d, src, dst) >= cut))
    return ok


def _part_pair_ok_plain(cfg, seed, q, id_a, id_b) -> torch.Tensor:
    """§2 bipartition check at round(s) ``q`` of vertices ``id_a`` and
    ``id_b`` (``aggregate.py:270-277``), shapes as in
    :func:`_open_edge_plain`; ``q`` is [B, ...] or an int."""
    active = _draw(seed, rng.STREAM_PARTITION, q, 0, 0) \
        < cfg.partition_cutoff
    side_a = _draw(seed, rng.STREAM_PARTITION, q, 1, id_a) & 1
    side_b = _draw(seed, rng.STREAM_PARTITION, q, 1, id_b) & 1
    return (side_a == side_b) | ~active


def uplink_edge_plain(cfg, seed, agg: AggRound, phase: int) -> torch.Tensor:
    """``aggregate.py:280-311`` ``uplink_edge``: [B, N] bool, sender i's
    §2 draw to its aggregator vertex at the aggregator's uplink round."""
    N, K = cfg.n_nodes, cfg.n_aggregators
    sids = agg_ids(N, K, seed.device)
    ui = torch.arange(N, dtype=torch.int64, device=seed.device)
    q = agg.q[:, sids]                                           # [B, N]
    open_ = _open_edge_plain(cfg, seed, q, ui, N + phase * K + sids)
    if cfg.partition_cutoff:
        open_ = open_ & _part_pair_ok_plain(cfg, seed, q, ui, N + sids)
    return open_


def downlink_plain(cfg, seed, r: int, agg: AggRound, phase: int,
                   dst) -> torch.Tensor:
    """``aggregate.py:326-345`` ``downlink``: [B, K, R] bool, aggregator a
    to receiver ``dst`` ([R] or [B, R] ids; negative ids receive nothing)
    at round r, dead aggregators delivering nothing."""
    N, K = cfg.n_nodes, cfg.n_aggregators
    dev = seed.device
    dst = torch.as_tensor(dst, dtype=torch.int64, device=dev)
    if dst.dim() == 1:
        dst = dst[None, :].expand(seed.shape[0], -1)
    valid = dst >= 0
    udst = dst.clamp(min=0)[:, None, :]                          # [B, 1, R]
    ua = torch.arange(K, dtype=torch.int64, device=dev)[None, :, None]
    open_ = _open_edge_plain(cfg, seed, r, N + phase * K + ua, udst)
    if cfg.partition_cutoff:
        active = _draw(seed, rng.STREAM_PARTITION, r, 0, 0) \
            < cfg.partition_cutoff                               # [B, 1]
        side_a = _draw(seed, rng.STREAM_PARTITION, r, 1, N + ua[0, :, 0])
        side_b = _draw(seed, rng.STREAM_PARTITION, r, 1, udst[:, 0, :])
        ok = ((side_a & 1)[:, :, None] == (side_b & 1)[:, None, :]) \
            | ~active[:, :, None]
        open_ = open_ & ok
    if agg.alive is not None:
        open_ = open_ & agg.alive[:, :, None]
    return open_ & valid[:, None, :]


# --- KAL: the round's aggregator table and uplinks -----------------------------

class AggTables(NamedTuple):
    """KAL's outputs for one round, which the SWITCH instances read:
    ``tab`` [B, K] int32 words (AGG_ALIVE, AGG_SIDE, AGG_POISON0 << ph),
    ``q`` [B, K] int32 the aggregators' uplink rounds, and ``up`` [B,
    phases, N] bool the uplink masks (a node down at the round's end, with
    the round's SPEC §6c flags, sends nothing)."""
    tab: torch.Tensor
    q: torch.Tensor
    up: torch.Tensor


def n_phases(cfg) -> int:
    """The switch phases of ``cfg``'s round: Paxos 2, else 1."""
    return 2 if cfg.protocol == "paxos" else 1


def agg_round_plain(cfg, seed, r: int, flags=None, t=None, w=None,
                     col: int = 0) -> AggTables:
    """Plain version of KAL: the round's :func:`agg_draws_plain`, each
    phase's :func:`agg_poison_plain` and :func:`uplink_edge_plain` (and'ed
    with the nodes up at the round's end, given the round's SPEC §6c
    ``flags``), and the partition side of each aggregator's vertex N + a at
    round r (0 without partitions), packed as :class:`AggTables`. With the
    run's counter totals ``t`` ([B, C] int32) it adds the AGG_TELEMETRY
    tail (:func:`agg_counts_plain` with :func:`poison_count_plain` of every
    phase) into columns ``col .. col + 2`` and, with the window ring ``w``,
    into window ``r // cfg.telemetry_window``, in place."""
    K, N = cfg.n_aggregators, cfg.n_nodes
    ph_n = n_phases(cfg)
    agg = agg_draws_plain(cfg, seed, r)
    B = seed.shape[0]
    tab = torch.zeros((B, K), dtype=torch.int32, device=seed.device)
    tab |= AGG_ALIVE if agg.alive is None else agg.alive.to(torch.int32)
    if cfg.partition_cutoff:
        ua = torch.arange(K, dtype=torch.int64, device=seed.device)
        side = _draw(seed, rng.STREAM_PARTITION, r, 1, N + ua) & 1
        tab |= (side * AGG_SIDE).to(torch.int32)
    masks = []
    ups = []
    for ph in range(ph_n):
        pz = agg_poison_plain(cfg, seed, r, ph)
        masks.append(pz)
        if pz is not None:
            tab |= pz.to(torch.int32) * (AGG_POISON0 << ph)
        ups.append(uplink_edge_plain(cfg, seed, agg, ph))
    up = torch.stack(ups, 1)
    if flags is not None:
        up = up & ((flags & CRASH_DOWN) == 0)[:, None, :]
    if t is not None:
        counts = agg_counts_plain(agg, poison_count_plain(agg, *masks))
        t[:, col:col + 3] += counts
        if w is not None:
            w[:, r // cfg.telemetry_window, col:col + 3] += counts
    return AggTables(tab, agg.q.to(torch.int32), up)


def agg_round(cfg, seed, r: int, flags=None, t=None, w=None,
              col: int = 0) -> AggTables:
    """Kernel KAL: same arguments, result and in-place additions as
    :func:`agg_round_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/agg_round.cu`` (a thread per (lane, phase,
    id) over ids below max(N, K): id a < K draws aggregator a's word and
    q, id i < N its uplink; the counters by warp ballots and integer
    atomics). Raises unless ``cfg.switch_on``."""
    if not cfg.switch_on:
        raise ValueError("KAL runs on switch rounds only "
                         "(net_model='switch')")
    if seed.device.type == "cpu":
        return agg_round_plain(cfg, seed, r, flags, t, w, col)
    from .. import _build
    B, N, K = seed.shape[0], cfg.n_nodes, cfg.n_aggregators
    dev = seed.device
    _build.check(seed, torch.uint32, dev, (B,))
    if flags is not None:
        _build.check(flags, torch.uint8, dev, (B, N))
    C = window = n_win = 0
    if t is not None:
        C = t.shape[1]
        _build.check(t, torch.int32, dev, (B, C))
        if not 0 <= col <= C - 3:
            raise ValueError(f"aggregation tail at column {col} of {C}")
        if w is not None:
            n_win = w.shape[1]
            window = r // cfg.telemetry_window
            _build.check(w, torch.int32, dev, (B, n_win, C))
            if not 0 <= window < n_win:
                raise ValueError(f"window {window} of {n_win}")
    ph_n = n_phases(cfg)
    tab = torch.empty((B, K), dtype=torch.int32, device=dev)
    q = torch.empty((B, K), dtype=torch.int32, device=dev)
    up = torch.empty((B, ph_n, N), dtype=torch.bool, device=dev)
    _build.launch("agg_round", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  None if flags is None else flags.data_ptr(),
                  tab.data_ptr(), q.data_ptr(), up.data_ptr(),
                  None if t is None else t.data_ptr(),
                  None if w is None else w.data_ptr(),
                  B, N, K, ph_n, cfg.agg_fail_cutoff, cfg.agg_stale_cutoff,
                  cfg.agg_max_stale,
                  cfg.agg_poison_cutoff if cfg.agg_poison_on else 0,
                  cfg.agg_byz, cfg.drop_cutoff, cfg.partition_cutoff,
                  cfg.max_delay_rounds, C, col, window, n_win)
    agg_round.launches += 1
    return AggTables(tab, q, up)


agg_round.launches = 0


def switch_tables(agg: AggTables | None) -> tuple:
    """KAL's uplink masks and table and K as C arguments (null, null, 0 on
    a flat round): the switch arguments of KAE, which draws the downlinks
    with its own drop, partition and delay settings."""
    if agg is None:
        return None, None, 0
    return agg.up.data_ptr(), agg.tab.data_ptr(), agg.tab.shape[1]


def switch_args(cfg, agg: AggTables | None) -> tuple:
    """The trailing C arguments of KM's, KY's and KZ's SWITCH instances:
    :func:`switch_tables`, then the drop, partition and delay settings of
    the downlink draws (0, 0, 0 on a flat round)."""
    if agg is None:
        return (*switch_tables(agg), 0, 0, 0)
    return (*switch_tables(agg), cfg.drop_cutoff, cfg.partition_cutoff,
            cfg.max_delay_rounds)


def sticky_target(cfg, agg: AggTables | None) -> int:
    """KM's SWITCH argument after :func:`switch_args`: the SPEC §A.3
    sticky target, whose responses are cut where the lane's attack word is
    set (-1: none, and on a flat round)."""
    if agg is None or cfg.attack_mode != ATTACK_STICKY:
        return -1
    return cfg.attack_target


def agg_step(cfg, seed, r: int, flags, names, telem=None, flight=None):
    """The round's KAL launch as an engine calls it: the AGG_TELEMETRY tail
    at ``names.index("agg_down_rounds")`` of the engine's counter names,
    with the totals ``telem`` and the recorder ``flight`` where given."""
    w = None if flight is None else flight[0]
    return agg_round(cfg, seed, r, flags, telem, w,
                      names.index(AGG_TELEMETRY[0]))


# --- what the SWITCH instances compute from KAL's tables -----------------------

def downlink_at_plain(seed, r: int, tab, N: int, phase: int, a, dst,
                      drop_cut: int, part_cut: int,
                      max_delay: int) -> torch.Tensor:
    """``ctt::agg_downlink``'s plain version: whether aggregator ``a``
    delivers phase ``phase``'s combine to receiver ``dst`` at round r, from
    KAL's [B, K] words ``tab`` (alive, side): the §2 draw ``(r, N +
    phase*K + a, dst)`` with the §A.2 retransmission of the last
    ``max_delay`` rounds, and, in a round whose partition is active, dst on
    the aggregator's side. ``a`` and ``dst`` are int64 tensors of shape [B,
    ...] that broadcast (ids >= 0); the result has their shape. Equals
    :func:`downlink_plain` at (a, dst)."""
    K = tab.shape[1]
    a, dst = torch.broadcast_tensors(a, dst)
    lead = (-1,) + (1,) * (a.dim() - 1)
    word = tab.to(torch.int64).gather(1, a.reshape(a.shape[0], -1)) \
        .reshape(a.shape)
    useed = rng.as_u32(seed).reshape(lead)
    g = N + phase * K + a
    ok = rng.delivery_u32_plain(useed, r, g, dst) >= drop_cut
    if max_delay > 0:
        from .adversary import delayed_open_plain
        ok = ok | delayed_open_plain(useed, r, g, dst, drop_cut, max_delay)
    ok = ok & ((word & AGG_ALIVE) != 0)
    if part_cut:
        active = (_draw(seed, rng.STREAM_PARTITION, r, 0, 0)
                  < part_cut).reshape(lead)
        side_d = rng.threefry2x32_plain(useed ^ rng.STREAM_PARTITION, r, 1,
                                        dst) & 1
        ok = ok & ((((word & AGG_SIDE) != 0) == (side_d == 1)) | ~active)
    return ok


def agg_downlink_plain(cfg, seed, r: int, tab, phase: int, a,
                       dst) -> torch.Tensor:
    """:func:`downlink_at_plain` with ``cfg``'s population and cutoffs."""
    return downlink_at_plain(seed, r, tab, cfg.n_nodes, phase, a, dst,
                             cfg.drop_cutoff, cfg.partition_cutoff,
                             cfg.max_delay_rounds)


def resp_plain(seed, r: int, up, tab, N: int, phase: int, dst,
               drop_cut: int, part_cut: int, max_delay: int):
    """[B, N, R] bool: node j's response reaches receiver ``dst[:, k]``
    ([B, R] int ids, negative: none) over the switch in phase ``phase``:
    j's uplink ``up`` ([B, N] bool, KAL's row of the phase) and its
    aggregator's downlink to the receiver (SPEC §9 "Counts": ``up(j) &
    down(a(j), dst)``); self edges are not cut here."""
    K = tab.shape[1]
    sids = agg_ids(N, K, seed.device)
    dst = torch.as_tensor(dst, dtype=torch.int64, device=seed.device)
    valid = dst >= 0
    a = sids[None, :, None].expand(dst.shape[0], N, dst.shape[1])
    d = dst.clamp(min=0)[:, None, :].expand_as(a)
    down = downlink_at_plain(seed, r, tab, N, phase, a, d, drop_cut,
                             part_cut, max_delay)
    return up[:, :, None] & down & valid[:, None, :]


def switch_resp_plain(cfg, seed, r: int, agg: AggTables, phase: int,
                      dst) -> torch.Tensor:
    """:func:`resp_plain` with ``cfg``'s population and cutoffs and KAL's
    tables ``agg``."""
    return resp_plain(seed, r, agg.up[:, phase], agg.tab, cfg.n_nodes, phase,
                      dst, cfg.drop_cutoff, cfg.partition_cutoff,
                      cfg.max_delay_rounds)
