"""SPEC §9 switch delivery and its §9b byzantine axes, and kernel KAL.

The counterparts of ``consensus_tpu/ops/aggregate.py`` (K21): both Raft
engines (election vote responses, phase 0), Paxos (promises, phase 0;
accepted responses, phase 1), HotStuff (votes, phase 0) and both PBFT
engines and their f-ladders (prepare votes, phase 0; commit votes, phase 1;
the decide gossip, phase 2). K aggregator vertices split the nodes into
contiguous segments (``a(i) = i // ceil(N / K)``; on a PBFT f-ladder
``min(i // ceil(n_real / K), K - 1)`` with each lane's population
``n_real``, which is then also the vertex base). In the count engines a
response from j reaches receiver c when j's uplink to its aggregator is
open and that aggregator's downlink to c is open (the factorized two-hop of
SPEC §9 "Counts"), so every count these engines take stays a sum over
senders of a per-sender predicate. Under §9b (HotStuff) a poisoned
aggregator that delivers counts one for every member of its segment. PBFT's
value-matched tallies combine each segment instead (:func:`value_votes_plain`,
:func:`min_id_votes_plain`; kernels KAM and KAN, ``ops/switch_tally.py``).

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
In a knob batch (``core/knobs.py``) ``cfg`` is a view: the gates
(``no_partition``, ``agg_poison_on``, ``uplink_lies_on``) are its base's,
the drop, partition, poison and lie cutoffs each lane's [B, 1] column, and
KAL runs its KNOBS instance.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import knobs, rng
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


def lane_ids(N: int, K: int, n_real=None, device=None) -> torch.Tensor:
    """Each node's aggregator: [N] int64 :func:`agg_ids` without
    ``n_real``, else [B, N] int64 ``min(i // ceil(n_real[b] / K), K - 1)``,
    the f-ladder's traced segmentation (``consensus_tpu/engines/
    pbft_sweep.py:80``; equal to :func:`agg_ids` where n_real = N)."""
    if n_real is None:
        return agg_ids(N, K, device)
    seg = (n_real.to(torch.int64) + K - 1) // K
    idx = torch.arange(N, dtype=torch.int64, device=n_real.device)
    return torch.minimum(idx[None, :] // seg[:, None],
                         torch.tensor(K - 1, device=n_real.device))


def vertex_base(cfg, seed, n_real=None) -> torch.Tensor:
    """[B, 1] int64: each lane's vertex base, ``cfg.n_nodes`` or the lane's
    ``n_real`` (the ladder's ``n_vert``, ``pbft_sweep.py:99-109``)."""
    if n_real is None:
        return torch.full((seed.shape[0], 1), cfg.n_nodes, dtype=torch.int64,
                          device=seed.device)
    return n_real.to(torch.int64)[:, None]


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


def _seg_index(x, seg_ids):
    """``seg_ids`` ([N] or [B, N]) broadcast to the shape of ``x``."""
    lead = seg_ids.shape[0] if seg_ids.dim() == 2 else 1
    return seg_ids.reshape((lead, -1) + (1,) * (x.dim() - 2)).expand(x.shape)


def seg_sum_plain(x, seg_ids, K: int) -> torch.Tensor:
    """[B, N, ...] -> [B, K, ...]: the per-segment sums of ``x``
    (``aggregate.py:216-218``), in x's dtype; ``seg_ids`` is [N] or, per
    lane, [B, N]."""
    shape = (x.shape[0], K) + tuple(x.shape[2:])
    return torch.zeros(shape, dtype=x.dtype, device=x.device) \
        .scatter_add(1, _seg_index(x, seg_ids), x)


def _seg_extreme(x, seg_ids, K: int, identity: int, how: str):
    shape = (x.shape[0], K) + tuple(x.shape[2:])
    out = torch.full(shape, identity, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(1, _seg_index(x, seg_ids), x, how,
                              include_self=True)


def seg_max_plain(x, seg_ids, K: int, identity: int) -> torch.Tensor:
    """[B, N, ...] -> [B, K, ...]: the per-segment maxima of ``x``, an empty
    segment ``identity`` (``aggregate.py:216-251``: the static reshape with
    identity padding and the traced ``segment_max`` with its empty
    segments normalised give the same)."""
    return _seg_extreme(x, seg_ids, K, identity, "amax")


def seg_min_plain(x, seg_ids, K: int, identity: int) -> torch.Tensor:
    """[B, N, ...] -> [B, K, ...]: the per-segment minima of ``x``, an
    empty segment ``identity`` (``aggregate.py:254-255``)."""
    return _seg_extreme(x, seg_ids, K, identity, "amin")


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
    204-213``); per lane with [B, N] ``seg_ids``."""
    if seg_ids.dim() == 1:
        return table[:, seg_ids]
    idx = seg_ids.reshape(seg_ids.shape + (1,) * (table.dim() - 2)).expand(
        seg_ids.shape + tuple(table.shape[2:]))
    return table.gather(1, idx)


def _open_edge_plain(cfg, seed, q, src, dst) -> torch.Tensor:
    """§2 drop leg with the §A.2 retransmission at round(s) ``q``
    (``aggregate.py:260-267``): int64 tensors that broadcast against a
    leading lane axis, ``q`` a Python int or a tensor."""
    useed = rng.as_u32(seed).reshape((-1,) + (1,) * (max(
        torch.as_tensor(src).dim(), torch.as_tensor(dst).dim(),
        torch.as_tensor(q).dim()) - 1))
    q = torch.as_tensor(q, dtype=torch.int64, device=seed.device)
    cut = knobs.at(cfg.drop_cutoff, useed.dim())
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


def _uplink_plain(cfg, seed, agg: AggRound, phase: int, bcast: bool,
                  n_real=None) -> torch.Tensor:
    """``aggregate.py:280-297`` ``_uplink``: [B, N] bool, at each sender's
    aggregator's uplink round, the edge model's §2 draw to its aggregator
    vertex or the §6b broadcast key (i, i), and the partition against the
    aggregator's vertex; ``n_real`` gives each lane its vertex base and
    segmentation (the ladder)."""
    N, K = cfg.n_nodes, cfg.n_aggregators
    sids = lane_ids(N, K, n_real, seed.device)
    base = vertex_base(cfg, seed, n_real)                        # [B, 1]
    ui = torch.arange(N, dtype=torch.int64, device=seed.device)
    q = take_seg_plain(agg.q, sids, K)                           # [B, N]
    dst = ui if bcast else base + phase * K + sids
    open_ = _open_edge_plain(cfg, seed, q, ui, dst)
    if not cfg.no_partition:
        open_ = open_ & _part_pair_ok_plain(cfg, seed, q, ui, base + sids)
    return open_


def uplink_edge_plain(cfg, seed, agg: AggRound, phase: int,
                      n_real=None) -> torch.Tensor:
    """``aggregate.py:300-310`` ``uplink_edge``: [B, N] bool, sender i's
    §2 draw to its aggregator vertex at the aggregator's uplink round."""
    return _uplink_plain(cfg, seed, agg, phase, False, n_real)


def uplink_bcast_plain(cfg, seed, agg: AggRound, n_real=None) -> torch.Tensor:
    """``aggregate.py:313-323`` ``uplink_bcast``: [B, N] bool, sender i's
    one §6b broadcast draw (key (q, i, i)) landing on its aggregator, for
    every phase of the round."""
    return _uplink_plain(cfg, seed, agg, 0, True, n_real)


def downlink_plain(cfg, seed, r: int, agg: AggRound, phase: int,
                   dst, n_real=None) -> torch.Tensor:
    """``aggregate.py:326-345`` ``downlink``: [B, K, R] bool, aggregator a
    to receiver ``dst`` ([R] or [B, R] ids; negative ids receive nothing)
    at round r, dead aggregators delivering nothing; ``n_real`` gives each
    lane its vertex base (the ladder's ``n_vert``)."""
    K = cfg.n_aggregators
    dev = seed.device
    dst = torch.as_tensor(dst, dtype=torch.int64, device=dev)
    if dst.dim() == 1:
        dst = dst[None, :].expand(seed.shape[0], -1)
    valid = dst >= 0
    udst = dst.clamp(min=0)[:, None, :]                          # [B, 1, R]
    base = vertex_base(cfg, seed, n_real)[:, :, None]            # [B, 1, 1]
    ua = torch.arange(K, dtype=torch.int64, device=dev)[None, :, None]
    open_ = _open_edge_plain(cfg, seed, r, base + phase * K + ua, udst)
    if not cfg.no_partition:
        active = _draw(seed, rng.STREAM_PARTITION, r, 0, 0) \
            < cfg.partition_cutoff                               # [B, 1]
        side_a = _draw(seed, rng.STREAM_PARTITION, r, 1,
                       (base + ua)[:, :, 0])
        side_b = _draw(seed, rng.STREAM_PARTITION, r, 1, udst[:, 0, :])
        ok = ((side_a & 1)[:, :, None] == (side_b & 1)[:, None, :]) \
            | ~active[:, :, None]
        open_ = open_ & ok
    if agg.alive is not None:
        open_ = open_ & agg.alive[:, :, None]
    return open_ & valid[:, None, :]


def downlink_self_plain(cfg, seed, r: int, agg: AggRound, phase: int,
                        n_real=None) -> torch.Tensor:
    """``aggregate.py:348-370`` ``downlink_self``: [B, N] bool, node j's
    own aggregator delivering phase ``phase``'s combine back to j at round
    r (the same draw as :func:`downlink_plain` at (a(j), j))."""
    N, K = cfg.n_nodes, cfg.n_aggregators
    dev = seed.device
    sids = lane_ids(N, K, n_real, dev)
    if sids.dim() == 1:
        sids = sids[None, :].expand(seed.shape[0], -1)
    base = vertex_base(cfg, seed, n_real)
    uj = torch.arange(N, dtype=torch.int64, device=dev)
    open_ = _open_edge_plain(cfg, seed, r, base + phase * K + sids, uj)
    if not cfg.no_partition:
        open_ = open_ & _part_pair_ok_plain(cfg, seed, r, base + sids, uj)
    if agg.alive is not None:
        open_ = open_ & take_seg_plain(agg.alive, sids, K)
    return open_


# --- PBFT's value-matched tallies ------------------------------------------

I32_MAX = 2**31 - 1
I32_MIN = -2**31


def value_votes_plain(vals, contrib, up, down, down_own, seg_ids, K: int, *,
                      eq_up=None, lie=None, lie_val=None, poison=None,
                      widths=None) -> torch.Tensor:
    """``aggregate.py:375-469`` ``value_votes`` with a lane axis, expression
    for expression: ``vals`` [B, N, S] int32, ``contrib`` [B, N, S] bool,
    ``up`` [B, N], ``down`` [B, K, N], ``down_own`` [B, N], ``seg_ids`` [N]
    or [B, N]; the §9b and equivocation arguments as there, with a lane
    axis. Each aggregator serves (count, value) for a value-uniform
    segment; a receiver totals the delivered serving segments holding its
    value, a poisoned and delivered one counting its segment's width, less
    its own returned copy. [B, N, S] int32."""
    live = contrib & up[:, :, None]
    cnt = seg_sum_plain(live.to(torch.int32), seg_ids, K)          # [B, K, S]
    vmax = seg_max_plain(torch.where(live, vals, I32_MIN), seg_ids, K,
                         I32_MIN)
    vmin = seg_min_plain(torch.where(live, vals, I32_MAX), seg_ids, K,
                         I32_MAX)
    if lie is not None:
        liar = lie & up
        cnt = cnt + seg_sum_plain(liar.to(torch.int32), seg_ids,
                                  K)[:, :, None]
        lmax = seg_max_plain(torch.where(liar, lie_val, I32_MIN), seg_ids, K,
                             I32_MIN)
        lmin = seg_min_plain(torch.where(liar, lie_val, I32_MAX), seg_ids, K,
                             I32_MAX)
        vmax = torch.maximum(vmax, lmax[:, :, None])
        vmin = torch.minimum(vmin, lmin[:, :, None])
    serve = (cnt > 0) & (vmax == vmin)
    total = cnt
    if eq_up is not None:
        eqc = seg_sum_plain(eq_up.to(torch.int32), seg_ids, K)
        total = cnt + eqc[:, :, None]
    c = torch.zeros(vals.shape, dtype=torch.int32, device=vals.device)
    for a in range(K):
        hit = (down[:, a, :, None] & serve[:, a, None, :]
               & (vmax[:, a, None, :] == vals))
        term = torch.where(hit, total[:, a, None, :], 0)
        if poison is not None:
            term = torch.where(poison[:, a, None, None]
                               & down[:, a, :, None],
                               widths[:, a, None, None], term)
        c = c + term
    serve_own = take_seg_plain(serve, seg_ids, K)
    val_own = take_seg_plain(vmax, seg_ids, K)
    hit_own = serve_own & (val_own == vals) & down_own[:, :, None]
    sub = (live & hit_own).to(torch.int32)
    eq_sub = None
    if eq_up is not None:
        eq_sub = ((eq_up & down_own)[:, :, None] & serve_own
                  & (val_own == vals)).to(torch.int32)
    if poison is not None:
        pz_own = (take_seg_plain(poison, seg_ids, K) & down_own)[:, :, None]
        sub = torch.where(pz_own, contrib.to(torch.int32), sub)
        if eq_sub is not None:
            eq_sub = torch.where(pz_own, 0, eq_sub)
    c = c - sub
    if eq_sub is not None:
        c = c - eq_sub
    return c


def min_id_votes_plain(dec, dval, up, down, seg_ids, K: int, N_pad: int):
    """``aggregate.py:472-504`` ``min_id_votes`` with a lane axis: each
    aggregator serves the least live deciding id of its segment and that
    decider's value; a receiver adopts from the least id over its delivered
    aggregators. ``(imin, vadopt)``, [B, N, S] int32 each (imin == N_pad:
    no decider reached)."""
    idx = torch.arange(dec.shape[1], dtype=torch.int32, device=dec.device)
    live = dec & up[:, :, None]
    src = torch.where(live, idx[:, None], N_pad)
    mid = seg_min_plain(src, seg_ids, K, N_pad)                    # [B, K, S]
    mid_own = take_seg_plain(mid, seg_ids, K)
    win = live & (idx[:, None] == mid_own)
    sval = seg_max_plain(torch.where(win, dval, I32_MIN), seg_ids, K,
                         I32_MIN)
    imin = torch.full(dec.shape, N_pad, dtype=torch.int32, device=dec.device)
    for a in range(K):
        m = mid[:, a, None, :]
        cand = torch.where(down[:, a, :, None] & (m < N_pad), m, N_pad)
        imin = torch.minimum(imin, cand)
    vadopt = torch.full(dec.shape, I32_MIN, dtype=torch.int32,
                        device=dec.device)
    for a in range(K):
        hit = down[:, a, :, None] & (mid[:, a, None, :] == imin) \
            & (imin < N_pad)
        vadopt = torch.maximum(vadopt, torch.where(hit, sval[:, a, None, :],
                                                   I32_MIN))
    return imin, vadopt


# --- KAL: the round's aggregator table and uplinks -----------------------------

class AggTables(NamedTuple):
    """KAL's outputs for one round, which the SWITCH instances and KAM, KAN
    read: ``tab`` [B, K] int32 words (AGG_ALIVE, AGG_SIDE, AGG_POISON0 <<
    ph), ``q`` [B, K] int32 the aggregators' uplink rounds, and ``up`` [B,
    phases, N] bool the uplink masks (a node down at the round's end, with
    the round's SPEC §6c flags, sends nothing)."""
    tab: torch.Tensor
    q: torch.Tensor
    up: torch.Tensor


def bcast_uplink(cfg) -> bool:
    """Whether ``cfg``'s uplink is the §6b broadcast key, one mask for
    every phase (PBFT under ``fault_model="bcast"``)."""
    return cfg.protocol == "pbft" and cfg.fault_model == "bcast"


def n_phases(cfg) -> int:
    """The uplink masks of ``cfg``'s switch round: Paxos 2, edge-model
    PBFT 3 (prepare and commit votes, the decide gossip), §6b PBFT 1 (its
    one broadcast serves every phase), else 1."""
    if cfg.protocol == "pbft":
        return 1 if bcast_uplink(cfg) else 3
    return 2 if cfg.protocol == "paxos" else 1


def poison_phases(cfg) -> int:
    """The phases whose combines §9b may forge: PBFT's two vote phases
    (its decide gossip names its decider and cannot be forged,
    ``consensus_tpu/engines/pbft.py:280-288``), else every phase."""
    return 2 if cfg.protocol == "pbft" else n_phases(cfg)


def agg_round_plain(cfg, seed, r: int, flags=None, t=None, w=None,
                     col: int = 0, n_real=None) -> AggTables:
    """Plain version of KAL: the round's :func:`agg_draws_plain`, each
    phase's :func:`agg_poison_plain` (:func:`poison_phases` of them) and
    uplink (:func:`uplink_edge_plain`, or on the §6b engine the one
    :func:`uplink_bcast_plain`; :func:`n_phases` masks, and'ed with the
    nodes up at the round's end, given the round's SPEC §6c ``flags``), and
    the partition side of each aggregator's vertex N + a at round r (0
    without partitions), packed as :class:`AggTables`. ``n_real`` ([B]
    int32, PBFT) gives each lane its vertex base and segmentation. With
    the run's counter totals ``t`` ([B, C] int32) it adds the AGG_TELEMETRY
    tail (:func:`agg_counts_plain` with :func:`poison_count_plain` of every
    poisonable phase) into columns ``col .. col + 2`` and, with the window
    ring ``w``, into window ``r // cfg.telemetry_window``, in place."""
    K = cfg.n_aggregators
    agg = agg_draws_plain(cfg, seed, r)
    B = seed.shape[0]
    tab = torch.zeros((B, K), dtype=torch.int32, device=seed.device)
    tab |= AGG_ALIVE if agg.alive is None else agg.alive.to(torch.int32)
    if not cfg.no_partition:
        ua = torch.arange(K, dtype=torch.int64, device=seed.device)
        side = _draw(seed, rng.STREAM_PARTITION, r, 1,
                     vertex_base(cfg, seed, n_real) + ua) & 1
        tab |= (side * AGG_SIDE).to(torch.int32)
    masks = []
    for ph in range(poison_phases(cfg)):
        pz = agg_poison_plain(cfg, seed, r, ph)
        masks.append(pz)
        if pz is not None:
            tab |= pz.to(torch.int32) * (AGG_POISON0 << ph)
    if bcast_uplink(cfg):
        ups = [uplink_bcast_plain(cfg, seed, agg, n_real)]
    else:
        ups = [uplink_edge_plain(cfg, seed, agg, ph, n_real)
               for ph in range(n_phases(cfg))]
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
              col: int = 0, n_real=None) -> AggTables:
    """Kernel KAL: same arguments, result and in-place additions as
    :func:`agg_round_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/agg_round.cu`` (a thread per (lane, phase,
    id) over ids below max(N, K): id a < K draws aggregator a's word and
    q, id i < N its uplink; the counters by warp ballots and integer
    atomics; its PBFT modes with the §6b uplink, two poisoned phases and
    ``n_real``; its KNOBS instance with a knob batch's view, which reads
    each lane's drop, partition and §9b poison cutoffs from the view's
    table, ``core/knobs.py``). Raises unless ``cfg.switch_on``."""
    if not cfg.switch_on:
        raise ValueError("KAL runs on switch rounds only "
                         "(net_model='switch')")
    if seed.device.type == "cpu":
        return agg_round_plain(cfg, seed, r, flags, t, w, col, n_real)
    from .. import _build
    B, N, K = seed.shape[0], cfg.n_nodes, cfg.n_aggregators
    dev = seed.device
    _build.check(seed, torch.uint32, dev, (B,))
    if flags is not None:
        _build.check(flags, torch.uint8, dev, (B, N))
    if n_real is not None:
        _build.check(n_real, torch.int32, dev, (B,))
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
    base, table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("agg_round", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  None if flags is None else flags.data_ptr(),
                  tab.data_ptr(), q.data_ptr(), up.data_ptr(),
                  None if t is None else t.data_ptr(),
                  None if w is None else w.data_ptr(),
                  B, N, K, ph_n, base.agg_fail_cutoff, base.agg_stale_cutoff,
                  base.agg_max_stale,
                  base.agg_poison_cutoff if base.agg_poison_on else 0,
                  base.agg_byz, base.drop_cutoff, base.partition_cutoff,
                  base.max_delay_rounds, C, col, window, n_win,
                  poison_phases(cfg), int(bcast_uplink(cfg)),
                  None if n_real is None else n_real.data_ptr(), table)
    agg_round.launches += 1
    agg_round.knob_launches += table is not None
    return AggTables(tab, q, up)


agg_round.launches = 0
# Launches of its KNOBS instance (a knob batch), also counted in
# ``launches``.
agg_round.knob_launches = 0


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


def agg_step(cfg, seed, r: int, flags, names, telem=None, flight=None,
             n_real=None):
    """The round's KAL launch as an engine calls it: the AGG_TELEMETRY tail
    at ``names.index("agg_down_rounds")`` of the engine's counter names,
    with the totals ``telem`` and the recorder ``flight`` where given (and
    a PBFT round's ``n_real``)."""
    w = None if flight is None else flight[0]
    return agg_round(cfg, seed, r, flags, telem, w,
                     names.index(AGG_TELEMETRY[0]),
                     *(() if n_real is None else (n_real,)))


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
    ...] that broadcast (ids >= 0); the result has their shape. ``N``, the
    vertex base, is an int or (a PBFT ladder) an int64 tensor of each
    lane's ``n_real`` that broadcasts with them. Equals
    :func:`downlink_plain` at (a, dst)."""
    K = tab.shape[1]
    a, dst = torch.broadcast_tensors(a, dst)
    lead = (-1,) + (1,) * (a.dim() - 1)
    word = tab.to(torch.int64).gather(1, a.reshape(a.shape[0], -1)) \
        .reshape(a.shape)
    useed = rng.as_u32(seed).reshape(lead)
    drop_cut = knobs.at(drop_cut, a.dim())
    g = N + phase * K + a
    ok = rng.delivery_u32_plain(useed, r, g, dst) >= drop_cut
    if max_delay > 0:
        from .adversary import delayed_open_plain
        ok = ok | delayed_open_plain(useed, r, g, dst, drop_cut, max_delay)
    ok = ok & ((word & AGG_ALIVE) != 0)
    if knobs.may_fire(part_cut):
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
