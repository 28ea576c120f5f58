"""PBFT's SPEC §9 switch tallies and their §9b byzantine axes: kernels KAM
and KAN.

Under ``net_model="switch"`` a PBFT round's prepare votes (P4, phase 0),
commit votes (P5, phase 1) and decide gossip (P6, phase 2) go through the K
aggregators (``consensus_tpu/engines/pbft.py:263-361``,
``pbft_bcast.py:553-670``, ``pbft_sweep.py:61-135``): each aggregator
combines its segment's live senders, and a receiver reads the K served
combines over its downlinks instead of N messages. In a vote phase an
aggregator serves ``(count, value)`` where its segment is value-uniform
(``consensus_tpu/ops/aggregate.py`` value_votes); in the decide phase it
serves its least deciding id, whose decided value the receiver adopts
(min_id_votes). Under §9b a byzantine member's uplink lie joins its
segment's combine, and a poisoned aggregator claims its whole segment for
whatever value the receiver holds.

Every phase takes KAL's tables (``ops/aggregate.py`` :func:`~consensus_tpu_
torch.ops.aggregate.agg_round`) and each lane's population ``n_real`` and
tolerance ``f`` ([B] int32), so the standalone engines (``n_real = N``) and
both f-ladders share one set of kernels, as the JAX package's engines and
``_padded_switch_phases`` share ``value_votes`` and ``min_id_votes``:

* :func:`switch_combine` — kernel KAM (``csrc/switch_combine.cu``): the
  phase's served table per (lane, aggregator, slot);
* :func:`switch_receive` — kernel KAN (``csrc/switch_receive.cu``): the
  downlinks and each receiver's threshold (P4, P5) or adoption and timers
  (P6, P7).

Each runs its plain PyTorch version (``<name>_plain``) for CPU tensors.
:func:`switch_phases` is the three phases as both PBFT rounds call them.
"""
from __future__ import annotations

import torch

from ..core import knobs
from ..core.config import BYZ_EQUIV, Config
from . import aggregate
from .adversary import CRASH_DOWN, equiv_stance_plain

# The phases: P4's prepare votes, P5's commit votes, P6's decide gossip.
PREPARE, COMMIT, DECIDE = 0, 1, 2
# int32's extremes: the identities of a segment's value max and min.
I32_MAX, I32_MIN = aggregate.I32_MAX, aggregate.I32_MIN
# The threads of a KAM and KAN block, and the (sender, slot) elements a
# KAM block of its first pass covers (as csrc/switch_combine.cu).
THREADS = 256
ELEMS = 16384
# The §6b engine's stance key for the per-round equivocation a switch
# dedups claims to (pbft.py:292-297, pbft_bcast.py:582-584).
STANCE_DST = 0x80000000


def uplink_row(cfg: Config, phase: int) -> int:
    """The row of KAL's uplinks that ``phase`` reads: the phase's own on
    the edge model, the one §6b broadcast row otherwise."""
    return 0 if aggregate.bcast_uplink(cfg) else phase


def _honest(n_real, nb: int, N: int):
    from ..engines.pbft import honest_nodes
    return honest_nodes(n_real, nb, N)


def _byzantine(n_real, nb: int, N: int):
    from ..engines.pbft import real_nodes
    return real_nodes(n_real, N) & ~_honest(n_real, nb, N)


def stance_plain(seed, r: int, N: int):
    """[B, N] bool: each node's per-round equivocation stance under the
    switch, ``draw(EQUIV, r, i, 0x80000000) & 1``."""
    ids = torch.arange(N, dtype=torch.int64, device=seed.device)
    return equiv_stance_plain(seed, r, ids[None, :], STANCE_DST)


def widths_plain(cfg: Config, n_real, N: int) -> torch.Tensor:
    """[B, K] int32: each segment's real population (``aggregate.py:
    181-187`` seg_widths over the lane's real prefix,
    ``pbft_sweep.py:93-94``)."""
    from ..engines.pbft import real_nodes
    K = cfg.n_aggregators
    return aggregate.seg_widths_plain(real_nodes(n_real, N),
                                      aggregate.lane_ids(N, K, n_real), K)


def combine_scratch_ints(B: int, N: int, S: int, K: int, decide: bool) -> int:
    """int32 words of KAM's scratch (csrc/switch_combine.cu): per (lane,
    aggregator, chunk of rows, slot) three partial words (one in the decide
    phase), and four per (lane, aggregator, chunk) in a vote phase."""
    sp = min(S, THREADS)
    rows = ELEMS // sp
    chunks = -(-aggregate.n_segments(N, K) // rows)
    cells = B * K * chunks
    return cells * S if decide else cells * (3 * S + 4)


# --- KAM: the segment combine -------------------------------------------------

def switch_combine_plain(cfg: Config, seed, r: int, phase: int,
                         agg: aggregate.AggTables, n_real, flag, vals=None):
    """Plain version of KAM: phase ``phase``'s served table. A sender of
    lane b is live where it is honest (i < n_real[b] - n_byzantine),
    ``flag`` ([B, N, S] bool) is set and its uplink (KAL's row
    :func:`uplink_row`) is open; segments are
    :func:`~consensus_tpu_torch.ops.aggregate.lane_ids`. A vote phase
    returns ``(tot, val)``, [B, K, S] int32 each: val the segment's vmax
    over its live senders' ``vals`` and its liars' forged values, tot its
    count plus the equivocating support where it serves (count > 0 and vmax
    == vmin, ``aggregate.py:415-435``), else 0. The decide phase returns
    ``(mid,)``, the least live id (N where there is none)."""
    B, N, S = flag.shape
    K = cfg.n_aggregators
    sids = aggregate.lane_ids(N, K, n_real)
    up = agg.up[:, uplink_row(cfg, phase)]
    live = flag & (_honest(n_real, cfg.n_byzantine, N) & up)[:, :, None]
    if phase == DECIDE:
        idx = torch.arange(N, dtype=torch.int32, device=flag.device)
        src = torch.where(live, idx[:, None], N)
        return (aggregate.seg_min_plain(src, sids, K, N),)
    cnt = aggregate.seg_sum_plain(live.to(torch.int32), sids, K)
    vmax = aggregate.seg_max_plain(torch.where(live, vals, I32_MIN), sids, K,
                                   I32_MIN)
    vmin = aggregate.seg_min_plain(torch.where(live, vals, I32_MAX), sids, K,
                                   I32_MAX)
    byz = _byzantine(n_real, cfg.n_byzantine, N)
    lie, fval = aggregate.uplink_lies_plain(cfg, seed, r, byz)
    if lie is not None:
        liar = lie & up
        cnt = cnt + aggregate.seg_sum_plain(liar.to(torch.int32), sids,
                                            K)[:, :, None]
        vmax = torch.maximum(vmax, aggregate.seg_max_plain(
            torch.where(liar, fval, I32_MIN), sids, K, I32_MIN)[:, :, None])
        vmin = torch.minimum(vmin, aggregate.seg_min_plain(
            torch.where(liar, fval, I32_MAX), sids, K, I32_MAX)[:, :, None])
    serve = (cnt > 0) & (vmax == vmin)
    total = cnt
    if cfg.byz == BYZ_EQUIV:
        eq_up = byz & stance_plain(seed, r, N) & up
        total = cnt + aggregate.seg_sum_plain(eq_up.to(torch.int32), sids,
                                              K)[:, :, None]
    return torch.where(serve, total, 0), vmax


def switch_combine(cfg: Config, seed, r: int, phase: int,
                   agg: aggregate.AggTables, n_real, flag, vals=None):
    """Kernel KAM: same arguments and result as
    :func:`switch_combine_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/switch_combine.cu`` (a block per (lane,
    aggregator, chunk of its rows) reduces its senders a slot in shared
    memory, and its byzantine members' lies and support; a second launch
    folds the chunks into the table)."""
    if flag.device.type == "cpu":
        return switch_combine_plain(cfg, seed, r, phase, agg, n_real, flag,
                                    vals)
    from .. import _build
    from ..engines.raft import check_all
    B, N, S = flag.shape
    K = cfg.n_aggregators
    dev = flag.device
    decide = phase == DECIDE
    P = agg.up.shape[1]
    check_all(dev, (seed, torch.uint32, (B,)), (n_real, torch.int32, (B,)),
              (flag, torch.bool, (B, N, S)), (agg.up, torch.bool, (B, P, N)),
              *(() if decide else ((vals, torch.int32, (B, N, S)),)))
    out = torch.empty((B, K, S), dtype=torch.int32, device=dev)
    out_val = None if decide else torch.empty_like(out)
    scratch = torch.empty(combine_scratch_ints(B, N, S, K, decide),
                          dtype=torch.int32, device=dev)
    base = knobs.static(cfg)
    knob_table = None if decide else knobs.table_ptr(cfg, dev, B)
    _build.launch("switch_combine", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  n_real.data_ptr(), flag.data_ptr(),
                  None if decide else vals.data_ptr(), agg.up.data_ptr(),
                  out.data_ptr(), None if decide else out_val.data_ptr(),
                  scratch.data_ptr(), P, uplink_row(cfg, phase), B, N, S, K,
                  int(decide), cfg.n_byzantine, int(cfg.byz == BYZ_EQUIV),
                  base.byz_uplink_cutoff if base.uplink_lies_on else 0,
                  knob_table)
    switch_combine.launches += 1
    switch_combine.switch_launches += 1
    switch_combine.knob_launches += knob_table is not None
    return (out,) if decide else (out, out_val)


switch_combine.launches = 0
switch_combine.switch_launches = 0
# Launches of its KNOBS instance (a knob batch; the decide phase, which
# reads no cutoff, runs the flat one), also counted in ``launches``.
switch_combine.knob_launches = 0


# --- KAN: the receivers ----------------------------------------------------------

def downlink_mask_plain(cfg: Config, seed, r: int, tab, n_real, phase: int,
                        N: int) -> torch.Tensor:
    """[B, K, N] bool: aggregator a delivers phase ``phase``'s combine to
    receiver j at round r, from KAL's words ``tab`` (alive, side), with the
    vertex base ``n_real`` (``ctt::agg_downlink``; equal to
    ``aggregate.py`` downlink at ``n_vert = n_real``)."""
    B, K, dev = seed.shape[0], cfg.n_aggregators, seed.device
    a = torch.arange(K, dtype=torch.int64, device=dev)[None, :, None]
    j = torch.arange(N, dtype=torch.int64, device=dev)[None, None, :]
    return aggregate.downlink_at_plain(
        seed, r, tab, n_real.to(torch.int64)[:, None, None], phase,
        a.expand(B, K, N), j, cfg.drop_cutoff, cfg.partition_cutoff,
        cfg.max_delay_rounds)


def switch_receive_plain(cfg: Config, seed, r: int, phase: int,
                         agg: aggregate.AggTables, n_real, f, table,
                         flag=None, vals=None, base=None, dval=None,
                         committed_start=None, timer=None, reset=None,
                         flags=None):
    """Plain version of KAN: phase ``phase``'s receivers, from KAM's
    ``table``. A vote phase (``flag`` and ``vals`` its senders' inputs,
    ``base`` the flag it grows: prepared at entry in P4, committed at entry
    in P5) counts, at each (node, slot), the delivered aggregators serving
    its value and the poisoned delivered ones' widths, less its own returned
    copy as ``aggregate.py:451-468`` subtracts it, plus its own honest vote,
    against 2 f + 1, and returns ``base | (flag & pass)``, and with ``dval``
    (P5) also the decided values where it commits. The decide phase
    (``base`` the committed flags after P5, ``dval`` after P5) adopts the
    decided value of the least served id it hears into each slot it has not
    committed and returns (committed, dval, timer) after P7. With the §6c
    ``flags`` a receiver down at the round's end takes nothing."""
    B, N, S = base.shape
    K = cfg.n_aggregators
    dev = base.device
    down = downlink_mask_plain(cfg, seed, r, agg.tab, n_real, phase, N)
    keep = torch.ones((B, N), dtype=torch.bool, device=dev) if flags is None \
        else (flags & CRASH_DOWN) == 0
    if phase == DECIDE:
        (mid,) = table
        imin = torch.full((B, N, S), N, dtype=torch.int32, device=dev)
        for a in range(K):
            imin = torch.minimum(imin, torch.where(down[:, a, :, None],
                                                   mid[:, a, None, :], N))
        adopt = (imin < N) & ~base & keep[:, :, None]
        won = dval.gather(1, imin.clamp(max=N - 1).to(torch.int64))
        committed = base | adopt
        dval = torch.where(adopt, won, dval)
        new = (committed & ~committed_start).any(2)
        timer = torch.where(reset | new, torch.where(new, 0, timer),
                            timer + 1)
        return committed, dval, timer
    tot, val = table
    sids = aggregate.lane_ids(N, K, n_real)
    honest = _honest(n_real, cfg.n_byzantine, N)
    up = agg.up[:, uplink_row(cfg, phase)]
    contrib = flag & honest[:, :, None]
    poison = ((agg.tab & (aggregate.AGG_POISON0 << phase)) != 0) \
        if cfg.agg_poison_on else None
    widths = widths_plain(cfg, n_real, N)
    c = torch.zeros((B, N, S), dtype=torch.int32, device=dev)
    for a in range(K):
        d = down[:, a, :, None]
        term = torch.where(d & (tot[:, a, None, :] > 0)
                           & (val[:, a, None, :] == vals),
                           tot[:, a, None, :], 0)
        if poison is not None:
            term = torch.where(poison[:, a, None, None] & d,
                               widths[:, a, None, None], term)
        c = c + term
    down_own = down.gather(1, sids[:, None, :])[:, 0]              # [B, N]
    tot_own = aggregate.take_seg_plain(tot, sids, K)
    val_own = aggregate.take_seg_plain(val, sids, K)
    own_hit = down_own[:, :, None] & (tot_own > 0) & (val_own == vals)
    sub = (contrib & up[:, :, None] & own_hit).to(torch.int32)
    eq_sub = torch.zeros_like(sub)
    if cfg.byz == BYZ_EQUIV:
        eq_up = _byzantine(n_real, cfg.n_byzantine, N) \
            & stance_plain(seed, r, N) & up
        eq_sub = (eq_up[:, :, None] & own_hit).to(torch.int32)
    if poison is not None:
        pz_own = (aggregate.take_seg_plain(poison, sids, K)
                  & down_own)[:, :, None]
        sub = torch.where(pz_own, contrib.to(torch.int32), sub)
        eq_sub = torch.where(pz_own, 0, eq_sub)
    count = c - sub - eq_sub + contrib.to(torch.int32)
    passed = flag & (count >= (2 * f + 1)[:, None, None])
    out = base | (passed & keep[:, :, None])
    if dval is None:
        return out
    return out, torch.where(passed & ~base, vals, dval)


def switch_receive(cfg: Config, seed, r: int, phase: int,
                   agg: aggregate.AggTables, n_real, f, table, flag=None,
                   vals=None, base=None, dval=None, committed_start=None,
                   timer=None, reset=None, flags=None):
    """Kernel KAN: same arguments and result as
    :func:`switch_receive_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/switch_receive.cu`` (a thread per (lane,
    receiver, 32 aggregators) draws the downlinks into a bit mask; then a
    block per lane and receivers, a thread per (receiver, slot), counts or
    adopts and, in the decide phase, sets the timers)."""
    if base.device.type == "cpu":
        return switch_receive_plain(cfg, seed, r, phase, agg, n_real, f,
                                    table, flag, vals, base, dval,
                                    committed_start, timer, reset, flags)
    from .. import _build
    from ..engines.raft import check_all
    B, N, S = base.shape
    K = cfg.n_aggregators
    dev = base.device
    decide = phase == DECIDE
    P = agg.up.shape[1]
    specs = [(seed, torch.uint32, (B,)), (n_real, torch.int32, (B,)),
             (f, torch.int32, (B,)), (agg.tab, torch.int32, (B, K)),
             (agg.up, torch.bool, (B, P, N)), (base, torch.bool, (B, N, S)),
             *((t, torch.int32, (B, K, S)) for t in table)]
    if decide:
        specs += [(dval, torch.int32, (B, N, S)),
                  (committed_start, torch.bool, (B, N, S)),
                  (timer, torch.int32, (B, N)), (reset, torch.bool, (B, N))]
    else:
        specs += [(flag, torch.bool, (B, N, S)),
                  (vals, torch.int32, (B, N, S)),
                  *(() if dval is None else ((dval, torch.int32, (B, N, S)),))]
    if flags is not None:
        specs.append((flags, torch.uint8, (B, N)))
    check_all(dev, *specs)
    if len(table) != (1 if decide else 2):
        raise ValueError(f"phase {phase} takes {1 if decide else 2} tables")
    out = torch.empty_like(base)
    dval_out = None if dval is None else torch.empty_like(dval)
    timer_out = torch.empty_like(timer) if decide else None
    mask = torch.empty((B, N, -(-K // 32)), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    base_cfg, knob_table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("switch_receive", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  n_real.data_ptr(), f.data_ptr(), agg.tab.data_ptr(),
                  table[0].data_ptr(), ptr(None if decide else table[1]),
                  ptr(flag), ptr(vals), agg.up.data_ptr(), P,
                  uplink_row(cfg, phase), base.data_ptr(), ptr(dval),
                  ptr(dval_out), out.data_ptr(), ptr(committed_start),
                  ptr(timer), ptr(reset), ptr(timer_out), ptr(flags),
                  mask.data_ptr(), B, N, S, K, phase, cfg.n_byzantine,
                  int(cfg.byz == BYZ_EQUIV), int(cfg.agg_poison_on),
                  base_cfg.drop_cutoff, base_cfg.partition_cutoff,
                  cfg.max_delay_rounds, knob_table)
    switch_receive.launches += 1
    switch_receive.switch_launches += 1
    switch_receive.knob_launches += knob_table is not None
    if decide:
        return out, dval_out, timer_out
    return out if dval is None else (out, dval_out)


switch_receive.launches = 0
switch_receive.switch_launches = 0
# Launches of its KNOBS instance (a knob batch), also counted in
# ``launches``.
switch_receive.knob_launches = 0


# --- the three phases of a round --------------------------------------------------

def switch_phases(cfg: Config, seed, r: int, agg: aggregate.AggTables, n_real,
                  f, pp_seen, pp_val, prepared, committed, dval, timer, reset,
                  flags=None):
    """P4-P7 of a PBFT switch round, after P3 (both engines, both ladders):
    KAM and KAN for the prepare votes, the commit votes and the decide
    gossip, in that order (each phase's senders are the last one's
    receivers; the wrappers take their arguments by position, as
    chip_smoke.py records them). ``prepared``, ``committed`` and ``dval``
    are the round's entry values. ``flags`` (the §6b round's §6c word, None elsewhere) keeps
    a receiver down at the round's end from preparing and from adopting;
    its P5 commits stay in for the telemetry's commit_missed, as the flat
    §6b tally's do, and the freeze drops them. Returns (prepared, committed
    after P5, committed, dval, timer)."""
    t4 = switch_combine(cfg, seed, r, PREPARE, agg, n_real, pp_seen, pp_val)
    prepared = switch_receive(cfg, seed, r, PREPARE, agg, n_real, f, t4,
                              pp_seen, pp_val, prepared, None, None, None,
                              None, flags)
    t5 = switch_combine(cfg, seed, r, COMMIT, agg, n_real, prepared, pp_val)
    tallied, dval = switch_receive(cfg, seed, r, COMMIT, agg, n_real, f, t5,
                                   prepared, pp_val, committed, dval)
    t6 = switch_combine(cfg, seed, r, DECIDE, agg, n_real, tallied)
    committed, dval, timer = switch_receive(
        cfg, seed, r, DECIDE, agg, n_real, f, t6, None, None, tallied, dval,
        committed, timer, reset, flags)
    return prepared, tallied, committed, dval, timer
