"""PBFT under the broadcast-atomic fault model (SPEC §6b) in PyTorch.

The port of ``consensus_tpu/engines/pbft_bcast.py`` (with the SPEC §A.2
delayed retransmission on the per-sender broadcast key, the SPEC §6c
crash-recover adversary, the SPEC §B timer skew, the SPEC §3c/§7c byzantine
nodes and the SPEC §9 switch with its §9b axes), with its telemetry and
flight recorder (kernel KAA, ``engines/pbft.py``
:func:`~consensus_tpu_torch.engines.pbft.pbft_telemetry`, as the dense
engine's), and, through the same functions, of
``consensus_tpu/engines/pbft_sweep.py``'s ``pbft_bcast_round_padded``
(which has no telemetry). Under §6b a sender's round broadcast is
dropped whole (one delivery draw keyed (i, i)), so what a receiver hears
depends only on its partition side, and every tally collapses to one
aggregate per (lane, slot, side): no [N, N] tensor exists, and the engine
runs at N = 100 000.

As in ``engines/pbft.py``, every phase takes the per-lane population
``n_real`` and tolerance ``f`` ([B] int32): node ``i`` of lane ``b`` is
real when ``i < n_real[b]``, and honest when ``i < n_real[b] -
n_byzantine`` (every real node without byzantine nodes), the quorum is
``2 f[b] + 1``,
P1's ranks are ``f[b] + 1`` and ``f[b]``, and the primary is ``view mod
n_real[b]``. A standalone run is the case ``n_real = n_nodes``, ``f =
cfg.f`` on every lane, so the standalone engine and the f-ladder share
one set of kernels.

The round's per-node facts travel as one byte a node (:func:`node_bits`):
bit 0 is ``bcast`` (a real node whose broadcast goes out this round,
honest or not), bit 1 its side, the drawn partition side while the round's
partition is active and 0 otherwise, and under SPEC §6c bit 2 is set for
a node down at the round's end, whose broadcast then does not go out. A node counts towards, and reads, the
aggregate of its own side only: with the partition active that is the
JAX package's ``side_ok``, and without it both of the JAX package's
per-side aggregates are the same, so one serves everyone.

Four functions are wrappers of hand-written CUDA kernels, each beside its
plain PyTorch version (``<name>_plain``), which CPU tensors run:

* :func:`bcast_view_preprepare` — kernel KT
  (``csrc/bcast_view_preprepare.cu``): the node bits, P0 churn, P1 the
  per-side order statistics and catch-up, P2 timeouts, P3 pre-prepare;
* :func:`bcast_tally` — kernel KU (``csrc/bcast_tally.cu``): P4 the
  prepare quorum and P5 the commit quorum, counted per (slot, side);
* :func:`bcast_decide` — kernel KV (``csrc/bcast_decide.cu``): P6 the
  min-id decide gossip per (slot, side) and P7 the timers;
* :func:`bcast_equiv_support` — kernel KAK (``csrc/bcast_equiv_support.cu``):
  under byzantine equivocation, each receiver's ``extra``, the byzantine
  senders whose broadcast reaches it and whose stance toward it is set.

With ``crash_prob > 0`` the round starts with kernel KAH (``ops/
adversary.py`` ``crash_transition``) and ends with the freeze of
``engines/pbft.py`` (kernel KAI), after the telemetry: KT resets a
recovered node's view and timer and writes bit 2; KU keeps a down node
from preparing and KV from adopting (``pbft_bcast.py:333-356,
639-664``); every down node's round is otherwise the JAX round's, which
the telemetry counts. With ``desync_rate > 0`` KT's DESYNC instance adds
each node's SPEC §B timer skew to the timer it enters the round with; the
freeze reads the round's input, so a down node's skew is dropped.

With byzantine nodes (``Config.byz``, SPEC §3c/§7c) KT, KU, KV and KAA run
BYZ instances: in both modes only honest senders count in P1, the tallies
and the decide gossip, only an honest primary offers, and a node's own
vote counts only where it is honest. Under equivocation KAK runs between
KT and KU: KU adds each receiver's ``extra`` to its P4 and P5 counts, KT
lets a byzantine primary offer every slot to each receiver its broadcast
reaches, with a value drawn from the receiver's view and its stance toward
it, and KAA counts the §7c safety tail. The tables KU keeps grow to the
JAX package's width under equivocation (:func:`table_width`, up to 4).

The plain versions follow the JAX package's algorithms (P1 by a binary
search on the view range, P4-P5 by one sort and top-``m`` run tables);
the kernels compute the same functions without a sort (see each source).
No input is changed: each phase writes fresh tensors.

With ``net_model="switch"`` (SPEC §9) KAL (``ops/aggregate.py``
``agg_round``, its §6b uplink: the round's one broadcast key lands on the
sender's aggregator) follows KT, and kernels KAM and KAN
(``ops/switch_tally.py``) take the place of KAK, KU and KV: the vote and
decide phases go through the K aggregators' combines
(``pbft_bcast.py:564-642``). Under §6c a receiver down at the round's end
neither prepares nor adopts, as there.
"""
from __future__ import annotations

import torch

from ..core import knobs, rng
from ..core.config import BYZ_EQUIV, BYZ_NONE, BYZ_SILENT, Config
from ..ops.adversary import (CRASH_DOWN, CRASH_REC, churn, crash_step,
                             equiv_stance_plain, open_drop_plain)
from ..ops.aggregate import agg_step
from ..ops.switch_tally import switch_phases
from ..ops.viewsync import desync_skew_plain
from . import pbft
from .pbft import (PbftState, fresh_values, honest_nodes, real_nodes,
                   view_bound)
from .raft import check_all

# The engine's name, as the JAX package's EngineDef names it.
NAME = "pbft-bcast"

I32_MAX = 2**31 - 1
I32_MIN = -2**31
# The widest top-m table kernel KU keeps (as csrc/bcast_tally.cu MAX_M):
# m is 1 or 2 without equivocators, up to 4 with them (:func:`table_width`).
MAX_M = 4
# Nodes a block of KU's and KV's passes covers (as csrc/bcast_tally.cu
# CHUNK), which sizes KU's per-block summaries.
CHUNK = 1024


def table_width(n_nodes: int, f: int, eb: int = 0) -> int:
    """The JAX package's ``_table_width`` (``consensus_tpu/engines/
    pbft_bcast.py:130-144``): how many values of one (slot, side) can reach
    a quorum threshold, with ``eb`` equivocators. A value that passes any
    node's check has at least Tmin = 2f - eb same-value senders (the self
    term adds at most one, a receiver's ``extra`` at most eb) among at
    most ``n_nodes``, so at most ``n_nodes // Tmin`` values qualify: 1 at
    f >= 2 and 2 at f = 1 without equivocators, 3 at eb = f >= 2, 4 at
    f = eb = 1."""
    return max(1, min(n_nodes, n_nodes // max(1, 2 * f - eb)))


def table_cap(cfg: Config, rungs=None) -> int:
    """The table width ``m`` a run's tallies use: ``cfg``'s own, or, for an
    f-ladder (``rungs``), the widest of its rungs', as the JAX package's
    ``_fsweep_static`` takes ``m_cap`` (``pbft_sweep.py:629-631``); eb is
    ``n_byzantine`` under equivocation and 0 otherwise."""
    eb = cfg.n_byzantine if cfg.byz == BYZ_EQUIV else 0
    if rungs is None:
        return table_width(cfg.n_nodes, cfg.f, eb)
    return max(table_width(3 * int(f) + 1, int(f), eb) for f in rungs)


# Bit 2 of a node's byte: down at the round's end (SPEC §6c).
BIT_DOWN = 4


def node_bits(cfg: Config, seed, r: int, n_real, flags=None) -> torch.Tensor:
    """[B, N] uint8, each node's byte of round ``r``: bit 0 set for a real
    node, honest or not, whose broadcast goes out (the delivery draw keyed
    (i, i) at or
    above the drop cutoff, or a broadcast dropped in one of the last
    ``max_delay_rounds`` rounds retransmitted now: SPEC §A.2 on the same
    self-edge key, JAX ``pbft_bcast.py:381-386``), bit 1 its partition
    side (the Threefry draw (r, 1, i) & 1) in a round whose partition is
    active, else 0; with the round's SPEC §6c ``flags``, bit 0 clear and
    bit 2 set for a node down at the round's end."""
    N = cfg.n_nodes
    idx = torch.arange(N, dtype=torch.int64, device=seed.device)
    useed = rng.as_u32(seed)[:, None]
    bc = open_drop_plain(useed, r, idx, idx, cfg.drop_cutoff,
                         cfg.max_delay_rounds)
    bits = (bc & real_nodes(n_real, N)).to(torch.uint8)
    if not cfg.no_partition:
        active = rng.random_u32_plain(seed, rng.STREAM_PARTITION, r, 0, 0) \
            < cfg.partition_cutoff                              # [B, 1]
        side = rng.threefry2x32_plain(useed ^ rng.STREAM_PARTITION, r, 1,
                                      idx) & 1
        bits |= ((side == 1) & active).to(torch.uint8) << 1
    if flags is not None:
        down = (flags & CRASH_DOWN) != 0
        bits = torch.where(down, (bits & ~1) | BIT_DOWN, bits)
    return bits


def hb_side(bits):
    """(bcast as bool, side as int64) of a node byte tensor
    (:func:`node_bits`)."""
    return (bits & 1).bool(), ((bits >> 1) & 1).to(torch.int64)


def kth_largest_plain(w1, ks, vmax: int) -> torch.Tensor:
    """The JAX package's ``_kth_largest``, batched: for each row of ``w1``
    ([..., C, N] int32, entry + 1 for members, 0 for pads), the largest v
    with |{j : w1[..., c, j] >= v + 1}| >= ks[..., c], by the same
    fixed-depth binary search on [0, vmax + 2). [..., C] int32 in [-1,
    vmax]: -1 when fewer than k entries, vmax when k <= 0."""
    lo = torch.zeros(w1.shape[:-1], dtype=torch.int32, device=w1.device)
    hi = torch.full_like(lo, vmax + 2)
    for _ in range(int(vmax + 1).bit_length()):
        mid = (lo + hi) // 2
        ok = (w1 >= mid[..., None]).sum(-1, dtype=torch.int32) >= ks
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return lo - 1


def _gather_nodes(x, idx):
    """x[b, idx[b, n], ...] for [B, N, ...] ``x`` and [B, M] ``idx``."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


# --- KT: node bits, P0 churn, P1 catch-up, P2 timeout, P3 pre-prepare --------

def bcast_view_preprepare_plain(cfg: Config, seed, r: int, n_real, f, view,
                                timer, pp_seen, pp_view, pp_val, prepared,
                                committed, want_catch: bool = False,
                                flags=None):
    """Plain version of KT, SPEC §6b P0-P3 at every node of each lane.

    P0: the round's churn event moves every view up by one. P1: the
    senders are the nodes of bit 0 (:func:`node_bits`); per side, a1 and
    a2 are the (f+1)-th and f-th largest sender view (a2 the int32 maximum
    at f = 0); a sender takes a1, another node clip(view, a1, a2), where
    that is above its view. P2: a node whose timer reached
    ``view_timeout`` moves to the next view. A moved node's timer is 0 and
    its ``reset`` set. P3: the primary of view v is node v mod n_real; it
    offers each slot it has seen and not committed and its first unseen
    slot (a fresh value drawn from its view); receiver j takes the offer
    when the primary is j or a sender of j's side, in j's view, into each
    slot it has not seen in this view, unless it prepared another value
    there. Returns new (view, timer, reset, pp_seen, pp_view, pp_val), the
    node bits and, with ``want_catch``, the [B, N] bool flags of the nodes
    P1 moved. With the round's SPEC §6c ``flags`` ([B, N] uint8, KAH), a
    recovered node's view and timer are 0 before P0 (``consensus_tpu/
    engines/pbft_bcast.py:438-445``) and the bits say who is down; with
    ``cfg.desync_on``, each node's SPEC §B skew (keyed by its absolute id)
    is added to its timer after that and before P0 (``pbft_bcast.py:
    446-453``, ``pbft_sweep.py:353-360``).

    With byzantine nodes (SPEC §3c/§7c, ``cfg.byz``; node i of lane b is
    honest when i < n_real[b] - n_byzantine) the senders of P1 are the
    honest ones of bit 0, and only an honest primary offers, in both modes
    (``pbft_bcast.py:470, 511``); an equivocating primary (``BYZ_EQUIV``)
    offers every slot to each real receiver j that it reaches (j itself,
    or its broadcast goes out on j's side), whatever the views, with the
    value drawn from j's view and subdraw 4 where its stance toward j is
    set, else 3 (``pbft_bcast.py:519-545``, ``pbft_sweep.py:410-431``)."""
    B, N, S = pp_seen.shape
    dev = view.device
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    real = real_nodes(n_real, N)
    honest = honest_nodes(n_real, cfg.n_byzantine, N)
    bits = node_bits(cfg, seed, r, n_real, flags)
    if flags is not None:
        rec = (flags & CRASH_REC) != 0
        view = torch.where(rec, 0, view)
        timer = torch.where(rec, 0, timer)
    if cfg.desync_on:
        timer = timer + desync_skew_plain(seed, r, idx, cfg.desync_cutoff,
                                          cfg.max_skew_rounds)
    bc, side = hb_side(bits)
    hb = bc & honest

    # ---- P0 churn.
    ch = churn(seed, r, cfg.churn_cutoff, rng.random_u32_plain)[:, None]
    view = view + ch.to(torch.int32)
    timer = torch.where(ch, 0, timer)
    reset = ch.expand(B, N)

    # ---- P1 catch-up: per-side order statistics of the senders' views.
    vplus = view + 1
    cols = torch.stack([torch.where(hb & (side == s), vplus, 0)
                        for s in (0, 1)], 1)                  # [B, 2, N]
    ks = torch.stack([f + 1, f + 1, f, f], 1)                 # [B, 4]
    stat = kth_largest_plain(torch.cat([cols, cols], 1), ks,
                             view_bound(cfg))                 # [B, 4]
    a1 = stat[:, 0:2].gather(1, side)
    a2 = torch.where((f >= 1)[:, None], stat[:, 2:4], I32_MAX).gather(1, side)
    vth = torch.where(hb, a1, torch.clamp(view, a1, a2))
    catch = vth > view
    view = torch.where(catch, vth, view)
    timer = torch.where(catch, 0, timer)
    reset = reset | catch

    # ---- P2 timeout.
    to = timer >= cfg.view_timeout
    view = view + to.to(torch.int32)
    timer = torch.where(to, 0, timer)
    reset = reset | to

    # ---- P3 pre-prepare.
    sarange = torch.arange(S, dtype=torch.int32, device=dev)
    prim = view.remainder(n_real[:, None]).to(torch.int64)     # [B, N]
    is_primary = honest & (prim == idx)
    fresh = torch.where(~pp_seen, sarange, S).amin(2)
    fresh_hot = sarange == fresh[:, :, None]
    ppb = is_primary[:, :, None] & ((pp_seen & ~committed) | fresh_hot)
    msg_val = torch.where(pp_seen, pp_val, fresh_values(seed, view, S))
    prim_del = ((prim == idx) | (bc.gather(1, prim)
                                 & (side.gather(1, prim) == side))) & real
    prim_ok = prim_del & (view.gather(1, prim) == view)
    prim_s = prim[:, :, None].expand(B, N, S)
    pm_b, pm_val = ppb.gather(1, prim_s), msg_val.gather(1, prim_s)
    if cfg.byz == BYZ_EQUIV:
        prim_byz = (real & ~honest).gather(1, prim)              # [B, N]
        sup = equiv_stance_plain(seed, r, prim, idx)
        prim_ok = torch.where(prim_byz, prim_del, prim_ok)
        pm_b = pm_b | prim_byz[:, :, None]
        pm_val = torch.where(prim_byz[:, :, None],
                             fresh_values(seed, view, S,
                                          torch.where(sup, 4, 3)), pm_val)
    accept = (prim_ok[:, :, None] & pm_b
              & (~pp_seen | (pp_view < view[:, :, None]))
              & (~prepared | (pm_val == pp_val)))
    out = (view, timer, reset, pp_seen | accept,
           torch.where(accept, view[:, :, None], pp_view),
           torch.where(accept, pm_val, pp_val), bits)
    return (*out, catch) if want_catch else out


def bcast_view_preprepare(cfg: Config, seed, r: int, n_real, f, view, timer,
                          pp_seen, pp_view, pp_val, prepared, committed,
                          want_catch: bool = False, flags=None):
    """Kernel KT: same arguments and result as
    :func:`bcast_view_preprepare_plain`, which it runs for CPU tensors; for
    CUDA tensors it launches ``csrc/bcast_view_preprepare.cu`` (a thread
    per node draws its bits and adds its view to its lane's per-side
    histogram; a thread per receiver reads its side's two statistics off
    the histogram's suffix sums for P1 and runs P2; a thread per (receiver,
    slot) runs P3, reading the rows as they stood before P3; P1's flags
    only with ``want_catch``; its CRASH instance with ``flags``, its DESYNC
    instance with ``cfg.desync_on``, its BYZ instances with byzantine
    nodes; its KNOBS instances with a knob batch's view, whose lanes read
    their churn, drop, partition and desync cutoffs from the view's table,
    ``core/knobs.py``)."""
    if view.device.type == "cpu":
        return bcast_view_preprepare_plain(cfg, seed, r, n_real, f, view,
                                           timer, pp_seen, pp_view, pp_val,
                                           prepared, committed, want_catch,
                                           flags)
    from .. import _build
    B, N, S = pp_seen.shape
    dev = view.device
    check_all(dev, (seed, torch.uint32, (B,)), (n_real, torch.int32, (B,)),
              (f, torch.int32, (B,)),
              *((t, torch.int32, (B, N)) for t in (view, timer)),
              *((t, torch.bool, (B, N, S)) for t in (pp_seen, prepared,
                                                      committed)),
              *((t, torch.int32, (B, N, S)) for t in (pp_view, pp_val)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)))
    vmax = view_bound(cfg)
    view_out, timer_out = torch.empty_like(view), torch.empty_like(timer)
    reset = torch.empty((B, N), dtype=torch.bool, device=dev)
    seen_out, pview_out = torch.empty_like(pp_seen), torch.empty_like(pp_view)
    pval_out = torch.empty_like(pp_val)
    bits = torch.empty((B, N), dtype=torch.uint8, device=dev)
    hist = torch.empty((B, 2, vmax + 2), dtype=torch.int32, device=dev)
    fresh = torch.empty((B, N), dtype=torch.int32, device=dev)
    catch = torch.empty_like(reset) if want_catch else None
    base, table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("bcast_view_preprepare", seed.data_ptr(),
                  int(r) & 0xFFFFFFFF, base.churn_cutoff, base.drop_cutoff,
                  base.partition_cutoff, cfg.max_delay_rounds,
                  cfg.view_timeout, vmax, base.desync_cutoff,
                  cfg.max_skew_rounds, *(t.data_ptr() for t in (
                      n_real, f, view, timer, pp_seen, pp_view, pp_val,
                      prepared, committed, view_out, timer_out, reset,
                      seen_out, pview_out, pval_out, bits, hist, fresh)),
                  None if catch is None else catch.data_ptr(),
                  None if flags is None else flags.data_ptr(), B, N, S,
                  cfg.byz, cfg.n_byzantine, table)
    bcast_view_preprepare.launches += 1
    bcast_view_preprepare.knob_launches += table is not None
    out = (view_out, timer_out, reset, seen_out, pview_out, pval_out, bits)
    return (*out, catch) if want_catch else out


bcast_view_preprepare.launches = 0
# Launches of its KNOBS instance (a knob batch), also counted in
# ``launches``.
bcast_view_preprepare.knob_launches = 0


# --- KU: P4 prepare tally, P5 commit tally -----------------------------------

def aggregate_tallies_plain(pp_val, pp_seen, prepared, committed, honest,
                            bcast, Q, m: int, side, up=None, extra=None):
    """The JAX package's ``_aggregate_tallies`` without the switch, batched
    over lanes: ``pp_val`` [B, N, S] int32; ``pp_seen``, ``prepared``,
    ``committed`` [B, N, S] bool; ``honest``, ``bcast`` [B, N] bool; ``Q``
    [B] the quorum; ``m`` the table width; ``side`` [B, N] int64 the side
    whose aggregate each node counts towards and reads (all 0 where the
    partition is off: one aggregate, the JAX package's ``side=None``);
    ``up`` [B, N] bool the nodes up at the round's end (SPEC §6c), None
    without crashes; ``extra`` [B, N] int32 each receiver's equivocating
    support (SPEC §7c), added to its P4 and P5 counts in node order and,
    for P5's senders, in sorted order (``pbft_bcast.py:265-270, 322-353``),
    None without equivocators.

    One sort of each (lane, slot) column of values; per (slot, side) the
    top-``m`` equal-value runs by count of honest broadcasting senders
    (those with ``relevant``: ``pp_seen`` for P4, the post-P4 prepared
    flags for P5); each node's count is its value's table entry (0 when
    absent), plus one for itself when it is honest, relevant and did not
    broadcast. Returns (prep_hit, prepared2, commit_now, c5)."""
    B, N, S = pp_val.shape
    sv, perm = torch.sort(pp_val.transpose(1, 2), dim=2, stable=True)
    brk = sv[:, :, 1:] != sv[:, :, :-1]
    one = torch.ones((B, S, 1), dtype=torch.bool, device=sv.device)
    newrun = torch.cat([one, brk], 2)
    endrun = torch.cat([brk, one], 2)

    def to_sorted(x):
        """[B, N, S] or [B, N] per node → [B, S, N] in sorted order."""
        if x.dim() == 2:
            x = x[:, :, None].expand(B, N, S)
        return x.transpose(1, 2).gather(2, perm)

    def run_counts(valid):
        flags = valid.to(torch.int32)
        s = flags.cumsum(2, dtype=torch.int32)
        ex_start = torch.where(newrun, s - flags, -1).cummax(2).values
        return s - ex_start

    def top_runs(end_counts):
        active = endrun
        tvs, tcs = [], []
        for _ in range(m):
            cur = torch.where(active, end_counts, -1)
            tc = cur.amax(2, keepdim=True)                        # [B, S, 1]
            hit = (cur == tc) & (tc >= 0)
            tv = torch.where(hit, sv, I32_MIN).amax(2, keepdim=True)
            active = active & ~((sv == tv) & (tc >= 0))
            tvs.append(tv)
            tcs.append(tc)
        return torch.cat(tvs, 2), torch.cat(tcs, 2)              # [B, S, m]

    def table_count(vals, tv, tc):
        match = (vals[..., None] == tv) & (tc >= 0)
        return torch.where(match, tc, 0).sum(-1, dtype=torch.int32)

    hb_s = to_sorted(honest & bcast)
    side_s = to_sorted(side)

    def tables_for(relevant_s):
        return [top_runs(run_counts(hb_s & relevant_s & (side_s == b)))
                for b in (0, 1)]

    def counts_sorted(tables):
        got = [table_count(sv, tv[:, :, None, :], tc[:, :, None, :])
               for tv, tc in tables]
        return torch.where(side_s == 1, got[1], got[0])

    def counts_nodes(tables):
        tv = torch.stack([t[0] for t in tables], 1)               # [B, 2, S, m]
        tc = torch.stack([t[1] for t in tables], 1)
        return table_count(pp_val, _gather_nodes(tv, side),
                           _gather_nodes(tc, side))

    q = Q[:, None, None]
    selfish = (honest & ~bcast)[:, :, None]
    extra_n = 0 if extra is None else extra[:, :, None]
    extra_s = 0 if extra is None else to_sorted(extra)
    t4 = tables_for(to_sorted(pp_seen))
    c4 = counts_nodes(t4) + (selfish & pp_seen).to(torch.int32) + extra_n
    prep_hit = pp_seen & (c4 >= q)
    if up is not None:
        prep_hit = prep_hit & up[:, :, None]
    prepared2 = prepared | prep_hit
    seen_s, selfish_s = to_sorted(pp_seen), to_sorted(honest & ~bcast)
    c4_s = counts_sorted(t4) + (selfish_s & seen_s).to(torch.int32) + extra_s
    prepared2_s = to_sorted(prepared) | (seen_s & (c4_s >= q))
    t5 = tables_for(prepared2_s)
    c5 = counts_nodes(t5) + (selfish & prepared2).to(torch.int32) + extra_n
    commit_now = prepared2 & (c5 >= q) & ~committed
    return prep_hit, prepared2, commit_now, c5


def bcast_tally_plain(m: int, n_real, f, bits, pp_seen, pp_val, prepared,
                      committed, dval, crash: bool = False, byz=None):
    """Plain version of KU, SPEC §6b P4-P5 at every (node, slot) of each
    lane: :func:`aggregate_tallies_plain` with the quorum 2f + 1, the
    senders and sides of the node bits and table width ``m``. Slot s of
    node j is prepared once 2f + 1 of the senders of j's side that have
    seen s with j's value, and j itself where it sent nothing, agree; it
    is committed, with that value decided, once 2f + 1 such senders have
    prepared it. Returns new (prepared, committed, dval). With ``crash``
    (SPEC §6c), a node of bit 2 prepares nothing (``consensus_tpu/engines/
    pbft_bcast.py:331-335``); its commits stay in, as the round's own
    tally reached them, for the telemetry's commit_missed, and the freeze
    drops them.

    With byzantine nodes ``byz`` is the pair (n_byzantine, extra): the
    senders counted are the honest ones (i < n_real - n_byzantine), a
    node's own vote counts only where it is honest, and under equivocation
    ``extra`` ([B, N] int32, kernel KAK) adds to each receiver's P4 and P5
    counts (``pbft_bcast.py:276-284, 322-353``); it is None in silent
    mode."""
    bc, side = hb_side(bits)
    nb, extra = (0, None) if byz is None else byz
    honest = honest_nodes(n_real, nb, bits.shape[1])
    up = (bits & BIT_DOWN) == 0 if crash else None
    _, prepared2, commit_now, _ = aggregate_tallies_plain(
        pp_val, pp_seen, prepared, committed, honest, bc, 2 * f + 1, m,
        side, up, extra)
    return (prepared2, committed | commit_now,
            torch.where(commit_now, pp_val, dval))


def tally_scratch_ints(B: int, N: int, S: int) -> int:
    """int32 words of KU's scratch (csrc/bcast_tally.cu): per-block
    summaries, two phases' candidate tables and exact counts, and the
    per-(lane, slot group) block counters."""
    nblk = -(-N // CHUNK)
    groups = -(-S // 256)
    table = B * S * 2 * MAX_M
    return 2 * nblk * table + 2 * 3 * table + 2 * B * groups


def bcast_tally(m: int, n_real, f, bits, pp_seen, pp_val, prepared,
                committed, dval, crash: bool = False, byz=None):
    """Kernel KU: same arguments and result as :func:`bcast_tally_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/bcast_tally.cu`` (per phase: a Misra-Gries summary of ``m``
    counters a (slot, side) from each block of senders, merged by the
    lane's last block into at most m candidates, an exact recount of the
    candidates, and a lookup of each node's value; its CRASH instance with
    ``crash``, its BYZ instances with ``byz``)."""
    if bits.device.type == "cpu":
        return bcast_tally_plain(m, n_real, f, bits, pp_seen, pp_val,
                                 prepared, committed, dval, crash, byz)
    from .. import _build
    B, N, S = pp_seen.shape
    dev = bits.device
    if not 1 <= m <= MAX_M:
        raise ValueError(f"table width m={m} is outside [1, {MAX_M}]")
    check_all(dev, (n_real, torch.int32, (B,)), (f, torch.int32, (B,)),
              (bits, torch.uint8, (B, N)),
              *((t, torch.bool, (B, N, S)) for t in (pp_seen, prepared,
                                                      committed)),
              *((t, torch.int32, (B, N, S)) for t in (pp_val, dval)))
    nb, extra = (0, None) if byz is None else byz
    if extra is not None:
        check_all(dev, (extra, torch.int32, (B, N)))
    mode = BYZ_NONE if byz is None else BYZ_SILENT if extra is None \
        else BYZ_EQUIV
    prep_out, com_out = torch.empty_like(prepared), torch.empty_like(committed)
    dval_out = torch.empty_like(dval)
    words = tally_scratch_ints(B, N, S)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    _build.launch("bcast_tally", *(t.data_ptr() for t in (
        n_real, f, bits, pp_seen, pp_val, prepared, committed, dval,
        prep_out, com_out, dval_out, scratch)), words, m, B, N, S,
        int(crash), mode, nb, None if extra is None else extra.data_ptr())
    bcast_tally.launches += 1
    return prep_out, com_out, dval_out


bcast_tally.launches = 0


# --- KV: P6 decide gossip, P7 timers -----------------------------------------

def bcast_decide_plain(bits, committed, dval, committed_start, timer, reset,
                       crash: bool = False, byz=None):
    """Plain version of KV, SPEC §6b P6-P7 at every node of each lane. P6:
    per (slot, side), the least-id sender that has committed the slot (as
    P5 left it) is the decider; a node that has not committed the slot
    adopts its side's decider's decided value. P7: a node that committed
    a slot this round (``committed_start`` is the round's entry) sets its
    timer to 0; another whose ``reset`` is set keeps it; the rest count it
    up. Returns new (committed, dval, timer). With ``crash`` (SPEC §6c), a
    node of bit 2 adopts nothing (``consensus_tpu/engines/
    pbft_bcast.py:663-664``). With byzantine nodes ``byz`` is the pair
    (n_real, n_byzantine), and the deciders are the honest senders only
    (``pbft_bcast.py:650``, SPEC §3c)."""
    B, N, S = committed.shape
    hb, side = hb_side(bits)
    if byz is not None:
        hb = hb & honest_nodes(byz[0], byz[1], N)
    idx = torch.arange(N, dtype=torch.int32, device=bits.device)
    dec = hb[:, :, None] & committed
    rows = torch.stack([torch.where(dec & (side == b)[:, :, None],
                                    idx[:, None], N).amin(1)
                        for b in (0, 1)], 1)                  # [B, 2, S]
    imin = _gather_nodes(rows, side)                          # [B, N, S]
    adopt = (imin < N) & ~committed
    if crash:
        adopt = adopt & ((bits & BIT_DOWN) == 0)[:, :, None]
    val_rows = dval.gather(1, rows.clamp(max=N - 1).to(torch.int64))
    dval = torch.where(adopt, _gather_nodes(val_rows, side), dval)
    committed = committed | adopt
    new_commit = (committed & ~committed_start).any(2)
    timer = torch.where(reset | new_commit, torch.where(new_commit, 0, timer),
                        timer + 1)
    return committed, dval, timer


def bcast_decide(bits, committed, dval, committed_start, timer, reset,
                 crash: bool = False, byz=None):
    """Kernel KV: same arguments and result as :func:`bcast_decide_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/bcast_decide.cu`` (each tile of :data:`DECIDE_TILE` nodes'
    least decider per (side, slot), stored plainly; then a thread per node
    takes its lane's minima over the tiles, adopts with 16-byte rows and
    runs P7, writing fresh tensors; its CRASH instance with ``crash``, its
    BYZ instance with ``byz``)."""
    if bits.device.type == "cpu":
        return bcast_decide_plain(bits, committed, dval, committed_start,
                                  timer, reset, crash, byz)
    from .. import _build
    B, N, S = committed.shape
    dev = bits.device
    check_all(dev, (bits, torch.uint8, (B, N)),
              *((t, torch.bool, (B, N, S)) for t in (committed,
                                                      committed_start)),
              (dval, torch.int32, (B, N, S)), (timer, torch.int32, (B, N)),
              (reset, torch.bool, (B, N)))
    n_real, nb = (None, 0) if byz is None else byz
    if n_real is not None:
        check_all(dev, (n_real, torch.int32, (B,)))
    com_out, dval_out = torch.empty_like(committed), torch.empty_like(dval)
    timer_out = torch.empty_like(timer)
    imin = torch.empty((B, -(-N // DECIDE_TILE), 2, S), dtype=torch.int32,
                       device=dev)
    _build.launch("bcast_decide", *(t.data_ptr() for t in (
        bits, committed, dval, committed_start, timer, reset, com_out,
        dval_out, timer_out, imin)), B, N, S, int(crash),
        None if n_real is None else n_real.data_ptr(), nb)
    bcast_decide.launches += 1
    return com_out, dval_out, timer_out


bcast_decide.launches = 0
# Nodes a block of KV's first launch searches for deciders
# (csrc/bcast_decide.cu TILE): the tiles' minima table is [B, ceil(N /
# DECIDE_TILE), 2, S].
DECIDE_TILE = 4096


# --- KAK: each receiver's equivocating support --------------------------------

# Elements of one [B, senders, N] block of stance draws the plain version
# makes at a time: memory, not the result, depends on it.
SUPPORT_BLOCK = 1 << 25


def bcast_equiv_support_plain(seed, r: int, n_real, nb: int, bits):
    """Plain version of KAK, SPEC §7c under §6b: [B, N] int32, ``extra[b,
    j]`` = the byzantine senders i of lane b (n_real[b] - nb <= i <
    n_real[b]) whose broadcast goes out (bit 0 of the node byte), i != j,
    on j's side while the round's partition is active (bit 1), and whose
    stance toward j, ``equiv_stance(seed, r, i, j)`` (absolute ids), is
    set (``consensus_tpu/engines/pbft_bcast.py:415-433``,
    ``pbft_sweep.py:335-350``); 0 for a receiver that is not real, whose
    count nothing reads. Every stance is its own Threefry draw, so it
    walks the senders in blocks of :data:`SUPPORT_BLOCK` draws."""
    B, N = bits.shape
    dev = bits.device
    bc, side = hb_side(bits)
    j = torch.arange(N, dtype=torch.int64, device=dev)
    extra = torch.zeros((B, N), dtype=torch.int32, device=dev)
    step = max(1, SUPPORT_BLOCK // max(1, B * N))
    for k0 in range(0, nb, step):
        k = torch.arange(k0, min(nb, k0 + step), dtype=torch.int64,
                         device=dev)
        i = (n_real.to(torch.int64) - nb)[:, None] + k           # [B, C]
        ok = (bc.gather(1, i)[:, :, None]
              & (side.gather(1, i)[:, :, None] == side[:, None, :])
              & (i[:, :, None] != j)
              & equiv_stance_plain(seed, r, i[:, :, None], j))   # [B, C, N]
        extra += ok.sum(1, dtype=torch.int32)
    return torch.where(real_nodes(n_real, N), extra, 0)


def bcast_equiv_support(seed, r: int, n_real, nb: int, bits):
    """Kernel KAK: same arguments and result as
    :func:`bcast_equiv_support_plain`, which it runs for CPU tensors; for
    CUDA tensors it launches ``csrc/bcast_equiv_support.cu`` (a block per
    256 receivers of a lane and chunk of byzantine senders stages the
    chunk's broadcasting senders in shared memory; each thread draws its
    receiver's stances from them, keeps its count in a register and adds
    it with one integer atomic)."""
    if bits.device.type == "cpu":
        return bcast_equiv_support_plain(seed, r, n_real, nb, bits)
    from .. import _build
    B, N = bits.shape
    dev = bits.device
    check_all(dev, (seed, torch.uint32, (B,)), (n_real, torch.int32, (B,)),
              (bits, torch.uint8, (B, N)))
    extra = torch.empty((B, N), dtype=torch.int32, device=dev)
    _build.launch("bcast_equiv_support", seed.data_ptr(),
                  int(r) & 0xFFFFFFFF, n_real.data_ptr(), bits.data_ptr(),
                  extra.data_ptr(), nb, B, N)
    bcast_equiv_support.launches += 1
    return extra


bcast_equiv_support.launches = 0


# --- the round ---------------------------------------------------------------

def pbft_bcast_round(cfg: Config, st: PbftState, r: int, n_real, f,
                     m: int, *, telem=None, flight=None) -> PbftState:
    """One SPEC §6b round with per-lane ``n_real`` and ``f`` ([B] int32)
    and table width ``m`` (:func:`table_cap`), phase by phase as
    ``consensus_tpu/engines/pbft_sweep.py`` ``pbft_bcast_round_padded``,
    and so, with ``n_real = cfg.n_nodes`` and ``f = cfg.f`` on every
    lane, as ``consensus_tpu/engines/pbft_bcast.py`` ``pbft_bcast_round``
    on its flat path: three kernel launches and nothing else, and with
    ``telem`` (and ``flight``, as ``engines/pbft.py`` :func:`pbft_round`
    takes them) a fourth, kernel KAA, which adds the round's counters.
    With ``cfg.crash_on`` (SPEC §6c) KAH comes first and the freeze, KAI,
    last. With byzantine nodes (``cfg.byz``) KT, KU, KV and KAA run their
    BYZ instances, and under equivocation KAK runs between KT and KU. Under
    the switch (``cfg.switch_on``) KAL, then KAM and KAN three times each,
    take the place of KAK, KU and KV."""
    if flight is not None and telem is None:
        raise ValueError("the flight recorder rides the telemetry "
                         "accumulator: pass telem with flight")
    # ---- Node bits, P0 churn, P1 catch-up, P2 timeout, P3 (KT), with P1's
    # flags when the telemetry counts them.
    # ---- SPEC §6c crash transition (KAH); the CRASH instances' arguments.
    down, flags = st.down, None
    on = () if telem is None else (True,)
    crash = ()
    if cfg.crash_on:
        down, flags = crash_step(cfg, st.seed, r, st.down,
                                 pbft.PBFT_TELEMETRY, telem, flight)
        on = (telem is not None, flags)
        crash = (True,)
    view, timer, reset, pp_seen, pp_view, pp_val, bits, *catch = \
        bcast_view_preprepare(cfg, st.seed, r, n_real, f, st.view, st.timer,
                              st.pp_seen, st.pp_view, st.pp_val,
                              st.prepared, st.committed, *on)

    if cfg.switch_on:
        # ---- SPEC §9: the aggregators' round (KAL), then P4-P7 through
        # their combines (KAM, KAN); no KAK, KU or KV.
        agg = agg_step(cfg, st.seed, r, flags, pbft.PBFT_TELEMETRY, telem,
                       flight, n_real)
        prepared, tallied, committed, dval, timer = switch_phases(
            cfg, st.seed, r, agg, n_real, f, pp_seen, pp_val, st.prepared,
            st.committed, st.dval, timer, reset, flags)
    else:
        # ---- SPEC §3c/§7c: the BYZ instances' arguments; under
        # equivocation each receiver's support (KAK).
        byz_tally = byz_decide = ()
        if cfg.byz:
            nb = cfg.n_byzantine
            extra = None if cfg.byz != BYZ_EQUIV else bcast_equiv_support(
                st.seed, r, n_real, nb, bits)
            byz_tally = (bool(crash), (nb, extra))
            byz_decide = (bool(crash), (n_real, nb))

        # ---- P4 prepare tally, P5 commit tally (KU).
        prepared, tallied, dval = bcast_tally(
            m, n_real, f, bits, pp_seen, pp_val, st.prepared, st.committed,
            st.dval, *(byz_tally or crash))

        # ---- P6 decide gossip, P7 timers (KV).
        committed, dval, timer = bcast_decide(bits, tallied, dval,
                                              st.committed, timer, reset,
                                              *(byz_decide or crash))

    # ---- Telemetry and flight recorder (KAA, the dense engine's; called
    # through its module, so that a stand-in put there sees the call).
    if telem is not None:
        pbft.pbft_telemetry(cfg, r, n_real, st.view, st.timer, view,
                            catch[0], down, pp_seen, st.prepared, prepared,
                            st.committed, tallied, committed, telem,
                            *(flight if flight is not None else (None, None)),
                            *((pbft.CRASH_VIEWS | pbft.CRASH_COMMITS,)
                              if crash else ()),
                            *(() if pbft.safety_mode(cfg) != BYZ_EQUIV else
                              ((0,) if not crash else ())
                              + ((pp_val, st.dval, dval),)))

    new = PbftState(st.seed, view, timer, pp_seen, pp_view, pp_val, prepared,
                    committed, dval, down)
    if flags is not None:
        pbft.freeze(flags, st, new)
    return new
