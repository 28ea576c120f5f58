"""Chained HotStuff in PyTorch: SPEC §7b, the linear-communication BFT
engine.

The port of ``consensus_tpu/engines/hotstuff.py`` on its flat path and
under the SPEC §A.2 delayed retransmission on the broadcast rows and the
votes, the SPEC §6c crash-recover adversary, the SPEC §B timer skew and
the SPEC §7c byzantine nodes, silent or equivocating, and the SPEC §9
switch with its §9b poisoned combines and uplink lies,
with its telemetry and flight recorder. Every
node keeps its own pacemaker (view, timer) and committed prefix; the QC
chain (b1, b2, b3), the certified-view map and
the global commit are per sweep. A round is three lane-wide steps in a
row: P1's highest-view gossip needs the highest view and the lowest id
holding it, P2's proposal the highest proposing view V* after P1, and the
QC of P3 the vote count at V*'s leader; P4's chain shift, P6's learning
and P7's pacemaker follow from the QC. Sweeps (lanes) are a leading batch
axis B on every tensor.

Five functions are wrappers of hand-written CUDA kernels, each beside its
plain PyTorch version (``<name>_plain``), which CPU tensors run:

* :func:`hotstuff_prologue` — kernel KAJ (``csrc/hotstuff_prologue.cu``),
  on a round with a §6c or §B gate on: the recovery reset, the timer skew
  and its premature timeouts, and P1's key over the nodes up (lane word
  KEY);
* :func:`hotstuff_propose` — kernel KAD (``csrc/hotstuff_propose.cu``):
  P0's churn and partition draws, P1's gossip and P2's proposers, whose
  highest view it reduces into the lane word VMAX;
* :func:`hotstuff_vote` — kernel KAE (``csrc/hotstuff_vote.cu``): P2's
  delivery, P3's vote count and, in each lane's last block, P4's chain
  shift, 3-chain commit and certified view;
* :func:`hotstuff_learn` — kernel KAF (``csrc/hotstuff_learn.cu``): P6's
  learning, P7's pacemaker, the next round's P1 extremes and, with
  telemetry, the round's HOTSTUFF_TELEMETRY counters and HOTSTUFF_LATENCY
  histograms;
* :func:`hotstuff_extract` — kernel KAG (``csrc/hotstuff_extract.cu``):
  the decided logs (``committed``, ``dval``) from the carry, once a run.

On the card a flat round is KAD, KAE and KAF and nothing else: no memset
and no PyTorch op. The lane-wide steps cross launches through ``lane``, a
[B, LANE_WORDS] int64 leaf the JAX carry does not have: P1's extremes of
the views at round entry, which KAF of the round before reduces
(:func:`p1_key`), and the kernels' accumulators, which each kernel leaves
at rest for the next (:func:`lane_at_rest`). ``chain_v`` and ``lane`` are
updated in place; every other tensor a round writes is fresh, so no block
reads what another block of its launch writes.

The gates break P1's key of the flat round: a §6c recovery resets a view
at round entry and a down node may not gossip, and a §B premature timeout
moves a view at round entry, after KAF built TOP. So a round of a run with
``crash_prob > 0`` or ``desync_rate > 0`` starts with KAJ (after kernel KAH,
``ops/adversary.py`` ``crash_transition``, where a crash is on), which
rebuilds the key over the nodes up into the KEY word, and KAD reads KEY: 4
launches a desync round, 5 a crash round. KAD, KAE and KAF have CRASH
instances, picked by the round's flag word: a down node neither hears the
gossip, proposes nor receives the proposal, and KAF counts every node's
round as the JAX round does, down nodes included, then writes a down node
its frozen view, timer and prefix (its input after the recovery reset,
without the skew).

Byzantine nodes (the ids from N - n_byzantine up, ``Config.byz``) are
fixed for a run, so P1's key at round entry is the key over the honest
nodes, which KAF's BYZ instances build into TOP (KAJ into KEY, over the
honest live ones): a byzantine round without a crash or a desync stays
three launches. Only honest receivers vote (KAE), and a silent node never
proposes (KAD). Under equivocation a byzantine leader shows each receiver
one of two variants; KAE counts each variant's votes in its own lane word
(VOTES, VOTES1), forms a QC where either reaches 2f + 1, writes
``chain_vid`` and, on a forked QC, the fork table in place, and names the
deceived receivers, whose fork bits KAF sets; with telemetry KAF counts
the §7c safety tail.

On a SPEC §9 switch round kernel KAL (``ops/aggregate.py`` ``agg_round``)
runs first (after KAH) and writes the round's aggregator table and
uplinks; KAE's SWITCH instance counts each supporter whose uplink and
whose aggregator's downlink to the leader are open, the leader's own
support locally, and under §9b each poisoned aggregator that reaches the
leader as its whole segment (the leader's local vote then dropped) and
each byzantine node's uplink lie as a vote: a switch round is four
launches (KAL, KAD, KAE, KAF).

In a knob batch (``network/runner.py`` ``run_knob_batch``, K23) the round
takes a :class:`~consensus_tpu_torch.core.knobs.KnobView` for ``cfg``: the
gates (``gated``, ``crash_on``, ``switch_on``, §9b's) are its base's, each
cutoff a [B, 1] column of the lane's own value for the plain versions, and
KAJ, KAD, KAE, KAL and KAH run their KNOBS instances, which read each
lane's row of the view's [B, 12] table.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import knobs, rng
from ..core.config import BYZ_EQUIV, BYZ_SILENT, Config
from ..ops.adversary import (AGG_TELEMETRY, CRASH_DOWN, CRASH_REC,
                             CRASH_TELEMETRY, SAFETY_TELEMETRY, bitcast_i32,
                             crash_step, equiv_stance_plain, open_drop_plain,
                             safety_counts_plain)
from ..ops.aggregate import (AGG_POISON0, agg_downlink_plain, agg_ids,
                             agg_step, switch_tables, uplink_lies_plain)
from ..ops.flight import (add_plain, bucket_counts_plain, check_recorder,
                          window_of)
from ..ops.viewsync import SYNC_TELEMETRY, desync_skew_plain, sync_counts_plain
from .raft import check_all

# The engine's name, as the JAX package's EngineDef names it.
NAME = "hotstuff"

# SPEC §7c fork-certificate table depth (consensus_tpu/engines/hotstuff.py
# FORK_TABLE, line 87): flat runs record no fork, but the carry and the
# extraction keep the table.
FORK_TABLE = 8

# The engine's telemetry counters, in order: a copy of
# consensus_tpu/engines/hotstuff.py HOTSTUFF_TELEMETRY (lines 158-169):
# rounds forming a QC, the global commit's advance, the per-node committed
# prefixes' advance, per-node timeout view changes, proposal receivers,
# votes the leader counted; then the crash tail (kernel KAH's), the
# aggregation tail (kernel KAL's, on a §9 switch round), the SPEC §7c
# safety tail (counted under
# equivocation) and the SPEC §B view-sync tail.
HOTSTUFF_TELEMETRY = ("qc_formed", "blocks_committed", "commits_learned",
                      "view_changes", "proposals_delivered",
                      "votes_counted") + CRASH_TELEMETRY + AGG_TELEMETRY \
    + SAFETY_TELEMETRY + SYNC_TELEMETRY
# The flight recorder's latency histograms (engines/hotstuff.py
# HOTSTUFF_LATENCY, line 180): timer + 1 at each node whose view advanced,
# and one observation a round of the pipeline depth b1_h + 1 - gcommit.
HOTSTUFF_LATENCY = ("view_change_wait_rounds", "chain_commit_lag_rounds")

# The words of ``lane``, a lane's int64 words between launches, and what
# each holds between rounds ("at rest"; csrc/hotstuff.cuh says who writes
# each):
TOP = 0         # P1's key of the views at round entry (see p1_key); on a
#                 crash run the key of the nodes up, read for the spread
#                 only
VMAX = 1        # KAD's max of the proposers' views; at rest -1
VOTES = 2       # KAE's vote count; at rest 0
DONE_VOTE = 3   # KAE's finished blocks; at rest 0
VSTAR = 4       # the round's V*, which KAE's last block writes for KAF
COUNTED = 5     # the round's vote count, likewise
VMIN = 6        # KAF's min of the end-of-round views; at rest I64_MAX
DONE_LEARN = 7  # KAF's finished blocks (with telemetry); at rest 0
KEY = 8         # KAJ's P1 key over the nodes up on a gated round, which
#                 KAD then reads; at rest KEY_REST
VOTES1 = 9      # KAE's vote count for variant 1 (SPEC §7c); at rest 0
QCF = 10        # the round's QC (bit 0) and forked QC (bit 1) under
#                 equivocation, which KAE's last block writes for KAF
FBIT = 11       # the fork bit a deceived node takes, likewise (0: none)
CONF = 12       # KAF's count of conflicting commits (telemetry); at rest 0
LANE_WORDS = 13
KEY_REST = -1   # reads as vM = -1, M = N: no gossip
I64_MIN = -2**63
I64_MAX = 2**63 - 1
# The JAX carry's leaves, in its order (consensus_tpu/engines/hotstuff.py
# HotstuffState, lines 90-108).
JAX_LEAVES = ("seed", "b1_v", "b1_h", "b2_v", "b2_h", "b3_v", "b3_h",
              "gcommit", "chain_v", "chain_vid", "fvec", "ftab_v", "ftab_h",
              "fnum", "view", "timer", "clen", "down")


class HotstuffState(NamedTuple):
    seed: torch.Tensor       # [B] uint32
    b1_v: torch.Tensor       # [B] i32: newest QC's view (-1 = none)
    b1_h: torch.Tensor       # [B] i32: newest QC's height (-1 = none)
    b2_v: torch.Tensor       # [B] i32: parent QC (the locked block)
    b2_h: torch.Tensor       # [B] i32
    b3_v: torch.Tensor       # [B] i32: grandparent QC
    b3_h: torch.Tensor       # [B] i32
    gcommit: torch.Tensor    # [B] i32: globally committed chain length
    chain_v: torch.Tensor    # [B, S] i32: view certifying height s (-1)
    chain_vid: torch.Tensor  # [B, S] i32: §7c value-id at height s
    fvec: torch.Tensor       # [B, N] i32: §7c fork bits (0 here)
    ftab_v: torch.Tensor     # [B, FORK_TABLE] i32: fork entry view
    ftab_h: torch.Tensor     # [B, FORK_TABLE] i32: fork entry height
    fnum: torch.Tensor       # [B] i32: fork entries recorded
    view: torch.Tensor       # [B, N] i32: node i's own pacemaker view
    timer: torch.Tensor      # [B, N] i32: rounds since i saw progress
    clen: torch.Tensor       # [B, N] i32: committed length i learned
    down: torch.Tensor       # [B, N] bool (SPEC §6c; all False here)
    lane: torch.Tensor       # [B, LANE_WORDS] int64: the port's own


def _wrap(x) -> torch.Tensor:
    """Integer values wrapped to int32, as int32 arithmetic wraps."""
    return bitcast_i32(rng.as_u32(x))


def _keys(view) -> torch.Tensor:
    """[B, N] int64: each node's ``(view << 32) | (N - 1 - id)``."""
    N = view.shape[1]
    low = N - 1 - torch.arange(N, dtype=torch.int64, device=view.device)
    return (view.to(torch.int64) << 32) | low


def p1_key(view, up=None) -> torch.Tensor:
    """[B] int64: the largest ``(view << 32) | (N - 1 - id)`` over a lane's
    nodes ([B, N] int32 ``view``), whose high word is the highest view and
    low word N - 1 minus the lowest id holding it: P1's gossiper (lines
    266-268 of the JAX round, every node honest and live). With ``up`` ([B,
    N] bool), over those nodes only (the honest live ones) and at least
    KEY_REST: the KEY word kernel KAJ builds, whose high word is the JAX
    round's vM where that is >= 0 (the only case in which P1 reads it)
    and -1 else."""
    if up is None:
        return _keys(view).amax(1)
    return torch.where(up, _keys(view), KEY_REST).amax(1)


def gossiper(key, N: int) -> tuple[torch.Tensor, torch.Tensor]:
    """P1's (vM, M), [B] int32 and int64, of the [B] int64 keys ``key``
    (:func:`p1_key`) of lanes of N nodes, as kernel KAD decodes them: M is
    N - 1 minus the low word read as int32, so that KEY_REST gives M = N."""
    low = key & 0xFFFFFFFF
    return ((key >> 32).to(torch.int32),
            N - 1 - torch.where(low >= 2**31, low - 2**32, low))


def lane_at_rest(view, n_honest: int | None = None) -> torch.Tensor:
    """The ``lane`` words of a state whose views are ``view`` ([B, N]
    int32), at a round's start: P1's key over the honest nodes (ids below
    ``n_honest``, by default every node; SPEC §3c/§7c, the JAX round's
    ``alive_h``, line 266), as kernel KAF builds TOP, and every
    accumulator at rest."""
    N = view.shape[1]
    lane = torch.zeros((view.shape[0], LANE_WORDS), dtype=torch.int64,
                       device=view.device)
    if n_honest is None or n_honest >= N:
        lane[:, TOP] = p1_key(view)
    else:
        honest = torch.arange(N, device=view.device) < n_honest
        lane[:, TOP] = torch.where(honest, _keys(view), I64_MIN).amax(1)
    lane[:, VMAX] = -1
    lane[:, VSTAR] = -1
    lane[:, VMIN] = I64_MAX
    lane[:, KEY] = KEY_REST
    return lane


def gated(cfg: Config) -> bool:
    """Whether a round of ``cfg`` runs KAJ first and reads P1's key off KEY:
    a SPEC §6c crash or a SPEC §B skew is on."""
    return cfg.crash_on or cfg.desync_on


def _open_from(cfg: Config, seed, r: int, src, N: int) -> torch.Tensor:
    """[B, N] bool: SPEC §2 openness of the round's broadcast row from the
    [B] node ids ``src`` to every node, on absolute edge keys: the
    delivery mixer's draw of (src, j) is not below the drop cutoff, or a
    flight lost on (src, j) in one of the last ``max_delay_rounds`` rounds
    arrives now (SPEC §A.2), and, in a round whose partition is active, j
    drew src's side (the JAX round's ``_bcast_open``, lines 243-256). Rows
    from one sender draw the same words, whichever phase sends them."""
    useed = rng.as_u32(seed)[:, None]
    j = torch.arange(N, dtype=torch.int64, device=seed.device)
    s = src.to(torch.int64)[:, None]
    ok = open_drop_plain(useed, r, s, j, cfg.drop_cutoff,
                         cfg.max_delay_rounds)
    part = rng.random_u32_plain(seed, rng.STREAM_PARTITION, r, 0, 0) \
        < cfg.partition_cutoff                                   # [B, 1]
    side = rng.threefry2x32_plain(useed ^ rng.STREAM_PARTITION, r, 1, j) & 1
    side_s = rng.threefry2x32_plain(useed ^ rng.STREAM_PARTITION, r, 1, s) & 1
    return ok & ((side == side_s) | ~part)


# --- KAJ: the gated prologue ---------------------------------------------------

def hotstuff_prologue_plain(cfg: Config, seed, r: int, view, timer, lane,
                            flags=None, t=None, w=None):
    """Plain version of KAJ, the JAX round's lines 207-230 and 266-268 on
    a round with a SPEC §6c crash (``flags``, the round's [B, N] uint8 flag
    word of kernel KAH) or a SPEC §B skew (``cfg.desync_on``) on: a node
    that recovered this round rejoins at view 0 and timer 0; then its timer
    takes its skew (:func:`~consensus_tpu_torch.ops.viewsync.
    desync_skew_plain`), and where that reaches ``view_timeout`` the node
    moves to the next view with timer 0. Every node runs it, down nodes
    too. ``lane[:, KEY]`` takes the max with :func:`p1_key` of the new
    views over the honest nodes not down (in place; SPEC §3c/§7c: ids
    below N - n_byzantine). With the totals ``t`` ([B,
    K] int32) and the window ring ``w``, the premature timeouts are added
    into view_changes (of window ``r // cfg.telemetry_window``). Returns
    (view, timer), fresh [B, N] int32."""
    N = view.shape[1]
    if flags is not None:
        rec = (flags & CRASH_REC) != 0
        view = torch.where(rec, 0, view)
        timer = torch.where(rec, 0, timer)
    if cfg.desync_on:
        ids = torch.arange(N, dtype=torch.int64, device=view.device)
        timer = _wrap(timer.to(torch.int64) + desync_skew_plain(
            seed, r, ids, cfg.desync_cutoff, cfg.max_skew_rounds))
        pre = timer >= cfg.view_timeout
        view = _wrap(view.to(torch.int64) + pre.to(torch.int64))
        timer = torch.where(pre, 0, timer)
        if t is not None:
            col = HOTSTUFF_TELEMETRY.index("view_changes")
            n = pre.sum(1, dtype=torch.int32)
            t[:, col] += n
            if w is not None:
                w[:, r // cfg.telemetry_window, col] += n
    up = torch.ones_like(view, dtype=torch.bool) if flags is None \
        else (flags & CRASH_DOWN) == 0
    up = up & (torch.arange(N, device=view.device) < cfg.n_honest)
    lane[:, KEY] = torch.maximum(lane[:, KEY], p1_key(view, up))
    return view, timer


def hotstuff_prologue(cfg: Config, seed, r: int, view, timer, lane,
                      flags=None, t=None, w=None):
    """Kernel KAJ: same arguments, results and in-place updates as
    :func:`hotstuff_prologue_plain`, which it runs for CPU tensors; for
    CUDA tensors it launches ``csrc/hotstuff_prologue.cu`` (a thread per
    (lane, node); the key by warp shuffles and one atomic a block; its
    DESYNC instance with ``cfg.desync_on``, its CRASH instance with
    ``flags``, its KNOBS instances with a knob batch's view: each lane's
    desync cutoff from the view's table). Raises unless a gate is on."""
    if flags is None and not cfg.desync_on:
        raise ValueError("the prologue runs on gated rounds only: a crash "
                         "(flags) or a desync")
    if t is None and w is not None:
        raise ValueError("the flight recorder rides the telemetry "
                         "accumulator: pass t with w")
    if view.device.type == "cpu":
        return hotstuff_prologue_plain(cfg, seed, r, view, timer, lane,
                                       flags, t, w)
    from .. import _build
    B, N = view.shape
    dev = view.device
    view, timer = view.contiguous(), timer.contiguous()
    K = len(HOTSTUFF_TELEMETRY)
    check_all(dev, (seed, torch.uint32, (B,)),
              *((x, torch.int32, (B, N)) for x in (view, timer)),
              (lane, torch.int64, (B, LANE_WORDS)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)),
              *(() if t is None else ((t, torch.int32, (B, K)),)))
    window = n_windows = 0
    if w is not None:
        n_windows = w.shape[1]
        window = r // cfg.telemetry_window
        check_all(dev, (w, torch.int32, (B, n_windows, K)))
    out = torch.empty((2, B, N), dtype=torch.int32, device=dev)
    base, table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("hotstuff_prologue", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  view.data_ptr(), timer.data_ptr(),
                  None if flags is None else flags.data_ptr(),
                  lane.data_ptr(), out.data_ptr(),
                  *(None if x is None else x.data_ptr() for x in (t, w)),
                  base.desync_cutoff, cfg.max_skew_rounds, cfg.view_timeout,
                  B, N, K, HOTSTUFF_TELEMETRY.index("view_changes"), window,
                  n_windows, cfg.n_byzantine, table)
    hotstuff_prologue.launches += 1
    hotstuff_prologue.knob_launches += table is not None
    return tuple(out.unbind(0))


hotstuff_prologue.launches = 0
# Launches of its KNOBS instance (a knob batch), also counted in
# ``launches``.
hotstuff_prologue.knob_launches = 0


# --- KAD: P0-P2 ----------------------------------------------------------------

def hotstuff_propose_plain(cfg: Config, seed, r: int, view, b1_h, lane,
                           flags=None):
    """Plain version of KAD, the JAX round's lines 232-299. P1: the
    gossiper M and its view vM are read off ``lane[:, TOP]`` (``lane[:,
    KEY]`` where :func:`gated`); a node j != M whose row from M is open
    (:func:`_open_from`) and whose view is below vM >= 0 catches up to vM.
    With the round's SPEC §6c ``flags``, a node down at the round's end
    neither catches up nor proposes (lines 271-272, 294). P2: node i proposes
    when its view after P1 elects it (view mod N == i, floor modulo),
    the round's churn event does not fire and the log has room (b1_h + 1
    < S); a silent byzantine node never proposes (SPEC §7c, line 292-293;
    an equivocating one does). The largest proposing view above -1 is
    merged into ``lane[:, VMAX]`` (in place). Returns (view after P1 [B,
    N] int32, P1's catch-up flags ``adv`` [B, N] bool)."""
    N, S = view.shape[1], cfg.log_capacity
    idx = torch.arange(N, dtype=torch.int64, device=view.device)
    vM, M = gossiper(lane[:, KEY if gated(cfg) else TOP], N)
    vM, M = vM[:, None], M[:, None]
    gdel = (vM >= 0) & (idx != M) & _open_from(cfg, seed, r,
                                                M[:, 0].clamp(0, N - 1), N)
    up = torch.ones_like(gdel) if flags is None else (flags & CRASH_DOWN) == 0
    adv = gdel & (view < vM) & up
    view1 = torch.where(adv, vM, view)
    churn = rng.random_u32_plain(seed, rng.STREAM_CHURN, r, 0, 0) \
        < cfg.churn_cutoff                                       # [B, 1]
    prop = (view1 % N == idx) & ~churn & up & (
        _wrap(b1_h.to(torch.int64) + 1) < S)[:, None]
    if cfg.byz == BYZ_SILENT:
        prop = prop & (idx < cfg.n_honest)
    cand = torch.where(prop, view1, -1).amax(1).to(torch.int64)
    lane[:, VMAX] = torch.where(cand > -1,
                                torch.maximum(lane[:, VMAX], cand),
                                lane[:, VMAX])
    return view1, adv


def hotstuff_propose(cfg: Config, seed, r: int, view, b1_h, lane,
                     flags=None):
    """Kernel KAD: same arguments, result and in-place update as
    :func:`hotstuff_propose_plain`, which it runs for CPU tensors; for
    CUDA tensors it launches ``csrc/hotstuff_propose.cu`` (a thread per
    (lane, node); a warp's largest proposing view goes into VMAX with one
    atomic; its CRASH instance with ``flags``, its BYZ instance with
    silent byzantine nodes, its KNOBS instances with a knob batch's view:
    each lane's drop, partition and churn cutoffs from the view's
    table)."""
    if view.device.type == "cpu":
        return hotstuff_propose_plain(cfg, seed, r, view, b1_h, lane, flags)
    from .. import _build
    B, N = view.shape
    dev = view.device
    view, b1_h = view.contiguous(), b1_h.contiguous()
    check_all(dev, (seed, torch.uint32, (B,)), (view, torch.int32, (B, N)),
              (b1_h, torch.int32, (B,)),
              (lane, torch.int64, (B, LANE_WORDS)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)))
    view1 = torch.empty((B, N), dtype=torch.int32, device=dev)
    adv = torch.empty((B, N), dtype=torch.bool, device=dev)
    base, table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("hotstuff_propose", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  view.data_ptr(), b1_h.data_ptr(), lane.data_ptr(),
                  view1.data_ptr(), adv.data_ptr(),
                  None if flags is None else flags.data_ptr(),
                  base.drop_cutoff, base.partition_cutoff, base.churn_cutoff,
                  cfg.max_delay_rounds, KEY if gated(cfg) else TOP, B, N,
                  cfg.log_capacity, cfg.byz, cfg.n_byzantine, table)
    hotstuff_propose.launches += 1
    hotstuff_propose.knob_launches += table is not None
    return view1, adv


hotstuff_propose.launches = 0
# Launches of its KNOBS instance (a knob batch), also counted in
# ``launches``.
hotstuff_propose.knob_launches = 0


# --- KAE: P2's delivery, P3, P4 ------------------------------------------------

def hotstuff_vote_plain(cfg: Config, seed, r: int, view1, lane, b1_v, b1_h,
                        b2_v, b2_h, b3_v, b3_h, gcommit, chain_v, flags=None,
                        fork=None, agg=None):
    """Plain version of KAE, the JAX round's lines 300-454. V* is
    ``lane[:, VMAX]``; when V* >= 0 its leader L = V* mod N broadcasts,
    else L = 0 and nobody hears a proposal.
    Node j receives it (``pdel``) when j == L or L's row to j is open, and
    its view after P1 is not above V*; a receiver's vote reaches L when j ==
    L or the mixer's draw of edge (j, L) is not below the drop cutoff or a
    vote lost on (j, L) in one of the last ``max_delay_rounds`` rounds
    arrives now (SPEC §A.2, the JAX round's lines 303-309). The QC forms
    when the lane's votes, added to ``lane[:, VOTES]``, reach Q = 2f + 1;
    then b1, b2, b3 shift, ``chain_v[h_next]`` takes V* (in place), and with
    three consecutive views the global commit becomes max(gcommit, b3_h + 1)
    of the NEW b3. With the round's SPEC §6c ``flags``, a node down at the
    round's end receives nothing (line 312). ``lane`` leaves at rest (in
    place): VSTAR and COUNTED hold the round's V* and vote count for KAF,
    TOP is emptied for KAF's reduction, KEY is at rest. Returns (pdel [B, N]
    bool, then b1_v, b1_h, b2_v, b2_h, b3_v, b3_h, gcommit after P4, fresh
    [B] int32).

    With byzantine nodes (SPEC §3c/§7c, ``cfg.byz``; ids N - n_byzantine
    and up) only honest receivers vote, in both modes (line 326). Under
    equivocation (``BYZ_EQUIV``, with ``fork`` = (chain_vid [B, S],
    ftab_v, ftab_h [B, FORK_TABLE], fnum [B]), all int32 and updated in
    place) a byzantine leader L shows receiver j the variant of its stance
    toward j (:func:`~consensus_tpu_torch.ops.adversary.
    equiv_stance_plain`; an honest leader shows variant 0), an honest
    receiver votes for the variant it was shown and a byzantine one for
    both; each variant's count (``lane[:, VOTES]`` and ``lane[:,
    VOTES1]``) needs its own quorum (lines 334-421). A QC of either
    variant shifts the chain; ``chain_vid[h_next]`` takes the certified
    variant (0 where variant 0 has a quorum); a forked QC (both) takes the
    next free row of the fork table (lines 436-453). ``lane[:, COUNTED]``
    is then both counts' sum, ``lane[:, QCF]`` the QC (bit 0) and the fork
    (bit 1), ``lane[:, FBIT]`` the fork bit that KAF sets in the
    deceived nodes' ``fvec`` (0 without a new table row), and the round
    also returns ``deceived`` ([B, N] bool): the honest receivers shown
    variant 1.

    On a SPEC §9 switch round (``agg``, kernel KAL's tables) the votes
    travel over the switch (lines 340-392): a supporter j != L counts where
    its phase-0 uplink and its aggregator's downlink to L are open, and L
    counts its own support locally. Under §9b a poisoned aggregator whose
    downlink to L is open counts one for each member of its segment
    instead (the leader too, whose local vote then drops), and a byzantine
    node's uplink lie is a claimed vote that needs no proposal; under
    equivocation a byzantine receiver's vote and a lie count for both
    variants. Summed per sender, this is the JAX round's self vote plus its
    delivered segment sums."""
    N, S, Q = view1.shape[1], cfg.log_capacity, 2 * cfg.f + 1
    dev = view1.device
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    vstar = lane[:, VMAX].to(torch.int32)
    exists = vstar >= 0
    L = torch.where(exists, vstar % N, 0).to(torch.int64)
    is_l = idx == L[:, None]
    useed = rng.as_u32(seed)[:, None]
    open_p = _open_from(cfg, seed, r, L, N)
    open_v = open_drop_plain(useed, r, idx, L[:, None], cfg.drop_cutoff,
                             cfg.max_delay_rounds)
    pdel = exists[:, None] & (is_l | open_p) & (view1 <= vstar[:, None])
    if flags is not None:
        pdel &= (flags & CRASH_DOWN) == 0
    back = is_l | open_v
    vote = pdel if not cfg.byz else pdel & (idx < cfg.n_honest)
    counted = (lambda sup, self_sup: (sup & back).sum(1))
    lie = torch.zeros_like(pdel)
    if agg is not None:
        counted, lie = _switch_count(cfg, seed, r, agg, L, is_l)
    if cfg.byz == BYZ_EQUIV:
        byz_l = exists & (L >= cfg.n_honest)
        evid = byz_l[:, None] & equiv_stance_plain(seed, r, L[:, None],
                                                   idx[None, :])
        claim = (pdel & (idx >= cfg.n_honest)) | lie
        sup0, sup1 = (vote & ~evid) | claim, (vote & evid) | claim
        cnt0 = lane[:, VOTES] + counted(sup0, sup0)
        cnt1 = lane[:, VOTES1] + counted(sup1, sup1)
        qc0, qc1 = exists & (cnt0 >= Q), exists & (cnt1 >= Q)
        qc, forked = qc0 | qc1, qc0 & qc1
        cnt = cnt0 + cnt1
    else:
        cnt = lane[:, VOTES] + counted(vote | lie, vote)
        qc = exists & (cnt >= Q)
    h_next = _wrap(b1_h.to(torch.int64) + 1)
    nb1_v, nb1_h = torch.where(qc, vstar, b1_v), torch.where(qc, h_next, b1_h)
    nb2_v, nb2_h = torch.where(qc, b1_v, b2_v), torch.where(qc, b1_h, b2_h)
    nb3_v, nb3_h = torch.where(qc, b2_v, b3_v), torch.where(qc, b2_h, b3_h)
    hot = (torch.arange(S, dtype=torch.int32, device=dev) == h_next[:, None]) \
        & qc[:, None]
    chain_v.copy_(torch.where(hot, vstar[:, None], chain_v))
    consec = (nb3_v >= 0) & (nb1_v == _wrap(nb2_v.to(torch.int64) + 1)) \
        & (nb2_v == _wrap(nb3_v.to(torch.int64) + 1))
    ngc = torch.where(qc & consec, torch.maximum(
        gcommit, _wrap(nb3_h.to(torch.int64) + 1)), gcommit)
    lane[:, VSTAR] = vstar.to(torch.int64)
    lane[:, COUNTED] = cnt
    lane[:, VMAX] = -1
    lane[:, VOTES] = 0
    lane[:, DONE_VOTE] = 0
    lane[:, TOP] = I64_MIN
    lane[:, KEY] = KEY_REST
    out = (pdel, nb1_v, nb1_h, nb2_v, nb2_h, nb3_v, nb3_h, ngc)
    if cfg.byz != BYZ_EQUIV:
        return out
    chain_vid, ftab_v, ftab_h, fnum = fork
    chain_vid.copy_(torch.where(hot, torch.where(qc0, 0, 1)[:, None],
                                chain_vid))
    can = forked & (fnum < FORK_TABLE)
    row = (torch.arange(FORK_TABLE, device=dev) == fnum[:, None]) \
        & can[:, None]
    ftab_v.copy_(torch.where(row, vstar[:, None], ftab_v))
    ftab_h.copy_(torch.where(row, h_next[:, None], ftab_h))
    fbit = torch.where(can, 1 << fnum.clamp(max=FORK_TABLE - 1), 0)
    fnum.copy_(fnum + can.to(torch.int32))
    lane[:, VOTES1] = 0
    lane[:, QCF] = qc.to(torch.int64) | (forked.to(torch.int64) << 1)
    lane[:, FBIT] = fbit.to(torch.int64)
    return (*out, vote & evid)


def _switch_count(cfg: Config, seed, r: int, agg, L, is_l):
    """The SPEC §9/§9b vote count of a switch round (the JAX round's lines
    340-392) as a sum over senders: ``(counted, lie)``, where
    ``counted(sup, self_sup)`` is [B] int64, the count of the [B, N]
    supporters ``sup`` with the leader's local support read off
    ``self_sup`` at L, and ``lie`` the round's uplink lies ([B, N] bool)."""
    N, K = cfg.n_nodes, cfg.n_aggregators
    B, dev = seed.shape[0], seed.device
    sids = agg_ids(N, K, dev)
    ak = torch.arange(K, device=dev)[None, :].expand(B, K)
    d0 = agg_downlink_plain(cfg, seed, r, agg.tab, 0, ak,
                            L[:, None].expand(B, K))            # [B, K]
    pz = ((agg.tab & AGG_POISON0) != 0) & d0                    # delivered
    d0j, pzj = d0[:, sids], pz[:, sids]                         # [B, N]
    up0 = agg.up[:, 0]
    lie, _ = uplink_lies_plain(cfg, seed, r,
                               torch.arange(N, device=dev) >= cfg.n_honest)
    if lie is None:
        lie = torch.zeros_like(up0)

    def counted(sup, self_sup):
        pred = torch.where(is_l, pzj | self_sup,
                           pzj | (sup & up0 & d0j))
        return pred.sum(1)
    return counted, lie


def hotstuff_vote(cfg: Config, seed, r: int, view1, lane, b1_v, b1_h, b2_v,
                  b2_h, b3_v, b3_h, gcommit, chain_v, flags=None, fork=None,
                  agg=None):
    """Kernel KAE: same arguments, results and in-place updates as
    :func:`hotstuff_vote_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/hotstuff_vote.cu`` (a thread per (lane,
    node); votes counted by a ballot a warp, a shared atomic a warp and a
    global one a block; the lane's last block does P4; its CRASH instance
    with ``flags``, its BYZ instances with byzantine nodes: under
    equivocation two ballots a warp, and the last block also writes
    ``fork``'s rows; its SWITCH instances with ``agg``, where each voter
    draws its aggregator's downlink to L and, under §9b, its lie; its
    KNOBS instances with a knob batch's view: each lane's drop, partition
    and lie cutoffs from the view's table)."""
    if (cfg.byz == BYZ_EQUIV) != (fork is not None):
        raise ValueError("pass fork (chain_vid, ftab_v, ftab_h, fnum) "
                         "exactly under byzantine equivocation")
    if view1.device.type == "cpu":
        return hotstuff_vote_plain(cfg, seed, r, view1, lane, b1_v, b1_h,
                                   b2_v, b2_h, b3_v, b3_h, gcommit, chain_v,
                                   flags, fork, agg)
    from .. import _build
    B, N = view1.shape
    S = cfg.log_capacity
    dev = view1.device
    view1 = view1.contiguous()
    regs = [x.contiguous() for x in (b1_v, b1_h, b2_v, b2_h, b3_v, b3_h,
                                     gcommit)]
    check_all(dev, (seed, torch.uint32, (B,)), (view1, torch.int32, (B, N)),
              (lane, torch.int64, (B, LANE_WORDS)),
              *((x, torch.int32, (B,)) for x in regs),
              (chain_v, torch.int32, (B, S)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)),
              *(() if fork is None else (
                  (fork[0], torch.int32, (B, S)),
                  *((x, torch.int32, (B, FORK_TABLE)) for x in fork[1:3]),
                  (fork[3], torch.int32, (B,)))),
              *(() if agg is None else (
                  (agg.up, torch.bool, (B, 1, N)),
                  (agg.tab, torch.int32, (B, cfg.n_aggregators)))))
    pdel = torch.empty((B, N), dtype=torch.bool, device=dev)
    new = torch.empty((7, B), dtype=torch.int32, device=dev)
    deceived = None if fork is None else torch.empty_like(pdel)
    base, table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("hotstuff_vote", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  view1.data_ptr(), lane.data_ptr(),
                  *(x.data_ptr() for x in regs), chain_v.data_ptr(),
                  pdel.data_ptr(), new.data_ptr(),
                  None if flags is None else flags.data_ptr(),
                  base.drop_cutoff, base.partition_cutoff,
                  cfg.max_delay_rounds, 2 * cfg.f + 1, B, N, S, cfg.byz,
                  cfg.n_byzantine,
                  *(None if x is None else x.data_ptr() for x in (
                      (*fork, deceived) if fork is not None else (None,) * 5)),
                  *switch_tables(agg),
                  base.byz_uplink_cutoff if base.uplink_lies_on else 0, table)
    hotstuff_vote.launches += 1
    hotstuff_vote.switch_launches += agg is not None
    hotstuff_vote.knob_launches += table is not None
    out = (pdel, *new.unbind(0))
    return out if deceived is None else (*out, deceived)


hotstuff_vote.launches = 0
# Launches of its SWITCH instances (SPEC §9) and of its KNOBS instances (a
# knob batch), each also counted in ``launches``.
hotstuff_vote.switch_launches = 0
hotstuff_vote.knob_launches = 0


# --- KAF: P6, P7 and the telemetry tail ----------------------------------------

def hotstuff_learn_plain(cfg: Config, r: int, view1, pdel, adv, timer, clen,
                         lane, gcommit, b1_h_new, gcommit_new, t=None,
                         w=None, lat=None, crash=None, fork=None):
    """Plain version of KAF, the JAX round's lines 456-480 and, with the
    accumulator ``t`` ([B, K] int32), its telemetry tail (lines 485-519;
    the aggregation tail is kernel KAL's). With the round's V* and vote
    count from ``lane`` (the QC forms when V* >= 0 and the count reaches 2f
    + 1): a receiver enters V* + 1 on a QC, else V*, and grows its committed
    prefix to the OLD ``gcommit`` (the commit as of proposal time); a node
    with neither a proposal nor a catch-up whose timer + 1 reaches
    view_timeout moves to the next view, and the timer restarts on progress
    or timeout. ``lane[:, TOP]`` takes the max with :func:`p1_key` of the
    new views (in place). With ``t``, the round's counters are added into
    ``t`` and, with the flight recorder (``w`` [B, n_windows, K] and ``lat``
    [B, 2, N_BUCKETS], both or neither), into window ``r //
    cfg.telemetry_window`` of ``w``, and the two histograms into ``lat``:
    the blocks committed are ``gcommit_new - gcommit``, the pipeline depth
    ``b1_h_new + 1 - gcommit_new``. With ``crash`` = (flags, view_in,
    timer_in), the round's SPEC §6c flag word and its input view and timer
    ([B, N]), every node's round is counted as above, down nodes included,
    and then a node down at the round's end takes its frozen view and timer:
    its input's, 0 where it recovered this round (lines 473-480); ``lane[:,
    TOP]`` and the view spread take the nodes up only (line 504). Returns
    (view, timer, clen), fresh [B, N] int32.

    With byzantine nodes (SPEC §3c/§7c, ``cfg.byz``) ``lane[:, TOP]`` and
    the view spread take the honest nodes only (ids below N -
    n_byzantine; lines 266, 504), in both modes. Under equivocation
    (``BYZ_EQUIV``, with ``fork`` = (deceived [B, N] bool from KAE, fvec
    [B, N], ftab_h [B, FORK_TABLE], fnum [B], the last three after KAE's
    update)) the QC is ``lane[:, QCF]``'s bit 0; each deceived node's
    ``fvec`` takes ``lane[:, FBIT]`` (in place; line 451); with ``t`` the
    safety tail counts the forked QC (bit 1) and conflict_commits, the
    nodes whose committed prefix crossed a recorded fork height this
    round with that fork's bit set (lines 494-502), and
    safety_violations."""
    check_recorder(cfg, w, lat)
    Q = 2 * cfg.f + 1
    vstar = lane[:, VSTAR].to(torch.int32)
    cnt = lane[:, COUNTED]
    qc = (vstar >= 0) & (cnt >= Q)
    if cfg.byz == BYZ_EQUIV:
        qc = (lane[:, QCF] & 1) != 0
    vnext = torch.where(qc, _wrap(vstar.to(torch.int64) + 1), vstar)
    view2 = torch.where(pdel, vnext[:, None], view1)
    clen2 = torch.where(pdel, torch.maximum(clen, gcommit[:, None]), clen)
    progress = pdel | adv
    tick = _wrap(timer.to(torch.int64) + 1)
    to = ~progress & (tick >= cfg.view_timeout)
    view3 = _wrap(view2.to(torch.int64) + to.to(torch.int64))
    timer2 = torch.where(progress | to, 0, tick)
    up = torch.ones_like(pdel)
    out = (view3, timer2, clen2)
    if crash is not None:
        flags, view_in, timer_in = crash
        up = (flags & CRASH_DOWN) == 0
        rec = (flags & CRASH_REC) != 0
        out = (torch.where(up, view3, torch.where(rec, 0, view_in)),
               torch.where(up, timer2, torch.where(rec, 0, timer_in)), clen2)
    honest = up
    if cfg.byz:
        N = view1.shape[1]
        honest = up & (torch.arange(N, device=up.device) < cfg.n_honest)
    lane[:, TOP] = torch.maximum(
        lane[:, TOP], torch.where(honest, _keys(view3), I64_MIN).amax(1))
    conf = None
    if cfg.byz == BYZ_EQUIV:
        deceived, fvec, ftab_h, fnum = fork
        fvec.copy_(torch.where(deceived, fvec | lane[:, FBIT:FBIT + 1].to(
            torch.int32), fvec))
        k = torch.arange(FORK_TABLE, device=fvec.device)
        hh = ftab_h[:, None, :]                                  # [B, 1, F]
        inw = ((k < fnum[:, None])[:, None, :] & (hh >= clen[..., None])
               & (hh < out[2][..., None]))
        conf = ((((fvec[..., None] >> k) & 1) != 0) & inw).sum(
            (1, 2), dtype=torch.int32)
    if t is None:
        return out
    B = view1.shape[0]
    sync = sync_counts_plain(view3, honest, adv)
    vec = torch.zeros_like(t)
    vec[:, :6] = torch.stack([
        qc.to(torch.int32), _wrap(gcommit_new.to(torch.int64) - gcommit),
        _wrap((clen2.to(torch.int64) - clen).sum(1)),
        to.sum(1, dtype=torch.int32), pdel.sum(1, dtype=torch.int32),
        _wrap(cnt)], 1)
    vec[:, -len(SYNC_TELEMETRY):] = sync
    if conf is not None:
        col = HOTSTUFF_TELEMETRY.index("forked_qc")
        vec[:, col:col + 3] = safety_counts_plain(
            (lane[:, QCF] >> 1) & 1, conf)
    hists = ()
    if w is not None:
        advn = (pdel & qc[:, None]) | adv | to
        lag = _wrap(b1_h_new.to(torch.int64) + 1 - gcommit_new)[:, None]
        hists = (bucket_counts_plain(tick, advn),
                 bucket_counts_plain(lag, torch.ones((B, 1), dtype=torch.bool,
                                                     device=lag.device)))
    add_plain(cfg, r, vec, t, w, lat, hists)
    return out


def hotstuff_learn(cfg: Config, r: int, view1, pdel, adv, timer, clen, lane,
                   gcommit, b1_h_new, gcommit_new, t=None, w=None,
                   lat=None, crash=None, fork=None):
    """Kernel KAF: same arguments, results and in-place updates as
    :func:`hotstuff_learn_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/hotstuff_learn.cu`` (a thread per (lane,
    node); the next round's P1 key by warp shuffles and one atomic a
    block; with telemetry, counters by warp sums and one atomic a block
    and counter, and the lane's last block adds the lane's counters, the
    view spread and the pipeline depth). Without ``t`` the kernel gets
    null accumulator pointers and does no telemetry work; its CRASH
    instance with ``crash``, its BYZ instances with byzantine nodes: under
    equivocation it also sets the deceived nodes' fork bits and, with
    telemetry, counts the safety tail, the conflicts into the CONF word
    and the lane's last block the rest)."""
    check_recorder(cfg, w, lat)
    if t is None and w is not None:
        raise ValueError("the flight recorder rides the telemetry "
                         "accumulator: pass t with w and lat")
    if (cfg.byz == BYZ_EQUIV) != (fork is not None):
        raise ValueError("pass fork (deceived, fvec, ftab_h, fnum) exactly "
                         "under byzantine equivocation")
    if view1.device.type == "cpu":
        return hotstuff_learn_plain(cfg, r, view1, pdel, adv, timer, clen,
                                    lane, gcommit, b1_h_new, gcommit_new, t,
                                    w, lat, crash, fork)
    from .. import _build
    B, N = view1.shape
    dev = view1.device
    view1, pdel, adv, timer, clen = (x.contiguous() for x in (
        view1, pdel, adv, timer, clen))
    regs = [x.contiguous() for x in (gcommit, b1_h_new, gcommit_new)]
    check_all(dev, *((x, torch.int32, (B, N)) for x in (view1, timer, clen)),
              *((x, torch.bool, (B, N)) for x in (pdel, adv)),
              (lane, torch.int64, (B, LANE_WORDS)),
              *((x, torch.int32, (B,)) for x in regs))
    if crash is not None:
        crash = tuple(x.contiguous() for x in crash)
        check_all(dev, (crash[0], torch.uint8, (B, N)),
                  *((x, torch.int32, (B, N)) for x in crash[1:]))
    window = n_windows = 0
    if t is not None:
        window, n_windows = window_of(cfg, r, t, w, lat, len(HOTSTUFF_LATENCY))
        if t.shape[1] != len(HOTSTUFF_TELEMETRY):
            raise ValueError(f"t has {t.shape[1]} counters, the engine "
                             f"{len(HOTSTUFF_TELEMETRY)}")
    if fork is not None:
        check_all(dev, (fork[0], torch.bool, (B, N)),
                  (fork[1], torch.int32, (B, N)),
                  (fork[2], torch.int32, (B, FORK_TABLE)),
                  (fork[3], torch.int32, (B,)))
    out = torch.empty((3, B, N), dtype=torch.int32, device=dev)
    _build.launch("hotstuff_learn", *(x.data_ptr() for x in (
        view1, pdel, adv, timer, clen, lane, *regs, out)),
        *(None if x is None else x.data_ptr() for x in (t, w, lat)),
        *((None,) * 3 if crash is None else (x.data_ptr() for x in crash)),
        2 * cfg.f + 1, cfg.view_timeout, B, N, window, n_windows, cfg.byz,
        cfg.n_byzantine,
        *((None,) * 4 if fork is None else (x.data_ptr() for x in fork)))
    hotstuff_learn.launches += 1
    return tuple(out.unbind(0))


hotstuff_learn.launches = 0


# --- KAG: the decided logs -----------------------------------------------------

def block_val_plain(seed, view, slot, sub: int = 5) -> torch.Tensor:
    """SPEC §7b block value at (certifying view, height): ``bitcast_i32(
    draw(STREAM_VALUE, view, sub, height))`` on int tensors that
    broadcast (the JAX package's ``_block_val``, lines 183-192); sub 6 is
    an equivocating leader's second variant."""
    k0 = rng.as_u32(seed) ^ rng.STREAM_VALUE
    return bitcast_i32(rng.threefry2x32_plain(k0, rng.as_u32(view), sub,
                                              rng.as_u32(slot)))


def hotstuff_extract_plain(seed, chain_v, chain_vid, clen, fvec, ftab_v,
                           ftab_h, fnum):
    """Plain version of KAG, the JAX package's ``_extract`` (lines
    544-569): node i of a lane committed heights [0, clen[i]); the value
    at height s is the block value of (chain_v[s], s), variant 6 where
    chain_vid[s] == 1, else 5; then for each fork entry k < fnum, in
    order, a committed node holding bit k of ``fvec`` has the variant-6
    value of (ftab_v[k], ftab_h[k]) at height ftab_h[k]. Returns
    (committed [B, N, S] bool, dval [B, N, S] int32)."""
    S = chain_v.shape[-1]
    s = torch.arange(S, dtype=torch.int64, device=chain_v.device)
    committed = s[None, None, :] < clen[..., None]
    v0 = block_val_plain(seed[:, None], chain_v, s[None, :], 5)
    v1 = block_val_plain(seed[:, None], chain_v, s[None, :], 6)
    base = torch.where(chain_vid == 1, v1, v0)
    dval = torch.where(committed, base[:, None, :], 0)
    for k in range(FORK_TABLE):
        hh = ftab_h[:, k].to(torch.int64)
        alt = block_val_plain(seed, ftab_v[:, k], hh, 6)
        hit = (((fvec >> k) & 1).to(torch.bool)[..., None]
               & (s == hh[:, None, None]) & (k < fnum)[:, None, None]
               & committed)
        dval = torch.where(hit, alt[:, None, None], dval)
    return committed, dval


def hotstuff_extract(seed, chain_v, chain_vid, clen, fvec, ftab_v, ftab_h,
                     fnum):
    """Kernel KAG: same arguments and results as
    :func:`hotstuff_extract_plain`, which it runs for CPU tensors; for
    CUDA tensors it launches ``csrc/hotstuff_extract.cu`` (a block per
    tile of a lane's rows and slots: the tile's block values once into
    shared memory, then a thread per (node, slot))."""
    if clen.device.type == "cpu":
        return hotstuff_extract_plain(seed, chain_v, chain_vid, clen, fvec,
                                      ftab_v, ftab_h, fnum)
    from .. import _build
    B, N = clen.shape
    S = chain_v.shape[1]
    dev = clen.device
    args = [x.contiguous() for x in (chain_v, chain_vid, clen, fvec, ftab_v,
                                     ftab_h, fnum)]
    check_all(dev, (seed, torch.uint32, (B,)),
              *((x, torch.int32, (B, S)) for x in args[:2]),
              *((x, torch.int32, (B, N)) for x in args[2:4]),
              *((x, torch.int32, (B, FORK_TABLE)) for x in args[4:6]),
              (args[6], torch.int32, (B,)))
    committed = torch.empty((B, N, S), dtype=torch.bool, device=dev)
    dval = torch.empty((B, N, S), dtype=torch.int32, device=dev)
    _build.launch("hotstuff_extract", seed.data_ptr(),
                  *(x.data_ptr() for x in args), committed.data_ptr(),
                  dval.data_ptr(), B, N, S)
    hotstuff_extract.launches += 1
    return committed, dval


hotstuff_extract.launches = 0


# --- the engine ----------------------------------------------------------------

def hotstuff_init(cfg: Config, seeds: torch.Tensor) -> HotstuffState:
    """Fresh state for each sweep seed in ``seeds`` ([B] uint32), as
    ``hotstuff_init`` (lines 522-533): no QC, an empty chain, every view,
    timer and prefix 0; and ``lane`` at rest, P1's key over the honest
    nodes."""
    N, S = cfg.n_nodes, cfg.log_capacity
    B, dev = seeds.shape[0], seeds.device
    i32 = dict(dtype=torch.int32, device=dev)
    none = torch.full((B,), -1, **i32)
    view = torch.zeros((B, N), **i32)
    return HotstuffState(
        seed=seeds, b1_v=none, b1_h=none.clone(), b2_v=none.clone(),
        b2_h=none.clone(), b3_v=none.clone(), b3_h=none.clone(),
        gcommit=torch.zeros((B,), **i32),
        chain_v=torch.full((B, S), -1, **i32),
        chain_vid=torch.zeros((B, S), **i32), fvec=torch.zeros((B, N), **i32),
        ftab_v=torch.full((B, FORK_TABLE), -1, **i32),
        ftab_h=torch.full((B, FORK_TABLE), -1, **i32),
        fnum=torch.zeros((B,), **i32), view=view,
        timer=torch.zeros((B, N), **i32), clen=torch.zeros((B, N), **i32),
        down=torch.zeros((B, N), dtype=torch.bool, device=dev),
        lane=lane_at_rest(view, cfg.n_honest))


def hotstuff_round(cfg: Config, st: HotstuffState, r: int, *, telem=None,
                   flight=None) -> HotstuffState:
    """One SPEC §7b round, as ``consensus_tpu/engines/hotstuff.py``
    ``hotstuff_round``: KAD, KAE and KAF, and nothing else on a flat
    round or a byzantine one; with a SPEC §B skew KAJ first, and with a
    SPEC §6c crash KAH and KAJ first (see the module's notes); on a SPEC §9
    switch round KAL (after KAH) and KAE's SWITCH instance. ``chain_v``
    and ``lane`` are updated in place, so the round consumes ``st``.

    ``telem`` ([B, K] i32, the run's counter totals) switches on the
    round's telemetry and ``flight`` (the window ring and latency buckets,
    a pair of [B, n_windows, K] and [B, 2, N_BUCKETS] i32) its flight
    recorder, as the JAX round's ``telem=True`` and ``flight=True``: KAF
    then adds the round's counters into the accumulators in place."""
    if flight is not None and telem is None:
        raise ValueError("the flight recorder rides the telemetry "
                         "accumulator: pass telem with flight")
    w, lat = flight if flight is not None else (None, None)

    # ---- SPEC §6c crash transition (KAH), then the gated prologue (KAJ):
    # recovery reset, §B skew and premature timeouts, P1's key.
    down, flags, crash = st.down, None, None
    if cfg.crash_on:
        down, flags = crash_step(cfg, st.seed, r, st.down, HOTSTUFF_TELEMETRY,
                                 telem, flight)
        crash = (flags, st.view, st.timer)
    # ---- SPEC §9 switch (KAL): the round's aggregator table and uplinks,
    # which KAE's SWITCH instance reads for P3's votes.
    agg = None
    if cfg.switch_on:
        agg = agg_step(cfg, st.seed, r, flags, HOTSTUFF_TELEMETRY, telem,
                       flight)
    view, timer = st.view, st.timer
    if gated(cfg):
        view, timer = hotstuff_prologue(cfg, st.seed, r, view, timer,
                                        st.lane, flags, telem, w)

    # ---- P0-P2 (KAD), P2's delivery, P3-P4 (KAE), P6-P7 (KAF).
    # Under SPEC §7c equivocation KAE also writes the fork table's rows and
    # names the deceived receivers, whose fork bits KAF sets.
    equiv = cfg.byz == BYZ_EQUIV
    view1, adv = hotstuff_propose(cfg, st.seed, r, view, st.b1_h, st.lane,
                                  flags)
    pdel, b1_v, b1_h, b2_v, b2_h, b3_v, b3_h, gcommit, *deceived = \
        hotstuff_vote(cfg, st.seed, r, view1, st.lane, st.b1_v, st.b1_h,
                      st.b2_v, st.b2_h, st.b3_v, st.b3_h, st.gcommit,
                      st.chain_v, flags, *(() if not equiv else (
                          (st.chain_vid, st.ftab_v, st.ftab_h, st.fnum),)),
                      *(() if agg is None else ((None,) * (not equiv)
                                                + (agg,))))
    view, timer, clen = hotstuff_learn(
        cfg, r, view1, pdel, adv, timer, st.clen, st.lane, st.gcommit, b1_h,
        gcommit, telem, w, lat, crash, *(() if not equiv else (
            (deceived[0], st.fvec, st.ftab_h, st.fnum),)))
    return st._replace(b1_v=b1_v, b1_h=b1_h, b2_v=b2_v, b2_h=b2_h,
                       b3_v=b3_v, b3_h=b3_h, gcommit=gcommit, view=view,
                       timer=timer, clen=clen, down=down)


def extract(st: HotstuffState) -> dict[str, torch.Tensor]:
    """The leaves the decided-log digest and the tests read (the JAX
    package's ``_extract``): the decided logs from KAG and the carry's
    clen, gcommit, chain_v, view, fvec and fnum."""
    committed, dval = hotstuff_extract(st.seed, st.chain_v, st.chain_vid,
                                       st.clen, st.fvec, st.ftab_v, st.ftab_h,
                                       st.fnum)
    return {"committed": committed, "dval": dval, "clen": st.clen,
            "gcommit": st.gcommit, "chain_v": st.chain_v, "view": st.view,
            "fvec": st.fvec, "fnum": st.fnum}
