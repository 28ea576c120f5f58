"""Dense PBFT in PyTorch: SPEC §6 with pairwise tallies over every node.

The port of ``consensus_tpu/engines/pbft.py`` on its flat path and under
the SPEC §A.2 delay, the SPEC §6c crash-recover adversary, the SPEC §B
timer skew, the SPEC §3c/§6 byzantine nodes and the SPEC §9 switch with its
§9b poisoned combines and uplink lies, with its telemetry and flight
recorder, and, through the same functions, of
``consensus_tpu/engines/pbft_sweep.py``'s ``pbft_round_padded`` (which
has no telemetry): every phase takes the per-lane population
``n_real`` and tolerance ``f`` ([B] int32 tensors). Node ``i`` of lane
``b`` is real when ``i < n_real[b]``, and honest when ``i < n_real[b] -
n_byzantine`` (every real node without byzantine nodes); padded nodes neither
send nor receive, never lead and never decide, and the quorum is
``2 f[b] + 1`` and the primary ``view mod n_real[b]``. A standalone run is
the case ``n_real = n_nodes``, ``f = cfg.f`` on every lane, so one set of
kernels serves the standalone engine and the f-ladder, and they cannot
drift apart. Sweeps (lanes) are a leading batch axis B on every tensor.

Four functions are wrappers of hand-written CUDA kernels, each beside its
plain PyTorch version (``<name>_plain``), which CPU tensors run; the
round's delivery mask is kernel KL (``ops/adversary.py``
:func:`~consensus_tpu_torch.ops.adversary.delivery`), as in dense Raft:

* :func:`pbft_view_preprepare` — kernel KQ (``csrc/pbft_view_preprepare.cu``):
  P0 churn, P1 the f+1 view catch-up, P2 timeouts and P3 pre-prepare;
* :func:`pbft_tally` — kernel KR (``csrc/pbft_tally.cu``): P4 the prepare
  tally and P5 the commit tally;
* :func:`pbft_decide` — kernel KS (``csrc/pbft_decide.cu``): P6 the
  min-id decide gossip and P7 the timers;
* :func:`pbft_telemetry` — kernel KAA (``csrc/pbft_telemetry.cu``): the
  round's PBFT_TELEMETRY counters and PBFT_LATENCY histograms, with
  telemetry on; the §6b engine (``engines/pbft_bcast.py``) runs it too.

On the card the round runs nothing but these launches. No input is
changed: each phase writes fresh tensors, and the round returns a new
state. With ``crash_prob > 0`` the round starts with kernel KAH
(``ops/adversary.py`` ``crash_transition``): KL cuts a down node's edges,
KQ's CRASH instance resets a recovered node's view and timer, and every
node's round is then the JAX round's, down nodes included, since the
telemetry counts their in-round slots (a down primary still pre-prepares
to itself). So the freeze comes last, after KAA: kernel KAI
(``ops/adversary.py`` ``freeze_down``) gives every down node's leaves
back their post-reset values. With ``desync_rate > 0`` KQ's DESYNC
instance adds each node's SPEC §B timer skew to the timer it enters the
round with (after the recovery reset, before P0); the freeze reads the
round's input, so a down node's skew is dropped, as the JAX package drops
it. With byzantine nodes (``Config.byz``) KQ, KR, KS and KAA run BYZ
instances: in both modes only honest senders count in P1, the tallies and
the decide gossip, and only an honest primary offers; under equivocation
KR adds each receiver's ``extra`` (byzantine senders delivered to it whose
stance toward it is set), a byzantine primary offers every slot with a
per-receiver value (KQ), and KAA counts the §7c safety tail. The JAX
package's ``_adopt_val`` is a one-hot reduction that only
keeps a gather off the TPU; here it is plain indexing, with the same
values.

With ``net_model="switch"`` (SPEC §9) the round launches KAL
(``ops/aggregate.py`` ``agg_round``) after KL and KQ, and kernels KAM and
KAN (``ops/switch_tally.py`` :func:`~consensus_tpu_torch.ops.switch_tally.
switch_phases`) take the place of KR and KS: the prepare votes, the commit
votes and the decide gossip each go through the K aggregators' combines,
as ``_padded_switch_phases`` and ``pbft_round``'s switch branch run them
(the dense round masks no receiver by §6c; the freeze does). The §7c safety
tail is counted wherever the JAX round counts it (:func:`safety_mode`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import knobs, rng
from ..core.config import BYZ_EQUIV, BYZ_SILENT, Config
from ..ops.adversary import (AGG_TELEMETRY, CRASH_REC, CRASH_TELEMETRY,
                             SAFETY_TELEMETRY, Byz, bitcast_i32, byz_of,
                             churn, crash_step, delivery, delivery_args,
                             equiv_stance_plain, freeze_down,
                             safety_counts_plain)
from ..ops.aggregate import agg_step
from ..ops.flight import (add_plain, bucket_counts_plain, check_recorder,
                          window_of)
from ..ops.switch_tally import switch_phases
from ..ops.viewsync import SYNC_TELEMETRY, desync_skew_plain, sync_counts_plain
from .raft import check_all

# The engine's name, as the JAX package's EngineDef names it.
NAME = "pbft"

# The PBFT engines' telemetry counters, in order: a copy of
# consensus_tpu/engines/pbft.py PBFT_TELEMETRY (lines 122-133): (node,
# slot)s newly prepared, seen and not prepared, committed by their own
# tally, prepared and not committed, committed by the decide gossip, and
# the sum of each node's view advance; then the crash, aggregation and
# safety tails (the aggregation tail counted under the switch, the safety
# tail under equivocation or §9b) and the SPEC §B desync tail.
PBFT_TELEMETRY = ("prepare_quorums", "prepare_missed", "commit_quorums",
                  "commit_missed", "commits_adopted", "view_changes") \
    + CRASH_TELEMETRY + AGG_TELEMETRY + SAFETY_TELEMETRY + SYNC_TELEMETRY
# The flight recorder's latency histograms (engines/pbft.py PBFT_LATENCY,
# line 145): the entry timer + 1 of each node whose view moved, and r - s
# of each (node, slot) committed in round r.
PBFT_LATENCY = ("view_change_wait_rounds", "slot_commit_rounds")


class PbftState(NamedTuple):
    seed: torch.Tensor       # [B] uint32
    view: torch.Tensor       # [B, N] i32
    timer: torch.Tensor      # [B, N] i32
    pp_seen: torch.Tensor    # [B, N, S] bool
    pp_view: torch.Tensor    # [B, N, S] i32
    pp_val: torch.Tensor     # [B, N, S] i32
    prepared: torch.Tensor   # [B, N, S] bool
    committed: torch.Tensor  # [B, N, S] bool
    dval: torch.Tensor       # [B, N, S] i32
    down: torch.Tensor       # [B, N] bool (SPEC §6c: down at round end)


# The leaves a down node holds (SPEC §6c), and the volatile ones of them,
# which a recovery resets to 0.
FROZEN = ("view", "timer", "pp_seen", "pp_view", "pp_val", "prepared",
          "committed", "dval")
VOLATILE = ("view", "timer")


def pbft_init(cfg: Config, seeds: torch.Tensor) -> PbftState:
    """Fresh state for each sweep seed in ``seeds`` ([B] uint32): zeros."""
    N, S = cfg.n_nodes, cfg.log_capacity
    B, dev = seeds.shape[0], seeds.device

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return PbftState(
        seed=seeds, view=zeros((B, N)), timer=zeros((B, N)),
        pp_seen=zeros((B, N, S), torch.bool), pp_view=zeros((B, N, S)),
        pp_val=zeros((B, N, S)), prepared=zeros((B, N, S), torch.bool),
        committed=zeros((B, N, S), torch.bool), dval=zeros((B, N, S)),
        down=zeros((B, N), torch.bool))


def view_bound(cfg: Config) -> int:
    """The top of P1's value range, 2 n_rounds + 2, as the JAX round passes
    it to ``_vth_select``: a view grows at most twice a round (churn and a
    timeout), so the statistic never reaches it."""
    return 2 * cfg.n_rounds + 2


def real_nodes(n_real, N: int) -> torch.Tensor:
    """[B, N] bool: node i of lane b is real (and honest) iff i <
    n_real[b]."""
    idx = torch.arange(N, dtype=torch.int32, device=n_real.device)
    return idx < n_real[:, None]


def honest_nodes(n_real, nb: int, N: int) -> torch.Tensor:
    """[B, N] bool: node i of lane b is honest iff i < n_real[b] - nb
    (SPEC §3c/§6: the byzantine nodes are a lane's top ``nb`` real ids,
    ``pbft.py:171``, ``pbft_sweep.py:157``)."""
    return real_nodes(n_real - nb, N)


def stances(seed, r: int, N: int) -> torch.Tensor:
    """[B, N, N] bool: ``sup[b, i, j]``, byzantine sender i's stance toward
    receiver j in round r (SPEC §6 equivocation, ``pbft.py:180-183``;
    absolute ids, so a padded ladder lane draws what a standalone run
    draws)."""
    ids = torch.arange(N, dtype=torch.int64, device=seed.device)
    return equiv_stance_plain(seed, r, ids[None, :, None], ids[None, None, :])


def real_delivery(deliver, n_real) -> torch.Tensor:
    """The round's mask with every edge from or to a padded node cut, as
    ``pbft_round_padded`` masks it: [B, N, N] bool."""
    real = real_nodes(n_real, deliver.shape[1])
    return deliver & real[:, :, None] & real[:, None, :]


def vth_select_plain(w, f, vmax: int) -> torch.Tensor:
    """The JAX package's ``_vth_select`` per lane: the (f[b]+1)-th largest
    of each column of ``w`` ([B, N, M] ints in [-1, vmax]), the largest v
    with |{i : w[b, i, j] >= v}| >= f[b] + 1, by the same fixed-depth
    binary search over t = v + 1 in [0, vmax + 2). [B, M] int32."""
    B, _, M = w.shape
    w1 = w + 1
    lo = torch.zeros((B, M), dtype=torch.int32, device=w.device)
    hi = torch.full((B, M), vmax + 2, dtype=torch.int32, device=w.device)
    need = (f + 1)[:, None]
    for _ in range(int(vmax + 1).bit_length()):
        mid = (lo + hi) // 2
        cnt = (w1 >= mid[:, None, :]).sum(1, dtype=torch.int32)
        ok = cnt >= need
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return lo - 1


def fresh_values(seed, view, S: int, sub=2) -> torch.Tensor:
    """[B, N, S] proposal values: the i32 bit pattern of the Threefry draw
    (seed ^ STREAM_VALUE, ctx = each node's view, c0 = ``sub``, c1 =
    slot). ``sub`` is 2 for an honest primary's fresh value, or a [B, N]
    tensor: an equivocating primary's 4 or 3 toward each receiver."""
    k0 = (rng.as_u32(seed) ^ rng.STREAM_VALUE)[:, None, None]
    k1 = rng.as_u32(view)[:, :, None]
    slots = torch.arange(S, dtype=torch.int64, device=view.device)
    shape = (*view.shape, S)
    c0 = torch.as_tensor(sub, dtype=torch.int64, device=view.device)
    if c0.dim():
        c0 = c0[:, :, None]
    d = rng.threefry2x32_plain(k0.expand(shape), k1.expand(shape),
                               c0.expand(shape), slots.expand(shape))
    return bitcast_i32(d)


def _lane_specs(deliver, n_real, f):
    B, N, _ = deliver.shape
    return [(deliver, torch.bool, (B, N, N)), (n_real, torch.int32, (B,)),
            (f, torch.int32, (B,))]


# --- KQ: P0 churn, P1 catch-up, P2 timeout, P3 pre-prepare -------------------

def pbft_view_preprepare_plain(cfg: Config, seed, r: int, deliver, n_real, f,
                               view, timer, pp_seen, pp_view, pp_val,
                               prepared, committed, want_catch: bool = False,
                               flags=None):
    """Plain version of KQ, SPEC §6 P0-P3 at every node of each lane.

    P0: the round's churn event moves every view up by one. P1: node j
    takes the (f+1)-th largest of its own view and the views of the real
    senders delivered to it (undelivered ones count as -1), where that is
    above its view. P2: a node whose timer reached ``view_timeout`` moves
    to the next view. A moved node's timer is 0 and its ``reset`` set.
    P3: the primary of view v is node v mod n_real, where its own view is
    v; it offers each slot it has seen and not committed (its value
    again) and its first unseen slot (a fresh value drawn from its view).
    Receiver j takes the offer of its primary, delivered or itself, when
    the primary's view is j's view, into each slot it has not seen in
    this view, unless it prepared another value there. Returns new
    (view, timer, reset, pp_seen, pp_view, pp_val) and, with
    ``want_catch``, the [B, N] bool flags of the nodes P1 moved. With the
    round's SPEC §6c ``flags`` ([B, N] uint8, KAH), a recovered node's view
    and timer are 0 before P0 (``consensus_tpu/engines/pbft.py:189-196``);
    with ``cfg.desync_on``, each node's SPEC §B skew
    (:func:`~consensus_tpu_torch.ops.viewsync.desync_skew_plain`, keyed by
    its absolute id) is added to its timer after that and before P0
    (``pbft.py:199-207``, ``pbft_sweep.py:175-182``).

    With byzantine nodes (SPEC §3c/§6, ``cfg.byz``; node i of lane b is
    honest when i < n_real[b] - n_byzantine), P1 counts the views of honest
    senders only and only an honest primary offers, in both modes; an
    equivocating primary (``BYZ_EQUIV``) offers every slot to each
    receiver j that it reaches (delivered or j itself), whatever the views,
    with the value drawn from j's view and subdraw 4 where its stance
    toward j (:func:`stances`) is set, else 3 (``pbft.py:244-255``)."""
    B, N, S = pp_seen.shape
    dev = view.device
    if flags is not None:
        rec = (flags & CRASH_REC) != 0
        view = torch.where(rec, 0, view)
        timer = torch.where(rec, 0, timer)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    if cfg.desync_on:
        timer = timer + desync_skew_plain(seed, r, idx, cfg.desync_cutoff,
                                          cfg.max_skew_rounds)
    real = real_nodes(n_real, N)
    honest = honest_nodes(n_real, cfg.n_byzantine, N)
    d_h = real_delivery(deliver, n_real)
    eye = torch.eye(N, dtype=torch.bool, device=dev)

    # ---- P0 churn.
    ch = churn(seed, r, cfg.churn_cutoff, rng.random_u32_plain)[:, None]
    view = view + ch.to(torch.int32)
    timer = torch.where(ch, 0, timer)
    reset = ch.expand(B, N)

    # ---- P1 catch-up: own view and the delivered honest senders' views.
    w = torch.where(d_h & honest[:, :, None], view[:, :, None], -1)
    w = torch.where(eye, view[:, None, :], w)
    vth = vth_select_plain(w, f, view_bound(cfg))
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
    del_self = d_h | eye
    prim_ok = (del_self.gather(1, prim[:, None, :])[:, 0]
               & (view.gather(1, prim) == view) & real)
    prim_s = prim[:, :, None].expand(B, N, S)
    pm_b, pm_val = ppb.gather(1, prim_s), msg_val.gather(1, prim_s)
    if cfg.byz == BYZ_EQUIV:
        prim_byz = (real & ~honest).gather(1, prim)              # [B, N]
        sup = stances(seed, r, N).gather(1, prim[:, None, :])[:, 0]
        bval = fresh_values(seed, view, S, torch.where(sup, 4, 3))
        prim_ok = torch.where(
            prim_byz, del_self.gather(1, prim[:, None, :])[:, 0] & real,
            prim_ok)
        pm_b = pm_b | prim_byz[:, :, None]
        pm_val = torch.where(prim_byz[:, :, None], bval, pm_val)
    accept = (prim_ok[:, :, None] & pm_b
              & (~pp_seen | (pp_view < view[:, :, None]))
              & (~prepared | (pm_val == pp_val)))
    out = (view, timer, reset, pp_seen | accept,
           torch.where(accept, view[:, :, None], pp_view),
           torch.where(accept, pm_val, pp_val))
    return (*out, catch) if want_catch else out


def pbft_view_preprepare(cfg: Config, seed, r: int, deliver, n_real, f, view,
                         timer, pp_seen, pp_view, pp_val, prepared,
                         committed, want_catch: bool = False, flags=None):
    """Kernel KQ: same arguments and result as
    :func:`pbft_view_preprepare_plain`, which it runs for CPU tensors; for
    CUDA tensors it launches ``csrc/pbft_view_preprepare.cu`` (a thread per
    node ranks its view within its lane, a thread per receiver walks its
    lane's senders in that order for P1 and runs P2, then a warp per
    receiver runs P3 over its slots, reading its primary's row as it stood
    before P3; P1's flags only with ``want_catch``; its CRASH instance
    with ``flags``, its DESYNC instance with ``cfg.desync_on``, its BYZ
    instances with byzantine nodes; its KNOBS instances with a knob batch's
    view, whose lanes read their churn and desync cutoffs from the view's
    table, ``core/knobs.py``)."""
    if view.device.type == "cpu":
        return pbft_view_preprepare_plain(cfg, seed, r, deliver, n_real, f,
                                          view, timer, pp_seen, pp_view,
                                          pp_val, prepared, committed,
                                          want_catch, flags)
    from .. import _build
    B, N, S = pp_seen.shape
    dev = view.device
    check_all(dev, (seed, torch.uint32, (B,)),
              *_lane_specs(deliver, n_real, f),
              *((t, torch.int32, (B, N)) for t in (view, timer)),
              *((t, torch.bool, (B, N, S)) for t in (pp_seen, prepared,
                                                      committed)),
              *((t, torch.int32, (B, N, S)) for t in (pp_view, pp_val)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)))
    view_out, timer_out = torch.empty_like(view), torch.empty_like(timer)
    reset = torch.empty((B, N), dtype=torch.bool, device=dev)
    seen_out, pview_out = torch.empty_like(pp_seen), torch.empty_like(pp_view)
    pval_out = torch.empty_like(pp_val)
    catch = torch.empty_like(reset) if want_catch else None
    order = torch.empty((B, N), dtype=torch.int32, device=dev)
    base, table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("pbft_view_preprepare", seed.data_ptr(),
                  int(r) & 0xFFFFFFFF, base.churn_cutoff, cfg.view_timeout,
                  view_bound(cfg), base.desync_cutoff, cfg.max_skew_rounds,
                  *(t.data_ptr() for t in (
                      deliver, n_real, f, view, timer, pp_seen, pp_view,
                      pp_val, prepared, committed, view_out, timer_out, reset,
                      seen_out, pview_out, pval_out)),
                  None if catch is None else catch.data_ptr(),
                  order.data_ptr(), None if flags is None else
                  flags.data_ptr(), B, N, S, cfg.byz, cfg.n_byzantine, table)
    pbft_view_preprepare.launches += 1
    pbft_view_preprepare.knob_launches += table is not None
    out = (view_out, timer_out, reset, seen_out, pview_out, pval_out)
    return (*out, catch) if want_catch else out


pbft_view_preprepare.launches = 0
# Launches of its KNOBS instances (a knob batch), also counted in
# ``launches``.
pbft_view_preprepare.knob_launches = 0


# --- KR: P4 prepare tally, P5 commit tally -----------------------------------

def pbft_tally_plain(deliver, n_real, f, pp_seen, pp_val, prepared,
                     committed, dval, byz: Byz | None = None):
    """Plain version of KR, SPEC §6 P4-P5 at every (node, slot) of each
    lane. P4: slot s of node j is prepared once 2f + 1 real senders i,
    delivered to j or j itself, have seen s with j's value. P5: it is
    committed, with that value as its decided value, once 2f + 1 such
    senders have prepared s with j's value (their prepared flags after
    P4). Materialises the [B, N, N, S] value match. Returns new
    (prepared, committed, dval).

    With the round's byzantine nodes ``byz`` (SPEC §3c/§6,
    :class:`~consensus_tpu_torch.ops.adversary.Byz`) the senders counted
    are the honest ones (i < n_real - nb), j itself only when honest, in
    both modes; under equivocation each count of receiver j also gets
    ``extra[j]``, the byzantine senders i delivered to j (``deliver[i,
    j]``, never j itself) whose stance toward j is set, which claim j's
    value at every slot (``pbft.py:309-339``)."""
    N = deliver.shape[1]
    eye = torch.eye(N, dtype=torch.bool, device=deliver.device)
    real = real_nodes(n_real, N)
    d_real = real_delivery(deliver, n_real)
    senders = real if byz is None else honest_nodes(n_real, byz.nb, N)
    d_self_h = ((d_real | eye)
                & senders[:, :, None])[..., None]               # [B, i, j, 1]
    val_eq = pp_val[:, :, None, :] == pp_val[:, None, :, :]     # [B, i, j, s]
    q = (2 * f + 1)[:, None, None]
    extra = 0
    if byz is not None and byz.mode == BYZ_EQUIV:
        extra = (d_real & (real & ~senders)[:, :, None]
                 & stances(byz.seed, byz.r, N)).sum(
                     1, dtype=torch.int32)[:, :, None]          # [B, j, 1]
    pcount = (d_self_h & pp_seen[:, :, None, :] & val_eq).sum(
        1, dtype=torch.int32) + extra
    prepared = prepared | (pp_seen & (pcount >= q))
    ccount = (d_self_h & prepared[:, :, None, :] & val_eq).sum(
        1, dtype=torch.int32) + extra
    commit_now = prepared & (ccount >= q) & ~committed
    return (prepared, committed | commit_now,
            torch.where(commit_now, pp_val, dval))


def pbft_tally(deliver, n_real, f, pp_seen, pp_val, prepared, committed,
               dval, byz: Byz | None = None):
    """Kernel KR: same arguments and result as :func:`pbft_tally_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/pbft_tally.cu`` twice, P4 then P5 (a block per 8 receivers and
    32 slots counts over the lane's real senders, staged 32 at a time in
    shared memory, wherever the slot's flag still waits on a quorum; its
    BYZ instances with ``byz``: honest senders, and under equivocation a
    first launch counts each receiver's ``extra``)."""
    if deliver.device.type == "cpu":
        return pbft_tally_plain(deliver, n_real, f, pp_seen, pp_val,
                                prepared, committed, dval, byz)
    from .. import _build
    B, N, S = pp_seen.shape
    dev = deliver.device
    check_all(dev, *_lane_specs(deliver, n_real, f),
              *((t, torch.bool, (B, N, S)) for t in (pp_seen, prepared,
                                                      committed)),
              *((t, torch.int32, (B, N, S)) for t in (pp_val, dval)))
    prep_out, com_out = torch.empty_like(prepared), torch.empty_like(committed)
    dval_out = torch.empty_like(dval)
    mode, nb, seed, r = (0, 0, None, 0) if byz is None else byz
    if seed is not None:
        check_all(dev, (seed, torch.uint32, (B,)))
    extra = torch.empty((B, N), dtype=torch.int32, device=dev) \
        if mode == BYZ_EQUIV else None
    _build.launch("pbft_tally", *(t.data_ptr() for t in (
        deliver, n_real, f, pp_seen, pp_val, prepared, committed, dval,
        prep_out, com_out, dval_out)), B, N, S, mode, nb,
        None if extra is None else seed.data_ptr(), int(r) & 0xFFFFFFFF,
        None if extra is None else extra.data_ptr())
    pbft_tally.launches += 1
    return prep_out, com_out, dval_out


pbft_tally.launches = 0


# --- KS: P6 decide gossip, P7 timers -----------------------------------------

def pbft_decide_plain(deliver, n_real, committed, dval, committed_start,
                      timer, reset, byz: Byz | None = None):
    """Plain version of KS, SPEC §6 P6-P7 at every node of each lane. P6:
    a slot that node j has not committed adopts the decided value of the
    least-id real sender delivered to j that has committed it (as P5 left
    them; an adoption is not seen by another receiver this round). P7: a
    node that committed a slot this round (``committed_start`` is the
    round's entry) sets its timer to 0; another whose ``reset`` is set
    keeps it; the rest count it up. Returns new (committed, dval,
    timer). With the round's byzantine nodes ``byz`` only honest deciders
    gossip (SPEC §3c/§6, ``pbft.py:347-356``), in both modes."""
    N = deliver.shape[1]
    idx = torch.arange(N, dtype=torch.int32, device=deliver.device)
    senders = real_nodes(n_real, N) if byz is None \
        else honest_nodes(n_real, byz.nb, N)
    dec_b = committed & senders[:, :, None]
    sent = real_delivery(deliver, n_real)[..., None] & dec_b[:, :, None, :]
    imin = torch.where(sent, idx[None, :, None, None], N).amin(1)
    adopt = (imin < N) & ~committed
    dval = torch.where(adopt, dval.gather(1, imin.clamp(max=N - 1)
                                          .to(torch.int64)), dval)
    committed = committed | adopt
    new_commit = (committed & ~committed_start).any(2)
    timer = torch.where(reset | new_commit, torch.where(new_commit, 0, timer),
                        timer + 1)
    return committed, dval, timer


def pbft_decide(deliver, n_real, committed, dval, committed_start, timer,
                reset, byz: Byz | None = None):
    """Kernel KS: same arguments and result as :func:`pbft_decide_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/pbft_decide.cu`` (a warp per receiver, a lane per slot, walks
    the real senders in id order to the first delivered decider, and
    writes fresh tensors, so that no adoption is read the same round; its
    BYZ instance with ``byz`` walks the honest senders only)."""
    if deliver.device.type == "cpu":
        return pbft_decide_plain(deliver, n_real, committed, dval,
                                 committed_start, timer, reset, byz)
    from .. import _build
    B, N, S = committed.shape
    dev = deliver.device
    check_all(dev, (deliver, torch.bool, (B, N, N)),
              (n_real, torch.int32, (B,)),
              *((t, torch.bool, (B, N, S)) for t in (committed,
                                                      committed_start)),
              (dval, torch.int32, (B, N, S)), (timer, torch.int32, (B, N)),
              (reset, torch.bool, (B, N)))
    com_out, dval_out = torch.empty_like(committed), torch.empty_like(dval)
    timer_out = torch.empty_like(timer)
    _build.launch("pbft_decide", *(t.data_ptr() for t in (
        deliver, n_real, committed, dval, committed_start, timer, reset,
        com_out, dval_out, timer_out)), B, N, S,
        0 if byz is None else byz.mode, 0 if byz is None else byz.nb)
    pbft_decide.launches += 1
    return com_out, dval_out, timer_out


pbft_decide.launches = 0


# --- KAA: the telemetry tail -------------------------------------------------

def safety_mode(cfg: Config) -> int:
    """The byzantine mode KAA runs: BYZ_EQUIV, whose instance counts the
    §7c safety tail, wherever the JAX round counts it (equivocation, or the
    switch's §9b poisoned combines or uplink lies: ``pbft.py:393``,
    ``pbft_bcast.py:698``), else ``cfg.byz``. Honesty is i < n_real -
    n_byzantine in every mode."""
    if cfg.switch_on and (cfg.agg_poison_on or cfg.uplink_lies_on):
        return BYZ_EQUIV
    return cfg.byz


# KAA's crash modes, bits of its ``crash`` argument: the view terms
# (view_changes, the view-change waits) count the nodes up at the round's
# end only, since a down node's view is frozen (both PBFT engines); the
# commit terms (commit_quorums, the commit latencies) too, since the §6b
# round masks a down node's commits (consensus_tpu/engines/
# pbft_bcast.py:355-356), while the dense round counts them.
CRASH_VIEWS, CRASH_COMMITS = 1, 2


def pbft_telemetry_plain(cfg: Config, r: int, n_real, view_in, timer_in, view,
                         catch, down, pp_seen, prepared_in, prepared,
                         committed_in, committed_tally, committed, t, w=None,
                         lat=None, crash: int = 0, values=None) -> None:
    """Plain version of KAA: the round's PBFT_TELEMETRY counters, per lane,
    added into the [B, K] int32 accumulator ``t`` and, with the flight
    recorder (``w`` [B, n_windows, K] and ``lat`` [B, 2, N_BUCKETS], both
    or neither), into window ``r // cfg.telemetry_window`` of ``w``, and
    the round's PBFT_LATENCY histograms into ``lat``, as
    ``consensus_tpu/engines/pbft.py`` pbft_round's tail (lines 377-422)
    and ``pbft_bcast.py`` pbft_bcast_round's (lines 687-728) on their flat
    paths. Its terms are read off the round's tensors: ``view_in``,
    ``timer_in``, ``prepared_in``, ``committed_in`` and ``down`` at round
    entry, the catch-up flags ``catch`` and ``pp_seen`` after P3,
    ``prepared`` and ``committed_tally`` after P5, ``view`` and
    ``committed`` at the round's end. The SPEC §B tail is taken over the
    lane's honest live nodes (i < ``n_real`` - n_byzantine, not
    ``down``); the aggregation tail is kernel KAL's to add, and the crash
    tail kernel KAH's. Where :func:`safety_mode` is BYZ_EQUIV (byzantine
    equivocation, or §9b under the switch) the safety tail counts,
    over the honest nodes, the slots whose commits by the tally hold two
    values of ``values[0]`` (pp_val after P3) and those whose decided
    values at the round's end differ (``values[1]``, ``values[2]``: dval
    at entry and after the round). Under SPEC §6c ``down`` is the mask at
    the round's end, ``view`` and ``committed`` are the round's values
    before the freeze, and ``crash`` (CRASH_VIEWS, CRASH_COMMITS) says
    which terms leave the down nodes out. Updates ``t``, ``w`` and ``lat``
    in place."""
    B, N, S = pp_seen.shape
    check_recorder(cfg, w, lat)

    def cnt(m):
        return m.sum((1, 2), dtype=torch.int32)
    up = ~down
    moved = (view - view_in).clamp(min=0)          # wraps as the JAX sum's
    waited = view > view_in
    newly = committed & ~committed_in
    commit_now = committed_tally & ~committed_in
    if crash & CRASH_VIEWS:
        moved = torch.where(up, moved, 0)
        waited = waited & up
    if crash & CRASH_COMMITS:
        newly = newly & up[:, :, None]
        commit_now = commit_now & up[:, :, None]
    honest = honest_nodes(n_real, cfg.n_byzantine, N)
    sync = sync_counts_plain(view, honest & up, catch)
    vec = torch.zeros_like(t)
    if safety_mode(cfg) == BYZ_EQUIV:
        pp_val, dval_in, dval = values

        def split(mask, val):
            # Per slot: some entry, and a max that differs from the min.
            lo = torch.where(mask, val, 2**31 - 1).amin(1)
            hi = torch.where(mask, val, -2**31).amax(1)
            return mask.any(1) & (hi != lo)
        forked = split(commit_now & honest[:, :, None], pp_val)
        frozen = down[:, :, None]
        cm = torch.where(frozen, committed_in, committed) & honest[:, :, None]
        conflicts = split(cm, torch.where(frozen, dval_in, dval))
        col = PBFT_TELEMETRY.index("forked_qc")
        vec[:, col:col + 3] = safety_counts_plain(forked, conflicts)
    vec[:, :6] = torch.stack([
        cnt(prepared & ~prepared_in), cnt(pp_seen & ~prepared),
        cnt(commit_now), cnt(prepared & ~committed_tally),
        cnt(committed & ~committed_tally), moved.sum(1, dtype=torch.int32)],
        1)
    vec[:, -3:] = sync
    hists = ()
    if w is not None:
        age = r - torch.arange(S, dtype=torch.int32, device=t.device)
        hists = (bucket_counts_plain(timer_in + 1, waited),
                 bucket_counts_plain(age.expand(B, N, S).reshape(B, -1),
                                     newly.reshape(B, -1)))
    add_plain(cfg, r, vec, t, w, lat, hists)


def pbft_telemetry(cfg: Config, r: int, n_real, view_in, timer_in, view,
                   catch, down, pp_seen, prepared_in, prepared, committed_in,
                   committed_tally, committed, t, w=None, lat=None,
                   crash: int = 0, values=None) -> None:
    """Kernel KAA: same arguments and in-place updates as
    :func:`pbft_telemetry_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/pbft_telemetry.cu`` (a block per 256 nodes
    of a lane: block sums and one integer atomic a block and counter; the
    lane's view spread by its last block; its CRASH instance with
    ``crash``; its BYZ instances with byzantine nodes, under equivocation
    with per-slot extremes in shared memory and the lane's safety tail by
    its last block)."""
    check_recorder(cfg, w, lat)
    if (safety_mode(cfg) == BYZ_EQUIV) != (values is not None):
        raise ValueError("pass values (pp_val, dval at entry, dval) exactly "
                         "where the safety tail counts (safety_mode)")
    if t.device.type == "cpu":
        return pbft_telemetry_plain(cfg, r, n_real, view_in, timer_in, view,
                                    catch, down, pp_seen, prepared_in,
                                    prepared, committed_in, committed_tally,
                                    committed, t, w, lat, crash, values)
    from .. import _build
    B, N, S = pp_seen.shape
    dev = t.device
    check_all(dev, (n_real, torch.int32, (B,)),
              *((x, torch.int32, (B, N)) for x in (view_in, timer_in, view)),
              *((x, torch.bool, (B, N)) for x in (catch, down)),
              *((x, torch.bool, (B, N, S)) for x in (
                  pp_seen, prepared_in, prepared, committed_in,
                  committed_tally, committed)),
              (t, torch.int32, (B, len(PBFT_TELEMETRY))),
              *(() if values is None else
                ((x, torch.int32, (B, N, S)) for x in values)))
    window, n_windows = window_of(cfg, r, t, w, lat, len(PBFT_LATENCY))
    # Scratch words a lane: the span's four, then under equivocation the
    # lane's safety counts and, a slot, four extremes' keys.
    words = 4 + (2 + 4 * S if values is not None else 0)
    span = torch.empty((B, words), dtype=torch.int32, device=dev)
    _build.launch("pbft_telemetry", *(x.data_ptr() for x in (
        n_real, view_in, timer_in, view, catch, down, pp_seen, prepared_in,
        prepared, committed_in, committed_tally, committed, t)),
        *(None if x is None else x.data_ptr() for x in (w, lat)),
        span.data_ptr(), int(r), B, N, S, t.shape[1], window, n_windows,
        int(crash), safety_mode(cfg), cfg.n_byzantine,
        *(None if x is None else x.data_ptr() for x in (
            values if values is not None else (None,) * 3)))
    pbft_telemetry.launches += 1


pbft_telemetry.launches = 0


# --- the round ---------------------------------------------------------------

def pbft_round(cfg: Config, st: PbftState, r: int, n_real, f, *, telem=None,
               flight=None) -> PbftState:
    """One SPEC §6 round with per-lane ``n_real`` and ``f`` ([B] int32),
    phase by phase as ``consensus_tpu/engines/pbft_sweep.py``
    ``pbft_round_padded``, and so, with ``n_real = cfg.n_nodes`` and ``f =
    cfg.f`` on every lane, as ``consensus_tpu/engines/pbft.py``
    ``pbft_round`` (``network/runner.py`` :func:`lane_inputs` gives both):
    a sequence of kernel launches and nothing else.

    ``telem`` ([B, K] i32, the run's counter totals) switches on the
    round's telemetry, as the JAX round's ``telem=True``, and ``flight``
    (the window ring and latency buckets, a pair of [B, n_windows, K] and
    [B, 2, N_BUCKETS] i32) its flight recorder, as ``flight=True``; KQ
    then also gives P1's catch-up flags, and kernel KAA adds the round's
    counters into the accumulators in place.

    With ``cfg.crash_on`` (SPEC §6c) the round starts with KAH and ends
    with KAI, the freeze (see the module's notes)."""
    N = cfg.n_nodes
    seed = st.seed
    if flight is not None and telem is None:
        raise ValueError("the flight recorder rides the telemetry "
                         "accumulator: pass telem with flight")

    # ---- SPEC §6c crash transition (KAH).
    down, flags = st.down, None
    if cfg.crash_on:
        down, flags = crash_step(cfg, seed, r, st.down, PBFT_TELEMETRY,
                                 telem, flight)

    # ---- The round's delivery mask (KL).
    deliver = delivery(seed, r, N, *delivery_args(cfg, flags))

    # ---- P0 churn, P1 catch-up, P2 timeout, P3 pre-prepare (KQ), with
    # P1's flags when the telemetry counts them.
    on = () if telem is None else (True,)
    if flags is not None:
        on = (telem is not None, flags)
    view, timer, reset, pp_seen, pp_view, pp_val, *catch = \
        pbft_view_preprepare(cfg, seed, r, deliver, n_real, f, st.view,
                             st.timer, st.pp_seen, st.pp_view, st.pp_val,
                             st.prepared, st.committed, *on)

    if cfg.switch_on:
        # ---- SPEC §9: the aggregators' round (KAL), then P4-P7 through
        # their combines (KAM, KAN).
        agg = agg_step(cfg, seed, r, flags, PBFT_TELEMETRY, telem, flight,
                       n_real)
        prepared, tallied, committed, dval, timer = switch_phases(
            cfg, seed, r, agg, n_real, f, pp_seen, pp_val, st.prepared,
            st.committed, st.dval, timer, reset)
    else:
        # ---- P4 prepare tally, P5 commit tally (KR), over the honest
        # senders (and the equivocators' claims) where SPEC §3c/§6
        # byzantine nodes run.
        byz = byz_of(cfg, seed, r)
        prepared, tallied, dval = pbft_tally(
            deliver, n_real, f, pp_seen, pp_val, st.prepared, st.committed,
            st.dval, *(() if byz is None else (byz,)))

        # ---- P6 decide gossip, P7 timers (KS).
        committed, dval, timer = pbft_decide(
            deliver, n_real, tallied, dval, st.committed, timer, reset,
            *(() if byz is None else (byz,)))

    # ---- Telemetry and flight recorder (KAA).
    if telem is not None:
        pbft_telemetry(cfg, r, n_real, st.view, st.timer, view, catch[0],
                       down, pp_seen, st.prepared, prepared, st.committed,
                       tallied, committed, telem,
                       *(flight if flight is not None else (None, None)),
                       *(() if flags is None else (CRASH_VIEWS,)),
                       *(() if safety_mode(cfg) != BYZ_EQUIV else
                         ((0,) if flags is None else ())
                         + ((pp_val, st.dval, dval),)))

    new = PbftState(seed, view, timer, pp_seen, pp_view, pp_val, prepared,
                    committed, dval, down)
    if flags is not None:
        freeze(flags, st, new)
    return new


def freeze(flags, st: PbftState, new: PbftState) -> None:
    """The SPEC §6c freeze of both PBFT engines (KAI), in place on the
    round's fresh outputs ``new``: each down node's leaves take their
    values in ``st``, its view and timer the post-reset ones
    (``consensus_tpu/engines/pbft.py:368-373``, ``pbft_bcast.py:677-684``)."""
    freeze_down(flags, [(getattr(new, k), getattr(st, k), k in VOLATILE)
                        for k in FROZEN])


def extract(st: PbftState) -> dict[str, torch.Tensor]:
    """The leaves the decided-log digest and the tests read."""
    return {"committed": st.committed, "dval": st.dval, "view": st.view,
            "prepared": st.prepared, "pp_val": st.pp_val,
            "pp_seen": st.pp_seen}
