"""Dense Raft in PyTorch, and the helpers it shares with the capped engine.

The port of ``consensus_tpu/engines/raft.py`` on its flat path and under
the SPEC §A.2 delay, the SPEC §6c crash-recover adversary, the SPEC §3c
byzantine nodes and the SPEC §A.3 targeted attacks (no switch gate), with
its telemetry and
flight recorder: SPEC §3 over every node at once, with the [N, N]
``match_idx`` / ``next_idx`` replication state and the full [N, N]
delivery mask of each round. Sweeps are a leading batch axis B on every
tensor.
``Config(max_active=0)`` selects it.

Five functions are wrappers of hand-written CUDA kernels, each beside its
plain PyTorch version (``<name>_plain``), which CPU tensors run:

* ``ops/adversary.py`` :func:`~consensus_tpu_torch.ops.adversary.delivery`
  — kernel KL (``csrc/delivery.cu``): the round's [B, N, N] mask;
* :func:`dense_elect` — kernel KM (``csrc/dense_elect.cu``): P0 churn, P1
  candidacy, P2 term catch-up, grants, tally and winners, whose
  ``match_idx`` / ``next_idx`` rows it resets;
* :func:`dense_append` — kernel KN (``csrc/dense_append.cu``): P3a
  propose, P3b snapshot, P3c receivers and the apply;
* :func:`dense_acks_commit` — kernel KO (``csrc/dense_acks_commit.cu``):
  P3d acks, P3e majority commit and P4 timers;
* :func:`dense_telemetry` — kernel KP (``csrc/dense_telemetry.cu``): the
  round's counters, window ring and latency buckets, with telemetry on.

On the card the round runs nothing but these launches; kernel KA
(``core/rng.py``) draws the initial timeouts. With ``crash_prob > 0`` the
round starts with kernel KAH (``ops/adversary.py`` ``crash_transition``),
whose flags the CRASH instances of KL and KM-KO read: KL cuts a down
node's edges, KM applies the recovered nodes' reset and holds every down
node at its post-reset state, KN leaves down leaders out of P3a and KO
does not count their timers, which is the JAX round's freeze. With
byzantine nodes (the ids from N - n_byzantine up; ``Config.byz``) KM-KO
run BYZ instances: a silent node's candidacy, vote responses (KM),
heartbeats (KN) and acks (KO) never travel; an equivocating node answers
every candidate whose request it got (KM). Under a SPEC §A.3 attack KL's
STICKY instance cuts the sticky target's inbound column, and KM's ATTACK
instances write each lane's attack word (the sticky activation, which
also skips the target's churn step-down, or the elect jam, under which
KM's P2 sees no request and no response), which KP counts as
attack_rounds. The logs and the
replication state are updated in place, where the JAX round returns new
arrays: a round's state replaces its input state.

The JAX package's ``_pick1`` / ``_pick_row`` one-hot reductions exist only
to keep gathers off the TPU's serial gather unit; here they are plain
indexing (``gather``), with the same values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import knobs, rng
from ..core.config import ATTACK_ELECT, ATTACK_STICKY, BYZ_SILENT, Config
from ..ops.adversary import (AGG_TELEMETRY, CRASH_DOWN, CRASH_REC,
                             CRASH_TELEMETRY, attack_fires, bitcast_i32,
                             churn, crash_step, delivery, delivery_args)
from ..ops.aggregate import (agg_step, sticky_target, switch_args,
                             switch_resp_plain)
from ..ops.flight import (add_plain, bucket_counts_plain, check_recorder,
                          window_of)

ROLE_F, ROLE_C, ROLE_L = 0, 1, 2
NONE = -1

# The engine's name, as the JAX package's EngineDef names it.
NAME = "raft"

# The Raft engines' telemetry counters, in order: a copy of
# consensus_tpu/engines/raft.py RAFT_TELEMETRY with its tails
# CRASH_TELEMETRY (kernel KAH's) and AGG_TELEMETRY (zeros: the port
# rejects the §9 switch).
RAFT_TELEMETRY = ("leader_elections", "append_accepted", "append_rejected",
                  "entries_committed", "attack_rounds") + CRASH_TELEMETRY \
    + AGG_TELEMETRY
# The flight recorder's latency histograms (engines/raft.py RAFT_LATENCY):
# each winner's round-entry timer + 1, and each live leader's
# log_len - commit, per round.
RAFT_LATENCY = ("election_wait_rounds", "commit_lag_rounds")


def draw_timeout(seed, t_min: int, t_max: int, term, idx,
                 u32=rng.random_u32) -> torch.Tensor:
    """[B, N] election timeouts: t_min + threefry(TIMEOUT, term, node) mod
    (t_max - t_min), one draw per node keyed by its current ``term``.
    ``u32`` draws the words: kernel KA, or ``rng.random_u32_plain`` in the
    plain versions of the kernels that draw timeouts inline."""
    d = u32(seed, rng.STREAM_TIMEOUT, term, 0, idx)
    return (t_min + d % (t_max - t_min)).to(torch.int32)


def match_dtype(L: int) -> torch.dtype:
    """Storage dtype of match/next bookkeeping: values are bounded by L + 1.
    The port supports the uint8 case only (Config caps log_capacity)."""
    if L + 1 > 0xFF:
        raise ValueError("match/next bookkeeping past uint8 is not ported")
    return torch.uint8


def last_term(log_term, log_len) -> torch.Tensor:
    """``log_term[..., log_len - 1]`` per row, or 0 for empty logs."""
    L = log_term.shape[-1]
    k = (log_len - 1).clamp(0, L - 1).to(torch.int64)
    picked = log_term.gather(-1, k[..., None])[..., 0]
    return torch.where(log_len > 0, picked, 0)


def bump(cfg: Config, seed, cond, new_term, term, role, voted_for, timeout):
    """Adopt a higher term where ``cond``: follower, no vote, and the
    timeout redrawn under the new term (the plain versions' draw)."""
    idx = torch.arange(term.shape[1], dtype=torch.int32, device=term.device)
    term = torch.where(cond, new_term, term)
    return (term, torch.where(cond, ROLE_F, role),
            torch.where(cond, NONE, voted_for),
            torch.where(cond, draw_timeout(seed, cfg.t_min, cfg.t_max, term,
                                           idx, rng.random_u32_plain),
                        timeout))


def attack_word(cfg: Config, seed, r: int, role_in):
    """The SPEC §A.3 attack word a Raft round starts from, [B] int32, or
    None without an attack: the round's activation (K13 ``attack_fires``),
    and under "sticky" only where the target led as the round began
    (``role_in``, the round's input roles, before the §6c reset;
    ``consensus_tpu/engines/raft.py:236-250``, ``raft_sparse.py:182-189``).
    Under "elect" the round then keeps it only where a live candidacy
    stood in P1 (the jam). In a knob batch each lane reads its own cutoff
    and target (``core/knobs.py`` :func:`~consensus_tpu_torch.core.knobs.
    target_role`)."""
    if not cfg.attack_mode:
        return None
    fires = attack_fires(seed, r, cfg.attack_cutoff, rng.random_u32_plain)
    if cfg.attack_mode == ATTACK_STICKY:
        fires = fires & (knobs.target_role(
            role_in, knobs.signed_target(cfg.attack_target)) == ROLE_L)
    return fires.to(torch.int32)


def target_ids(cfg, idx) -> torch.Tensor:
    """[N] or, in a knob batch, [B, N] bool: where the node ids ``idx``
    ([N]) are the SPEC §A.3 sticky target (a lane's out-of-range target
    matches none, as in the JAX package)."""
    return idx == knobs.at(knobs.signed_target(cfg.attack_target), 2)


def commit_median_plain(match, majority: int, E: int) -> torch.Tensor:
    """The majority-th largest value of each [N] row of the u8 ``match``
    ([B, R, N]), capped at E: the largest m in [0, E] that at least
    ``majority`` entries reach, by the same fixed-depth binary search over
    [0, E + 1) as the JAX round. [B, R] i32."""
    B, R, _ = match.shape
    lo = torch.zeros((B, R), dtype=torch.int32, device=match.device)
    hi = torch.full((B, R), E + 1, dtype=torch.int32, device=match.device)
    for _ in range((E + 1).bit_length()):
        mid = (lo + hi) // 2
        cnt = (match >= mid[:, :, None]).sum(2, dtype=torch.int32)
        ok = cnt >= majority
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return lo


def timeout_span(cfg: Config) -> int:
    """t_max - t_min, the modulus of the inline timeout draws."""
    span = cfg.t_max - cfg.t_min
    if not 0 < span < 2**32 or not -2**31 <= cfg.t_min < 2**31:
        raise ValueError("the kernels take int32 t_min and 0 < t_max - t_min "
                         "< 2**32")
    return span


def check_all(dev, *specs) -> None:
    """Raise unless each (tensor, dtype, shape) of ``specs`` is what a
    kernel takes on the CUDA device ``dev`` (:func:`_build.check`)."""
    from .. import _build
    for t, dt, shape in specs:
        _build.check(t, dt, dev, shape)


# --- the dense engine --------------------------------------------------------

class RaftState(NamedTuple):
    seed: torch.Tensor       # [B] uint32
    term: torch.Tensor       # [B, N] i32
    role: torch.Tensor       # [B, N] i32
    voted_for: torch.Tensor  # [B, N] i32
    log_term: torch.Tensor   # [B, N, L] i32
    log_val: torch.Tensor    # [B, N, L] i32
    log_len: torch.Tensor    # [B, N] i32
    commit: torch.Tensor     # [B, N] i32
    timer: torch.Tensor      # [B, N] i32
    timeout: torch.Tensor    # [B, N] i32
    match_idx: torch.Tensor  # [B, N, N] uint8, match_idx[b, l, j]
    next_idx: torch.Tensor   # [B, N, N] uint8
    down: torch.Tensor       # [B, N] bool (SPEC §6c: down at round end)


def raft_init(cfg: Config, seeds: torch.Tensor) -> RaftState:
    """Fresh state for each sweep seed in ``seeds`` ([B] uint32)."""
    N, L = cfg.n_nodes, cfg.log_capacity
    B, dev = seeds.shape[0], seeds.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    z = torch.zeros((B, N), dtype=torch.int32, device=dev)
    mdt = match_dtype(L)
    return RaftState(
        seed=seeds, term=z, role=z.clone(),
        voted_for=torch.full((B, N), NONE, dtype=torch.int32, device=dev),
        log_term=torch.zeros((B, N, L), dtype=torch.int32, device=dev),
        log_val=torch.zeros((B, N, L), dtype=torch.int32, device=dev),
        log_len=z.clone(), commit=z.clone(), timer=z.clone(),
        timeout=draw_timeout(seeds, cfg.t_min, cfg.t_max, 0, idx),
        match_idx=torch.zeros((B, N, N), dtype=mdt, device=dev),
        next_idx=torch.ones((B, N, N), dtype=mdt, device=dev),
        down=torch.zeros((B, N), dtype=torch.bool, device=dev),
    )


# --- KM: P0 churn, P1 candidacy, P2 election ---------------------------------

def dense_elect_plain(cfg: Config, seed, r: int, deliver, term, role,
                      voted_for, timer, timeout, log_term, log_len, match_idx,
                      next_idx, want_win: bool = False, flags=None,
                      agg=None):
    """Plain version of KM, SPEC §3 P0-P2 at every node of each sweep.

    P0: the round's churn event steps leaders down. P1: every non-leader
    whose timer reached its timeout stands for the next term, votes for
    itself and redraws its timeout. P2 over the requests of every
    candidate c (its post-P1 term, log length and last log term): P2a, the
    highest term among the requests ``deliver[c, j]`` delivered to j bumps
    j; P2b, j re-grants to ``voted_for`` if that candidate is eligible at
    j, else grants the least eligible candidate id if it has not voted;
    P2c, candidate c counts 1 + the grants ``deliver[j, c]`` delivered to
    it, and a candidate holding a majority becomes leader with fresh
    ``match_idx`` (0 but its own log length at its own column) and
    ``next_idx`` (its log length + 1) rows. ``match_idx`` / ``next_idx``
    ([B, N, N] u8) are updated in place; returns new (term, role,
    voted_for, timer, timeout, reset), all [B, N], and with ``want_win``
    also the winners ([B, N] bool), which the telemetry counts.

    With the round's SPEC §6c ``flags`` ([B, N] uint8, KAH; ``deliver``
    then already cuts down nodes' edges), a recovered node first becomes a
    follower with its timer at 0 and its ``match_idx`` row 0 and
    ``next_idx`` row 1 (``consensus_tpu/engines/raft.py:282-285``); every
    node's round is computed as the JAX round computes it, but a down
    node's outputs are its post-reset inputs and its rows are not written
    (the freeze, ``raft.py:527-536``), while ``win`` keeps its in-round
    value, which the telemetry counts.

    With byzantine nodes (SPEC §3c, ``cfg.byz``; ids N - n_byzantine and
    up), a silent one's candidacy broadcasts no request and its vote
    response never travels, and an equivocating one's response reaches
    every candidate c whose request it got, over ``deliver[j, c]``,
    whatever it granted (``raft.py:335-337, 402-410``).

    Under a SPEC §A.3 attack (``cfg.attack_mode``) it also returns the
    round's attack word (:func:`attack_word`, [B] int32) last:
    "sticky" skips the target's churn step-down where it fires (``deliver``
    then already lacks the target's inbound column, KL's STICKY
    instance); "elect" keeps it where a live candidacy stood in P1, and
    then P2 runs on ``deliver & ~jam`` (``raft.py:303-304, 320-330``).

    On a SPEC §9 switch round (``agg``, kernel KAL's :class:`~consensus_tpu_
    torch.ops.aggregate.AggTables`) P2c's grants travel back over the
    switch instead of ``deliver[j, c]``: j's phase-0 uplink and its
    aggregator's downlink to c, j != c, c up at the round's end; the
    sticky target's column is cut where the attack word is set (the JAX
    round zeroes its ``votes_in``), and an elect jam leaves no grant
    (``raft.py:367-400``)."""
    u32 = rng.random_u32_plain
    N = term.shape[1]
    idx = torch.arange(N, dtype=torch.int32, device=term.device)
    mdt = match_idx.dtype
    atk = attack_word(cfg, seed, r, role)
    if flags is not None:
        rec = (flags & CRASH_REC) != 0
        down = (flags & CRASH_DOWN) != 0
        role = torch.where(rec, ROLE_F, role)
        timer = torch.where(rec, 0, timer)
        rows = rec[:, :, None]
        match_idx.copy_(torch.where(rows, 0, match_idx))
        next_idx.copy_(torch.where(rows, 1, next_idx))
        frozen = (term, role, voted_for, timer, timeout)

    # ---- P0 churn, P1 candidacy.
    stepdown = churn(seed, r, cfg.churn_cutoff, u32)[:, None] \
        & (role == ROLE_L)
    if cfg.attack_mode == ATTACK_STICKY:
        stepdown = stepdown & ~((atk != 0)[:, None] & target_ids(cfg, idx))
    role = torch.where(stepdown, ROLE_F, role)
    timer = torch.where(stepdown, 0, timer)
    reset = stepdown
    cand_new = (role != ROLE_L) & (timer >= timeout)
    term = term + cand_new.to(torch.int32)
    role = torch.where(cand_new, ROLE_C, role)
    voted_for = torch.where(cand_new, idx, voted_for)
    timer = torch.where(cand_new, 0, timer)
    reset = reset | cand_new
    timeout = torch.where(
        cand_new, draw_timeout(seed, cfg.t_min, cfg.t_max, term, idx, u32),
        timeout)
    if cfg.attack_mode == ATTACK_ELECT:
        live = cand_new if flags is None else cand_new & ~down
        atk = atk * live.any(1)
        deliver = deliver & (atk == 0)[:, None, None]

    # ---- P2 election over the post-P1 requests; [B, c, j] below. Silent
    # byzantine candidates never broadcast (SPEC §3c).
    honest = idx < cfg.n_honest
    was_cand = role == ROLE_C
    if cfg.byz == BYZ_SILENT:
        was_cand = was_cand & honest
    req_term, req_lidx = term, log_len
    req_lterm = last_term(log_term, log_len)
    sent = was_cand[:, :, None] & deliver
    t_in = torch.where(sent, req_term[:, :, None], 0).amax(1)
    term, role, voted_for, timeout = bump(cfg, seed, t_in > term, t_in,
                                          term, role, voted_for, timeout)
    up_to_date = (req_lterm[:, :, None] > req_lterm[:, None, :]) | (
        (req_lterm[:, :, None] == req_lterm[:, None, :])
        & (req_lidx[:, :, None] >= log_len[:, None, :]))
    elig = sent & (req_term[:, :, None] == term[:, None, :]) & up_to_date
    vf_safe = voted_for.clamp(0, N - 1).to(torch.int64)
    vf_elig = (voted_for >= 0) & elig.gather(1, vf_safe[:, None, :])[:, 0]
    first_elig = torch.where(elig, idx[:, None], N).amin(1)
    grant = torch.where(
        vf_elig, voted_for,
        torch.where((voted_for == NONE) & (first_elig < N), first_elig, NONE))
    granted = grant >= 0
    voted_for = torch.where(granted, grant, voted_for)
    timer = torch.where(granted, 0, timer)
    reset = reset | granted
    back = deliver                                              # [B, j, c]
    if agg is not None:
        back = switch_resp_plain(cfg, seed, r, agg, 0,
                                 idx[None, :].expand(term.shape[0], N))
        back = back & (idx[:, None] != idx[None, :])
        if flags is not None:
            back = back & ~down[:, None, :]
        if cfg.attack_mode == ATTACK_STICKY:
            back = back & ~((atk != 0)[:, None, None]
                            & target_ids(cfg, idx).unsqueeze(-2))
    resp = (grant[:, :, None] == idx) & back
    if cfg.byz == BYZ_SILENT:
        resp = resp & honest[:, None]
    elif cfg.byz:
        resp = torch.where(honest[:, None], resp, was_cand[:, None, :]
                           & deliver.transpose(1, 2) & back)
    votes = 1 + resp.sum(1, dtype=torch.int32)
    win = (role == ROLE_C) & (votes >= N // 2 + 1)
    role = torch.where(win, ROLE_L, role)
    timer = torch.where(win, 0, timer)
    reset = reset | win
    eye = torch.eye(N, dtype=torch.bool, device=term.device)
    w = win[:, :, None] if flags is None else (win & ~down)[:, :, None]
    match_idx.copy_(torch.where(
        w, torch.where(eye, log_len[:, :, None], 0), match_idx).to(mdt))
    next_idx.copy_(torch.where(w, log_len[:, :, None] + 1,
                               next_idx).to(mdt))
    if flags is not None:
        term, role, voted_for, timer, timeout = (
            torch.where(down, o, n) for o, n in zip(
                frozen, (term, role, voted_for, timer, timeout)))
    out = (term, role, voted_for, timer, timeout, reset) \
        + ((win,) if want_win else ())
    return out if atk is None else (*out, atk)


def dense_elect(cfg: Config, seed, r: int, deliver, term, role, voted_for,
                timer, timeout, log_term, log_len, match_idx, next_idx,
                want_win: bool = False, flags=None, agg=None):
    """Kernel KM: same arguments, in-place update and result as
    :func:`dense_elect_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/dense_elect.cu`` (a thread per node for
    P0-P1 that lists the sweep's candidates, a thread per receiver that
    walks that list for P2a-P2b and adds its delivered grant to the
    tally, then a block per sweep for the winners and their rows; the
    winner flags only with ``want_win``; its CRASH instance with
    ``flags``; its BYZ instances with byzantine nodes; its ATTACK
    instances under an attack; its SWITCH instances with ``agg``, whose
    receivers draw each grant's downlink inline; its KNOBS instances with
    a knob batch's view, whose lanes read their churn and attack cutoffs
    and target from the view's table, ``core/knobs.py``)."""
    if term.device.type == "cpu":
        return dense_elect_plain(cfg, seed, r, deliver, term, role,
                                 voted_for, timer, timeout, log_term, log_len,
                                 match_idx, next_idx, want_win, flags, agg)
    from .. import _build
    B, N, L = log_term.shape
    dev = term.device
    check_all(dev, (seed, torch.uint32, (B,)),
              (deliver, torch.bool, (B, N, N)),
              *((t, torch.int32, (B, N)) for t in (
                  term, role, voted_for, timer, timeout, log_len)),
              (log_term, torch.int32, (B, N, L)),
              (match_idx, torch.uint8, (B, N, N)),
              (next_idx, torch.uint8, (B, N, N)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)),
              *(() if agg is None else ((agg.up, torch.bool, (B, 1, N)),
                                        (agg.tab, torch.int32,
                                         (B, cfg.n_aggregators)))))
    out = [torch.empty_like(term) for _ in range(5)]
    reset = torch.empty((B, N), dtype=torch.bool, device=dev)
    win = torch.empty_like(reset) if want_win else None
    # Candidate count and tally (zeroed by the kernel), the candidates'
    # request table (4 words each) and each node's last log term.
    scratch = torch.empty(B * (1 + 6 * N), dtype=torch.int32, device=dev)
    atk = torch.empty(B, dtype=torch.int32, device=dev) \
        if cfg.attack_mode else None
    base, table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("dense_elect", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  base.churn_cutoff, cfg.t_min, timeout_span(cfg),
                  *(t.data_ptr() for t in (
                      deliver, term, role, voted_for, timer, timeout,
                      log_term, log_len, match_idx, next_idx, *out, reset)),
                  None if win is None else win.data_ptr(), scratch.data_ptr(),
                  None if flags is None else flags.data_ptr(), B, N, L,
                  cfg.byz, cfg.n_byzantine, cfg.attack_mode,
                  base.attack_cutoff, base.attack_target,
                  None if atk is None else atk.data_ptr(),
                  *switch_args(base, agg), sticky_target(base, agg), table)
    dense_elect.launches += 1
    dense_elect.switch_launches += agg is not None
    dense_elect.knob_launches += table is not None
    out = (*out, reset) + (() if win is None else (win,))
    return out if atk is None else (*out, atk)


dense_elect.launches = 0
# Launches of its SWITCH instances (SPEC §9), also counted in ``launches``.
dense_elect.switch_launches = 0
# Launches of its KNOBS instances (a knob batch), also counted in
# ``launches``.
dense_elect.knob_launches = 0


# --- KN: P3a propose, P3b snapshot, P3c receivers ----------------------------

def dense_append_plain(cfg: Config, seed, r: int, deliver, term, role,
                       voted_for, timer, timeout, reset, log_term, log_val,
                       log_len, commit, match_idx, next_idx, flags=None):
    """Plain version of KN, SPEC §3 P3a-P3c at every node of each sweep.

    P3a: every leader whose log holds fewer than E entries writes (term,
    value) at its log length, the value a Threefry draw of STREAM_VALUE
    keyed by (round, node), grows its log by one and matches itself there.
    P3b: the leaders' term, length, commit and log rows as they stand now
    are what P3c reads of them, whatever P3c then does to the leaders
    themselves. P3c at receiver j: the highest snapshot term among the
    heartbeats ``deliver[l, j]`` bumps j; of the delivered leaders of j's
    term, the least id ``ls`` is j's leader (``has_l``); j resets its timer
    and a candidate steps down; then the log-match check at prev =
    ``next_idx[ls, j]`` - 1, and where it holds, the copy of the leader's
    entries [prev, its length), the leader's length and the commit
    following min(leader's commit, new length). ``log_term`` /
    ``log_val`` and the diagonal of ``match_idx`` are updated in place;
    returns new (term, role, voted_for, timer, timeout, reset, log_len,
    commit), the sender flags ``was_leader`` and the acks ``ack_to``
    (``ls`` or NONE), ``ack_ok`` (applied) and ``ack_match`` (the new
    length where applied, else 0), all [B, N]. With the round's SPEC §6c
    ``flags``, a down leader neither appends nor sends (its log and row
    stay frozen; its heartbeats would be cut anyway). A silent byzantine
    leader (SPEC §3c) appends but sends nothing: it is no sender of P3c
    and no ``was_leader`` of P3d (``raft.py:435``)."""
    B, N, L = log_term.shape
    E = min(cfg.max_entries, L)
    dev = term.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)

    # ---- P3a propose: the one-slot append, in place.
    lead = role == ROLE_L
    if flags is not None:
        lead = lead & ((flags & CRASH_DOWN) == 0)
    can_prop = lead & (log_len < E)
    prop_val = bitcast_i32(rng.random_u32_plain(seed, rng.STREAM_VALUE, r, 0,
                                                idx))
    pos = log_len.clamp(max=L - 1).to(torch.int64)[..., None]
    for log, val in ((log_term, term), (log_val, prop_val)):
        kept = log.gather(2, pos)[..., 0]
        log.scatter_(2, pos, torch.where(can_prop, val, kept)[..., None])
    log_len = log_len + can_prop.to(torch.int32)
    diag = match_idx.diagonal(dim1=1, dim2=2)
    diag.copy_(torch.where(can_prop, log_len.to(match_idx.dtype), diag))

    # ---- P3b snapshot (next_idx is not written before P3d). A silent
    # byzantine leader sends no heartbeat (SPEC §3c).
    was_leader = lead
    if cfg.byz == BYZ_SILENT:
        was_leader = was_leader & (idx < cfg.n_honest)
    s_term, s_len, s_commit = term, log_len, commit
    s_logt, s_logv = log_term.clone(), log_val.clone()

    # ---- P3c receivers; [B, l, j] below.
    sent = was_leader[:, :, None] & deliver
    t_in2 = torch.where(sent, s_term[:, :, None], 0).amax(1)
    term, role, voted_for, timeout = bump(cfg, seed, t_in2 > term, t_in2,
                                          term, role, voted_for, timeout)
    valid = sent & (s_term[:, :, None] == term[:, None, :])
    lstar = torch.where(valid, idx[:, None], N).amin(1)
    has_l = lstar < N
    ls = lstar.clamp(0, N - 1).to(torch.int64)
    timer = torch.where(has_l, 0, timer)
    reset = reset | has_l
    role = torch.where(has_l & (role == ROLE_C), ROLE_F, role)

    bi = torch.arange(B, device=dev)[:, None]
    prev = next_idx.gather(1, ls[:, None, :])[:, 0].to(torch.int32) - 1
    lrow_t, lrow_v = s_logt[bi, ls], s_logv[bi, ls]             # [B, N, L]
    kprev = (prev - 1).clamp(0, L - 1).to(torch.int64)[..., None]
    prev_term_l = torch.where(prev > 0, lrow_t.gather(2, kprev)[..., 0], 0)
    own_at_prev = torch.where((prev > 0) & (prev <= log_len),
                              log_term.gather(2, kprev)[..., 0], 0)
    ok = (prev == 0) | ((prev <= log_len) & (own_at_prev == prev_term_l))
    apply_ = has_l & ok
    l_len = s_len.gather(1, ls)
    kar = torch.arange(L, dtype=torch.int32, device=dev)
    copy = apply_[..., None] & (kar >= prev[..., None]) \
        & (kar < l_len[..., None])
    log_term.copy_(torch.where(copy, lrow_t, log_term))
    log_val.copy_(torch.where(copy, lrow_v, log_val))
    new_len = torch.where(apply_, l_len, log_len)
    commit = torch.where(
        apply_, torch.maximum(commit, torch.minimum(s_commit.gather(1, ls),
                                                    new_len)), commit)
    ack_to = torch.where(has_l, ls.to(torch.int32), NONE)
    ack_match = torch.where(apply_, l_len, 0)
    return (term, role, voted_for, timer, timeout, reset, new_len, commit,
            was_leader, ack_to, apply_, ack_match)


def dense_append(cfg: Config, seed, r: int, deliver, term, role, voted_for,
                 timer, timeout, reset, log_term, log_val, log_len, commit,
                 match_idx, next_idx, flags=None):
    """Kernel KN: same arguments, in-place updates and result as
    :func:`dense_append_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/dense_append.cu`` (a thread per node
    appends and lists the sweep's leaders with their scalars, a block per
    sweep copies the leaders' rows aside, then a lane per receiver walks
    the list and applies, the warp copying long ranges; its CRASH instance
    with ``flags``, its BYZ instance with silent byzantine nodes)."""
    if term.device.type == "cpu":
        return dense_append_plain(cfg, seed, r, deliver, term, role,
                                  voted_for, timer, timeout, reset, log_term,
                                  log_val, log_len, commit, match_idx,
                                  next_idx, flags)
    from .. import _build
    B, N, L = log_term.shape
    dev = term.device
    check_all(dev, (seed, torch.uint32, (B,)),
              (deliver, torch.bool, (B, N, N)),
              *((t, torch.int32, (B, N)) for t in (
                  term, role, voted_for, timer, timeout, log_len, commit)),
              (reset, torch.bool, (B, N)),
              (log_term, torch.int32, (B, N, L)),
              (log_val, torch.int32, (B, N, L)),
              (match_idx, torch.uint8, (B, N, N)),
              (next_idx, torch.uint8, (B, N, N)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)))
    out = [torch.empty_like(term) for _ in range(5)]
    reset_out = torch.empty_like(reset)
    new_len, new_commit = torch.empty_like(log_len), torch.empty_like(commit)
    was_leader = torch.empty_like(reset)
    ack_to, ack_ok = torch.empty_like(term), torch.empty_like(reset)
    ack_match = torch.empty_like(term)
    # Leader count (zeroed by the kernel) and the leaders' table (4 words
    # each), then the leaders' two log rows, by place in the table.
    scratch = torch.empty(B * (1 + 4 * N), dtype=torch.int32, device=dev)
    rows = torch.empty((2, B, N, L), dtype=torch.int32, device=dev)
    _build.launch("dense_append", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  cfg.t_min, timeout_span(cfg), *(t.data_ptr() for t in (
                      deliver, term, role, voted_for, timer, timeout, reset,
                      log_term, log_val, log_len, commit, match_idx, next_idx,
                      *out, reset_out, new_len, new_commit, was_leader,
                      ack_to, ack_ok, ack_match, scratch, rows)),
                  None if flags is None else flags.data_ptr(),
                  B, N, L, min(cfg.max_entries, L), cfg.byz, cfg.n_byzantine)
    dense_append.launches += 1
    return (*out, reset_out, new_len, new_commit, was_leader, ack_to, ack_ok,
            ack_match)


dense_append.launches = 0


# --- KO: P3d acks, P3e majority commit, P4 timers ----------------------------

def dense_acks_commit_plain(cfg: Config, seed, deliver, was_leader, ack_to,
                            ack_ok, ack_match, log_term, term, role,
                            voted_for, timeout, commit, match_idx, next_idx,
                            timer, reset, flags=None) -> None:
    """Plain version of KO, SPEC §3 P3d-P4 at every node of each sweep.

    P3d: node j's ack to ``ack_to[j]`` travels on ``deliver[j, l]``. A
    sender of P3b that still leads takes the highest acked term; a higher
    one than its own bumps it, otherwise it processes its acks: a success
    raises ``match_idx[l, j]`` to ``ack_match[j]`` and sets ``next_idx[l,
    j]`` one past it, a failure steps ``next_idx[l, j]`` back, not below 1
    (u8 arithmetic, as JAX). P3e: a processing leader's commit advances to
    the majority-th largest entry of its ``match_idx`` row (at most E)
    where its post-P3c log holds an entry of its own term there. P4:
    leaders hold ``timer`` at 0, and every other node counts it up unless
    ``reset`` says the round reset it; with the round's SPEC §6c
    ``flags``, a down node's timer stays as it is (the freeze). A silent
    byzantine node's ack never travels (SPEC §3c, ``raft.py:483-484``).
    Updates ``term``, ``role``, ``voted_for``, ``timeout``, ``commit``,
    ``match_idx``, ``next_idx`` and ``timer`` in place."""
    N = term.shape[1]
    L = log_term.shape[2]
    E = min(cfg.max_entries, L)
    mdt = match_idx.dtype
    idx = torch.arange(N, dtype=torch.int32, device=term.device)

    # ---- P3d leaders process acks; ackm is [B, j, l].
    still_lead = was_leader & (role == ROLE_L)
    ackm = (ack_to[:, :, None] == idx) & deliver
    if cfg.byz == BYZ_SILENT:
        ackm = ackm & (idx < cfg.n_honest)[:, None]
    t_in3 = torch.where(ackm, term[:, :, None], 0).amax(1)
    bump3 = still_lead & (t_in3 > term)
    new = bump(cfg, seed, bump3, t_in3, term, role, voted_for, timeout)
    for t, v in zip((term, role, voted_for, timeout), new):
        t.copy_(v)
    proc = (still_lead & ~bump3)[:, :, None]
    succ = (ackm & ack_ok[:, :, None]).transpose(1, 2)          # [B, l, j]
    fail = (ackm & ~ack_ok[:, :, None]).transpose(1, 2)
    match_idx.copy_(torch.where(
        proc & succ, torch.maximum(match_idx, ack_match[:, None, :].to(mdt)),
        match_idx))
    next_idx.copy_(torch.where(
        proc & succ, match_idx + 1,
        torch.where(proc & fail, (next_idx - 1).clamp_min(1), next_idx)))

    # ---- P3e commit advance.
    med = commit_median_plain(match_idx, N // 2 + 1, E)
    kmed = (med - 1).clamp(0, L - 1).to(torch.int64)
    term_at_med = log_term.gather(2, kmed[..., None])[..., 0]
    adv = proc[:, :, 0] & (med > commit) & (med > 0) & (term_at_med == term)
    commit.copy_(torch.where(adv, med, commit))

    # ---- P4 timers, on the roles the bump above settled.
    new_timer = torch.where(role == ROLE_L, 0,
                            torch.where(reset, timer, timer + 1))
    if flags is not None:
        new_timer = torch.where((flags & CRASH_DOWN) != 0, timer, new_timer)
    timer.copy_(new_timer)


def dense_acks_commit(cfg: Config, seed, deliver, was_leader, ack_to, ack_ok,
                      ack_match, log_term, term, role, voted_for, timeout,
                      commit, match_idx, next_idx, timer, reset,
                      flags=None) -> None:
    """Kernel KO: same arguments and in-place updates as
    :func:`dense_acks_commit_plain`, which it runs for CPU tensors; for
    CUDA tensors it launches ``csrc/dense_acks_commit.cu``: one launch, a
    block a sweep, whose threads hold their nodes' fields (read in two
    waves), take their delivered acks' terms into their leaders' maxima
    (shared atomics), bump or list each leader as processing and count the
    timers, and apply the acks to the processing leaders' rows. The
    sweep's first node that still leads has its median taken off a
    histogram of its row as the acks leave it, from entries read before
    them; every other processing leader takes a warp and the JAX round's
    binary search over its finished row. The maxima, flags and list live
    in shared memory, or past N = 29 055 in ``scratch`` (its GLOBAL
    instance); its CRASH instance runs with ``flags``, its BYZ instance
    with silent byzantine nodes. A max, one writer an entry and each
    median over its own row make the result independent of thread and
    leader order."""
    if term.device.type == "cpu":
        return dense_acks_commit_plain(cfg, seed, deliver, was_leader,
                                       ack_to, ack_ok, ack_match, log_term,
                                       term, role, voted_for, timeout, commit,
                                       match_idx, next_idx, timer, reset,
                                       flags)
    from .. import _build
    B, N, L = log_term.shape
    dev = term.device
    E = min(cfg.max_entries, L)
    check_all(dev, (seed, torch.uint32, (B,)),
              (deliver, torch.bool, (B, N, N)),
              *((t, torch.bool, (B, N)) for t in (was_leader, ack_ok, reset)),
              *((t, torch.int32, (B, N)) for t in (
                  ack_to, ack_match, term, role, voted_for, timeout, commit,
                  timer)),
              (log_term, torch.int32, (B, N, L)),
              (match_idx, torch.uint8, (B, N, N)),
              (next_idx, torch.uint8, (B, N, N)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)))
    # Each sweep's ack-term maxima (then processing flags), processing
    # list and count, where they do not fit in shared memory (zeroed by
    # the kernel's block).
    scratch = torch.empty(B * (2 * N + 1), dtype=torch.int32, device=dev)
    _build.launch("dense_acks_commit", seed.data_ptr(), cfg.t_min,
                  timeout_span(cfg), *(t.data_ptr() for t in (
                      deliver, was_leader, ack_to, ack_ok, ack_match,
                      log_term, term, role, voted_for, timeout, commit,
                      match_idx, next_idx, timer, reset, scratch)),
                  None if flags is None else flags.data_ptr(), B, N, L, E,
                  cfg.byz, cfg.n_byzantine)
    dense_acks_commit.launches += 1


dense_acks_commit.launches = 0


# --- KP: telemetry and flight recorder --------------------------------------

def dense_telemetry_plain(cfg: Config, r: int, win, timer_in, ack_to, ack_ok,
                          commit_in, commit, role, log_len, down, t, w=None,
                          lat=None, atk=None) -> None:
    """Plain version of KP: the round's RAFT_TELEMETRY counters, per sweep,
    added into the [B, K] i32 accumulator ``t`` and, with the flight
    recorder (``w`` [B, n_windows, K] and ``lat`` [B, 2, N_BUCKETS], both
    or neither), into the window ``r // cfg.telemetry_window`` of ``w``,
    and the round's RAFT_LATENCY histograms into ``lat``: the round-entry
    ``timer_in`` + 1 of each winner of ``win``, and ``log_len - commit`` of
    each leader not ``down``. The counters: winners, ``ack_ok`` (the
    applied appends), a leader heard (``ack_to >= 0``) and not applied,
    the sum of ``commit - commit_in``, attack_rounds from the round's SPEC
    §A.3 attack word ``atk`` ([B] int32, KM's; 0 without an attack), 0 for
    the aggregation tail (kernel KAL adds it on a §9 switch round); the
    crash tail is KAH's to add. Updates ``t``, ``w`` and ``lat`` in place."""
    vec = torch.zeros_like(t)
    vec[:, 0] = win.sum(1, dtype=torch.int32)
    vec[:, 1] = ack_ok.sum(1, dtype=torch.int32)
    vec[:, 2] = ((ack_to >= 0) & ~ack_ok).sum(1, dtype=torch.int32)
    vec[:, 3] = (commit - commit_in).sum(1, dtype=torch.int32)
    if atk is not None:
        vec[:, 4] = (atk != 0).to(torch.int32)
    hists = ()
    if w is not None:
        hists = (bucket_counts_plain(timer_in + 1, win),
                 bucket_counts_plain(log_len - commit,
                                     (role == ROLE_L) & ~down))
    add_plain(cfg, r, vec, t, w, lat, hists)


def dense_telemetry(cfg: Config, r: int, win, timer_in, ack_to, ack_ok,
                    commit_in, commit, role, log_len, down, t, w=None,
                    lat=None, atk=None) -> None:
    """Kernel KP: same arguments and in-place updates as
    :func:`dense_telemetry_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/dense_telemetry.cu`` (a thread per node,
    warp and block partial counts, then integer atomics into the
    accumulators; its ATTACK instance with ``atk``)."""
    check_recorder(cfg, w, lat)
    if t.device.type == "cpu":
        return dense_telemetry_plain(cfg, r, win, timer_in, ack_to, ack_ok,
                                     commit_in, commit, role, log_len, down,
                                     t, w, lat, atk)
    from .. import _build
    B, N = timer_in.shape
    K = len(RAFT_TELEMETRY)
    dev = t.device
    check_all(dev, *((x, torch.bool, (B, N)) for x in (win, ack_ok, down)),
              *((x, torch.int32, (B, N)) for x in (
                  timer_in, ack_to, commit_in, commit, role, log_len)),
              (t, torch.int32, (B, K)),
              *(() if atk is None else ((atk, torch.int32, (B,)),)))
    window, n_windows = window_of(cfg, r, t, w, lat, len(RAFT_LATENCY))
    _build.launch("dense_telemetry", *(x.data_ptr() for x in (
        win, timer_in, ack_to, ack_ok, commit_in, commit, role, log_len,
        down, t)), *(None if x is None else x.data_ptr() for x in (w, lat)),
        B, N, K, window, n_windows, None if atk is None else atk.data_ptr())
    dense_telemetry.launches += 1


dense_telemetry.launches = 0


# --- the round ---------------------------------------------------------------

def raft_round(cfg: Config, st: RaftState, r: int, *, telem=None,
               flight=None) -> RaftState:
    """One SPEC §3 round of the dense engine, phase by phase as
    ``consensus_tpu/engines/raft.py`` ``raft_round``: a sequence of kernel
    launches and nothing else. Updates ``st.log_term``, ``st.log_val``,
    ``st.match_idx`` and ``st.next_idx`` in place.

    ``telem`` ([B, K] i32, the run's counter totals) switches on the
    round's telemetry, as the JAX round's ``telem=True``, and ``flight``
    (the window ring and latency buckets, a pair of [B, n_windows, K] and
    [B, 2, N_BUCKETS] i32) its flight recorder, as ``flight=True``; kernel
    KP adds the round's counters into them in place.

    With ``cfg.crash_on`` (SPEC §6c) the round first launches KAH, which
    gives the new down mask, the flags the CRASH instances of KL and KM-KO
    read, and, with telemetry, the crash tail of the counters. Under a
    SPEC §A.3 attack KL (sticky) and KM run their ATTACK instances, and KM
    gives the round's attack word, which KP counts."""
    N = st.term.shape[1]
    seed = st.seed
    log_term, log_val = st.log_term, st.log_val
    match_idx, next_idx = st.match_idx, st.next_idx
    if flight is not None and telem is None:
        raise ValueError("the flight recorder rides the telemetry "
                         "accumulator: pass telem with flight")

    # ---- SPEC §6c crash transition (KAH). Its flags are the CRASH
    # instances' last argument, which the flat path's calls do not pass.
    down, crash = st.down, ()
    if cfg.crash_on:
        down, flags = crash_step(cfg, seed, r, st.down, RAFT_TELEMETRY,
                                 telem, flight)
        crash = (flags,)

    # ---- SPEC §9 switch (KAL): the round's aggregator table and uplinks,
    # which KM's SWITCH instance reads for P2c's grants.
    agg = None
    if cfg.switch_on:
        agg = agg_step(cfg, seed, r, crash[0] if crash else None,
                       RAFT_TELEMETRY, telem, flight)

    # ---- The round's delivery mask (KL); under the sticky attack without
    # the target's inbound column where its activation fires.
    sticky = None
    if cfg.attack_mode == ATTACK_STICKY:
        base = knobs.static(cfg)
        sticky = (st.role, base.attack_target, base.attack_cutoff)
    deliver = delivery(seed, r, N, *delivery_args(
        cfg, crash[0] if crash else None, sticky))

    # ---- P0 churn, P1 candidacy, P2 election (KM), with the winners when
    # the telemetry counts them and the attack word under an attack.
    term, role, voted_for, timer, timeout, reset, *extra = dense_elect(
        cfg, seed, r, deliver, st.term, st.role, st.voted_for, st.timer,
        st.timeout, log_term, st.log_len, match_idx, next_idx,
        telem is not None, *(crash if agg is None else (
            (crash or (None,)) + (agg,))))
    atk = extra[-1:] if cfg.attack_mode else []

    # ---- P3a propose, P3b snapshot, P3c receivers and apply (KN).
    (term, role, voted_for, timer, timeout, reset, log_len, commit,
     was_leader, ack_to, ack_ok, ack_match) = dense_append(
        cfg, seed, r, deliver, term, role, voted_for, timer, timeout, reset,
        log_term, log_val, st.log_len, st.commit, match_idx, next_idx, *crash)

    # ---- P3d acks, P3e commit advance, P4 timers (KO), in place.
    dense_acks_commit(cfg, seed, deliver, was_leader, ack_to, ack_ok,
                      ack_match, log_term, term, role, voted_for, timeout,
                      commit, match_idx, next_idx, timer, reset, *crash)

    # ---- Telemetry and flight recorder (KP). KN's acks are its apply and
    # reject flags: ack_ok is the apply, ack_to >= 0 a leader heard.
    if telem is not None:
        dense_telemetry(cfg, r, extra[0], st.timer, ack_to, ack_ok,
                        st.commit, commit, role, log_len, down, telem,
                        *(flight if flight is not None else (None, None)),
                        *atk)

    return RaftState(seed, term, role, voted_for, log_term, log_val, log_len,
                     commit, timer, timeout, match_idx, next_idx, down)


def extract(st: RaftState) -> dict[str, torch.Tensor]:
    """The leaves the decided-log digest and the tests read."""
    return {"commit": st.commit, "log_term": st.log_term,
            "log_val": st.log_val, "term": st.term, "role": st.role}
