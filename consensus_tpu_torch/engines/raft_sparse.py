"""Large-population Raft under the SPEC §3b active-sender cap, in PyTorch.

The port of ``consensus_tpu/engines/raft_sparse.py`` on its flat path and
under the SPEC §A.2 delay, the SPEC §6c crash-recover adversary, the
SPEC §3c byzantine nodes, the SPEC §A.3 targeted attacks and the SPEC §9
switch, with its telemetry
and flight recorder. Per round only the top-A candidates and the top-A
leaders by (term desc, id asc) send, and leader replication state lives in
A tracked slots of [A, N] rows, so a round is O(A*N) plus one pass over
the rows of the [N, L] logs that a heartbeat reaches. Sweeps are a leading
batch axis B on every tensor.

Eight functions here are wrappers of hand-written CUDA kernels, each beside
its plain PyTorch version (``<name>_plain``), which CPU tensors run:

* :func:`candidacy` — kernel KE (``csrc/candidacy.cu``): P0 churn, P1
  candidacy;
* :func:`top_active` — kernel KC (``csrc/top_active.cu``): the top-A
  candidates and tracked leaders;
* :func:`elect` — kernel KF (``csrc/elect.cu``): P2 term catch-up, grants,
  tally and winners, and the leader mask;
* :func:`slots` — kernel KG (``csrc/slots.cu``): the tracked-leader slot
  lifecycle with P3a's self-match;
* :func:`propose` — kernel KI (``csrc/propose.cu``): P3a's append and P3b's
  snapshot;
* :func:`append_entries` — kernel KD (``csrc/append_entries.cu``): P3c, the
  receivers and the apply;
* :func:`acks_commit` — kernel KH (``csrc/acks_commit.cu``): P3d acks, P3e
  majority commit and P4 timers;
* :func:`telemetry` — kernel KK (``csrc/telemetry.cu``): the round's
  counters and latency histograms, added into the run's accumulators.

The round's delivery masks come from kernel KB (``ops/adversary.py``); on
the card the round runs nothing but these launches. Kernel KA
(``core/rng.py``) draws the initial timeouts. With ``crash_prob > 0`` the
round starts with kernel KAH (``ops/adversary.py`` ``crash_transition``),
whose per-node flags the CRASH instances of KB, KE, KF and KH read: KE
resets a recovered node's role and timer and holds every down node at
that post-reset state, KB cuts every edge with a down end, KF leaves down
leaders out of the leader mask (so KC never tracks them and KI appends
nothing to their logs) and KH does not count their timers. KC, KG, KI and
KD then leave a down node's state as it is, which is the JAX round's
``freeze_down`` (``raft_sparse.py:494-501``). With byzantine nodes (the
ids from N - n_byzantine up; ``Config.byz``) KE, KF, KI and KH run BYZ
instances: a silent node's candidacy stays out of KC's candidate mask (KE),
its vote responses (KF) and acks (KH) never travel, and its tracked
leader slot sends no heartbeat (KI marks it unsent, so KB gives it no
edge and KH does not process it); an equivocating node's response reaches
every valid candidate whose request it got (KF). Under a SPEC §A.3 attack
KE's ATTACK instance writes each lane's attack word (the elect jam, or
the sticky target's activation, which also skips its churn step-down),
which KB's ATTACK instance reads (every edge of P2's two calls under a
jam, every edge into the sticky target on all four calls) and KK counts
as attack_rounds. On a SPEC §9 switch round (``net_model="switch"``) kernel
KAL (``ops/aggregate.py`` ``agg_round``) runs after KAH and writes the
round's aggregator table and uplinks (and, with telemetry, the aggregation
tail of the counters); KB's SWITCH instance then gives P2c's responses
``del_jc`` as the two-hop ``up0[j] & down0[a(j), c]``, with the elect jam
and the sticky cut as the JAX round zeroes ``votes_in``
(``raft_sparse.py:301-334``), and KF counts them as before.

The [B, N, L] logs are updated in place (P3a's one-slot append and P3c's
suffix copy), where the JAX round returns new arrays: a round's state
replaces its input state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import knobs, rng
from ..core.config import (ATTACK_ELECT, ATTACK_STICKY, BYZ_SILENT,
                           MAX_ACTIVE, Config)
from ..ops.adversary import (CRASH_DOWN, CRASH_REC, bitcast_i32, churn,
                             crash_step, delivery_edges)
from ..ops.aggregate import agg_step
from ..ops.flight import (add_plain, bucket_counts_plain, check_recorder,
                          window_of)
from .raft import (NONE, RAFT_LATENCY, RAFT_TELEMETRY, ROLE_C, ROLE_F, ROLE_L,
                   attack_word, bump, check_all, commit_median_plain,
                   draw_timeout, last_term, match_dtype, target_ids,
                   timeout_span)

# The engine's name, as the JAX package's EngineDef names it.
NAME = "raft-sparse"
I32_MIN = -2**31
# Plain top-A key of an unmasked node; above every masked key.
_KEY_NONE = 2**63 - 1


class RaftSparseState(NamedTuple):
    seed: torch.Tensor        # [B] uint32
    term: torch.Tensor        # [B, N] i32
    role: torch.Tensor        # [B, N] i32
    voted_for: torch.Tensor   # [B, N] i32
    log_term: torch.Tensor    # [B, N, L] i32
    log_val: torch.Tensor     # [B, N, L] i32
    log_len: torch.Tensor     # [B, N] i32
    commit: torch.Tensor      # [B, N] i32
    timer: torch.Tensor       # [B, N] i32
    timeout: torch.Tensor     # [B, N] i32
    lead_id: torch.Tensor     # [B, A] i32, NONE when the slot is empty
    lead_match: torch.Tensor  # [B, A, N] uint8
    lead_next: torch.Tensor   # [B, A, N] uint8
    down: torch.Tensor        # [B, N] bool (SPEC §6c: down at round end)


def raft_sparse_init(cfg: Config, seeds: torch.Tensor) -> RaftSparseState:
    """Fresh state for each sweep seed in ``seeds`` ([B] uint32)."""
    N, L, A = cfg.n_nodes, cfg.log_capacity, cfg.max_active
    B, dev = seeds.shape[0], seeds.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    z = torch.zeros((B, N), dtype=torch.int32, device=dev)
    mdt = match_dtype(L)
    return RaftSparseState(
        seed=seeds, term=z, role=z.clone(),
        voted_for=torch.full((B, N), NONE, dtype=torch.int32, device=dev),
        log_term=torch.zeros((B, N, L), dtype=torch.int32, device=dev),
        log_val=torch.zeros((B, N, L), dtype=torch.int32, device=dev),
        log_len=z.clone(), commit=z.clone(), timer=z.clone(),
        timeout=draw_timeout(seeds, cfg.t_min, cfg.t_max, 0, idx),
        lead_id=torch.full((B, A), NONE, dtype=torch.int32, device=dev),
        lead_match=torch.zeros((B, A, N), dtype=mdt, device=dev),
        lead_next=torch.ones((B, A, N), dtype=mdt, device=dev),
        down=torch.zeros((B, N), dtype=torch.bool, device=dev),
    )


def _scatter_max(x, ids, vals, on):
    """``x.at[ids].max(vals)`` where ``on``, no write elsewhere: the JAX
    round's ``mode="drop"`` scatter at index N. Off lanes carry I32_MIN,
    which leaves any i32 unchanged, so duplicates among them are harmless."""
    return x.scatter_reduce(1, ids.to(torch.int64),
                            torch.where(on, vals, I32_MIN), "amax")


# --- KC: top-A active senders -------------------------------------------------

def top_active_plain(mask, term, A: int) -> torch.Tensor:
    """Plain version of KC: the ids of the top-A ``mask`` nodes of each
    sweep by (term desc, id asc), NONE-padded; [B, A] i32. The keys are
    unique, so A rounds of "take the least key" equal the JAX package's
    two-key ``lax.sort``."""
    N = mask.shape[1]
    idx = torch.arange(N, dtype=torch.int64, device=mask.device)
    hi = (2**31 - 1) - term.to(torch.int64)          # in [0, 2**32)
    key = torch.where(mask, hi * 2**31 + idx, _KEY_NONE)
    ids = []
    for _ in range(A):
        k = key.argmin(1, keepdim=True)
        ids.append(torch.where(key.gather(1, k) != _KEY_NONE, k, NONE))
        key = key.scatter(1, k, _KEY_NONE)
    return torch.cat(ids, 1).to(torch.int32)


def top_active(mask, term, A: int) -> torch.Tensor:
    """Kernel KC: same arguments and result as :func:`top_active_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/top_active.cu`` (per-block partial top-A, then one merge block
    per sweep)."""
    if mask.device.type == "cpu":
        return top_active_plain(mask, term, A)
    from .. import _build
    B, N = mask.shape
    if not 1 <= A <= MAX_ACTIVE:
        raise ValueError(f"top_active takes 1 <= A <= {MAX_ACTIVE}")
    _build.check(mask, torch.bool, mask.device, (B, N))
    _build.check(term, torch.int32, mask.device, (B, N))
    blocks = max(1, min(64, -(-N // 4096)))
    partial = torch.empty((B, blocks, A), dtype=torch.int64,
                          device=mask.device)
    out = torch.empty((B, A), dtype=torch.int32, device=mask.device)
    _build.launch("top_active", mask.data_ptr(), term.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), B, N, A, blocks)
    top_active.launches += 1
    return out


top_active.launches = 0


# --- KD: P3c receivers and AppendEntries apply ---------------------------------

def append_entries_plain(cfg: Config, seed, del_lj, lead_id, s_term, term,
                         role, voted_for, timer, timeout, reset, log_term,
                         log_val, log_len, commit, s_next, s_len, s_commit,
                         s_logt, s_logv):
    """Plain version of KD, SPEC §3 P3c at each follower j of each sweep.

    The receiver side: ``t_in2``, the highest snapshot term ``s_term[k]``
    among the heartbeats ``del_lj[k, j]`` delivered to j, bumps j (follower,
    no vote, timeout redrawn under the new term); of the delivered slots of
    j's term, ``kstar[j]`` is the one with the least leader id and
    ``has_l[j]`` says there is one; a follower that heard a leader resets
    its timer, and a candidate steps down. Then the apply: with k = kstar[j]
    (used where has_l[j]), check that the follower's log matches the
    leader's at prev = s_next[k, j] - 1, and where it does, copy the
    leader's entries [prev, s_len[k]) into the follower's row, set its log
    length to s_len[k] and let its commit follow min(s_commit[k], new
    length). ``log_term``/``log_val`` ([B, N, L]) are updated in place;
    returns new (term, role, voted_for, timer, timeout, reset, kstar,
    has_l, apply, log_len, commit), all [B, N]."""
    B, N, L = log_term.shape

    # The receivers.
    t_in2 = torch.where(del_lj, s_term[:, :, None], 0).amax(1)
    term, role, voted_for, timeout = bump(cfg, seed, t_in2 > term, t_in2,
                                          term, role, voted_for, timeout)
    valid = del_lj & (s_term[:, :, None] == term[:, None, :])  # [B, A, N]
    lid = lead_id.clamp(0, N - 1)
    lcand = torch.where(valid, lid[:, :, None], N)
    has_l = lcand.amin(1) < N
    kstar = lcand.argmin(1).to(torch.int32)                    # [B, N] slot
    timer = torch.where(has_l, 0, timer)
    reset = reset | has_l
    role = torch.where(has_l & (role == ROLE_C), ROLE_F, role)

    # The apply.
    k = kstar.to(torch.int64)
    bi = torch.arange(B, device=k.device)[:, None]
    prev = s_next.gather(1, k[:, None, :])[:, 0].to(torch.int32) - 1
    l_len = s_len.gather(1, k)
    l_commit = s_commit.gather(1, k)
    kprev = (prev - 1).clamp(0, L - 1).to(torch.int64)
    prev_term_l = torch.where(prev > 0, s_logt[bi, k, kprev], 0)
    own_at_prev = torch.where((prev > 0) & (prev <= log_len),
                              log_term.gather(2, kprev[..., None])[..., 0], 0)
    ok = (prev == 0) | ((prev <= log_len) & (own_at_prev == prev_term_l))
    apply_ = has_l & ok
    kar = torch.arange(L, dtype=torch.int32, device=k.device)
    copy = apply_[..., None] & (kar >= prev[..., None]) \
        & (kar < l_len[..., None])
    log_term.copy_(torch.where(copy, s_logt[bi, k], log_term))
    log_val.copy_(torch.where(copy, s_logv[bi, k], log_val))
    new_len = torch.where(apply_, l_len, log_len)
    new_commit = torch.where(
        apply_, torch.maximum(commit, torch.minimum(l_commit, new_len)),
        commit)
    return (term, role, voted_for, timer, timeout, reset, kstar, has_l,
            apply_, new_len, new_commit)


def append_entries(cfg: Config, seed, del_lj, lead_id, s_term, term, role,
                   voted_for, timer, timeout, reset, log_term, log_val,
                   log_len, commit, s_next, s_len, s_commit, s_logt, s_logv):
    """Kernel KD: same arguments, in-place log update and result as
    :func:`append_entries_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/append_entries.cu`` (a lane per follower
    runs the receiver side and the apply's scalars, then the warp copies
    each follower's range; only copied words are written)."""
    if term.device.type == "cpu":
        return append_entries_plain(cfg, seed, del_lj, lead_id, s_term, term,
                                    role, voted_for, timer, timeout, reset,
                                    log_term, log_val, log_len, commit,
                                    s_next, s_len, s_commit, s_logt, s_logv)
    from .. import _build
    B, N, L = log_term.shape
    A = s_len.shape[1]
    dev = term.device
    check_all(dev, (seed, torch.uint32, (B,)),
              (del_lj, torch.bool, (B, A, N)),
              (lead_id, torch.int32, (B, A)), (s_term, torch.int32, (B, A)),
              *((t, torch.int32, (B, N)) for t in (
                  term, role, voted_for, timer, timeout, log_len, commit)),
              (reset, torch.bool, (B, N)),
              (log_term, torch.int32, (B, N, L)),
              (log_val, torch.int32, (B, N, L)),
              (s_next, torch.uint8, (B, A, N)), (s_len, torch.int32, (B, A)),
              (s_commit, torch.int32, (B, A)),
              (s_logt, torch.int32, (B, A, L)),
              (s_logv, torch.int32, (B, A, L)))
    out = [torch.empty_like(term) for _ in range(5)]
    reset_out = torch.empty_like(reset)
    kstar = torch.empty_like(term)
    has_l = torch.empty_like(reset)
    apply_ = torch.empty_like(reset)
    new_len = torch.empty_like(log_len)
    new_commit = torch.empty_like(commit)
    _build.launch("append_entries", seed.data_ptr(), cfg.t_min,
                  timeout_span(cfg), *(t.data_ptr() for t in (
                      del_lj, lead_id, s_term, term, role, voted_for, timer,
                      timeout, reset, log_term, log_val, log_len, commit,
                      s_next, s_len, s_commit, s_logt, s_logv, *out,
                      reset_out, kstar, has_l, apply_, new_len, new_commit)),
                  B, N, A, L)
    append_entries.launches += 1
    return (*out, reset_out, kstar, has_l, apply_, new_len, new_commit)


append_entries.launches = 0


# --- KE: P0 churn and P1 candidacy ---------------------------------------------

def candidacy_plain(cfg: Config, seed, r: int, term, role, voted_for, timer,
                    timeout, log_term, log_len, flags=None):
    """Plain version of KE, SPEC §3 P0-P1 at every node of each sweep: the
    round's churn event steps leaders down; every non-leader whose timer
    reached its timeout becomes a candidate of the next term, votes for
    itself and redraws its timeout. Also returns each node's last log term
    (the P2b input, from the logs as they enter the round) and the
    candidate mask. With the round's SPEC §6c ``flags`` ([B, N] uint8, KAH),
    a recovered node first becomes a follower with its timer at 0, and a
    down node keeps that post-reset state and is no candidate
    (``consensus_tpu/engines/raft_sparse.py:209-227, 259-260``). With
    silent byzantine nodes (SPEC §3c, ``cfg.byz``) their candidacies stay
    out of the mask: they never broadcast (line 258). Updates nothing in
    place; returns new (term, role, voted_for, timer, timeout, reset,
    own_lterm, cand_mask), all [B, N], and under a SPEC §A.3 attack
    (``cfg.attack_mode``) also the round's attack word
    (``raft.attack_word``). In a knob batch (``cfg`` a view,
    ``core/knobs.py``) each lane reads its churn and attack cutoffs and
    its target as [B, 1] columns; a lane's target outside [0, N) shields
    no leader from the churn but its activation reads the clamped role
    (``raft.target_ids``, ``knobs.target_role``)."""
    u32 = rng.random_u32_plain
    idx = torch.arange(term.shape[1], dtype=torch.int32, device=term.device)
    atk = attack_word(cfg, seed, r, role)
    if flags is not None:
        rec = (flags & CRASH_REC) != 0
        role = torch.where(rec, ROLE_F, role)
        timer = torch.where(rec, 0, timer)
        frozen = (term, role, voted_for, timer, timeout)
    stepdown = churn(seed, r, cfg.churn_cutoff, u32)[:, None] \
        & (role == ROLE_L)
    if cfg.attack_mode == ATTACK_STICKY:
        stepdown = stepdown & ~((atk != 0)[:, None] & target_ids(cfg, idx))
    role = torch.where(stepdown, ROLE_F, role)
    timer = torch.where(stepdown, 0, timer)
    reset = stepdown
    cand_new = (role != ROLE_L) & (timer >= timeout)
    if cfg.attack_mode == ATTACK_ELECT:
        live = cand_new if flags is None \
            else cand_new & ((flags & CRASH_DOWN) == 0)
        atk = atk * live.any(1)
    term = term + cand_new.to(torch.int32)
    role = torch.where(cand_new, ROLE_C, role)
    voted_for = torch.where(cand_new, idx, voted_for)
    timer = torch.where(cand_new, 0, timer)
    reset = reset | cand_new
    timeout = torch.where(
        cand_new, draw_timeout(seed, cfg.t_min, cfg.t_max, term, idx, u32),
        timeout)
    own_lterm = last_term(log_term, log_len)
    cand_mask = role == ROLE_C
    if cfg.byz == BYZ_SILENT:
        cand_mask = cand_mask & (idx < cfg.n_honest)
    if flags is not None:
        down = (flags & CRASH_DOWN) != 0
        term, role, voted_for, timer, timeout = (
            torch.where(down, o, n) for o, n in zip(
                frozen, (term, role, voted_for, timer, timeout)))
        cand_mask = cand_mask & ~down
    out = (term, role, voted_for, timer, timeout, reset, own_lterm,
           cand_mask)
    return out if atk is None else (*out, atk)


def candidacy(cfg: Config, seed, r: int, term, role, voted_for, timer,
              timeout, log_term, log_len, flags=None):
    """Kernel KE: same arguments and result as :func:`candidacy_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/candidacy.cu`` (a thread per node, the churn and timeout
    Threefry draws inline; its CRASH instance with ``flags``, its BYZ
    instance with silent byzantine nodes, its ATTACK instances under an
    attack, its KNOBS instances with a knob batch's view, whose lanes read
    their churn and attack cutoffs and target from the view's table,
    ``core/knobs.py``). Updates nothing in place."""
    if term.device.type == "cpu":
        return candidacy_plain(cfg, seed, r, term, role, voted_for, timer,
                               timeout, log_term, log_len, flags)
    from .. import _build
    B, N, L = log_term.shape
    dev = term.device
    check_all(dev, (seed, torch.uint32, (B,)),
              *((t, torch.int32, (B, N)) for t in (
                  term, role, voted_for, timer, timeout, log_len)),
              (log_term, torch.int32, (B, N, L)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)))
    out = [torch.empty_like(term) for _ in range(5)]
    reset = torch.empty((B, N), dtype=torch.bool, device=dev)
    own_lterm = torch.empty_like(term)
    cand = torch.empty((B, N), dtype=torch.bool, device=dev)
    atk = torch.empty(B, dtype=torch.int32, device=dev) \
        if cfg.attack_mode else None
    base, table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("candidacy", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  base.churn_cutoff, cfg.t_min, timeout_span(cfg),
                  *(t.data_ptr() for t in (
                      term, role, voted_for, timer, timeout, log_term,
                      log_len, *out, reset, own_lterm, cand)),
                  None if flags is None else flags.data_ptr(), B, N, L,
                  cfg.byz, cfg.n_byzantine, cfg.attack_mode,
                  base.attack_cutoff, base.attack_target,
                  None if atk is None else atk.data_ptr(), table)
    candidacy.launches += 1
    candidacy.knob_launches += table is not None
    out = (*out, reset, own_lterm, cand)
    return out if atk is None else (*out, atk)


candidacy.launches = 0
# Launches of its KNOBS instances (a knob batch), also counted in
# ``launches``.
candidacy.knob_launches = 0


# --- KF: P2 election -------------------------------------------------------------

def elect_plain(cfg: Config, seed, cand_ids, del_cj, del_jc, term, role,
                voted_for, timer, timeout, reset, log_len, own_lterm,
                flags=None):
    """Plain version of KF, SPEC §3 P2 over the sweep's active candidates
    ``cand_ids`` ([B, A], NONE-padded) with their request masks ``del_cj``
    ([B, A, N]) and response masks ``del_jc`` ([B, N, A]): P2a term
    catch-up, P2b grants (re-grant to ``voted_for`` if eligible, else the
    lowest eligible candidate id), P2c the tally; winners become leaders.
    The candidates' request fields are read from ``term``, ``log_len`` and
    ``own_lterm`` as they enter. Updates nothing in place; returns new
    (term, role, voted_for, timer, timeout, reset), the leader mask
    ``role == ROLE_L`` (all [B, N]; with the round's SPEC §6c ``flags``,
    of the nodes up at the round's end only: a down leader is neither
    tracked nor appends, ``raft_sparse.py:359-360``) and the winner flags
    ``win`` ([B, A] bool). With byzantine nodes (SPEC §3c, ``cfg.byz``) a
    silent one's vote response never travels, and an equivocating one
    answers every valid candidate whose request it got and whose way back
    is open (``del_cj.T & del_jc``), whatever it granted (lines
    338-346)."""
    N = term.shape[1]
    majority = N // 2 + 1
    cvalid = cand_ids >= 0
    cid = cand_ids.clamp(0, N - 1).to(torch.int64)
    req_term = torch.where(cvalid, term.gather(1, cid), 0)
    req_lidx = log_len.gather(1, cid)
    req_lterm = own_lterm.gather(1, cid)

    # P2a term catch-up.
    t_in = torch.where(del_cj, req_term[:, :, None], 0).amax(1)
    term, role, voted_for, timeout = bump(cfg, seed, t_in > term, t_in,
                                          term, role, voted_for, timeout)

    # P2b grants.
    up_to_date = (req_lterm[:, :, None] > own_lterm[:, None, :]) | (
        (req_lterm[:, :, None] == own_lterm[:, None, :])
        & (req_lidx[:, :, None] >= log_len[:, None, :]))
    elig = del_cj & (req_term[:, :, None] == term[:, None, :]) & up_to_date
    vf_elig = ((cand_ids[:, :, None] == voted_for[:, None, :]) & elig).any(1)
    first_elig = torch.where(elig, cid.to(torch.int32)[:, :, None],
                             N).amin(1)
    grant = torch.where(
        vf_elig, voted_for,
        torch.where((voted_for == NONE) & (first_elig < N), first_elig, NONE))
    granted = grant >= 0
    voted_for = torch.where(granted, grant, voted_for)
    timer = torch.where(granted, 0, timer)
    reset = reset | granted

    # P2c tally per active candidate; winners become leaders. A silent
    # byzantine node's response never travels; an equivocating one's
    # reaches every valid candidate whose request it got.
    resp = (grant[:, :, None] == cand_ids[:, None, :]) & del_jc
    if cfg.byz:
        honest = (torch.arange(N, device=term.device) < cfg.n_honest)[
            None, :, None]
        if cfg.byz == BYZ_SILENT:
            resp = resp & honest
        else:
            resp = torch.where(honest, resp, cvalid[:, None, :]
                               & del_cj.transpose(1, 2) & del_jc)
    votes = 1 + resp.sum(1, dtype=torch.int32)                  # [B, A]
    win = cvalid & (role.gather(1, cid) == ROLE_C) & (votes >= majority)
    won = torch.zeros_like(term).scatter_reduce(
        1, cid, win.to(torch.int32), "amax").bool()
    role = torch.where(won, ROLE_L, role)
    timer = torch.where(won, 0, timer)
    reset = reset | won
    lead = role == ROLE_L
    if flags is not None:
        lead = lead & ((flags & CRASH_DOWN) == 0)
    return term, role, voted_for, timer, timeout, reset, lead, win


def elect(cfg: Config, seed, cand_ids, del_cj, del_jc, term, role, voted_for,
          timer, timeout, reset, log_len, own_lterm, flags=None):
    """Kernel KF: same arguments and result as :func:`elect_plain`, which it
    runs for CPU tensors; for CUDA tensors it launches ``csrc/elect.cu``
    (a thread per node with the candidates' fields in shared memory and
    block-partial vote counts, then a [B, A] winner epilogue that also
    completes the leader mask; its CRASH instance with ``flags``, its BYZ
    instances with byzantine nodes). Updates nothing in place."""
    if term.device.type == "cpu":
        return elect_plain(cfg, seed, cand_ids, del_cj, del_jc, term, role,
                           voted_for, timer, timeout, reset, log_len,
                           own_lterm, flags)
    from .. import _build
    B, N = term.shape
    A = cand_ids.shape[1]
    dev = term.device
    if not 1 <= A <= MAX_ACTIVE:
        raise ValueError(f"elect takes 1 <= A <= {MAX_ACTIVE}")
    check_all(dev, (seed, torch.uint32, (B,)),
              (cand_ids, torch.int32, (B, A)),
              (del_cj, torch.bool, (B, A, N)),
              (del_jc, torch.bool, (B, N, A)),
              *((t, torch.int32, (B, N)) for t in (
                  term, role, voted_for, timer, timeout, log_len,
                  own_lterm)),
              (reset, torch.bool, (B, N)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)))
    out = [torch.empty_like(term) for _ in range(5)]
    reset_out = torch.empty_like(reset)
    lead = torch.empty_like(reset)
    win = torch.empty((B, A), dtype=torch.bool, device=dev)
    votes = torch.empty((B, A), dtype=torch.int32, device=dev)
    _build.launch("elect", seed.data_ptr(), cfg.t_min, timeout_span(cfg),
                  *(t.data_ptr() for t in (
                      cand_ids, del_cj, del_jc, term, role, voted_for, timer,
                      timeout, reset, log_len, own_lterm, *out, reset_out,
                      lead, win, votes)),
                  None if flags is None else flags.data_ptr(), B, N, A,
                  cfg.byz, cfg.n_byzantine)
    elect.launches += 1
    return (*out, reset_out, lead, win)


elect.launches = 0


# --- KG: tracked-leader slot lifecycle ------------------------------------------

def slots_plain(cfg: Config, new_ids, lead_id, lead_match, lead_next, role,
                log_len):
    """Plain version of KG, the SPEC §3b slot lifecycle: slot a of the new
    tracked set ``new_ids`` ([B, A]) carries the [N] match/next rows of the
    old slot that tracked the same leader, or starts fresh rows (match 0
    but the leader's own log length at its own column, next = length + 1).
    Then P3a's self-match: a tracked leader that will append this round
    (``role`` leader, ``log_len`` below E, both as P3a reads them) matches
    itself at its new length. Updates nothing in place; returns new
    (lead_match, lead_next), [B, A, N] u8."""
    B, A = new_ids.shape
    N = role.shape[1]
    E = min(cfg.max_entries, cfg.log_capacity)
    mdt = lead_match.dtype
    idx = torch.arange(N, dtype=torch.int32, device=role.device)
    bi = torch.arange(B, device=role.device)[:, None]
    same = new_ids[:, :, None] == torch.where(
        lead_id >= 0, lead_id, N + 1)[:, None, :]               # [B, A, A]
    carried = same.any(2) & (new_ids >= 0)
    src_slot = same.to(torch.uint8).argmax(2)
    nid = new_ids.clamp(0, N - 1).to(torch.int64)
    nlen = log_len.gather(1, nid)                               # [B, A]
    init_match = torch.where(idx == nid[:, :, None], nlen[:, :, None],
                             0).to(mdt)
    init_next = (nlen + 1).to(mdt)[:, :, None].expand(B, A, N)
    lead_match = torch.where(carried[:, :, None], lead_match[bi, src_slot],
                             init_match)
    lead_next = torch.where(carried[:, :, None], lead_next[bi, src_slot],
                            init_next)
    # P3a's self-match: one entry per slot row, at the leader's own column.
    can_prop = (role == ROLE_L) & (log_len < E)
    self_on = ((new_ids >= 0) & can_prop.gather(1, nid))[:, :, None]
    lead_match = lead_match.scatter(
        2, nid[:, :, None], torch.where(
            self_on, (nlen + 1).to(mdt)[:, :, None],
            lead_match.gather(2, nid[:, :, None])))
    return lead_match, lead_next


def slots(cfg: Config, new_ids, lead_id, lead_match, lead_next, role,
          log_len):
    """Kernel KG: same arguments and result as :func:`slots_plain`, which
    it runs for CPU tensors; for CUDA tensors it launches ``csrc/slots.cu``
    (a thread per (slot, node) byte; the slot match is found once per
    block). Writes fresh rows, since carrying permutes them; updates
    nothing in place."""
    if role.device.type == "cpu":
        return slots_plain(cfg, new_ids, lead_id, lead_match, lead_next,
                           role, log_len)
    from .. import _build
    B, A = new_ids.shape
    N = role.shape[1]
    dev = role.device
    if not 1 <= A <= MAX_ACTIVE:
        raise ValueError(f"slots takes 1 <= A <= {MAX_ACTIVE}")
    check_all(dev, (new_ids, torch.int32, (B, A)),
              (lead_id, torch.int32, (B, A)),
              (lead_match, torch.uint8, (B, A, N)),
              (lead_next, torch.uint8, (B, A, N)),
              (role, torch.int32, (B, N)), (log_len, torch.int32, (B, N)))
    match_out = torch.empty_like(lead_match)
    next_out = torch.empty_like(lead_next)
    _build.launch("slots", *(t.data_ptr() for t in (
        new_ids, lead_id, lead_match, lead_next, role, log_len, match_out,
        next_out)), B, N, A, min(cfg.max_entries, cfg.log_capacity))
    slots.launches += 1
    return match_out, next_out


slots.launches = 0


# --- KH: P3d acks, P3e majority commit, P4 timers -------------------------------

def acks_commit_plain(cfg: Config, seed, lead_id, was_lead_k, del_jl, has_l,
                      kstar, apply_, log_len, log_term, term, role, voted_for,
                      timeout, commit, lead_match, lead_next, timer,
                      reset, flags=None) -> None:
    """Plain version of KH, SPEC §3 P3d-P4 for each tracked slot that sent
    heartbeats (``was_lead_k``, [B, A]) and still leads: follower j acks
    slot ``kstar[j]`` where ``has_l[j]`` and ``del_jl[j, kstar[j]]``, with
    its term and (where ``apply_``) its new ``log_len``. A higher acked
    term bumps the leader; otherwise its match/next rows follow the acks
    (u8 arithmetic, as JAX), and its commit advances to the majority-th
    largest match when that entry is of its own term. ``log_term`` is the
    post-P3c log. Then P4: leaders hold ``timer`` at 0, and every other
    node counts it up unless ``reset`` says the round reset it; with the
    round's SPEC §6c ``flags``, a down node's timer stays as it is (the
    freeze). A silent byzantine node's ack never travels (SPEC §3c,
    ``raft_sparse.py:446-447``). Updates ``term``, ``role``,
    ``voted_for``, ``timeout``, ``commit``, ``lead_match``, ``lead_next``
    and ``timer`` in place."""
    B, N = term.shape
    A = lead_id.shape[1]
    E = min(cfg.max_entries, cfg.log_capacity)
    majority = N // 2 + 1
    mdt = lead_match.dtype
    bi = torch.arange(B, device=term.device)[:, None]
    slot_ids = torch.arange(A, dtype=torch.int32, device=term.device)
    lid = lead_id.clamp(0, N - 1).to(torch.int64)
    ack_slot = torch.where(has_l, kstar, A)
    ack_match = torch.where(apply_, log_len, 0)

    # ---- P3d tracked leaders process acks.
    still_lead_k = was_lead_k & (role.gather(1, lid) == ROLE_L)
    ackm = (ack_slot[:, :, None] == slot_ids) & del_jl          # [B, N, A]
    if cfg.byz == BYZ_SILENT:
        ackm = ackm & (torch.arange(N, device=term.device)
                       < cfg.n_honest)[None, :, None]
    t_in3 = torch.where(ackm, term[:, :, None], 0).amax(1)      # [B, A]
    bump3_k = still_lead_k & (t_in3 > term.gather(1, lid))
    new_t = _scatter_max(term, lid, t_in3, bump3_k)
    new = bump(cfg, seed, new_t > term, new_t, term, role, voted_for,
               timeout)
    for t, v in zip((term, role, voted_for, timeout), new):
        t.copy_(v)
    proc = (still_lead_k & ~bump3_k)[:, :, None]                # [B, A, 1]

    succ = (ackm & apply_[:, :, None]).transpose(1, 2)          # [B, A, N]
    fail = (ackm & ~apply_[:, :, None]).transpose(1, 2)
    lead_match.copy_(torch.where(
        proc & succ, torch.maximum(lead_match, ack_match[:, None, :].to(mdt)),
        lead_match))
    lead_next.copy_(torch.where(
        proc & succ, lead_match + 1,
        torch.where(proc & fail, (lead_next - 1).clamp_min(1), lead_next)))

    # ---- P3e commit advance.
    med = commit_median_plain(lead_match, majority, E)
    kmed = (med - 1).clamp(0, cfg.log_capacity - 1).to(torch.int64)
    term_at_med = log_term[bi, lid, kmed]                       # post-P3c
    adv = proc[:, :, 0] & (med > commit.gather(1, lid)) & (med > 0) \
        & (term_at_med == term.gather(1, lid))
    commit.copy_(_scatter_max(commit, lid, med, adv))

    # ---- P4 timers, on the roles the bump above settled.
    new_timer = torch.where(role == ROLE_L, 0,
                            torch.where(reset, timer, timer + 1))
    if flags is not None:
        new_timer = torch.where((flags & CRASH_DOWN) != 0, timer, new_timer)
    timer.copy_(new_timer)


def acks_commit(cfg: Config, seed, lead_id, was_lead_k, del_jl, has_l, kstar,
                apply_, log_len, log_term, term, role, voted_for, timeout,
                commit, lead_match, lead_next, timer, reset,
                flags=None) -> None:
    """Kernel KH: same arguments and in-place updates as
    :func:`acks_commit_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/acks_commit.cu`` (block-partial ack-term
    maxima, a [B, A] bump epilogue, the match/next update with a per-row
    256-bin histogram of the new matches, a [B, A] commit epilogue
    reading the majority-th largest match off the histogram, and a thread
    per node for the timers; its CRASH instance with ``flags``, its BYZ
    instance with silent byzantine nodes). The
    tracked ids ``lead_id`` of slots with ``was_lead_k`` must be distinct,
    as kernel KC gives them."""
    if term.device.type == "cpu":
        return acks_commit_plain(cfg, seed, lead_id, was_lead_k, del_jl,
                                 has_l, kstar, apply_, log_len, log_term,
                                 term, role, voted_for, timeout, commit,
                                 lead_match, lead_next, timer, reset, flags)
    from .. import _build
    B, N, L = log_term.shape
    A = lead_id.shape[1]
    dev = term.device
    if not 1 <= A <= MAX_ACTIVE:
        raise ValueError(f"acks_commit takes 1 <= A <= {MAX_ACTIVE}")
    check_all(dev, (seed, torch.uint32, (B,)),
              (lead_id, torch.int32, (B, A)),
              (was_lead_k, torch.bool, (B, A)),
              (del_jl, torch.bool, (B, N, A)),
              (has_l, torch.bool, (B, N)), (apply_, torch.bool, (B, N)),
              *((t, torch.int32, (B, N)) for t in (
                  kstar, log_len, term, role, voted_for, timeout, commit,
                  timer)),
              (log_term, torch.int32, (B, N, L)),
              (lead_match, torch.uint8, (B, A, N)),
              (lead_next, torch.uint8, (B, A, N)),
              (reset, torch.bool, (B, N)),
              *(() if flags is None else ((flags, torch.uint8, (B, N)),)))
    t_in3 = torch.empty((B, A), dtype=torch.int32, device=dev)
    proc = torch.empty((B, A), dtype=torch.int32, device=dev)
    hist = torch.empty((B, A, 256), dtype=torch.int32, device=dev)
    _build.launch("acks_commit", seed.data_ptr(), cfg.t_min,
                  timeout_span(cfg), *(t.data_ptr() for t in (
                      lead_id, was_lead_k, del_jl, has_l, kstar, apply_,
                      log_len, log_term, term, role, voted_for, timeout,
                      commit, lead_match, lead_next, timer, reset, t_in3,
                      proc, hist)),
                  None if flags is None else flags.data_ptr(),
                  B, N, A, L, min(cfg.max_entries, L), cfg.byz,
                  cfg.n_byzantine)
    acks_commit.launches += 1


acks_commit.launches = 0


# --- KI: P3a propose and P3b snapshot -------------------------------------------

def propose_plain(cfg: Config, seed, r: int, lead, term, log_term, log_val,
                  log_len, commit, lead_id):
    """Plain version of KI, SPEC §3 P3a-P3b. P3a: every leader (``lead``,
    tracked or not) whose log holds fewer than E entries writes (term,
    value) at its log length, the value a Threefry draw of STREAM_VALUE
    keyed by (round, node), and grows its log by one. P3b: per tracked slot
    of ``lead_id`` ([B, A]), whether it still leads (``was_lead_k``), the
    heartbeat sender id (``hb_ids``: the leader's id, or NONE), and its
    term, new length, commit and post-append log rows. ``log_term`` /
    ``log_val`` ([B, N, L]) are updated in place; returns (log_len [B, N],
    was_lead_k, hb_ids, s_term, s_len, s_commit [B, A], s_logt, s_logv
    [B, A, L]). A silent byzantine leader (SPEC §3c) sends no heartbeat:
    its slot's ``was_lead_k`` is False (``raft_sparse.py:392-393``), so
    kernel KB gives its heartbeats no edge and kernel KH does not process
    its slot."""
    B, N, L = log_term.shape
    E = min(cfg.max_entries, L)
    dev = term.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    # P3a: the one-slot append is a scatter into the logs, in place.
    can_prop = lead & (log_len < E)
    prop_val = bitcast_i32(rng.random_u32_plain(seed, rng.STREAM_VALUE, r, 0,
                                                idx))
    pos = log_len.clamp(max=L - 1).to(torch.int64)[..., None]
    log_term.scatter_(2, pos, torch.where(can_prop, term,
                                          log_term.gather(2, pos)[..., 0]
                                          )[..., None])
    log_val.scatter_(2, pos, torch.where(can_prop, prop_val,
                                         log_val.gather(2, pos)[..., 0]
                                         )[..., None])
    log_len = log_len + can_prop.to(torch.int32)
    # P3b: the tracked senders' snapshot.
    bi = torch.arange(B, device=dev)[:, None]
    lid = lead_id.clamp(0, N - 1).to(torch.int64)
    was_lead_k = (lead_id >= 0) & lead.gather(1, lid)
    if cfg.byz == BYZ_SILENT:
        was_lead_k = was_lead_k & (lead_id < cfg.n_honest)
    hb_ids = torch.where(was_lead_k, lead_id, NONE)
    return (log_len, was_lead_k, hb_ids, term.gather(1, lid),
            log_len.gather(1, lid), commit.gather(1, lid), log_term[bi, lid],
            log_val[bi, lid])


def propose(cfg: Config, seed, r: int, lead, term, log_term, log_val,
            log_len, commit, lead_id):
    """Kernel KI: same arguments, in-place log update and result as
    :func:`propose_plain`, which it runs for CPU tensors; for CUDA tensors
    it launches ``csrc/propose.cu`` (a thread per node appends with the
    value drawn inline, then a block per slot snapshots the leader's row
    after the append; with silent byzantine nodes the snapshot leaves
    their slots unsent)."""
    if term.device.type == "cpu":
        return propose_plain(cfg, seed, r, lead, term, log_term, log_val,
                             log_len, commit, lead_id)
    from .. import _build
    B, N, L = log_term.shape
    A = lead_id.shape[1]
    dev = term.device
    check_all(dev, (seed, torch.uint32, (B,)), (lead, torch.bool, (B, N)),
              *((t, torch.int32, (B, N)) for t in (term, log_len, commit)),
              (log_term, torch.int32, (B, N, L)),
              (log_val, torch.int32, (B, N, L)),
              (lead_id, torch.int32, (B, A)))
    new_len = torch.empty_like(log_len)
    was_lead_k = torch.empty((B, A), dtype=torch.bool, device=dev)
    small = [torch.empty((B, A), dtype=torch.int32, device=dev)
             for _ in range(4)]                 # hb_ids, s_term, s_len, s_commit
    rows = [torch.empty((B, A, L), dtype=torch.int32, device=dev)
            for _ in range(2)]                  # s_logt, s_logv
    _build.launch("propose", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  *(t.data_ptr() for t in (
                      lead, term, log_term, log_val, log_len, commit, lead_id,
                      new_len, was_lead_k, *small, *rows)),
                  B, N, A, L, min(cfg.max_entries, L), cfg.byz,
                  cfg.n_byzantine)
    propose.launches += 1
    return (new_len, was_lead_k, *small, *rows)


propose.launches = 0


# --- KK: telemetry and flight recorder -------------------------------------------

def telemetry_plain(cfg: Config, r: int, cand_ids, win, timer_in, has_l,
                    apply_, commit_in, commit, role, log_len, down, t,
                    w=None, lat=None, atk=None) -> None:
    """Plain version of KK: the round's RAFT_TELEMETRY counters, per sweep,
    added into the [B, K] i32 accumulator ``t`` and, with the flight
    recorder (``w`` [B, n_windows, K] and ``lat`` [B, 2, N_BUCKETS], both
    or neither), into the window ``r // cfg.telemetry_window`` of ``w``,
    and the round's RAFT_LATENCY histograms into ``lat``: the round-entry
    ``timer_in`` + 1 of each winner of ``win`` (candidate slots of
    ``cand_ids``), and ``log_len - commit`` of each leader not ``down``
    (the mask at the round's end). The counters: winners, ``apply_``,
    ``has_l & ~apply_``, the sum of ``commit - commit_in``, attack_rounds
    from the round's SPEC §A.3 attack word ``atk`` ([B] int32, KE's; 0
    without an attack), and 0 for the aggregation tail (kernel KAL adds it
    on a §9 switch round); the crash tail is kernel KAH's to add. Updates
    ``t``, ``w`` and ``lat`` in place."""
    N = timer_in.shape[1]
    vec = torch.zeros_like(t)
    vec[:, 0] = win.sum(1, dtype=torch.int32)
    vec[:, 1] = apply_.sum(1, dtype=torch.int32)
    vec[:, 2] = (has_l & ~apply_).sum(1, dtype=torch.int32)
    vec[:, 3] = (commit - commit_in).sum(1, dtype=torch.int32)
    if atk is not None:
        vec[:, 4] = (atk != 0).to(torch.int32)
    hists = ()
    if w is not None:
        cid = cand_ids.clamp(0, N - 1).to(torch.int64)
        hists = (bucket_counts_plain(timer_in.gather(1, cid) + 1, win),
                 bucket_counts_plain(log_len - commit,
                                     (role == ROLE_L) & ~down))
    add_plain(cfg, r, vec, t, w, lat, hists)


def telemetry(cfg: Config, r: int, cand_ids, win, timer_in, has_l, apply_,
              commit_in, commit, role, log_len, down, t, w=None,
              lat=None, atk=None) -> None:
    """Kernel KK: same arguments and in-place updates as
    :func:`telemetry_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/telemetry.cu`` (a thread per node, warp and
    block partial counts, then integer atomics into the accumulators; its
    ATTACK instance with ``atk``)."""
    check_recorder(cfg, w, lat)
    if t.device.type == "cpu":
        return telemetry_plain(cfg, r, cand_ids, win, timer_in, has_l,
                               apply_, commit_in, commit, role, log_len, down,
                               t, w, lat, atk)
    from .. import _build
    B, N = timer_in.shape
    A = cand_ids.shape[1]
    K = len(RAFT_TELEMETRY)
    dev = t.device
    check_all(dev, (cand_ids, torch.int32, (B, A)), (win, torch.bool, (B, A)),
              *((x, torch.int32, (B, N)) for x in (
                  timer_in, commit_in, commit, role, log_len)),
              *((x, torch.bool, (B, N)) for x in (has_l, apply_, down)),
              (t, torch.int32, (B, K)),
              *(() if atk is None else ((atk, torch.int32, (B,)),)))
    window, n_windows = window_of(cfg, r, t, w, lat, len(RAFT_LATENCY))
    _build.launch("telemetry", *(x.data_ptr() for x in (
        cand_ids, win, timer_in, has_l, apply_, commit_in, commit, role,
        log_len, down, t)), *(None if x is None else x.data_ptr()
                              for x in (w, lat)),
        B, N, A, K, window, n_windows,
        None if atk is None else atk.data_ptr())
    telemetry.launches += 1


telemetry.launches = 0


# --- the round ----------------------------------------------------------------

def raft_sparse_round(cfg: Config, st: RaftSparseState, r: int, *,
                      telem=None, flight=None) -> RaftSparseState:
    """One SPEC §3 round under the §3b cap, phase by phase as
    ``consensus_tpu/engines/raft_sparse.py`` ``raft_sparse_round``: a
    sequence of kernel launches and nothing else. Updates
    ``st.log_term``/``st.log_val`` in place.

    ``telem`` ([B, K] i32, the run's counter totals) switches on the
    round's telemetry, as the JAX round's ``telem=True``, and ``flight``
    (the window ring and latency buckets, a pair of [B, n_windows, K] and
    [B, 2, N_BUCKETS] i32) its flight recorder, as ``flight=True``; kernel
    KK adds the round's counters into them in place.

    With ``cfg.crash_on`` (SPEC §6c) the round first launches KAH, which
    gives the new down mask, the flags the CRASH instances of KB, KE, KF
    and KH read, and, with telemetry, the crash tail of the counters.
    Under a SPEC §A.3 attack KE also gives the round's attack word, which
    KB's and KK's ATTACK instances read.

    In a knob batch ``cfg`` is a view (``core/knobs.py``): the wrappers
    pass the base's cutoffs and the view's table, and the KNOBS instances
    of KAH, KAL, KE and KB read each lane's drop, partition, churn, crash,
    recover and attack cutoffs and its target; KC, KF, KG, KI, KD and KH
    read no knob, and KK only KE's attack word."""
    B, N = st.term.shape
    A = cfg.max_active
    seed = st.seed
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

    log_term, log_val = st.log_term, st.log_val

    # ---- SPEC §9 switch (KAL): the round's aggregator table and uplinks,
    # which KB's SWITCH instance reads for P2c's responses.
    switch = None
    if cfg.switch_on:
        agg = agg_step(cfg, seed, r, crash[0] if crash else None,
                       RAFT_TELEMETRY, telem, flight)
        switch = (agg.up[:, 0], agg.tab)

    # ---- P0 churn, P1 candidacy (KE), after the §6c reset; under a SPEC
    # §A.3 attack also the round's attack word.
    (term, role, voted_for, timer, timeout, reset, own_lterm,
     cand_mask, *atk) = candidacy(cfg, seed, r, st.term, st.role,
                                  st.voted_for, st.timer, st.timeout,
                                  log_term, st.log_len, *crash)
    # KB's ATTACK instance: the sticky target's inbound edges on every call,
    # every edge of P2's two calls under an elect jam. In a knob batch the
    # cutoffs and the sticky target passed are the base's, and KB's KNOBS
    # instances read each lane's from the view's table.
    base = knobs.static(cfg)
    sticky = (atk[0], base.attack_target) \
        if cfg.attack_mode == ATTACK_STICKY else None
    jam = (atk[0], -1) if cfg.attack_mode == ATTACK_ELECT else sticky

    def dedge(ids, ids_are_src, attack=None, sw=None):
        # The optional arguments by position, without trailing unset ones,
        # as the flat path always called KB.
        extra = [crash[0] if crash else None, attack, sw,
                 knobs.table_of(cfg)]
        while extra and extra[-1] is None:
            extra.pop()
        return delivery_edges(seed, r, ids, N, base.drop_cutoff,
                              base.partition_cutoff, ids_are_src,
                              cfg.max_delay_rounds, *extra)

    # ---- P2 election over the active candidate set (SPEC §3b; KC, KB, KF),
    # with the leader mask that KC and KI read.
    cand_ids = top_active(cand_mask, term, A)                   # [B, A]
    del_cj = dedge(cand_ids, True, jam)                         # [B, A, N]
    del_jc = dedge(cand_ids, False, jam, switch)                # [B, N, A]
    term, role, voted_for, timer, timeout, reset, lead, win = elect(
        cfg, seed, cand_ids, del_cj, del_jc, term, role, voted_for, timer,
        timeout, reset, st.log_len, own_lterm, *crash)

    # ---- Tracked-leader slot lifecycle, with P3a's self-match (KC, KG).
    lead_id = top_active(lead, term, A)                         # [B, A]
    lead_match, lead_next = slots(cfg, lead_id, st.lead_id, st.lead_match,
                                  st.lead_next, role, st.log_len)

    # ---- P3a propose (every leader: local append), P3b snapshot (KI).
    (log_len, was_lead_k, hb_ids, s_term, s_len, s_commit, s_logt,
     s_logv) = propose(cfg, seed, r, lead, term, log_term, log_val,
                       st.log_len, st.commit, lead_id)

    # ---- P3c receivers and apply (KB, KD).
    del_lj = dedge(hb_ids, True, sticky)                        # [B, A, N]
    (term, role, voted_for, timer, timeout, reset, kstar, has_l, apply_,
     log_len, commit) = append_entries(
        cfg, seed, del_lj, lead_id, s_term, term, role, voted_for, timer,
        timeout, reset, log_term, log_val, log_len, st.commit, lead_next,
        s_len, s_commit, s_logt, s_logv)

    # ---- P3d acks, P3e commit advance, P4 timers (KB, KH), in place.
    del_jl = dedge(hb_ids, False, sticky)                       # [B, N, A]
    acks_commit(cfg, seed, lead_id, was_lead_k, del_jl, has_l, kstar, apply_,
                log_len, log_term, term, role, voted_for, timeout, commit,
                lead_match, lead_next, timer, reset, *crash)

    # ---- Telemetry and flight recorder (KK), on the round's new down mask.
    if telem is not None:
        telemetry(cfg, r, cand_ids, win, st.timer, has_l, apply_, st.commit,
                  commit, role, log_len, down, telem,
                  *(flight if flight is not None else (None, None)), *atk)

    return RaftSparseState(seed, term, role, voted_for, log_term, log_val,
                           log_len, commit, timer, timeout, lead_id,
                           lead_match, lead_next, down)


def extract(st: RaftSparseState) -> dict[str, torch.Tensor]:
    """The leaves the decided-log digest and the tests read."""
    return {"commit": st.commit, "log_term": st.log_term,
            "log_val": st.log_val, "term": st.term, "role": st.role}
