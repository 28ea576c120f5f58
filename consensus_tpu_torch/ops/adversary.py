"""Adversary draws of the engines, and kernels KB, KL, KAH and KAI.

The counterparts of ``consensus_tpu/ops/adversary.py``'s ``draw``,
``cutoff``, ``bitcast_i32``, ``churn``, ``slot_missed``, ``attack_fires``
(and ``engines/dpos.py``'s §A.4 draw), ``delayed_open``, ``delivery_edges``,
``delivery``, ``crash_transition``, ``freeze_down`` and ``crash_counts``.
The cutoffs are ints, or in a knob batch (``core/knobs.py``) each lane's
[B, 1] column, which the plain versions broadcast against their draws.
Every decision is a pure counter function of (seed, round, ids), so an
edge's delivery here equals the JAX package's entry for the same absolute
(round, src, dst) ids, with or without the SPEC §A.2 delayed
retransmission (``max_delay > 0``) and the SPEC §6c down mask.

:func:`delivery_edges` is the wrapper of the hand-written CUDA kernel KB
(``csrc/delivery_edges.cu``), the capped engine's masks between a few ids
and all nodes; :func:`delivery` that of kernel KL (``csrc/delivery.cu``),
the dense engines' full [N, N] mask; :func:`crash_transition` that of
kernel KAH (``csrc/crash_transition.cu``), the round's SPEC §6c down mask and flags;
:func:`freeze_down` that of kernel KAI (``csrc/freeze_down.cu``), the §6c
freeze of the PBFT engines. On CPU tensors they run their ``_plain``
versions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import knobs, rng
from ..core.knobs import N_KNOBS, signed_target, target_role
from ..core.knobs import at as knobs_at
from ..core.knobs import column as knob_column


def draw(seed, stream: int, ctx, c0, c1) -> torch.Tensor:
    """Device-side Threefry draw over sweeps; see :func:`rng.random_u32`."""
    return rng.random_u32(seed, stream, ctx, c0, c1)


def cutoff(cut):
    """u32 probability cutoff (draw < cutoff <=> the event fires): an int,
    or a knob batch's per-lane [B, 1] column (``core/knobs.py``) as it
    is."""
    return cut if isinstance(cut, torch.Tensor) else int(cut)


def bitcast_i32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret u32 draws (int64 in [0, 2**32)) as i32 payload values."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


# The tails of every engine's counter vector, copies of the JAX package's
# names: the §6c crash-recover adversary's
# (consensus_tpu/ops/adversary.py:96-98 CRASH_TELEMETRY), the §9 switch
# layer's (consensus_tpu/ops/aggregate.py:58-60 AGG_TELEMETRY) and the
# §7c safety invariants' of the BFT engines
# (consensus_tpu/ops/adversary.py:161-163 SAFETY_TELEMETRY). The crash tail
# counts where crash_prob > 0 (kernel KAH adds it) and is 0 on the flat
# path; the safety tail counts under equivocating byzantine nodes (dense
# PBFT and HotStuff, :func:`safety_counts_plain`); the aggregation tail
# counts on a §9 switch round (kernel KAL adds it, ``ops/aggregate.py``)
# and is 0 on the flat path, as the JAX package's agg_counts() gives it.
CRASH_TELEMETRY = ("crashes", "recoveries", "nodes_down")
AGG_TELEMETRY = ("agg_down_rounds", "stale_serves", "poisoned_serves")
SAFETY_TELEMETRY = ("forked_qc", "conflict_commits", "safety_violations")


def safety_counts_plain(forked, conflicts) -> torch.Tensor:
    """The :data:`SAFETY_TELEMETRY` tail of each lane, a copy of
    ``consensus_tpu/ops/adversary.py:166-175`` ``safety_counts`` with a
    leading lane axis: [B, 3] int32 from ``forked`` and ``conflicts``
    ([B, ...] masks or counts, summed over the rest): forked_qc,
    conflict_commits, and safety_violations = conflict_commits > 0, so the
    flag never disagrees with the count. Without byzantine equivocation
    the engines leave the tail at 0, as the JAX package's
    ``safety_counts()`` gives it."""
    nf = forked.to(torch.int32).reshape(forked.shape[0], -1).sum(
        1, dtype=torch.int32)
    nc = conflicts.to(torch.int32).reshape(conflicts.shape[0], -1).sum(
        1, dtype=torch.int32)
    return torch.stack([nf, nc, (nc > 0).to(torch.int32)], 1)


class Byz(NamedTuple):
    """A round's SPEC §3c/§7c byzantine nodes, as the PBFT phase wrappers
    that take no Config take them: ``mode`` (``core/config.py`` BYZ_SILENT
    or BYZ_EQUIV), ``nb`` (n_byzantine: node i of a lane of ``n_real``
    nodes is honest when i < n_real - nb), and the round's ``seed`` ([B]
    uint32) and ``r``, which key the equivocators' STREAM_EQUIV stances."""
    mode: int
    nb: int
    seed: torch.Tensor
    r: int


def byz_of(cfg, seed, r: int) -> "Byz | None":
    """The round's :class:`Byz`, None without byzantine nodes (the flat
    instances)."""
    return None if cfg.byz == 0 else Byz(cfg.byz, cfg.n_byzantine, seed, r)


def equiv_stance_plain(seed, r: int, src, dst) -> torch.Tensor:
    """SPEC §6/§7c: byzantine node ``src``'s stance toward receiver
    ``dst`` in round ``r``, ``draw(seed ^ STREAM_EQUIV, r, src, dst) & 1``
    (``consensus_tpu/engines/pbft.py:180-183``, ``hotstuff.py:329-332``)
    as bool. ``seed`` ([B] uint32) is shaped [B, 1, ..., 1] to the rank
    of ``src`` and ``dst``, int tensors that broadcast (a lane axis of 1
    or B in front)."""
    src, dst = torch.as_tensor(src), torch.as_tensor(dst)
    rank = max(src.dim(), dst.dim(), 1)
    k0 = (rng.as_u32(seed) ^ rng.STREAM_EQUIV).reshape(-1, *(1,) * (rank - 1))
    return (rng.threefry2x32_plain(k0, int(r) & 0xFFFFFFFF, rng.as_u32(src),
                                   rng.as_u32(dst)) & 1).to(torch.bool)


def churn(seed, r: int, churn_cut: int, u32=rng.random_u32) -> torch.Tensor:
    """SPEC §2: [B] bool, True where the round's leader-churn event fires
    (``churn_cut`` an int or a per-lane [B, 1] column). ``u32`` draws the
    words (kernel KA unless a plain version says otherwise)."""
    return (u32(seed, rng.STREAM_CHURN, r, 0, 0) < cutoff(churn_cut))[:, 0]


def slot_missed(seed, r: int, p, miss_cut: int,
                u32=rng.random_u32) -> torch.Tensor:
    """K13 ``slot_missed`` (``consensus_tpu/ops/adversary.py:206-213``),
    SPEC §A.1: [B] bool, True where round r's scheduled producer ``p`` ([B]
    int ids) misses its slot, one draw a (round, producer). ``u32`` as in
    :func:`churn`; the kernels draw it as ``ctt::slot_missed``
    (``csrc/rng.cuh``)."""
    return (u32(seed, rng.STREAM_SLOTMISS, r, 0, p.to(torch.int64)[:, None])
            < cutoff(miss_cut))[:, 0]


def suppressed(seed, r: int, window: int, p, suppress_cut: int,
               u32=rng.random_u32) -> torch.Tensor:
    """The SPEC §A.4 draw of ``consensus_tpu/engines/dpos.py:157-163``:
    [B] bool, True where producer ``p`` ([B] int ids) is suppressed in the
    window of round r, one draw a (r // ``window``, producer). ``u32`` as in
    :func:`churn`; the kernels draw it as ``ctt::suppressed``."""
    return (u32(seed, rng.STREAM_SUPPRESS, int(r) // int(window), 0,
                p.to(torch.int64)[:, None]) < cutoff(suppress_cut))[:, 0]


def attack_fires(seed, r: int, attack_cut: int,
                 u32=rng.random_u32) -> torch.Tensor:
    """K13 ``attack_fires`` (``consensus_tpu/ops/adversary.py:216-219``),
    SPEC §A.3: [B] bool, the round's targeted-attack activation. ``u32`` as
    in :func:`churn`; the kernels draw it as ``ctt::attack_fires``."""
    return (u32(seed, rng.STREAM_ATTACK, r, 0, 0) < cutoff(attack_cut))[:, 0]


def delayed_open_plain(useed, r: int, i, j, drop_cut: int,
                       max_delay: int) -> torch.Tensor:
    """Plain version of K13 ``delayed_open`` (``consensus_tpu/ops/
    adversary.py:38-57``), the SPEC §A.2 OR-term: True where a flight
    dropped on edge i -> j at some round q = r - d, d in 1..max_delay,
    arrives at round r. The base delivery draw at q dropped it and the
    retransmission draw (:func:`rng.delay_u32_plain`) survives the same
    cutoff. Rounds d > r do not exist (the JAX package's ``r >= d``
    guard). ``useed``, ``i`` and ``j`` are int64 tensors of u32 values
    that broadcast; every draw is made, as in the JAX package (the CUDA
    twin, ``ctt::delayed_open`` in ``csrc/rng.cuh``, stops early). In a
    knob batch ``drop_cut`` is each lane's [B, 1] column, compared at the
    draws' rank (``useed`` leads with the lane axis)."""
    shape = torch.broadcast_shapes(useed.shape, i.shape, j.shape)
    out = torch.zeros(shape, dtype=torch.bool, device=useed.device)
    cut = knobs.at(drop_cut, len(shape))
    for d in range(1, min(max_delay, r) + 1):
        q = r - d
        out |= (rng.delivery_u32_plain(useed, q, i, j) < cut) \
            & (rng.delay_u32_plain(useed, q, d, i, j) >= cut)
    return out


def open_drop_plain(useed, r: int, i, j, drop_cut: int,
                    max_delay: int) -> torch.Tensor:
    """The drop leg of SPEC §2 with §A.2: the delivery mixer's draw of edge
    i -> j in round r is not below ``drop_cut``, or a dropped flight of the
    last ``max_delay`` rounds arrives now (:func:`delayed_open_plain`).
    Arguments as there."""
    ok = rng.delivery_u32_plain(useed, r, i, j) >= knobs.at(
        drop_cut, max(useed.dim(), i.dim(), j.dim()))
    if max_delay > 0:
        ok = ok | delayed_open_plain(useed, r, i, j, drop_cut, max_delay)
    return ok


def delivery_edges_plain(seed, r: int, ids, n: int, drop_cut: int,
                         part_cut: int, ids_are_src: bool,
                         max_delay: int = 0, flags=None,
                         attack=None, switch=None,
                         knobs=None) -> torch.Tensor:
    """Plain version of KB: the SPEC §2 delivery mask between the [B, A]
    ids and all ``n`` node ids: [B, A, n] (ids send) when ``ids_are_src``,
    else [B, n, A] (ids receive), with the §A.2 retransmissions of the
    last ``max_delay`` rounds. Negative ids are masked-out lanes and give
    False. With the round's §6c ``flags`` ([B, n] uint8, from
    :func:`crash_transition`), an edge with a down end is not delivered
    (``consensus_tpu/engines/raft_sparse.py:192-195``). With a SPEC §A.3
    ``attack`` = (word, dst), the round's [B] int32 attack word of kernel
    KE and a receiver id, an edge is not delivered where the lane's word
    is set and its receiver is ``dst``, or any receiver when ``dst`` is -1
    (the sticky target's inbound edges; every P2 edge under an elect jam,
    ``raft_sparse.py:197-199, 276, 338-339``).

    With ``switch`` = (up, tab), kernel KAL's phase-0 uplink row ([B, n]
    bool, a down sender already cut) and [B, K] aggregator table (SPEC §9,
    ``ops/aggregate.py``), the mask is the responses' (ids receive only):
    node j reaches ids[k] when j != ids[k], j's uplink is open and its
    aggregator's downlink to ids[k] is open (``raft_sparse.py:301-334``:
    the two-hop ``up0[j] & down0[a(j), c]`` that the JAX round sums per
    candidate), with the crash and attack cuts above at the receiver.

    With ``knobs``, a knob batch's [B, 12] int64 table (``core/knobs.py``),
    each lane reads its drop and partition cutoffs and, under the sticky
    attack (``dst`` >= 0: the base's target), its target from its row in
    place of the arguments, as the kernel's KNOBS instances do. A lane's
    target is the int32 of its column (:func:`~consensus_tpu_torch.core.
    knobs.signed_target`), so one outside [0, n) jams no receiver; ``dst``
    = -1 stays the elect jam of every receiver."""
    if knobs is not None:
        drop_cut = knob_column(knobs, "drop_cutoff")
        part_cut = knob_column(knobs, "partition_cutoff")
        if attack is not None and attack[1] >= 0:
            attack = (attack[0], signed_target(knob_column(
                knobs, "attack_target")))
    if switch is not None:
        from .aggregate import resp_plain
        if ids_are_src:
            raise ValueError("the switch carries responses: ids receive")
        up, tab = switch
        out = resp_plain(seed, r, up, tab, n, 0, ids, drop_cut, part_cut,
                         max_delay)
        nodes = torch.arange(n, device=ids.device)[None, :, None]
        out = out & (nodes != ids[:, None, :])
        if flags is not None:
            upc = (flags & CRASH_DOWN) == 0
            out = out & upc.gather(1, ids.clamp(0, n - 1).to(torch.int64)
                                   )[:, None, :]
        if attack is not None:
            out = out & ~((attack[0] != 0)[:, None, None]
                          & _jammed(ids[:, None, :], attack[1]))
        return out
    nodes = torch.arange(n, dtype=torch.int32, device=ids.device)[None, :]
    if ids_are_src:
        src, dst = ids[:, :, None], nodes[:, None, :]
    else:
        src, dst = nodes[:, :, None], ids[:, None, :]
    valid = (src >= 0) & (dst >= 0)
    usrc, udst = rng.as_u32(src), rng.as_u32(dst)
    useed = rng.as_u32(seed)[:, None, None]
    open_drop = open_drop_plain(useed, r, usrc, udst, drop_cut, max_delay)
    part_active = rng.random_u32_plain(seed, rng.STREAM_PARTITION, r, 0, 0) \
        < part_cut                                           # [B, 1]
    side_s = rng.threefry2x32_plain(useed ^ rng.STREAM_PARTITION, r, 1,
                                    usrc) & 1
    side_d = rng.threefry2x32_plain(useed ^ rng.STREAM_PARTITION, r, 1,
                                    udst) & 1
    same_side = side_s == side_d
    off_diag = usrc != udst
    out = valid & open_drop & (same_side | ~part_active[:, :, None]) \
        & off_diag
    if flags is not None:
        up = (flags & CRASH_DOWN) == 0                       # [B, n]
        bi = torch.arange(ids.shape[0], device=ids.device)[:, None, None]
        up_s = up[bi, src.clamp(0, n - 1).to(torch.int64)]
        up_d = up[bi, dst.clamp(0, n - 1).to(torch.int64)]
        out = out & up_s & up_d
    if attack is not None:
        out = out & ~((attack[0] != 0)[:, None, None]
                      & _jammed(dst, attack[1]))
    return out


def _jammed(dst, dst_id):
    """Where an attack word cuts an edge into receiver ``dst`` (ids
    of rank 3 led by the lane axis, or broadcasting to it): every receiver
    for ``dst_id`` -1 (the elect jam), else the receiver ``dst_id``, an int
    or a knob batch's [B, 1] column of signed targets."""
    if isinstance(dst_id, torch.Tensor):
        return dst == dst_id.reshape(-1, 1, 1)
    if dst_id >= 0:
        return dst == dst_id
    return torch.ones_like(dst, dtype=torch.bool)


def delivery_edges(seed, r: int, ids, n: int, drop_cut: int, part_cut: int,
                   ids_are_src: bool, max_delay: int = 0, flags=None,
                   attack=None, switch=None, knobs=None) -> torch.Tensor:
    """Kernel KB: same arguments and result as :func:`delivery_edges_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/delivery_edges.cu`` (its CRASH instance with ``flags``, its
    ATTACK instance with ``attack``, its SWITCH instance with ``switch``,
    its KNOBS instances with ``knobs``, where the cutoff arguments and a
    sticky ``attack``'s target are the base's, which pick the instance and
    the attack, and each lane reads its own from the table)."""
    if ids.device.type == "cpu":
        return delivery_edges_plain(seed, r, ids, n, drop_cut, part_cut,
                                    ids_are_src, max_delay, flags, attack,
                                    switch, knobs)
    if switch is not None and ids_are_src:
        raise ValueError("the switch carries responses: ids receive")
    from .. import _build
    B, A = ids.shape
    _build.check(ids, torch.int32, ids.device)
    _build.check(seed, torch.uint32, ids.device, (B,))
    if flags is not None:
        _build.check(flags, torch.uint8, ids.device, (B, n))
    if attack is not None:
        _build.check(attack[0], torch.int32, ids.device, (B,))
    if switch is not None:
        _build.check(switch[0], torch.bool, ids.device, (B, n))
        _build.check(switch[1], torch.int32, ids.device)
        if switch[1].dim() != 2 or switch[1].shape[0] != B \
                or switch[0].stride(1) != 1 \
                or not 1 <= switch[1].shape[1] <= n:
            raise ValueError("switch = (up [B, n] with adjacent nodes, "
                             "tab [B, K]), 1 <= K <= n")
    if knobs is not None:
        _build.check(knobs, torch.int64, ids.device, (B, N_KNOBS))
    shape = (B, A, n) if ids_are_src else (B, n, A)
    out = torch.empty(shape, dtype=torch.bool, device=ids.device)
    _build.launch("delivery_edges", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  ids.data_ptr(), out.data_ptr(), B, A, n, int(drop_cut),
                  int(part_cut), int(ids_are_src), int(max_delay),
                  None if flags is None else flags.data_ptr(),
                  None if attack is None else attack[0].data_ptr(),
                  -1 if attack is None else int(attack[1]),
                  *((None, None, 0, 0) if switch is None else (
                      switch[0].data_ptr(), switch[1].data_ptr(),
                      switch[1].shape[1], switch[0].stride(0))),
                  None if knobs is None else knobs.data_ptr())
    delivery_edges.launches += 1
    delivery_edges.switch_launches += switch is not None
    delivery_edges.knob_launches += knobs is not None
    return out


delivery_edges.launches = 0
# Launches of its SWITCH instance (SPEC §9), also counted in ``launches``.
delivery_edges.switch_launches = 0
# Launches of its KNOBS instances (a knob batch), also counted in
# ``launches``.
delivery_edges.knob_launches = 0


# The Raft engines' leader role (engines/raft.py ROLE_L), which the SPEC
# §A.3 sticky cut reads.
RAFT_LEADER = 2


def delivery_plain(seed, r: int, n: int, drop_cut: int, part_cut: int,
                   max_delay: int = 0, flags=None, sticky=None,
                   knobs=None) -> torch.Tensor:
    """Plain version of KL: the SPEC §2 delivery mask of round ``r`` over
    all ``n`` nodes of each sweep of ``seed`` ([B] uint32): [B, n, n] bool,
    [b, i, j] True iff a message i -> j is delivered. The edge draw with
    the §A.2 retransmissions of the last ``max_delay`` rounds, the round's
    bipartition and the empty diagonal of the JAX package's ``delivery``,
    built from the same mixer and Threefry draws as
    :func:`delivery_edges_plain`. With the round's §6c ``flags`` ([B, n]
    uint8), rows and columns of down nodes are cut (``deliver & up[:, None]
    & up[None, :]`` of the dense engines). With the SPEC §A.3 ``sticky`` =
    (role, target, attack_cut), the round's input roles ([B, n] int32) of
    dense Raft, column ``target`` is cut in a lane whose round activation
    (:func:`attack_fires`) fires while the target leads
    (``consensus_tpu/engines/raft.py:241-253``). With ``knobs``, a knob
    batch's [B, 12] int64 table (``core/knobs.py``), each lane reads its
    drop, partition, attack cutoffs and target from its row in place of
    the arguments, as the kernel's KNOBS instances do (the target as
    :func:`~consensus_tpu_torch.core.knobs.target_role` reads it)."""
    if knobs is not None:
        drop_cut = knob_column(knobs, "drop_cutoff")
        part_cut = knob_column(knobs, "partition_cutoff")
        if sticky is not None:
            sticky = (sticky[0], signed_target(knob_column(
                knobs, "attack_target")), knob_column(knobs, "attack_cutoff"))
    ids = torch.arange(n, dtype=torch.int64, device=seed.device)
    useed = rng.as_u32(seed)[:, None, None]
    open_drop = open_drop_plain(useed, r, ids[:, None], ids[None, :],
                                drop_cut, max_delay)
    part_active = rng.random_u32_plain(seed, rng.STREAM_PARTITION, r, 0, 0) \
        < part_cut                                           # [B, 1]
    side = rng.threefry2x32_plain(useed[:, 0] ^ rng.STREAM_PARTITION, r, 1,
                                  ids) & 1                   # [B, n]
    same_side = side[:, :, None] == side[:, None, :]
    off_diag = ids[:, None] != ids[None, :]
    out = open_drop & (same_side | ~part_active[:, :, None]) & off_diag
    if flags is not None:
        up = (flags & CRASH_DOWN) == 0
        out = out & up[:, :, None] & up[:, None, :]
    if sticky is not None:
        role, tgt, attack_cut = sticky
        act = attack_fires(seed, r, attack_cut, rng.random_u32_plain) \
            & (target_role(role, tgt) == RAFT_LEADER)
        col = (ids == knobs_at(tgt, 2)).reshape(-1, 1, n)    # [B | 1, 1, n]
        out = out & ~(act[:, None, None] & col)
    return out


def delivery_args(cfg, flags=None, sticky=None) -> tuple:
    """The arguments of the round's KL launch after (seed, r, n), as an
    engine passes them: the static cutoffs of ``cfg`` (its base's in a knob
    batch, ``core/knobs.py``), its delay depth, then the round's §6c
    ``flags``, §A.3 ``sticky`` triple and a view's knob table where given,
    by position and without trailing unset ones, as the flat path always
    called it."""
    base = knobs.static(cfg)
    extra = [flags, sticky, knobs.table_of(cfg)]
    while extra and extra[-1] is None:
        extra.pop()
    return (base.drop_cutoff, base.partition_cutoff, cfg.max_delay_rounds,
            *extra)


def delivery(seed, r: int, n: int, drop_cut: int, part_cut: int,
             max_delay: int = 0, flags=None, sticky=None,
             knobs=None) -> torch.Tensor:
    """Kernel KL: same arguments and result as :func:`delivery_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/delivery.cu`` (with a partition, a thread per node first draws
    its side; then a thread per four edges of a row; its CRASH instance
    with ``flags``, its STICKY instance with ``sticky``, its KNOBS
    instances with ``knobs``, where the cutoff and target arguments are the
    base's, which pick the launches, and each lane reads its own from the
    table)."""
    if seed.device.type == "cpu":
        return delivery_plain(seed, r, n, drop_cut, part_cut, max_delay,
                              flags, sticky, knobs)
    from .. import _build
    B = seed.shape[0]
    _build.check(seed, torch.uint32, seed.device, (B,))
    if flags is not None:
        _build.check(flags, torch.uint8, seed.device, (B, n))
    if sticky is not None:
        _build.check(sticky[0], torch.int32, seed.device, (B, n))
    if knobs is not None:
        _build.check(knobs, torch.int64, seed.device, (B, N_KNOBS))
    out = torch.empty((B, n, n), dtype=torch.bool, device=seed.device)
    side = torch.empty((B, n), dtype=torch.uint8, device=seed.device)
    _build.launch("delivery", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  out.data_ptr(), side.data_ptr(), B, n, int(drop_cut),
                  int(part_cut), int(max_delay),
                  None if flags is None else flags.data_ptr(),
                  *((None, 0, 0) if sticky is None else (
                      sticky[0].data_ptr(), int(sticky[1]), int(sticky[2]))),
                  None if knobs is None else knobs.data_ptr())
    delivery.launches += 1
    delivery.knob_launches += knobs is not None
    return out


delivery.launches = 0
# Launches of its KNOBS instances (a knob batch), also counted in
# ``launches``.
delivery.knob_launches = 0


# --- KAH: the SPEC §6c crash transition ----------------------------------------

# The bits of the per-node flag word KAH writes: down at the round's end
# (the new mask, applied in the same round), recovered this round, crashed
# this round. A node may recover and crash again in one round: both bits.
CRASH_DOWN, CRASH_REC, CRASH_NEW = 1, 2, 4


def crash_counts_plain(crashed, rec, down) -> torch.Tensor:
    """The port's copy of K13 ``crash_counts`` (``consensus_tpu/ops/
    adversary.py:143-152``): the :data:`CRASH_TELEMETRY` tail of each lane,
    (crashes, recoveries, nodes_down), [B, 3] int32."""
    return torch.stack([m.sum(1, dtype=torch.int32)
                        for m in (crashed, rec, down)], 1)


def crash_transition_plain(seed, r: int, down, crash_cut: int,
                           recover_cut: int, max_crashed: int, t=None,
                           w=None, col: int = 0, window: int = 0,
                           knobs=None):
    """Plain version of KAH: the port's copy of K13 ``crash_transition``
    (``consensus_tpu/ops/adversary.py:101-130``) on each lane of ``seed``
    ([B] uint32) and ``down`` ([B, N] bool). A down node recovers where its
    draw (STREAM_CRASH, round r, c0 = 1, node) is below ``recover_cut``; a
    node up after the recoveries crashes where its draw with c0 = 0 is
    below ``crash_cut``; with ``max_crashed > 0`` only the would-be
    crashers whose ascending-id rank, added to the count still down, stays
    within ``max_crashed`` crash. Returns ``(down', flags)``: the new [B,
    N] bool mask and the [B, N] uint8 flag word (CRASH_DOWN, CRASH_REC,
    CRASH_NEW). With the run's counter totals ``t`` ([B, K] int32), adds
    :func:`crash_counts_plain` into columns ``col .. col + 2`` of it and,
    with the window ring ``w``, into window ``window`` of ``w``, in
    place. In a knob batch the cutoffs are each lane's [B, 1] columns
    (``core/knobs.py``); ``knobs``, the [B, 12] table the kernel's KNOBS
    instance reads instead, is not read here."""
    N = down.shape[1]
    idx = torch.arange(N, dtype=torch.int32, device=down.device)
    rec = down & (rng.random_u32_plain(seed, rng.STREAM_CRASH, r, 1, idx)
                  < recover_cut)
    still = down & ~rec
    crashed = ~still & (rng.random_u32_plain(seed, rng.STREAM_CRASH, r, 0,
                                             idx) < crash_cut)
    if max_crashed > 0:
        base = still.sum(1, keepdim=True, dtype=torch.int64)
        rank = crashed.to(torch.int64).cumsum(1)
        crashed = crashed & (base + rank <= max_crashed)
    new = still | crashed
    flags = (new.to(torch.uint8) * CRASH_DOWN + rec.to(torch.uint8)
             * CRASH_REC + crashed.to(torch.uint8) * CRASH_NEW)
    if t is not None:
        counts = crash_counts_plain(crashed, rec, new)
        t[:, col:col + 3] += counts
        if w is not None:
            w[:, window, col:col + 3] += counts
    return new, flags


def crash_transition(seed, r: int, down, crash_cut: int, recover_cut: int,
                     max_crashed: int, t=None, w=None, col: int = 0,
                     window: int = 0, knobs=None):
    """Kernel KAH: same arguments, in-place additions and result as
    :func:`crash_transition_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/crash_transition.cu`` (a thread per node;
    with ``max_crashed > 0`` two launches over tiles of 1 024 nodes: the
    tiles' counts, then each tile's block scan ranks its would-be crashers
    in ascending id order on top of the tiles before it). With ``knobs``,
    a knob batch's [B, 12] int64 table (``core/knobs.py``), its KNOBS
    instance reads each lane's cutoffs from the table's row and the
    cutoff arguments are not read."""
    if down.device.type == "cpu":
        return crash_transition_plain(seed, r, down, crash_cut, recover_cut,
                                      max_crashed, t, w, col, window, knobs)
    from .. import _build
    B, N = down.shape
    _build.check(seed, torch.uint32, down.device, (B,))
    _build.check(down, torch.bool, down.device, (B, N))
    K = 0
    if t is not None:
        K = t.shape[1]
        _build.check(t, torch.int32, down.device, (B, K))
        if not 0 <= col <= K - 3:
            raise ValueError(f"crash tail at column {col} of {K}")
        if w is not None:
            _build.check(w, torch.int32, down.device, (B, w.shape[1], K))
            if not 0 <= window < w.shape[1]:
                raise ValueError(f"window {window} of {w.shape[1]}")
    new = torch.empty_like(down)
    flags = torch.empty((B, N), dtype=torch.uint8, device=down.device)
    tiles = torch.empty((B, 2, -(-N // 1024)), dtype=torch.int32,
                        device=down.device) if max_crashed > 0 else None
    cuts = (0, 0)
    if knobs is None:
        cuts = (int(crash_cut), int(recover_cut))
    else:
        _build.check(knobs, torch.int64, down.device, (B, N_KNOBS))
    _build.launch("crash_transition", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  down.data_ptr(), new.data_ptr(), flags.data_ptr(),
                  *cuts, int(max_crashed),
                  None if t is None else t.data_ptr(),
                  None if w is None else w.data_ptr(),
                  None if tiles is None else tiles.data_ptr(), B, N, K,
                  int(col), int(window), 0 if w is None else w.shape[1],
                  None if knobs is None else knobs.data_ptr())
    crash_transition.launches += 1
    crash_transition.knob_launches += knobs is not None
    return new, flags


crash_transition.launches = 0
# Launches of its KNOBS instance (a knob batch), also counted in
# ``launches``.
crash_transition.knob_launches = 0


def crash_step(cfg, seed, r: int, down, names, telem=None, flight=None):
    """The round's KAH launch as an engine calls it: ``cfg``'s cutoffs and
    cap, the crash tail at ``names.index("crashes")`` of the engine's
    counter names, with the totals ``telem`` and the recorder ``flight``
    (window ring, latency buckets) where given; with a knob batch's view
    (``core/knobs.py``), each lane's cutoffs and the view's table."""
    w = None if flight is None else flight[0]
    window = 0 if w is None else r // cfg.telemetry_window
    return crash_transition(seed, r, down, cfg.crash_cutoff,
                            cfg.recover_cutoff, cfg.max_crashed, telem, w,
                            names.index("crashes"), window,
                            knobs.table_of(cfg))


# --- KAI: the SPEC §6c freeze of the PBFT engines --------------------------------

# The most leaves one freeze_down launch restores.
MAX_FROZEN = 8


def freeze_down_plain(flags, leaves) -> None:
    """Plain version of KAI, the port's K13 ``freeze_down``
    (``consensus_tpu/ops/adversary.py:133-140``): for each ``(dst, src,
    reset)`` of ``leaves``
    ([B, N, ...] tensors, ``dst`` and ``src`` of one shape and dtype), the
    rows of the nodes down at the round's end (``flags & CRASH_DOWN``)
    take ``src``'s, or 0 where ``reset`` and the node recovered this round
    (its volatile reset), in place: ``where(down, frozen, new)`` with the
    frozen leaves read off the round's input state."""
    down = (flags & CRASH_DOWN) != 0
    rec = (flags & CRASH_REC) != 0
    for dst, src, reset in leaves:
        shape = down.shape + (1,) * (dst.dim() - 2)
        val = torch.where(rec.reshape(shape), torch.zeros_like(src), src) \
            if reset else src
        dst.copy_(torch.where(down.reshape(shape), val, dst))


def freeze_down(flags, leaves) -> None:
    """Kernel KAI: same arguments and in-place update as
    :func:`freeze_down_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/freeze_down.cu`` (a thread per 16, 8, 4 or
    1 bytes of each leaf's rows; a down node's threads copy its rows)."""
    if flags.device.type == "cpu":
        return freeze_down_plain(flags, leaves)
    from .. import _build
    B, N = flags.shape
    if not 1 <= len(leaves) <= MAX_FROZEN:
        raise ValueError(f"freeze_down takes 1 to {MAX_FROZEN} leaves")
    _build.check(flags, torch.uint8, flags.device, (B, N))
    ptrs, sizes, resets = [], [], 0
    for k, (dst, src, reset) in enumerate(leaves):
        _build.check(dst, dst.dtype, flags.device)
        _build.check(src, dst.dtype, flags.device, tuple(dst.shape))
        if tuple(dst.shape[:2]) != (B, N):
            raise ValueError("a frozen leaf is [B, N, ...]")
        ptrs += [dst.data_ptr(), src.data_ptr()]
        sizes.append(dst[0, 0].numel() * dst.element_size())
        resets |= int(bool(reset)) << k
    pad = MAX_FROZEN - len(leaves)
    _build.launch("freeze_down", flags.data_ptr(), *ptrs, *([None] * 2 * pad),
                  *sizes, *([0] * pad), resets, B, N)
    freeze_down.launches += 1


freeze_down.launches = 0
