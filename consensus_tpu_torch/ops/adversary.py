"""Adversary draws of the Raft engines, and kernels KB and KL.

The counterparts of ``consensus_tpu/ops/adversary.py``'s ``draw``,
``cutoff``, ``bitcast_i32``, ``churn``, ``delayed_open``, ``delivery_edges``
and ``delivery``. Every decision is a pure counter function of (seed,
round, ids), so an edge's delivery here equals the JAX package's entry for
the same absolute (round, src, dst) ids, with or without the SPEC §A.2
delayed retransmission (``max_delay > 0``).

:func:`delivery_edges` is the wrapper of the hand-written CUDA kernel KB
(``csrc/delivery_edges.cu``), the capped engine's masks between a few ids
and all nodes; :func:`delivery` that of kernel KL (``csrc/delivery.cu``),
the dense engine's full [N, N] mask. On CPU tensors they run
:func:`delivery_edges_plain` and :func:`delivery_plain`.
"""
from __future__ import annotations

import torch

from ..core import rng


def draw(seed, stream: int, ctx, c0, c1) -> torch.Tensor:
    """Device-side Threefry draw over sweeps; see :func:`rng.random_u32`."""
    return rng.random_u32(seed, stream, ctx, c0, c1)


def cutoff(cut: int) -> int:
    """u32 probability cutoff (draw < cutoff <=> the event fires)."""
    return int(cut)


def bitcast_i32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret u32 draws (int64 in [0, 2**32)) as i32 payload values."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


# The zero tails of every engine's counter vector, copies of the JAX
# package's names: the §6c crash-recover adversary's
# (consensus_tpu/ops/adversary.py:96-98 CRASH_TELEMETRY), the §9 switch
# layer's (consensus_tpu/ops/aggregate.py:58-60 AGG_TELEMETRY) and the
# §7c safety invariants' of the BFT engines
# (consensus_tpu/ops/adversary.py:161-163 SAFETY_TELEMETRY). The port
# rejects the gates that make them count, so they stay 0, as the JAX
# package's crash_counts(), agg_counts() and safety_counts() give them
# on the flat path.
CRASH_TELEMETRY = ("crashes", "recoveries", "nodes_down")
AGG_TELEMETRY = ("agg_down_rounds", "stale_serves", "poisoned_serves")
SAFETY_TELEMETRY = ("forked_qc", "conflict_commits", "safety_violations")


def churn(seed, r: int, churn_cut: int, u32=rng.random_u32) -> torch.Tensor:
    """SPEC §2: [B] bool, True where the round's leader-churn event fires.
    ``u32`` draws the words (kernel KA unless a plain version says
    otherwise)."""
    return u32(seed, rng.STREAM_CHURN, r, 0, 0)[:, 0] < cutoff(churn_cut)


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
    twin, ``ctt::delayed_open`` in ``csrc/rng.cuh``, stops early)."""
    shape = torch.broadcast_shapes(useed.shape, i.shape, j.shape)
    out = torch.zeros(shape, dtype=torch.bool, device=useed.device)
    for d in range(1, min(max_delay, r) + 1):
        q = r - d
        out |= (rng.delivery_u32_plain(useed, q, i, j) < drop_cut) \
            & (rng.delay_u32_plain(useed, q, d, i, j) >= drop_cut)
    return out


def open_drop_plain(useed, r: int, i, j, drop_cut: int,
                    max_delay: int) -> torch.Tensor:
    """The drop leg of SPEC §2 with §A.2: the delivery mixer's draw of edge
    i -> j in round r is not below ``drop_cut``, or a dropped flight of the
    last ``max_delay`` rounds arrives now (:func:`delayed_open_plain`).
    Arguments as there."""
    ok = rng.delivery_u32_plain(useed, r, i, j) >= drop_cut
    if max_delay > 0:
        ok = ok | delayed_open_plain(useed, r, i, j, drop_cut, max_delay)
    return ok


def delivery_edges_plain(seed, r: int, ids, n: int, drop_cut: int,
                         part_cut: int, ids_are_src: bool,
                         max_delay: int = 0) -> torch.Tensor:
    """Plain version of KB: the SPEC §2 delivery mask between the [B, A]
    ids and all ``n`` node ids: [B, A, n] (ids send) when ``ids_are_src``,
    else [B, n, A] (ids receive), with the §A.2 retransmissions of the
    last ``max_delay`` rounds. Negative ids are masked-out lanes and give
    False."""
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
    return valid & open_drop & (same_side | ~part_active[:, :, None]) \
        & off_diag


def delivery_edges(seed, r: int, ids, n: int, drop_cut: int, part_cut: int,
                   ids_are_src: bool, max_delay: int = 0) -> torch.Tensor:
    """Kernel KB: same arguments and result as :func:`delivery_edges_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/delivery_edges.cu``."""
    if ids.device.type == "cpu":
        return delivery_edges_plain(seed, r, ids, n, drop_cut, part_cut,
                                    ids_are_src, max_delay)
    from .. import _build
    B, A = ids.shape
    _build.check(ids, torch.int32, ids.device)
    _build.check(seed, torch.uint32, ids.device, (B,))
    shape = (B, A, n) if ids_are_src else (B, n, A)
    out = torch.empty(shape, dtype=torch.bool, device=ids.device)
    _build.launch("delivery_edges", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  ids.data_ptr(), out.data_ptr(), B, A, n, int(drop_cut),
                  int(part_cut), int(ids_are_src), int(max_delay))
    delivery_edges.launches += 1
    return out


delivery_edges.launches = 0


def delivery_plain(seed, r: int, n: int, drop_cut: int, part_cut: int,
                   max_delay: int = 0) -> torch.Tensor:
    """Plain version of KL: the SPEC §2 delivery mask of round ``r`` over
    all ``n`` nodes of each sweep of ``seed`` ([B] uint32): [B, n, n] bool,
    [b, i, j] True iff a message i -> j is delivered. The edge draw with
    the §A.2 retransmissions of the last ``max_delay`` rounds, the round's
    bipartition and the empty diagonal of the JAX package's ``delivery``,
    built from the same mixer and Threefry draws as
    :func:`delivery_edges_plain`."""
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
    return open_drop & (same_side | ~part_active[:, :, None]) & off_diag


def delivery(seed, r: int, n: int, drop_cut: int, part_cut: int,
             max_delay: int = 0) -> torch.Tensor:
    """Kernel KL: same arguments and result as :func:`delivery_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/delivery.cu`` (with a partition, a thread per node first draws
    its side; then a thread per four edges of a row)."""
    if seed.device.type == "cpu":
        return delivery_plain(seed, r, n, drop_cut, part_cut, max_delay)
    from .. import _build
    B = seed.shape[0]
    _build.check(seed, torch.uint32, seed.device, (B,))
    out = torch.empty((B, n, n), dtype=torch.bool, device=seed.device)
    side = torch.empty((B, n), dtype=torch.uint8, device=seed.device)
    _build.launch("delivery", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  out.data_ptr(), side.data_ptr(), B, n, int(drop_cut),
                  int(part_cut), int(max_delay))
    delivery.launches += 1
    return out


delivery.launches = 0
