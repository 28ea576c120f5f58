"""SPEC §B per-node view-synchronizer ops of the BFT engines: a copy of
``consensus_tpu/ops/viewsync.py``'s ``SYNC_TELEMETRY``, ``desync_skew``
and ``sync_counts`` (lines 30-70) on tensors with a leading lane axis.

:func:`desync_skew_plain` is the STREAM_DESYNC timer skew (K22), which the
plain versions of kernels KQ, KT and KAJ add; on the card those kernels
draw it inline (``ctt::desync_skew`` in ``csrc/rng.cuh``). Kernels
``pbft_telemetry`` (``engines/pbft.py``) and ``hotstuff_learn``
(``engines/hotstuff.py``) compute the telemetry tail on the card;
:func:`sync_counts_plain` is what their plain versions run.
"""
from __future__ import annotations

import torch

from ..core import rng

# The tail's counters, after the SAFETY tail of an engine's vector: the
# round's spread max - min of the honest live views (summed over rounds),
# the rounds with any spread, and the receivers whose view advanced by a
# delivered view-sync message (PBFT's P1 catch-up).
SYNC_TELEMETRY = ("view_spread_max", "desync_rounds", "sync_msgs_delivered")

I32_MIN = -2**31
I32_MAX = 2**31 - 1


def desync_skew_plain(seed, r: int, ids, desync_cut: int,
                      max_skew: int) -> torch.Tensor:
    """SPEC §B timer skew of round ``r``, the port's copy of K22
    ``desync_skew`` (``consensus_tpu/ops/viewsync.py:40-53``): [B, N]
    int32, 0 where node id's activation draw (seed ^ STREAM_DESYNC, r, 0,
    id) is not below ``desync_cut``, else 1 + its depth draw (r, 1, id)
    mod ``max_skew``. ``seed`` is [B] uint32, ``desync_cut`` an int or, in
    a knob batch, each lane's [B, 1] column, and ``ids`` the [N] absolute
    node ids (a padded ladder lane draws for its padded ids too, as the
    JAX package's does). The draws are the plain Threefry's, never kernel
    KA's: the plain versions that call this also run on CUDA tensors when
    they are held against their kernels."""
    fire = rng.random_u32_plain(seed, rng.STREAM_DESYNC, r, 0, ids) \
        < desync_cut
    depth = 1 + rng.random_u32_plain(seed, rng.STREAM_DESYNC, r, 1, ids) \
        % max_skew
    return torch.where(fire, depth, 0).to(torch.int32)


def sync_counts_plain(view, mask, delivered) -> torch.Tensor:
    """The :data:`SYNC_TELEMETRY` tail of each lane: [B, 3] int32 from the
    end-of-round [B, N] int32 ``view``, the [B, N] bool ``mask`` of the
    honest live nodes whose disagreement counts (an empty mask reads as
    spread 0) and the [B, N] bool ``delivered`` caught-up flags. The
    spread wraps in int32 as the JAX package's does."""
    vmax = torch.where(mask, view, I32_MIN).amax(-1)
    vmin = torch.where(mask, view, I32_MAX).amin(-1)
    spread = torch.where(mask.any(-1), vmax - vmin, 0).to(torch.int32)
    return torch.stack([spread, (spread > 0).to(torch.int32),
                        delivered.sum(-1, dtype=torch.int32)], -1)
