"""The SPEC §B view-desync telemetry tail of the BFT engines: a copy of
``consensus_tpu/ops/viewsync.py``'s ``SYNC_TELEMETRY`` and ``sync_counts``
(lines 40-70) on tensors with a leading lane axis.

Kernel ``pbft_telemetry`` (``engines/pbft.py``) computes the same tail on
the card; :func:`sync_counts_plain` is what its plain version runs. The
timer-skew adversary ``desync_skew`` is not ported: the port rejects
``desync_rate > 0``.
"""
from __future__ import annotations

import torch

# The tail's counters, after the SAFETY tail of an engine's vector: the
# round's spread max - min of the honest live views (summed over rounds),
# the rounds with any spread, and the receivers whose view advanced by a
# delivered view-sync message (PBFT's P1 catch-up).
SYNC_TELEMETRY = ("view_spread_max", "desync_rounds", "sync_msgs_delivered")

I32_MIN = -2**31
I32_MAX = 2**31 - 1


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
