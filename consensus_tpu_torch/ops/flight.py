"""Flight-recorder buckets: a copy of ``consensus_tpu/ops/flight.py``.

Latency observations are bucketed into ``N_BUCKETS`` power-of-two buckets:
bucket 0 holds values <= 0, bucket i (1 <= i <= 14) holds [2^(i-1), 2^i),
and the last bucket holds values >= 2^14. Integer compares only. The
telemetry kernels (KK, KP, KAA-KAC) bucket the same way on the card;
:func:`bucket_counts_plain` is what their plain versions run, and
:func:`add_plain` how they add a round into the run's accumulators.
"""
from __future__ import annotations

import torch

N_BUCKETS = 16
# Lower-inclusive bucket edges: (0, 1, 2, 4, ..., 2^14).
BUCKET_LO = (0,) + tuple(2 ** i for i in range(N_BUCKETS - 1))


def bucket_counts_plain(values, mask, dim: int = -1) -> torch.Tensor:
    """Histogram of the i32 ``values`` where ``mask`` over dimension
    ``dim``: a [..., N_BUCKETS] i32 tensor (the leading dimensions are
    kept, so a [B, N] input gives one histogram a sweep). The same masked
    threshold counts and differences as the JAX package's
    ``bucket_counts``."""
    v, m = torch.broadcast_tensors(values.to(torch.int32), mask)
    total = m.sum(dim, dtype=torch.int32)
    ge = torch.stack([(m & (v >= t)).sum(dim, dtype=torch.int32)
                      for t in BUCKET_LO[1:]], -1)
    lo = torch.cat([total[..., None], ge], -1)
    hi = torch.cat([ge, torch.zeros_like(total)[..., None]], -1)
    return lo - hi


# --- the accumulators a telemetry kernel adds into ----------------------------

def check_recorder(cfg, w, lat) -> None:
    """Raise unless the flight recorder's window ring ``w`` and latency
    buckets ``lat`` come together, and with ``cfg.telemetry_window > 0``."""
    if (w is None) != (lat is None):
        raise ValueError("the flight recorder takes w and lat together")
    if w is not None and cfg.telemetry_window < 1:
        raise ValueError("the flight recorder needs telemetry_window > 0")


def add_plain(cfg, r: int, vec, t, w=None, lat=None, hists=()) -> None:
    """What a telemetry kernel's plain version adds, in place: the round's
    [B, K] int32 counter vector ``vec`` into the totals ``t`` and, with the
    recorder, into window ``r // cfg.telemetry_window`` of the ring ``w``,
    and each [B, N_BUCKETS] histogram of ``hists`` into ``lat[:, h]``."""
    t += vec
    if w is None:
        return
    w[:, r // cfg.telemetry_window] += vec
    for h, hist in enumerate(hists):
        lat[:, h] += hist


def window_of(cfg, r: int, t, w, lat, n_hists: int) -> tuple[int, int]:
    """(window, n_windows) of round ``r`` as a telemetry kernel takes them,
    (0, 0) with the recorder off, after checking the CUDA accumulators:
    ``t`` [B, K], ``w`` [B, n_windows, K] and ``lat`` [B, n_hists,
    N_BUCKETS], all int32."""
    from .. import _build
    B, K = t.shape
    _build.check(t, torch.int32, t.device, (B, K))
    if w is None:
        return 0, 0
    n_windows = w.shape[1]
    _build.check(w, torch.int32, t.device, (B, n_windows, K))
    _build.check(lat, torch.int32, t.device, (B, n_hists, N_BUCKETS))
    window = r // cfg.telemetry_window
    if not 0 <= window < n_windows:
        raise ValueError(f"round {r} lies past the {n_windows} windows")
    return window, n_windows
