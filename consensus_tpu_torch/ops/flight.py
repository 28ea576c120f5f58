"""Flight-recorder buckets: a copy of ``consensus_tpu/ops/flight.py``.

Latency observations are bucketed into ``N_BUCKETS`` power-of-two buckets:
bucket 0 holds values <= 0, bucket i (1 <= i <= 14) holds [2^(i-1), 2^i),
and the last bucket holds values >= 2^14. Integer compares only. Kernel KK
(``engines/raft_sparse.py`` :func:`telemetry`) buckets the same way on the
card; :func:`bucket_counts_plain` is what its plain version runs.
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
