"""Raft helpers shared with the capped engine (``consensus_tpu/engines/raft.py``).

The JAX package's ``_pick1`` / ``_pick_row`` one-hot reductions exist only to
keep gathers off the TPU's serial gather unit; here they are plain indexing
(``gather``) at the call sites, with the same values.
"""
from __future__ import annotations

import torch

from ..core import rng

ROLE_F, ROLE_C, ROLE_L = 0, 1, 2
NONE = -1

# The capped engine's telemetry counters, in order: a copy of
# consensus_tpu/engines/raft.py RAFT_TELEMETRY with its tails
# ops/adversary.py CRASH_TELEMETRY and ops/aggregate.py AGG_TELEMETRY
# (zeros here: the port rejects the crash and switch gates).
RAFT_TELEMETRY = ("leader_elections", "append_accepted", "append_rejected",
                  "entries_committed", "attack_rounds",
                  "crashes", "recoveries", "nodes_down",
                  "agg_down_rounds", "stale_serves", "poisoned_serves")
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
