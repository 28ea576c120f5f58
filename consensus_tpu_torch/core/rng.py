"""Counter-based RNG of the simulator in PyTorch, plus kernel KA.

A copy of what the capped-Raft path needs from ``consensus_tpu/core/rng.py``
(the stream constants and ``prob_threshold_u32``) and plain PyTorch versions
of its Threefry-2x32, SPEC §2 delivery-mixer and SPEC §A.2 retransmission
draws. Every random decision is a pure function of (seed, stream, ctx, c0,
c1), so the port reproduces the JAX package's draws bit for bit.

PyTorch has no wrapping ``uint32`` arithmetic (``+``, shifts and ``%`` are
missing for ``torch.uint32``), so the plain versions below compute in int64
holding values in [0, 2**32) and mask after every step; no product ever
exceeds 2**63. A u32 draw is returned the same way: an int64 tensor of
values in [0, 2**32).

:func:`random_u32` is the wrapper of the hand-written CUDA kernel KA
(``csrc/random_u32.cu``); on CPU tensors it runs :func:`random_u32_plain`.
"""
from __future__ import annotations

import torch

# Threefry-2x32 constants (Random123 reference implementation).
_KS_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)

# Stream constants, copied from consensus_tpu/core/rng.py (must match
# cpp/threefry.h and csrc/rng.cuh).
STREAM_DELIVER = 0x9E3779B1    # per (round, edge) message delivery
STREAM_TIMEOUT = 0x85EBCA77    # per (term, node) election timeout
STREAM_CHURN = 0xC2B2AE3D      # per round leader-churn event
STREAM_PARTITION = 0x27D4EB2F  # per round partition side/active
STREAM_STAKE = 0x165667B1      # per validator initial stake (DPoS)
STREAM_VOTE = 0xD3A2646C       # per (epoch, validator) vote target
STREAM_VALUE = 0xFD7046C5      # proposal payload values
STREAM_BYZANTINE = 0xB55A4F09  # reserved: byzantine node pick
STREAM_EQUIV = 0x94D049BB      # per (round, byz sender, receiver) stance
STREAM_CRASH = 0x68E31DA5      # per (round, node) crash/recover draw
STREAM_SLOTMISS = 0x7F4A7C15   # per (round, producer) DPoS slot miss
STREAM_DELAY = 0x2545F491      # per (origin round, d, edge) retransmit
STREAM_ATTACK = 0xBB67AE85     # per round targeted-attack activation
STREAM_AGG = 0x510E527F        # per (round, subdraw, aggregator)
STREAM_POISON = 0x6A09E667     # per (round, subdraw, vertex_or_node)
STREAM_SUPPRESS = 0x1F83D9AB   # per (window, subdraw, producer)
STREAM_DESYNC = 0x5BE0CD19     # per (round, subdraw, node)
STREAM_SEARCH = 0x3C6EF372     # per (generation, subdraw, index)

# SPEC §2 murmur-style delivery mixer constants.
_MIX_C1 = 0xCC9E2D51
_MIX_C2 = 0x1B873593
_MIX_C3 = 0xE6546B64
_FMIX_A = 0x85EBCA6B
_FMIX_B = 0xC2B2AE35

_M32 = 0xFFFFFFFF


def prob_threshold_u32(p: float) -> int:
    """Integer cutoff for probability ``p``: draw < cutoff <=> event fires."""
    if p <= 0.0:
        return 0
    if p >= 1.0:
        return 0xFFFFFFFF
    return min(int(p * 4294967296.0), 0xFFFFFFFF)


# --- plain PyTorch versions (int64 holding u32 values) ------------------------

def as_u32(x) -> torch.Tensor:
    """An integer tensor's 32-bit pattern as int64 values in [0, 2**32)."""
    return x.to(torch.int64) & _M32


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a u32 constant,
    split in 16-bit halves so that no intermediate leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl32(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32_plain(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds) on int64 tensors of u32 values; returns y0."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for block in range(5):
        for r in (_ROT_A if block % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _M32
    return x0


def mix_absorb_plain(h, c):
    k = _mul32(_rotl32(_mul32(c, _MIX_C1), 15), _MIX_C2)
    h = _rotl32(h ^ k, 13)
    return (_mul32(h, 5) + _MIX_C3) & _M32


def mix_fin_plain(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX_A)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX_B)
    return h ^ (h >> 16)


def delivery_u32_plain(seed, r, i, j):
    """SPEC §2 delivery draw on int64 tensors of u32 values (broadcasts)."""
    h = mix_absorb_plain(seed ^ STREAM_DELIVER, r)
    return mix_fin_plain(mix_absorb_plain(mix_absorb_plain(h, i), j))


def delay_u32_plain(seed, q, d, i, j):
    """SPEC §A.2 retransmission draw on int64 tensors of u32 values
    (broadcasts): the delivery mixer keyed ``seed ^ STREAM_DELAY``,
    absorbing (q, d, i, j), the origin round, the delay and the edge
    (``consensus_tpu/core/rng.py:329-347`` ``delay_u32_np``)."""
    h = mix_absorb_plain(mix_absorb_plain(seed ^ STREAM_DELAY, q), d)
    return mix_fin_plain(mix_absorb_plain(mix_absorb_plain(h, i), j))


def _operand(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return as_u32(x)
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def random_u32_plain(seed, stream: int, ctx, c0, c1) -> torch.Tensor:
    """Plain version of KA: ``random_u32(seed_b ^ stream, ctx, c0, c1)``.

    ``seed`` is a [B] tensor of per-sweep seeds; each of ``ctx``, ``c0``,
    ``c1`` is a Python int or an int32 tensor of shape [M] or [B, M]. Returns
    the [B, M] draws (M = 1 when all three are ints) as int64 u32 values.
    """
    dev = seed.device
    k0 = (as_u32(seed) ^ stream)[:, None]
    ops = [_operand(x, dev) for x in (ctx, c0, c1)]
    shape = torch.broadcast_shapes(k0.shape, *(o.shape for o in ops))
    k1, x0, x1 = (o.expand(shape) for o in ops)
    return threefry2x32_plain(k0.expand(shape), k1, x0, x1)


def random_u32(seed, stream: int, ctx, c0, c1) -> torch.Tensor:
    """Kernel KA: Threefry draws over a [B, M] grid with per-sweep seeds.

    Same arguments and result as :func:`random_u32_plain`, which it runs for
    CPU tensors; for CUDA tensors it launches ``csrc/random_u32.cu``.
    """
    if seed.device.type == "cpu":
        return random_u32_plain(seed, stream, ctx, c0, c1)
    from .. import _build
    B = seed.shape[0]
    tensors = [x for x in (ctx, c0, c1) if isinstance(x, torch.Tensor)]
    M = tensors[0].shape[-1] if tensors else 1
    args = []
    for x in (ctx, c0, c1):
        if isinstance(x, torch.Tensor):
            _build.check(x, torch.int32, seed.device)
            if x.shape not in ((M,), (B, M)):
                raise ValueError(f"operand shape {tuple(x.shape)} is neither "
                                 f"[{M}] nor [{B}, {M}]")
            args += [x.data_ptr(), 0, M if x.dim() == 2 else 0]
        else:
            args += [None, int(x) & _M32, 0]
    _build.check(seed, torch.uint32, seed.device, (B,))
    out = torch.empty((B, M), dtype=torch.int64, device=seed.device)
    _build.launch("random_u32", seed.data_ptr(), stream & _M32, *args,
                  out.data_ptr(), B, M)
    random_u32.launches += 1
    return out


random_u32.launches = 0
