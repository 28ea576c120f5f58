"""The port's RNG (consensus_tpu_torch/core/rng.py) against the JAX package's.

The plain versions of kernels KA (Threefry draws) and KB's delivery mixer
must equal ``random_u32_np`` / ``delivery_u32_np`` and their jnp twins bit
for bit (tolerance 0), over a lattice of seed, ctx and counter values that
includes 0 and 0xFFFFFFFF.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu.core import rng as jrng  # noqa: E402
from consensus_tpu_torch.core import rng  # noqa: E402

EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint32)


def _lattice(n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    return np.concatenate([EDGES, r.integers(0, 2**32, n, dtype=np.uint64)
                           .astype(np.uint32)])


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint32).view(np.int32).copy())


STREAMS = ["STREAM_DELIVER", "STREAM_TIMEOUT", "STREAM_CHURN",
           "STREAM_PARTITION", "STREAM_STAKE", "STREAM_VOTE", "STREAM_VALUE",
           "STREAM_BYZANTINE", "STREAM_EQUIV", "STREAM_CRASH",
           "STREAM_SLOTMISS", "STREAM_DELAY", "STREAM_ATTACK", "STREAM_AGG",
           "STREAM_POISON", "STREAM_SUPPRESS", "STREAM_DESYNC",
           "STREAM_SEARCH"]


def test_stream_constants_are_the_reference_copies():
    for name in STREAMS:
        assert getattr(rng, name) == int(getattr(jrng, name)), name


@pytest.mark.parametrize("p", [0.0, 1e-9, 0.001, 0.01, 0.5, 0.999, 1.0, 2.0])
def test_prob_threshold_matches(p):
    assert rng.prob_threshold_u32(p) == jrng.prob_threshold_u32(p)


@pytest.mark.parametrize("stream", ["STREAM_TIMEOUT", "STREAM_VALUE",
                                    "STREAM_CHURN", "STREAM_PARTITION"])
def test_random_u32_plain_matches_numpy_and_jnp(stream):
    import jax.numpy as jnp
    st = getattr(rng, stream)
    seeds = np.array([0, 0xFFFFFFFF, 6, 0x80000000], np.uint32)
    ctx = _lattice(57, 1).reshape(1, -1).repeat(4, 0)
    ctx[1] = ctx[1][::-1]
    c0 = _lattice(57, 2)
    c1 = _lattice(57, 3)
    got = rng.random_u32_plain(torch.from_numpy(seeds), st, _i32(ctx),
                               _i32(c0), _i32(c1)).numpy()
    for b, s in enumerate(seeds):
        want = jrng.random_u32_np(int(s), getattr(jrng, stream), ctx[b], c0,
                                  c1)
        assert np.array_equal(got[b], want.astype(np.int64))
        want_j = np.asarray(jrng.random_u32_jnp(
            jnp.uint32(s), getattr(jrng, stream), jnp.asarray(ctx[b]),
            jnp.asarray(c0), jnp.asarray(c1)))
        assert np.array_equal(got[b], want_j.astype(np.int64))


def test_random_u32_scalar_operands():
    seeds = np.array([0, 0xFFFFFFFF, 41], np.uint32)
    for ctx, c0, c1 in [(0, 0, 0), (0xFFFFFFFF, 0, 0), (63, 1, 0xFFFFFFFF)]:
        got = rng.random_u32(torch.from_numpy(seeds), rng.STREAM_CHURN, ctx,
                             c0, c1)
        assert got.shape == (3, 1)
        want = [jrng.random_u32_np(int(s), jrng.STREAM_CHURN, ctx, c0, c1)
                for s in seeds]
        assert got[:, 0].tolist() == [int(w) for w in want]


def test_delivery_mixer_plain_matches_numpy_and_jnp():
    import jax.numpy as jnp
    seed, r, i, j = (_lattice(300, s) for s in range(10, 14))
    got = rng.delivery_u32_plain(*(torch.from_numpy(a.astype(np.int64))
                                   for a in (seed, r, i, j))).numpy()
    assert np.array_equal(got, jrng.delivery_u32_np(seed, r, i, j)
                          .astype(np.int64))
    want_j = np.asarray(jrng.delivery_u32_jnp(
        jnp.asarray(seed), jnp.asarray(r), jnp.asarray(i), jnp.asarray(j)))
    assert np.array_equal(got, want_j.astype(np.int64))
