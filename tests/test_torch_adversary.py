"""The port's adversary ops and top-A selection against the JAX package's.

Plain versions of kernel KB (``delivery_edges``) and kernel KC
(``top_active``), batched over sweeps, must equal the JAX functions run on
each sweep alone: tolerance 0 (booleans and ids).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax.numpy as jnp  # noqa: E402

from consensus_tpu.core import rng as jrng  # noqa: E402
from consensus_tpu.engines import raft_sparse as jrs  # noqa: E402
from consensus_tpu.ops import adversary as jadv  # noqa: E402
from consensus_tpu_torch.engines import raft_sparse as trs  # noqa: E402
from consensus_tpu_torch.ops import adversary as tadv  # noqa: E402

N, A = 97, 6
SEEDS = np.array([0, 0xFFFFFFFF, 12345], np.uint32)


def _ids(seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    ids = r.integers(-1, N, (len(SEEDS), A)).astype(np.int32)
    ids[0, :3] = [-1, N - 1, 0]
    ids[1, :] = -1
    return ids


@pytest.mark.parametrize("ids_are_src", [True, False])
@pytest.mark.parametrize("r,drop,part", [
    (0, 0.0, 0.0), (7, 0.2, 0.0), (13, 0.1, 1.0), (0xFFFFFFFF, 0.3, 0.5),
    (29, 0.05, 0.9)])
def test_delivery_edges_matches_jax(ids_are_src, r, drop, part):
    ids = _ids(r & 0xFFFF)
    drop_cut, part_cut = (jrng.prob_threshold_u32(p) for p in (drop, part))
    got = tadv.delivery_edges(torch.from_numpy(SEEDS), r,
                              torch.from_numpy(ids), N, drop_cut, part_cut,
                              ids_are_src).numpy()
    assert got.shape == ((len(SEEDS), A, N) if ids_are_src
                         else (len(SEEDS), N, A))
    nodes = jnp.arange(N, dtype=jnp.int32)
    for b, s in enumerate(SEEDS):
        k = jnp.asarray(ids[b])
        src, dst = ((k[:, None], nodes[None, :]) if ids_are_src
                    else (nodes[:, None], k[None, :]))
        want = np.asarray(jadv.delivery_edges(
            jnp.uint32(s), jnp.uint32(r), src, dst, drop_cut, part_cut))
        assert np.array_equal(got[b], want)
    assert not got[1].any()                       # all-NONE ids: nothing


@pytest.mark.parametrize("r", [0, 5, 0xFFFFFFFF])
def test_churn_and_bitcast_match_jax(r):
    cut = jrng.prob_threshold_u32(0.5)
    got = tadv.churn(torch.from_numpy(SEEDS), r, cut).numpy()
    want = [bool(jadv.churn(jnp.uint32(s), jnp.uint32(r), cut))
            for s in SEEDS]
    assert got.tolist() == want
    draws = tadv.draw(torch.from_numpy(SEEDS), jrng.STREAM_VALUE, r, 0,
                      torch.arange(N, dtype=torch.int32))
    for b, s in enumerate(SEEDS):
        want_v = np.asarray(jadv.bitcast_i32(jadv.draw(
            jnp.uint32(s), jrng.STREAM_VALUE, jnp.uint32(r), 0,
            jnp.arange(N, dtype=jnp.uint32))))
        assert np.array_equal(tadv.bitcast_i32(draws[b]).numpy(), want_v)


def _top_case(kind: str):
    r = np.random.default_rng(len(kind))
    B, n = 4, 300
    term = r.integers(0, 5, (B, n)).astype(np.int32)   # many ties in term
    if kind == "sparse":
        mask = r.random((B, n)) < 0.02
    elif kind == "binding":                              # more than A set
        mask = r.random((B, n)) < 0.3
    elif kind == "all":
        mask = np.ones((B, n), bool)
    else:
        mask = np.zeros((B, n), bool)
    if kind != "none":
        mask[0, :2] = [True, True]                       # a tie at term
        term[0, :2] = term[0, 1]
    return mask, term


@pytest.mark.parametrize("kind", ["sparse", "binding", "all", "none"])
@pytest.mark.parametrize("a", [1, 4, 16])
def test_top_active_matches_jax(kind, a):
    mask, term = _top_case(kind)
    got = trs.top_active(torch.from_numpy(mask), torch.from_numpy(term),
                         a).numpy()
    n = mask.shape[1]
    for b in range(mask.shape[0]):
        want = np.asarray(jrs._top_active(
            jnp.asarray(mask[b]), jnp.asarray(term[b]),
            jnp.arange(n, dtype=jnp.int32), a))
        assert np.array_equal(got[b], want)
    if kind == "binding":
        assert (mask.sum(1) > a).all() and (got >= 0).all()
