"""The port's DPoS engine against the JAX package, on the CPU.

``Config(protocol="dpos")`` selects the SPEC §7 engine
(``consensus_tpu_torch/engines/dpos.py``). The same seeds go through
``consensus_tpu`` and through the port's plain versions; everything must be
equal, tolerance 0: whole runs (digest, every extract leaf, the
last-irreversible index ``lib``) at ``tests/test_dpos.py``'s configs and at
dpos-100k's knobs cut to V = 2 000, one round from a converted JAX carry
and from random states (full chains among them), the epoch schedule
(producers and tallies, zero tallies tied across candidates), numpy models
of kernel KW on adversarial tallies (its RANKS instance's rank count, its
packed u64 keys and its clusters' counted ranks) and of its partial
tallies, and chip_smoke.py's hostile DPoS anchor made again by the JAX
package.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.core import rng as jrng  # noqa: E402
from consensus_tpu.engines import dpos as jdpos  # noqa: E402
from consensus_tpu.engines.raft import _store_dtype  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.engines import dpos  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402

from helpers import run_cached  # noqa: E402

# tests/test_dpos.py's BASE and CFGS (the last crosses into uint16 on both
# chain fields).
BASE = dict(protocol="dpos", n_nodes=50, n_candidates=16, n_producers=4,
            epoch_len=16, n_rounds=96, log_capacity=128, n_sweeps=3,
            seed=888)
CFGS = {
    "base": BASE,
    "lossy": {**BASE, "drop_rate": 0.3, "churn_rate": 0.1, "seed": 1},
    "k21-partitions": {**BASE, "n_nodes": 200, "n_candidates": 32,
                       "n_producers": 21, "drop_rate": 0.2,
                       "partition_rate": 0.1, "seed": 2},
    "u16": {**BASE, "n_nodes": 300, "n_candidates": 300, "n_producers": 21,
            "n_rounds": 300, "drop_rate": 0.1, "seed": 3},
}
# dpos-100k (benchmarks/run_benchmarks.py CONFIGS) cut to V = 2 000.
DPOS_100K_CUT = dict(protocol="dpos", n_nodes=2_000, n_rounds=256,
                     n_sweeps=1, log_capacity=256, n_candidates=1024,
                     n_producers=21, epoch_len=32, seed=5, drop_rate=0.01,
                     churn_rate=0.001)


def _jax_store(vmax: int) -> np.dtype:
    return np.dtype(_store_dtype(vmax))


def _port_dtypes(cfg):
    return (dpos.store_dtype(cfg.n_rounds - 1),
            dpos.store_dtype(cfg.n_candidates - 1))


# --- whole runs --------------------------------------------------------------

@pytest.mark.parametrize("name", [*CFGS, "dpos-100k-cut"])
def test_whole_run_matches_jax(name):
    kw = DPOS_100K_CUT if name == "dpos-100k-cut" else CFGS[name]
    jcfg, cfg = JConfig(**kw), Config(**kw)
    assert jsim.engine_def(jcfg).name == simulator.engine_def(cfg).name
    want = jdpos.dpos_run(jcfg)
    got = dpos.dpos_run(cfg, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert simulator.decided_payload(cfg, got)[3] == \
        jsim.decided_payload(jcfg, want)[3]
    assert want["chain_len"].max() > 0


def test_simulator_front_door_matches_jax():
    """The digest and ``extras["lib"]`` of ``simulator.run``."""
    kw = CFGS["k21-partitions"]
    want = run_cached(JConfig(**kw))
    res = simulator.run(Config(**kw), device="cpu")
    assert res.digest == want.digest
    assert res.extras["lib"].dtype == want.extras["lib"].dtype
    assert np.array_equal(res.extras["lib"], want.extras["lib"])
    assert res.node_round_steps == 3 * 200 * 96


def test_chains_store_the_jax_dtypes():
    for kw in CFGS.values():
        cfg = Config(**kw)
        st = runner.init(cfg, runner.make_seeds(cfg), "cpu")
        assert (st.chain_r.dtype, st.chain_p.dtype) == _port_dtypes(cfg)
        assert st.chain_r.numpy().dtype == _jax_store(cfg.n_rounds - 1)
        assert st.chain_p.numpy().dtype == _jax_store(cfg.n_candidates - 1)
    for vmax in (0, 255, 256, 65535, 65536, 2**31 - 1):
        assert np.dtype(str(dpos.store_dtype(vmax)).removeprefix(
            "torch.")) == _jax_store(vmax)
    assert _port_dtypes(Config(**CFGS["u16"])) == (torch.uint16,
                                                    torch.uint16)


# --- the epoch schedule (KW) -------------------------------------------------

@pytest.mark.parametrize("kw", [
    CFGS["base"], CFGS["u16"], DPOS_100K_CUT,
    # V = C = 20: about a third of the candidates get no vote, and K = C
    # ranks every one of them, the zero tallies by id.
    {**BASE, "n_nodes": 20, "n_candidates": 20, "n_producers": 20}],
    ids=["base", "u16", "dpos-100k-cut", "zero-ties"])
def test_schedule_matches_jax(kw):
    cfg = Config(**kw)
    seeds = runner.make_seeds(cfg)
    producers, tallies = dpos.dpos_schedule(cfg, torch.from_numpy(seeds))
    assert producers.dtype == tallies.dtype == torch.int32
    assert producers.shape == (cfg.n_sweeps, dpos.n_epochs(cfg),
                               cfg.n_producers)
    zero_ties = 0
    for b, s in enumerate(seeds):
        _, want_p, want_t = jdpos.dpos_schedule(JConfig(**kw), s)
        assert np.array_equal(producers[b].numpy(), np.asarray(want_p))
        assert np.array_equal(tallies[b].numpy(), np.asarray(want_t))
        zero_ties += int((np.asarray(want_t) == 0).sum(1).clip(0).max())
    if kw["n_candidates"] == kw["n_producers"]:
        assert zero_ties >= 2


def rank_model(tallies: np.ndarray, K: int) -> np.ndarray:
    """A numpy model of kernel KW's RANKS instance (C > 16 384), its
    second launch: each candidate i of an epoch
    counts the candidates j ranked before it, by the wrapped negated tally
    (key_j < key_i, or key_j == key_i and j < i), and is written at that
    rank when it is below K."""
    keys = (-tallies.astype(np.int64)).astype(np.uint32).astype(np.int32)
    E, C = keys.shape
    out = np.full((E, K), -1, np.int32)
    j = np.arange(C)
    for e in range(E):
        for i in range(C):
            rank = int(((keys[e] < keys[e, i])
                        | ((keys[e] == keys[e, i]) & (j < i))).sum())
            if rank < K:
                assert out[e, rank] == -1
                out[e, rank] = i
    return out


@pytest.mark.parametrize("C,K", [(1, 1), (7, 7), (40, 21), (300, 21)])
def test_rank_model_matches_the_plain_order(C, K):
    """KW's rank count gives the plain version's stable order on tallies
    full of ties, zeros, and the int32 extremes whose negation wraps."""
    g = np.random.default_rng(C)
    t = g.choice(np.array([0, 1, 5, 5, 7, -3, 2**31 - 1, -2**31], np.int32),
                 size=(6, C))
    t[0] = 0
    t[1] = g.integers(-2**31, 2**31, C, dtype=np.int64).astype(np.int32)
    want = dpos.top_producers_plain(torch.from_numpy(t), K).numpy()
    assert np.array_equal(rank_model(t, K), want)
    # The plain order is JAX's argsort of the negated tallies.
    jax_order = np.asarray(jnp.argsort(-jnp.asarray(t), axis=-1,
                                       stable=True))[:, :K]
    assert np.array_equal(want, jax_order)


def packed_keys(tallies: np.ndarray) -> np.ndarray:
    """Kernel KW's u64 keys of [..., C] int32 tallies: high word the
    wrapped negated tally as u32 xor 0x80000000, low word the id."""
    neg = (-tallies.astype(np.int64)).astype(np.uint32)
    hi = (neg ^ np.uint32(0x80000000)).astype(np.uint64)
    ids = np.arange(tallies.shape[-1], dtype=np.uint64)
    return (hi << np.uint64(32)) | ids


@pytest.mark.parametrize("C,K", [(1, 1), (7, 7), (33, 33), (40, 21),
                                 (300, 21), (1024, 21), (1500, 100)])
def test_packed_key_order_matches_the_plain_order(C, K):
    """KW's packed u64 keys, in ascending order, give the plain version's
    stable order (and JAX's argsort of the negated tallies) on tallies full
    of ties, zeros and the int32 extremes whose negation wraps; C not a
    multiple of 32 and C = K among them."""
    g = np.random.default_rng(C + 7 * K)
    t = g.choice(np.array([0, 1, 5, 5, 7, -3, 2**31 - 1, -2**31], np.int32),
                 size=(6, C))
    t[0] = 0
    t[1] = g.integers(-2**31, 2**31, C, dtype=np.int64).astype(np.int32)
    want = dpos.top_producers_plain(torch.from_numpy(t), K).numpy()
    for e in range(len(t)):
        got = np.sort(packed_keys(t[e]))
        assert len(np.unique(got)) == C
        assert np.array_equal((got[:K] & np.uint64(0xFFFFFFFF))
                              .astype(np.int32), want[e])
    jax_order = np.asarray(jnp.argsort(-jnp.asarray(t), axis=-1,
                                       stable=True))[:, :K]
    assert np.array_equal(want, jax_order)


def top_k_model(tally: np.ndarray, K: int, g) -> np.ndarray:
    """KW's second launch on one epoch's tallies: the cluster's blocks
    (CLUSTER_SLICE = 128 candidates a block at least, up to 8) each count,
    for each key of their slice, the slice's keys below it, and put the
    keys that count below kk = min(K, slice) into the first block's union
    (in a shuffled order); the first block counts, for each key of the
    union, the union's keys below it, and writes the ids that count below
    K at that count. Returns the [K] ids."""
    C = len(tally)
    cs = 1
    while cs < 8 and cs * 128 < C:
        cs *= 2
    slice_ = -(-C // cs)
    kk = min(K, slice_)
    keys = packed_keys(tally)
    pool = []
    for r in range(cs):
        sk = keys[r * slice_:(r + 1) * slice_]
        below = (sk[None, :] < sk[:, None]).sum(1)
        pool.extend(sk[below < kk])
    pool = np.array(pool, np.uint64)[g.permutation(len(pool))]
    out = np.full(K, -1, np.int64)
    for x, n in zip(pool, (pool[None, :] < pool[:, None]).sum(1)):
        if n < K:
            assert out[n] == -1
            out[n] = int(x & np.uint64(0xFFFFFFFF))
    return out.astype(np.int32)


@pytest.mark.parametrize("V,C,G,eg", [(1000, 40, 7, 3), (37, 7, 8, 8),
                                      (5, 3, 16, 2), (2000, 300, 1, 8),
                                      (4099, 1024, 132, 8)])
def test_partial_sums_equal_the_plain_tally(V, C, G, eg):
    """KW's two launches: G blocks a lane each draw the stakes and votes of
    a chunk of ceil(V / G) validators (chunks that do not divide V, and
    empty blocks) into u32 histograms, ``eg`` epochs at a time; then the
    cluster of a (lane, epoch) sums slices of the candidates over the G
    partials, and its blocks' sorted runs give the first K ids
    (:func:`top_k_model`). The tallies equal the plain version's, and so do
    the producers."""
    cfg = Config(protocol="dpos", n_nodes=V, n_candidates=C,
                 n_producers=min(C, 21), epoch_len=4, n_rounds=30, seed=3)
    seeds = np.array([3, 0xFFFFFFFF], np.uint32)
    want_p, want_t = dpos.dpos_schedule_plain(cfg, torch.from_numpy(seeds))
    E, K = dpos.n_epochs(cfg), cfg.n_producers
    ch = -(-V // G)
    for b, sd in enumerate(seeds):
        partials = np.zeros((G, E, C), np.uint32)
        for g in range(G):
            v = np.arange(g * ch, min(V, (g + 1) * ch), dtype=np.uint32)
            for e0 in range(0, E, eg):
                stake = jrng.random_u32_np(int(sd), jrng.STREAM_STAKE, 0, 0,
                                           v) % np.uint32(1000) + np.uint32(1)
                for e in range(e0, min(E, e0 + eg)):
                    vote = jrng.random_u32_np(int(sd), jrng.STREAM_VOTE,
                                              np.uint32(e), 0, v) % np.uint32(C)
                    np.add.at(partials[g, e], vote, stake)
        for e in range(E):
            tally = np.zeros(C, np.uint32)
            for g in np.random.default_rng(e).permutation(G):
                tally += partials[g, e]
            tally = tally.view(np.int32)
            assert np.array_equal(tally, want_t[b, e].numpy())
            assert np.array_equal(top_k_model(tally, K, np.random.default_rng(
                e)), want_p[b, e].numpy())


@pytest.mark.parametrize("C,K", [(1, 1), (33, 33), (300, 21), (1024, 21),
                                 (1024, 200), (2000, 2000)])
def test_top_k_model_matches_the_plain_order(C, K):
    """KW's second launch (:func:`top_k_model`: counted ranks in each
    slice, then in the union of each slice's first min(K, slice)) gives
    the plain version's first K on tallies full of ties, zeros and the
    int32 extremes, with K below, at and above a slice."""
    g = np.random.default_rng(3 * C + K)
    t = g.choice(np.array([0, 1, 5, 5, 7, -3, 2**31 - 1, -2**31], np.int32),
                 size=(3, C))
    t[0] = 0
    want = dpos.top_producers_plain(torch.from_numpy(t), K).numpy()
    for e in range(len(t)):
        assert np.array_equal(top_k_model(t[e], K, g), want[e])


# --- one round from a converted JAX carry ------------------------------------

STEPS = (0, 31, 32, 200, 299)


def _carry_leaves(carry) -> dict:
    producers, st = carry
    return convert.dpos_leaves(np.array(producers),
                               {k: np.array(v)
                                for k, v in st._asdict().items()})


@pytest.fixture(scope="module")
def jax_steps():
    """{k: (leaves before round k, leaves after it)} of the "u16" config
    (300 rounds, 128-slot chains: full chains from round 128 on)."""
    jcfg = JConfig(**{**CFGS["u16"], "log_capacity": 128,
                      "partition_rate": 0.2})
    eng = jsim.engine_def(jcfg)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    out, r0 = {}, 0
    for k in STEPS:
        if k > r0:
            carry = jrunner._chunk_jit(jcfg, eng, k - r0, carry, jnp.int32(r0))
        before = _carry_leaves(carry)
        carry = jrunner._chunk_jit(jcfg, eng, 1, carry, jnp.int32(k))
        out[k] = (before, _carry_leaves(carry))
        r0 = k + 1
    return jcfg, out


@pytest.mark.parametrize("k", STEPS)
def test_one_round_from_jax_state(jax_steps, k):
    jcfg, steps = jax_steps
    before, after = steps[k]
    st = convert.state_from_numpy(before)
    assert isinstance(st, dpos.DposState)
    cfg = Config(**{f.name: getattr(jcfg, f.name)
                    for f in dataclasses.fields(Config)})
    got = convert.state_to_numpy(dpos.dpos_step(cfg, st, k))
    assert set(got) == set(after)
    for name in after:
        assert got[name].dtype == after[name].dtype, name
        assert np.array_equal(got[name], after[name]), name
    if k >= 200:
        assert (after["chain_len"] == 128).any()


def test_dpos_carry_roundtrip_keeps_every_dtype(jax_steps):
    _, steps = jax_steps
    before, _ = steps[STEPS[1]]
    st = convert.state_from_numpy(before)
    assert st.chain_r.dtype == st.chain_p.dtype == torch.uint16
    assert st.producers.dtype == torch.int32 and st.seed.dtype == torch.uint32
    back = convert.state_to_numpy(st)
    for name, a in before.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a)
    producers, rest = convert.dpos_carry(back)
    assert np.array_equal(producers, before["producers"])
    assert list(rest) == list(jdpos.DposState._fields)
    with pytest.raises(TypeError):
        convert.state_from_numpy(
            {**before, "chain_r": before["chain_r"].astype(np.int64)})


# --- one round from random states --------------------------------------------

def _jax_round(jcfg):
    def one(producers, st, r):
        return jdpos.dpos_round(jcfg, producers, st, r)
    return jax.jit(jax.vmap(one, in_axes=(0, 0, None)))


@pytest.mark.parametrize("kw", [
    {**CFGS["u16"], "partition_rate": 0.5, "churn_rate": 0.0,
     "log_capacity": 40},
    {**CFGS["lossy"], "log_capacity": 16, "partition_rate": 0.3}],
    ids=["u16", "u8"])
def test_one_round_from_random_states(kw):
    """Random chains, a third of them full, random producer lists."""
    jcfg, cfg = JConfig(**kw), Config(**kw)
    g = np.random.default_rng(5)
    B, V, L = 4, cfg.n_nodes, cfg.log_capacity
    rdt, pdt = (np.dtype(str(t).removeprefix("torch."))
                for t in _port_dtypes(cfg))
    E, K = dpos.n_epochs(cfg), cfg.n_producers
    for r in (0, 17, cfg.n_rounds - 1):
        chain_len = g.integers(0, L + 1, (B, V)).astype(np.int32)
        chain_len[:, ::3] = L
        leaves = {"seed": np.arange(40, 40 + B, dtype=np.uint32),
                  "producers": g.integers(0, cfg.n_candidates,
                                          (B, E, K)).astype(np.int32),
                  "chain_r": g.integers(0, cfg.n_rounds,
                                        (B, V, L)).astype(rdt),
                  "chain_p": g.integers(0, cfg.n_candidates,
                                        (B, V, L)).astype(pdt),
                  "chain_len": chain_len, "down": np.zeros((B, V), bool)}
        st = convert.state_from_numpy(leaves)
        got = convert.state_to_numpy(dpos.dpos_step(cfg, st, r))
        producers, rest = convert.dpos_carry(leaves)
        want = _jax_round(jcfg)(jnp.asarray(producers), jdpos.DposState(
            **{k: jnp.asarray(v) for k, v in rest.items()}), jnp.int32(r))
        for name, a in want._asdict().items():
            a = np.asarray(a)
            assert got[name].dtype == a.dtype, name
            assert np.array_equal(got[name], a), (r, name)
        assert (got["chain_len"] > chain_len).any()


# --- chip_smoke.py's hostile anchor ------------------------------------------

def _smoke(name: str):
    """The constant ``name`` of the repo's chip_smoke.py, read by
    importing the script without running it."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return getattr(smoke, name)


def test_hostile_dpos_anchor_is_jax():
    """The anchor chip_smoke.py holds the hostile DPoS run on the card to
    is the JAX package's digest at its knobs; its chains fill and cross
    into uint16 on both fields."""
    kw = _smoke("DPOS_HOSTILE")
    jcfg = JConfig(**kw)
    res = run_cached(jcfg)
    assert res.digest == _smoke("DPOS_HOSTILE_DIGEST")
    assert int(res.counts.min()) == jcfg.log_capacity
    assert _port_dtypes(Config(**kw)) == (torch.uint16, torch.uint16)
