"""The port's telemetry and flight recorder (kernels KK's and KP's plain
versions, the runner's accumulators) against the JAX package's, on the CPU.

The same Config runs through ``consensus_tpu.network.runner.run`` with
``telemetry=True`` and through ``consensus_tpu_torch``'s, on the capped
engine and on the dense one (``max_active = 0``, N = 5 to 300): the
per-sweep counters, the window ring (W = 6 over 20 rounds, so the last
window is ragged) and the latency buckets must be equal, bit for bit, and
so must the decided-log digest with telemetry on and off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu.ops import flight as jflight  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.engines import raft as trd  # noqa: E402
from consensus_tpu_torch.engines import raft_sparse as trs  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402
from consensus_tpu_torch.ops import flight as tflight  # noqa: E402

BASE = dict(protocol="raft", n_rounds=20, n_sweeps=2, log_capacity=32,
            max_entries=24, drop_rate=0.1, partition_rate=0.1,
            churn_rate=0.05, t_min=2, t_max=6, telemetry_window=6)
CASES = {"cap4-n1500": dict(n_nodes=1500, max_active=4, seed=7),
         "cap8-n1024": dict(n_nodes=1024, max_active=8, seed=3),
         "dense-n5": dict(n_nodes=5, max_active=0, seed=17),
         "dense-n64": dict(n_nodes=64, max_active=0, seed=3),
         "dense-n300": dict(n_nodes=300, max_active=0, seed=5)}


@pytest.fixture(scope="module")
def jax_runs():
    """{case: the JAX package's simulator.run with telemetry}."""
    return {case: jsim.run(JConfig(**BASE, **kw), warmup=False,
                           telemetry=True)
            for case, kw in CASES.items()}


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.array_equal(got, want), where
    else:
        assert got == want, where


@pytest.mark.parametrize("case", list(CASES))
def test_run_stats_match_jax(jax_runs, case):
    want = jax_runs[case]
    cfg = Config(**BASE, **CASES[case])
    stats: dict = {}
    out = runner.run(cfg, device="cpu", telemetry=True, stats=stats)
    assert simulator.decided_payload(cfg, out)[3] == want.payload
    assert stats["start_round"] == 0 and stats["executed_rounds"] == 20
    _assert_same(stats["telemetry"], want.extras["telemetry"]["per_sweep"])
    _assert_same(stats["flight"], {k: v for k, v in want.extras["flight"]
                                   .items() if k != "engine"})
    flight = stats["flight"]
    assert flight["n_windows"] == 4                     # windows of 6, 6, 6, 2
    for name, total in stats["telemetry"].items():
        assert np.array_equal(flight["windows"][name].sum(1), total), name
    assert stats["telemetry"]["leader_elections"].min() > 0
    assert stats["telemetry"]["append_rejected"].min() > 0
    assert np.array_equal(
        flight["latency"]["election_wait_rounds"].sum(1),
        stats["telemetry"]["leader_elections"])


def test_simulator_extras_and_digest_match_jax(jax_runs):
    kw = {**BASE, **CASES["cap4-n1500"]}
    want = jax_runs["cap4-n1500"]
    got = simulator.run(Config(**kw), device="cpu", telemetry=True)
    assert got.digest == want.digest
    _assert_same(got.extras, {k: want.extras[k]
                              for k in ("telemetry", "flight")})
    # Telemetry off: the same decided logs.
    cfg_off = Config(**{**kw, "telemetry_window": 0})
    off = runner.run(cfg_off, device="cpu")
    assert simulator.decided_payload(cfg_off, off)[3] == got.payload


@pytest.fixture(scope="module")
def jax_rounds():
    """The JAX carry and accumulators before each of the first 14 rounds
    of the cap-8 case, as numpy, stepped one round a call."""
    kw = {**BASE, **CASES["cap8-n1024"]}
    jcfg = JConfig(**kw)
    eng = jsim.engine_def(jcfg)
    B, K = kw["n_sweeps"], len(eng.telemetry_names)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    acc = (jnp.zeros((B, K), jnp.int32),
           jnp.zeros((B, runner.n_windows(Config(**kw)), K), jnp.int32),
           jnp.zeros((B, 2, jflight.N_BUCKETS), jnp.int32))
    out = []
    for r in range(14):
        leaves = {n: np.array(v) for n, v in carry._asdict().items()}
        out.append((leaves, [np.array(a) for a in acc]))
        # The step donates its inputs: go on from what it returns.
        carry, *acc = jrunner._chunk_jit(jcfg, eng, 1, carry, jnp.int32(r),
                                         *acc)
    out.append(({n: np.array(v) for n, v in carry._asdict().items()},
                [np.array(a) for a in acc]))
    return out


# Rounds 6 and 13 (windows 1 and 2) each elect a leader, accept and reject
# appends and commit entries in sweep 0.
@pytest.mark.parametrize("k", [6, 13])
def test_one_round_from_jax_carry_with_accumulators(jax_rounds, k):
    cfg = Config(**BASE, **CASES["cap8-n1024"])
    (before, acc_before), (after, acc_after) = jax_rounds[k], jax_rounds[k + 1]
    st = convert.state_from_numpy(before)
    telem, flight = convert.accumulators_from_numpy(*acc_before)
    got = convert.state_to_numpy(trs.raft_sparse_round(
        cfg, st, k, telem=telem, flight=flight))
    for name, want in after.items():
        assert np.array_equal(got[name], want), name
    for g, w in zip(convert.accumulators_to_numpy(telem, flight), acc_after):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    step = acc_after[0] - acc_before[0]
    assert (step[0, :4] > 0).all()


EDGES = [2 ** i for i in range(15)]


@pytest.mark.parametrize("values", [
    [0, -1, -7, -2 ** 31],                              # bucket 0
    *([e - 1, e, e + 1] for e in EDGES),                # each edge 2^i
    [2 ** 14, 2 ** 14 + 1, 2 ** 20, 2 ** 31 - 1],       # the overflow
], ids=lambda v: f"at{v[1]}")
def test_bucket_counts_matches_jax(values):
    v = np.array([values, values[::-1]], np.int32)
    m = np.array([[True] * len(values), [True, False] * (len(values) // 2)
                  + [True] * (len(values) % 2)])
    want = np.stack([np.array(jflight.bucket_counts(jnp.asarray(v[b]),
                                                    jnp.asarray(m[b])))
                     for b in range(2)])
    got = tflight.bucket_counts_plain(torch.from_numpy(v),
                                      torch.from_numpy(m)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert tflight.BUCKET_LO == jflight.BUCKET_LO
    assert tflight.N_BUCKETS == jflight.N_BUCKETS


@pytest.mark.parametrize("window,telemetry,stats", [
    (6, False, {}),          # a window without telemetry
    (0, True, None),         # telemetry without a stats dict
    (6, True, None),
])
def test_run_rejections_match_jax(window, telemetry, stats):
    kw = {**BASE, **CASES["cap4-n1500"], "n_nodes": 64,
          "telemetry_window": window}
    jcfg = JConfig(**kw)
    with pytest.raises(ValueError) as want:
        jrunner.run(jcfg, jsim.engine_def(jcfg), telemetry=telemetry,
                    stats=stats)
    with pytest.raises(ValueError) as got:
        runner.run(Config(**kw), device="cpu", telemetry=telemetry,
                   stats=stats)
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


def test_names_match_jax():
    from consensus_tpu.engines import raft as jraft
    from consensus_tpu_torch.engines import raft as traft
    assert traft.RAFT_TELEMETRY == jraft.RAFT_TELEMETRY
    assert traft.RAFT_LATENCY == jraft.RAFT_LATENCY
    assert trs.NAME == jsim.engine_def(JConfig(
        protocol="raft", n_nodes=9, max_active=2)).name


# --- the dense engine (kernel KP) ---------------------------------------------

@pytest.mark.parametrize("case", ["dense-n5", "dense-n300"])
def test_dense_digest_does_not_move_with_telemetry(jax_runs, case):
    kw = {**BASE, **CASES[case]}
    got = simulator.run(Config(**kw), device="cpu", telemetry=True)
    assert got.digest == jax_runs[case].digest
    assert got.extras["flight"]["engine"] == "raft"
    cfg_off = Config(**{**kw, "telemetry_window": 0})
    off = runner.run(cfg_off, device="cpu")
    assert simulator.decided_payload(cfg_off, off)[3] == got.payload
    # Telemetry without the flight recorder.
    stats: dict = {}
    runner.run(cfg_off, device="cpu", telemetry=True, stats=stats)
    _assert_same(stats["telemetry"],
                 jax_runs[case].extras["telemetry"]["per_sweep"])
    assert "flight" not in stats


@pytest.fixture(scope="module")
def jax_dense_rounds():
    """The JAX dense carry and accumulators before each of the first 14
    rounds of the N = 64 case, as numpy, stepped one round a call."""
    kw = {**BASE, **CASES["dense-n64"]}
    jcfg = JConfig(**kw)
    eng = jsim.engine_def(jcfg)
    B, K = kw["n_sweeps"], len(eng.telemetry_names)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    acc = (jnp.zeros((B, K), jnp.int32),
           jnp.zeros((B, runner.n_windows(Config(**kw)), K), jnp.int32),
           jnp.zeros((B, 2, jflight.N_BUCKETS), jnp.int32))
    out = []
    for r in range(14):
        out.append(({n: np.array(v) for n, v in carry._asdict().items()},
                    [np.array(a) for a in acc]))
        carry, *acc = jrunner._chunk_jit(jcfg, eng, 1, carry, jnp.int32(r),
                                         *acc)
    out.append(({n: np.array(v) for n, v in carry._asdict().items()},
                [np.array(a) for a in acc]))
    return out


# Rounds 6 and 13 each elect a leader and reject appends in sweep 0.
@pytest.mark.parametrize("k", [6, 13])
def test_dense_round_from_jax_carry_with_accumulators(jax_dense_rounds, k):
    cfg = Config(**BASE, **CASES["dense-n64"])
    (before, acc_before), (after, acc_after) = (jax_dense_rounds[k],
                                                jax_dense_rounds[k + 1])
    st = convert.state_from_numpy(before)
    telem, flight = convert.accumulators_from_numpy(*acc_before)
    got = convert.state_to_numpy(trd.raft_round(cfg, st, k, telem=telem,
                                                flight=flight))
    for name, want in after.items():
        assert np.array_equal(got[name], want), name
    for g, w in zip(convert.accumulators_to_numpy(telem, flight), acc_after):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    assert ((acc_after[0] - acc_before[0])[0, :3] > 0).all()


def test_dense_telemetry_wrapper_on_cpu_equals_plain_and_raises_off_it():
    """KP's wrapper runs its plain version on CPU tensors and raises on
    others; KM gives the winner flags only when asked."""
    kw = {**BASE, **CASES["dense-n64"]}
    cfg = Config(**kw)
    telem, flight = runner.accumulators(cfg, "cpu")
    st = runner.advance(cfg, runner.init(cfg, runner.make_seeds(cfg), "cpu"),
                        0, 6, telem=telem, flight=flight)
    got, original = {}, trd.dense_telemetry

    def record(*args):
        got["args"] = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args)
        return original(*args)
    record.launches = 0
    trd.dense_telemetry = record
    try:
        trd.raft_round(cfg, st, 6, telem=telem, flight=flight)
    finally:
        trd.dense_telemetry = original
    args = got["args"]
    ka = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
    pa = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
    trd.dense_telemetry(*ka)
    trd.dense_telemetry_plain(*pa)
    for k, p in zip(ka, pa):
        if isinstance(k, torch.Tensor):
            assert torch.equal(k, p)
    assert not torch.equal(ka[-3], args[-3])        # the totals moved
    with pytest.raises(ValueError, match="CUDA"):
        trd.dense_telemetry(*(a.to("meta") if isinstance(a, torch.Tensor)
                              else a for a in args))
    with pytest.raises(ValueError, match="together"):
        trd.dense_telemetry(*args[:-1], None)


def test_dense_elect_gives_winners_only_when_asked():
    kw = {**BASE, **CASES["dense-n64"]}
    cfg = Config(**kw)
    # Round 6 elects a leader in sweep 0.
    st = runner.advance(cfg, runner.init(cfg, runner.make_seeds(cfg), "cpu"),
                        0, 6)
    deliver = trd.delivery(st.seed, 6, 64, cfg.drop_cutoff,
                           cfg.partition_cutoff)
    args = (cfg, st.seed, 6, deliver, st.term, st.role, st.voted_for,
            st.timer, st.timeout, st.log_term, st.log_len)
    plain = trd.dense_elect(*args, st.match_idx.clone(), st.next_idx.clone())
    with_win = trd.dense_elect(*args, st.match_idx.clone(),
                               st.next_idx.clone(), True)
    assert len(plain) == 6 and len(with_win) == 7
    for a, b in zip(plain, with_win):
        assert torch.equal(a, b)
    win, lead = with_win[6], with_win[1] == trd.ROLE_L
    assert win.dtype == torch.bool and win.any()
    # A winner leads; a node that leads now and did not at the round's
    # entry won.
    assert not (win & ~lead).any()
    assert torch.equal(win & (st.role != trd.ROLE_L),
                       lead & (st.role != trd.ROLE_L))
