"""The port's telemetry and flight recorder on the dense and §6b PBFT, DPoS
and Paxos engines (kernels KAA-KAC's plain versions, the runner's
engine-generic accumulators) against the JAX package's, on the CPU.

The same Config runs through ``consensus_tpu.network.runner.run`` with
``telemetry=True`` and through ``consensus_tpu_torch``'s: the per-sweep
counters, the window ring (W = 6 over 20 rounds, so the last window is
ragged) and the latency buckets must be equal, bit for bit, and so must
the decided-log digest with telemetry on and off. One round from random
states (views that differ across nodes, so that P1 catches up and the
view spread is not 0) holds each tail to the JAX round's counter vector
and histograms; the optional outputs that KQ, KT, KX, KY and KZ give the
telemetry are held to what they count.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.engines import dpos as jdpos  # noqa: E402
from consensus_tpu.engines import paxos as jpaxos  # noqa: E402
from consensus_tpu.engines import pbft as jpbft  # noqa: E402
from consensus_tpu.engines import pbft_bcast as jbcast  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu.ops import viewsync as jviewsync  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.engines import dpos, paxos, pbft  # noqa: E402
from consensus_tpu_torch.engines import pbft_bcast  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402
from consensus_tpu_torch.ops import adversary, viewsync  # noqa: E402
from consensus_tpu_torch.ops.flight import N_BUCKETS  # noqa: E402

W = 6
HOSTILE = dict(n_rounds=20, n_sweeps=2, drop_rate=0.15, partition_rate=0.1,
               churn_rate=0.05, telemetry_window=W)
CASES = {
    "pbft-n7": dict(protocol="pbft", f=2, n_nodes=7, log_capacity=8, seed=3),
    "pbft-n31": dict(protocol="pbft", f=10, n_nodes=31, log_capacity=8,
                     seed=7),
    "bcast-n100": dict(protocol="pbft", fault_model="bcast", f=33,
                       n_nodes=100, log_capacity=8, seed=7),
    "dpos-v500": dict(protocol="dpos", n_nodes=500, n_candidates=40,
                      n_producers=5, epoch_len=8, log_capacity=16, seed=5),
    "paxos-n64": dict(protocol="paxos", n_nodes=64, log_capacity=64,
                      n_proposers=20, seed=4),
}


@pytest.fixture(scope="module")
def jax_runs():
    """{case: the JAX package's simulator.run with telemetry}."""
    return {case: jsim.run(JConfig(**HOSTILE, **kw), warmup=False,
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
    cfg = Config(**HOSTILE, **CASES[case])
    stats: dict = {}
    out = runner.run(cfg, device="cpu", telemetry=True, stats=stats)
    assert simulator.decided_payload(cfg, out)[3] == want.payload
    _assert_same(stats["telemetry"], want.extras["telemetry"]["per_sweep"])
    _assert_same(stats["flight"], {k: v for k, v in want.extras["flight"]
                                   .items() if k != "engine"})
    assert stats["flight"]["n_windows"] == 4       # windows of 6, 6, 6, 2
    for name, total in stats["telemetry"].items():
        assert np.array_equal(stats["flight"]["windows"][name].sum(1),
                              total), name
    # The counters count: the first of each engine's vector is not 0.
    assert stats["telemetry"][runner.engine(cfg).telemetry_names[0]].min() > 0
    # The front door's extras, and the same decided logs without telemetry.
    res = simulator.run(cfg, device="cpu", telemetry=True)
    assert res.digest == want.digest
    _assert_same(res.extras["telemetry"], want.extras["telemetry"])
    _assert_same(res.extras["flight"], want.extras["flight"])
    off = Config(**{**HOSTILE, **CASES[case], "telemetry_window": 0})
    assert simulator.run(off, device="cpu").digest == want.digest
    # Telemetry without the flight recorder.
    stats = {}
    runner.run(off, device="cpu", telemetry=True, stats=stats)
    _assert_same(stats["telemetry"], want.extras["telemetry"]["per_sweep"])
    assert "flight" not in stats


def test_names_match_jax():
    assert pbft.PBFT_TELEMETRY == jpbft.PBFT_TELEMETRY
    assert pbft.PBFT_LATENCY == jpbft.PBFT_LATENCY
    assert dpos.DPOS_TELEMETRY == jdpos.DPOS_TELEMETRY
    assert dpos.DPOS_LATENCY == jdpos.DPOS_LATENCY
    assert paxos.PAXOS_TELEMETRY == jpaxos.PAXOS_TELEMETRY
    assert paxos.PAXOS_LATENCY == jpaxos.PAXOS_LATENCY
    assert viewsync.SYNC_TELEMETRY == jviewsync.SYNC_TELEMETRY
    for kw in CASES.values():
        jeng = jsim.engine_def(JConfig(**kw))
        eng = runner.engine(Config(**kw))
        assert eng.telemetry_names == jeng.telemetry_names
        assert eng.latency_names == jeng.latency_names


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sync_counts_matches_jax(seed):
    g = np.random.default_rng(seed)
    B, N = 6, 9
    view = g.integers(-5, 2**31 - 1 if seed == 2 else 8,
                      (B, N)).astype(np.int32)
    if seed == 2:
        view[:, 0] = -2**31                     # the spread wraps in int32
    mask = g.random((B, N)) < 0.5
    mask[0] = False                             # an empty mask
    mask[1] = False
    mask[1, 3] = True                           # one node
    delivered = g.random((B, N)) < 0.3
    got = viewsync.sync_counts_plain(torch.from_numpy(view),
                                     torch.from_numpy(mask),
                                     torch.from_numpy(delivered)).numpy()
    want = np.stack([np.array(jviewsync.sync_counts(
        jnp.asarray(view[b]), jnp.asarray(mask[b]),
        jnp.asarray(delivered[b]))) for b in range(B)])
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert got[0, 0] == 0 and got[1, 0] == 0 and (got[:, 1] > 0).any()


# --- one round from random states: each tail against the JAX round's ---------

def pbft_state(g, B, N, S):
    """A batched PbftState as numpy leaves whose views differ across
    nodes (P1 catches up, the spread is not 0)."""
    view = g.integers(0, 6, (B, N)).astype(np.int32)
    pp_seen = g.random((B, N, S)) < 0.6
    pp_val = g.integers(0, 3, (B, N, S)).astype(np.int32)
    prepared = pp_seen & (g.random((B, N, S)) < 0.5)
    committed = prepared & (g.random((B, N, S)) < 0.4)
    return {"seed": np.arange(100, 100 + B, dtype=np.uint32), "view": view,
            "timer": g.integers(0, 10, (B, N)).astype(np.int32),
            "pp_seen": pp_seen,
            "pp_view": np.where(pp_seen, np.minimum(g.integers(
                0, 6, (B, N, S)), view[:, :, None]), 0).astype(np.int32),
            "pp_val": pp_val, "prepared": prepared, "committed": committed,
            "dval": np.where(committed, pp_val, 0).astype(np.int32),
            "down": np.zeros((B, N), bool)}


def dpos_state(g, B, cfg):
    V, L = cfg.n_nodes, cfg.log_capacity
    chain_len = g.integers(0, L + 1, (B, V)).astype(np.int32)
    chain_len[:, ::3] = L
    return {"seed": np.arange(40, 40 + B, dtype=np.uint32),
            "producers": g.integers(0, cfg.n_candidates, (
                B, dpos.n_epochs(cfg), cfg.n_producers)).astype(np.int32),
            "chain_r": g.integers(0, cfg.n_rounds, (B, V, L)).astype(
                np.uint8),
            "chain_p": g.integers(0, cfg.n_candidates, (B, V, L)).astype(
                np.uint8),
            "chain_len": chain_len, "down": np.zeros((B, V), bool)}


def paxos_state(g, B, N, S, r):
    hi = (r + 1) * N + 1
    return {"seed": np.arange(70, 70 + B, dtype=np.uint32),
            "promised": g.integers(0, hi, (B, N, S)).astype(np.int32),
            "acc_bal": g.choice(np.array([0, 3, 5, hi], np.int32),
                                (B, N, S)),
            "acc_val": g.integers(-3, 3, (B, N, S)).astype(np.int32),
            "learned_val": g.integers(-9, 9, (B, N, S)).astype(np.int32),
            "learned_mask": g.random((B, N, S)) < 0.5,
            "down": np.zeros((B, N), bool)}


RANDOM = {
    "pbft": dict(protocol="pbft", f=2, n_nodes=7, log_capacity=8,
                 view_timeout=4, drop_rate=0.3, partition_rate=0.3),
    "bcast": dict(protocol="pbft", fault_model="bcast", f=3, n_nodes=10,
                  log_capacity=8, view_timeout=4, drop_rate=0.3,
                  partition_rate=0.3),
    "dpos": dict(protocol="dpos", n_nodes=60, n_candidates=9,
                 n_producers=4, epoch_len=4, log_capacity=16,
                 drop_rate=0.3, partition_rate=0.3, churn_rate=0.2),
    "paxos": dict(protocol="paxos", n_nodes=16, log_capacity=7,
                  drop_rate=0.4, churn_rate=0.2),
}


def _jax_tail(name, jcfg):
    """The JAX round of engine ``name`` with its telemetry and recorder,
    jitted over the lanes: (batched numpy leaves, r) -> (counter vector,
    histograms) per lane."""
    if name == "dpos":
        step = jax.jit(jax.vmap(lambda p, s, r: jdpos.dpos_round(
            jcfg, p, s, r, telem=True, flight=True)[1:],
            in_axes=(0, 0, None)))

        def run(leaves, r):
            producers, rest = convert.dpos_carry(leaves)
            return step(jnp.asarray(producers), jdpos.DposState(
                **{k: jnp.asarray(v) for k, v in rest.items()}),
                jnp.int32(r))
        return run
    rnd, kind = {"pbft": (jpbft.pbft_round, jpbft.PbftState),
                 "bcast": (jbcast.pbft_bcast_round, jpbft.PbftState),
                 "paxos": (jpaxos.paxos_round, jpaxos.PaxosState)}[name]
    step = jax.jit(jax.vmap(lambda s, r: rnd(jcfg, s, r, telem=True,
                                             flight=True)[1:],
                            in_axes=(0, None)))
    return lambda leaves, r: step(kind(**{k: jnp.asarray(v) for k, v in
                                          leaves.items()}), jnp.int32(r))


@pytest.mark.parametrize("name", list(RANDOM))
def test_tail_from_random_states_matches_jax(name):
    kw = {**RANDOM[name], "n_rounds": 20, "telemetry_window": W}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    g = np.random.default_rng(len(name))
    B, N, S = 6, cfg.n_nodes, cfg.log_capacity
    tail = _jax_tail(name, jcfg)
    moved = 0
    for r in (0, 3, 13, 19):
        leaves = {"pbft": lambda: pbft_state(g, B, N, S),
                  "bcast": lambda: pbft_state(g, B, N, S),
                  "dpos": lambda: dpos_state(g, B, cfg),
                  "paxos": lambda: paxos_state(g, B, N, S, r)}[name]()
        st = convert.state_from_numpy(leaves)
        lane_cfg = dataclasses.replace(cfg, n_sweeps=B)
        telem, flight = runner.accumulators(lane_cfg, "cpu")
        lanes = {k: v for k, v in runner.device_lanes(
            lane_cfg, None, "cpu").items() if k != "seed"}
        if name == "bcast":
            lanes["m"] = pbft_bcast.table_cap(cfg)
        runner.engine(cfg).round(cfg, st, r, telem=telem, flight=flight,
                                 **lanes)
        vec, lat = (np.asarray(a) for a in tail(leaves, r))
        assert np.array_equal(telem.numpy(), vec), r
        assert np.array_equal(flight[0][:, r // W].numpy(), vec), r
        assert not flight[0][:, [w for w in range(4) if w != r // W]].any()
        assert np.array_equal(flight[1].numpy(), lat), r
        moved += int((vec != 0).sum())
        if name in ("pbft", "bcast"):
            k = len(pbft.PBFT_TELEMETRY)
            # The view spread and the catch-ups are not all 0.
            assert vec[:, k - 3].any() and vec[:, k - 1].any()
    assert moved > 0


# --- the optional outputs the telemetry asks of KQ, KT, KX, KY and KZ --------

def _pbft_args(name):
    kw = RANDOM[name]
    cfg = Config(**kw, n_rounds=20, n_sweeps=4)
    st = convert.state_from_numpy(pbft_state(np.random.default_rng(3), 4,
                                             cfg.n_nodes, cfg.log_capacity))
    lanes = runner.device_lanes(cfg, None, "cpu")
    return cfg, st, lanes["n_real"], lanes["f"]


def test_kq_catch_flags():
    """KQ gives the same six results with and without its catch-up flags,
    and a flagged node's view moved past its churn step."""
    cfg, st, n_real, f = _pbft_args("pbft")
    r = 7
    deliver = adversary.delivery(st.seed, r, cfg.n_nodes, cfg.drop_cutoff,
                                 cfg.partition_cutoff)
    args = (cfg, st.seed, r, deliver, n_real, f, st.view, st.timer,
            st.pp_seen, st.pp_view, st.pp_val, st.prepared, st.committed)
    plain = pbft.pbft_view_preprepare(*args)
    flagged = pbft.pbft_view_preprepare(*args, True)
    assert len(plain) == 6 and len(flagged) == 7
    for a, b in zip(plain, flagged):
        assert torch.equal(a, b)
    catch = flagged[6]
    assert catch.dtype == torch.bool and catch.any() and not catch.all()
    assert (flagged[0][catch] > st.view[catch]).all()
    assert flagged[2][catch].all()                      # reset


def test_kt_catch_flags():
    cfg, st, n_real, f = _pbft_args("bcast")
    args = (cfg, st.seed, 7, n_real, f, st.view, st.timer, st.pp_seen,
            st.pp_view, st.pp_val, st.prepared, st.committed)
    plain = pbft_bcast.bcast_view_preprepare(*args)
    flagged = pbft_bcast.bcast_view_preprepare(*args, True)
    assert len(plain) == 7 and len(flagged) == 8
    for a, b in zip(plain, flagged):
        assert torch.equal(a, b)
    catch = flagged[7]
    assert catch.dtype == torch.bool and catch.any()
    assert (flagged[0][catch] > st.view[catch]).all()


def test_kx_append_count():
    kw = {**RANDOM["dpos"], "n_rounds": 20}
    cfg = Config(**kw, n_sweeps=4)
    leaves = dpos_state(np.random.default_rng(4), 4, cfg)
    args = lambda st: (cfg, st.seed, 5, st.producers, st.chain_r,  # noqa
                       st.chain_p, st.chain_len)
    a = convert.state_from_numpy(leaves)
    b = convert.state_from_numpy(leaves)
    plain = dpos.dpos_round(*args(a))
    counted = dpos.dpos_round(*args(b), True)
    assert len(plain) == 3 and len(counted) == 4
    for x, y in zip(plain, counted):
        assert torch.equal(x, y)
    n_app = counted[3]
    assert n_app.dtype == torch.int32 and n_app.shape == (4,)
    assert torch.equal(n_app, (counted[2] - torch.from_numpy(
        leaves["chain_len"])).sum(1, dtype=torch.int32))
    assert (n_app > 0).any()


def test_ky_kz_counts():
    """KY's pair counts bound its promises and count both flights of each
    proposing node; KZ's accepted responses and decided flags are its
    phase 5, and the results without them are unchanged."""
    kw = {**RANDOM["paxos"], "n_rounds": 20}
    cfg = Config(**kw, n_sweeps=3)
    N, S, r = cfg.n_nodes, cfg.log_capacity, 6
    st = convert.state_from_numpy(paxos_state(np.random.default_rng(6), 3, N,
                                              S, r))
    deliver = adversary.delivery(st.seed, r, N, cfg.drop_cutoff,
                                 cfg.partition_cutoff)
    ky = (cfg, st.seed, r, deliver, st.promised, st.acc_bal)
    plain = paxos.paxos_promise(*ky)
    paired = paxos.paxos_promise(*ky, True)
    assert len(plain) == 5 and len(paired) == 6
    for a, b in zip(plain, paired):
        assert torch.equal(a, b)
    n_prom, n_pair = paired[1], paired[5]
    is_prop = paxos.proposals(cfg, st.seed, r, N, S)[0]
    both = deliver & deliver.transpose(1, 2)
    assert torch.equal(n_pair, torch.where(is_prop, both.sum(
        1, dtype=torch.int32), 0))
    assert (n_pair >= n_prom).all() and (n_pair > n_prom).any()
    kz = (cfg, st.seed, r, deliver, paired[4], paired[0], n_prom, paired[2],
          paired[3], st.acc_bal, st.acc_val, st.learned_val, st.learned_mask)
    plain = paxos.paxos_accept_learn(*kz)
    counted = paxos.paxos_accept_learn(*kz, True)
    assert len(plain) == 5 and len(counted) == 7
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)
    n_acc, decided = counted[5], counted[6]
    assert n_acc.dtype == decided.dtype == torch.int32
    majority = N // 2 + 1
    assert torch.equal(decided, (is_prop & (n_prom >= majority)
                                 & (n_acc >= majority)).to(torch.int32))
    assert decided.any()


# --- the runner ----------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_accumulators_take_the_engine_names(case):
    cfg = Config(**HOSTILE, **CASES[case])
    eng = runner.engine(cfg)
    telem, (win, lat) = runner.accumulators(cfg, "cpu")
    K, H = len(eng.telemetry_names), len(eng.latency_names)
    assert telem.shape == (2, K) and win.shape == (2, 4, K)
    assert lat.shape == (2, H, N_BUCKETS)
    assert {t.dtype for t in (telem, win, lat)} == {torch.int32}
    assert not any(t.any() for t in (telem, win, lat))
    assert (K, H) == {"pbft": (18, 2), "dpos": (9, 1),
                      "paxos": (11, 1)}[cfg.protocol]


@pytest.mark.parametrize("fault_model", ["edge", "bcast"])
def test_ladder_telemetry_raises(fault_model):
    cfg = Config(protocol="pbft", fault_model=fault_model, f=2, n_nodes=7,
                 n_rounds=4, log_capacity=8, n_sweeps=2)
    for window in (0, 2):
        pad = dataclasses.replace(cfg, telemetry_window=window)
        with pytest.raises(ValueError, match="f-ladder"):
            runner.run_device(pad, "cpu", telemetry=True, rungs=[1, 2])
