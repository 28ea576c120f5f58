"""The port's SPEC §B view desync against the JAX package, on the CPU.

Each round a node's local timer jumps ahead by d in [1, max_skew_rounds]
where its STREAM_DESYNC draw fires (``consensus_tpu/ops/viewsync.py``
``desync_skew``, keyed by absolute node ids); a skewed timer that reaches
``view_timeout`` fires a premature view change. The same seeds go through
``consensus_tpu`` and through the port's plain versions; everything must
be equal, tolerance 0: the skew itself on every draw shape; whole runs of
dense PBFT, §6b PBFT and HotStuff at the JAX package's own desync cases
(``tests/test_pbft.py``, ``tests/test_pbft_bcast.py``,
``tests/test_hotstuff.py``) against the JAX package and the C++ oracle,
with telemetry and the flight recorder on one of each; both f-ladders rung
by rung (``tests/test_pbft_sweep.py`` test_padded_desync_equals_unpadded);
one round from a converted JAX carry of each engine; ``desync_rate = 0``
runs the flat round (no kernel KAJ); and the CUDA graph's key holds both
knobs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.engines import pbft_sweep as jsweep  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu.ops import viewsync as jviewsync  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.core import rng  # noqa: E402
from consensus_tpu_torch.engines import hotstuff, pbft_sweep  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402
from consensus_tpu_torch.ops import viewsync  # noqa: E402

SEEDS = (0, 0xFFFFFFFF, 12345)
CUTS = (0, rng.prob_threshold_u32(0.3), rng.prob_threshold_u32(1.0))


# --- the skew ------------------------------------------------------------------

@pytest.mark.parametrize("r", [0, 1, 200])
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_desync_skew_matches_jax(n, r):
    """desync_skew_plain is JAX's desync_skew on every lane, for every
    depth 1..8 and the cutoffs 0 (never), mid and the largest (always)."""
    seed = torch.tensor(SEEDS, dtype=torch.int64).to(torch.uint32)
    ids = torch.arange(n, dtype=torch.int64)
    jseed = jnp.asarray(SEEDS, dtype=jnp.uint32)[:, None]
    jids = jnp.arange(n, dtype=jnp.uint32)[None, :]
    for cut in CUTS:
        for max_skew in range(1, 9):
            got = viewsync.desync_skew_plain(seed, r, ids, cut, max_skew)
            assert got.dtype == torch.int32 and got.shape == (len(SEEDS), n)
            want = np.asarray(jviewsync.desync_skew(jseed, r, jids, cut,
                                                    max_skew))
            assert np.array_equal(got.numpy(), want), (cut, max_skew)
            if cut == 0:
                assert not got.any()
            else:
                assert (got <= max_skew).all()
                if cut == CUTS[-1]:
                    assert (got >= 1).all()


# --- whole runs ------------------------------------------------------------------

W = 6
# The JAX package's desync cases without the gates the port rejects:
# tests/test_pbft.py:42, tests/test_pbft_bcast.py:44 and :48,
# tests/test_hotstuff.py:39 and :51.
PBFT_BASE = dict(protocol="pbft", n_rounds=64, log_capacity=16, n_sweeps=4,
                 seed=777)
BCAST_BASE = dict(protocol="pbft", fault_model="bcast", n_rounds=48,
                  log_capacity=16, n_sweeps=2, seed=77, view_timeout=8,
                  drop_rate=0.1, partition_rate=0.05, churn_rate=0.05)
HOTSTUFF_BASE = dict(protocol="hotstuff", f=2, n_nodes=7, n_rounds=96,
                     n_sweeps=3, log_capacity=96, seed=3)
RUNS = {
    "pbft-f2": {**PBFT_BASE, "f": 2, "n_nodes": 7, "desync_rate": 0.2,
                "max_skew_rounds": 4, "view_timeout": 4, "drop_rate": 0.15,
                "seed": 10},
    "bcast-f2": {**BCAST_BASE, "f": 2, "n_nodes": 7, "desync_rate": 0.2,
                 "max_skew_rounds": 4, "view_timeout": 4, "seed": 23},
    "bcast-f100": {**BCAST_BASE, "f": 100, "n_nodes": 301, "n_rounds": 24,
                   "desync_rate": 0.1, "max_skew_rounds": 3,
                   "view_timeout": 4, "seed": 29},
    "hotstuff-n7": {**HOTSTUFF_BASE, "desync_rate": 0.15,
                    "max_skew_rounds": 4, "view_timeout": 4,
                    "drop_rate": 0.25, "seed": 11},
    "hotstuff-n1024": {**HOTSTUFF_BASE, "f": 341, "n_nodes": 1024,
                       "n_rounds": 32, "n_sweeps": 1, "log_capacity": 32,
                       "desync_rate": 0.1, "max_skew_rounds": 4,
                       "view_timeout": 4, "drop_rate": 0.1,
                       "partition_rate": 0.05, "seed": 17},
}
# The cases also run with telemetry and W-round windows.
TELEMETRY = ("pbft-f2", "bcast-f2", "hotstuff-n7")


def _same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    else:
        assert np.array_equal(np.asarray(got), np.asarray(want)), where


@pytest.mark.parametrize("name", list(RUNS))
def test_whole_run_matches_jax_and_the_oracle(name):
    """Every extract leaf and the digest equal JAX's and the oracle's; at
    N = 7 the skew moved the run: its views differ from the flat run's."""
    kw = RUNS[name]
    jcfg, cfg = JConfig(**kw), Config(**kw)
    want = jrunner.run(jcfg, jsim.engine_def(jcfg))
    got = runner.run(cfg, "cpu")
    _same(got, want, name)
    payload = simulator.decided_payload(cfg, got)[3]
    assert payload == jsim.decided_payload(jcfg, want)[3]
    cpu = jsim.run(dataclasses.replace(jcfg, engine="cpu"), warmup=False)
    assert cpu.payload == payload
    if cfg.n_nodes == 7:
        flat = runner.run(Config(**{**kw, "desync_rate": 0.0,
                                    "max_skew_rounds": 1}), "cpu")
        assert not np.array_equal(flat["view"], got["view"])


@pytest.mark.parametrize("name", TELEMETRY)
def test_telemetry_matches_jax(name):
    """Counters and recorder under the skew, premature timeouts counted
    as view changes (HotStuff) and the view spread nonzero."""
    kw = {**RUNS[name], "n_rounds": 18, "telemetry_window": W}
    want = jsim.run(JConfig(**kw), warmup=False, telemetry=True)
    stats: dict = {}
    out = runner.run(Config(**kw), "cpu", telemetry=True, stats=stats)
    assert simulator.decided_payload(Config(**kw), out)[3] == want.payload
    _same(stats["telemetry"], want.extras["telemetry"]["per_sweep"],
          "telemetry")
    _same(stats["flight"], {k: v for k, v in want.extras["flight"].items()
                            if k != "engine"}, "flight")
    tel = stats["telemetry"]
    assert tel["view_spread_max"].sum() > 0 and tel["desync_rounds"].sum() > 0
    assert tel["view_changes"].sum() > 0


# SPEC §B on both f-ladders: tests/test_pbft_sweep.py BASE and BCAST (f = 1,
# 24 rounds, 8 slots, seed 7, drop 0.15, partitions 0.05, churn 0.05) with
# desync 0.2, depth 4 and view_timeout 4, rungs (1, 2).
LADDER_BASE = dict(protocol="pbft", f=1, n_nodes=4, n_rounds=24,
                   log_capacity=8, seed=7, drop_rate=0.15,
                   partition_rate=0.05, churn_rate=0.05, desync_rate=0.2,
                   max_skew_rounds=4, view_timeout=4)


@pytest.mark.parametrize("fault_model", ["edge", "bcast"])
def test_ladder_rung_by_rung_matches_jax(fault_model):
    """Each rung of the port's ladder equals the JAX package's ladder's
    rung and the oracle's standalone run of the rung (f = fs[k], seed +
    k): the skew is keyed by absolute ids, so padding leaves it
    unchanged."""
    kw = {**LADDER_BASE, "fault_model": fault_model}
    fs = (1, 2)
    got = pbft_sweep.rung_payloads(pbft_sweep.pbft_fsweep_run(
        Config(**kw), fs, device="cpu"))
    assert got == jsweep.rung_payloads(jsweep.pbft_fsweep_run(JConfig(**kw),
                                                              fs))
    for k, f in enumerate(fs):
        rung = JConfig(**{**kw, "f": f, "n_nodes": 3 * f + 1,
                          "seed": kw["seed"] + k})
        assert got[k] == jsim.run(dataclasses.replace(rung, engine="cpu"),
                                  warmup=False).payload


# --- one round from a converted JAX carry ----------------------------------------

def _leaves(carry) -> dict:
    return {k: np.array(v) for k, v in carry._asdict().items()}


STEP_CASES = {"pbft": RUNS["pbft-f2"], "pbft-bcast": RUNS["bcast-f2"],
              "hotstuff": RUNS["hotstuff-n7"]}
STEP = 13


@pytest.mark.parametrize("engine", list(STEP_CASES))
def test_one_round_from_jax_state(engine):
    """Round 13 of the JAX scan from its converted carry: the port's round
    gives the carry JAX's round gives."""
    kw = STEP_CASES[engine]
    jcfg, cfg = JConfig(**kw), Config(**kw)
    eng = jsim.engine_def(jcfg)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    for r in range(STEP):
        carry = jrunner._chunk_jit(jcfg, eng, 1, carry, jnp.int32(r))
    before = _leaves(carry)
    after = _leaves(jrunner._chunk_jit(jcfg, eng, 1, carry,
                                       jnp.int32(STEP)))
    lanes = {k: v for k, v in runner.device_lanes(cfg, None, "cpu").items()
             if k != "seed"}
    st = runner.advance(cfg, convert.state_from_numpy(before), STEP, 1,
                        lanes=lanes)
    got = convert.state_to_numpy(st)
    assert set(got) == set(after)
    for name in after:
        assert got[name].dtype == after[name].dtype, name
        assert np.array_equal(got[name], after[name]), (engine, name)


# --- the gate's edges -------------------------------------------------------------

@pytest.mark.parametrize("name", ["pbft-f2", "bcast-f2", "hotstuff-n7"])
def test_desync_off_is_digest_neutral(name):
    """desync_rate = 0 is the flat run (the JAX package's static gate):
    the flat round, without kernel KAJ on HotStuff, as the JAX package's
    oracle gives it."""
    kw = {**RUNS[name], "desync_rate": 0.0, "max_skew_rounds": 1,
          "n_rounds": 24}
    cfg = Config(**kw)
    assert not cfg.desync_on and not hotstuff.gated(cfg)
    calls = []
    real = hotstuff.hotstuff_prologue

    def counting(*args):
        calls.append(args)
        return real(*args)
    hotstuff.hotstuff_prologue = counting
    try:
        got = simulator.run(cfg, device="cpu")
    finally:
        hotstuff.hotstuff_prologue = real
    assert not calls
    assert got.payload == jsim.run(JConfig(**kw, engine="cpu"),
                                   warmup=False).payload


def test_the_graph_key_holds_both_desync_knobs():
    """A CUDA graph is cached per config but its seed, so runs that differ
    in their desync rate or depth never share one."""
    a = Config(**RUNS["hotstuff-n7"])
    dev = torch.device("cpu")
    for b in (dataclasses.replace(a, desync_rate=0.2),
              dataclasses.replace(a, max_skew_rounds=3)):
        assert runner._graph_key(a, dev, False, None) != \
            runner._graph_key(b, dev, False, None)
    assert runner._graph_key(a, dev, False, None) == \
        runner._graph_key(dataclasses.replace(a, seed=5), dev, False, None)
