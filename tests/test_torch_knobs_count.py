"""The port's knob batch (``runner.run_knob_batch``, K23) on the count
engines against the JAX package's, on the CPU: dense Raft, dense PBFT,
Paxos and DPoS.

The port's ``run_knob_batch(device="cpu")`` must give the JAX package's
``run_knob_batch`` bit for bit: every leaf of the extract and every window
and latency series of the flight recorder. Covered: the four engines of
tests/test_advsearch.py's LANE_CASES (lines 50-79) with their variant rows
and a lane that zeroes a gated-on knob, each lane also a port production
run of its own config; a dense PBFT base without the SPEC §B desync whose
lanes vary the desync column, which both packages ignore. The helpers serve
tests/test_torch_knobs_count_sticky.py and _spaces.py too. Tolerance:
exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch.core import knobs  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402

from torch_byz_helpers import port  # noqa: E402

# A copy of tests/test_advsearch.py's LANE_CASES: (base, a variant's
# overrides).
LANE_CASES = {
    "dpos": (
        JConfig(protocol="dpos", n_nodes=24, n_rounds=64, n_sweeps=2,
                log_capacity=96, n_candidates=12, n_producers=6, seed=11,
                drop_rate=0.4, miss_rate=0.2, max_delay_rounds=4,
                telemetry_window=4),
        dict(drop_rate=0.1, miss_rate=0.05)),
    "raft": (
        JConfig(protocol="raft", n_nodes=7, n_rounds=64, n_sweeps=2,
                log_capacity=32, max_entries=24, seed=11, drop_rate=0.3,
                partition_rate=0.2, churn_rate=0.05, crash_prob=0.1,
                recover_prob=0.3, max_delay_rounds=4, telemetry_window=4),
        dict(drop_rate=0.55, crash_prob=0.02, partition_rate=0.0)),
    "pbft": (
        JConfig(protocol="pbft", f=2, n_nodes=7, n_rounds=64, n_sweeps=2,
                log_capacity=64, seed=11, drop_rate=0.3,
                partition_rate=0.15, churn_rate=0.03, crash_prob=0.1,
                recover_prob=0.3, telemetry_window=4),
        dict(drop_rate=0.45, churn_rate=0.1)),
    "paxos": (
        JConfig(protocol="paxos", n_nodes=9, n_rounds=64, n_sweeps=2,
                log_capacity=64, seed=11, drop_rate=0.3,
                partition_rate=0.15, churn_rate=0.03, crash_prob=0.1,
                recover_prob=0.3, telemetry_window=4),
        dict(drop_rate=0.5, crash_prob=0.25, recover_prob=0.1)),
}
# Each case's gated-on knob that a third lane zeroes.
ZEROED = {"dpos": dict(miss_rate=0.0), "raft": dict(crash_prob=0.0),
          "pbft": dict(partition_rate=0.0), "paxos": dict(churn_rate=0.0)}
COL = {name: i for i, name in enumerate(knobs.KNOB_COLUMNS)}


def jax_batch(jbase, seeds, kmat):
    return jrunner.run_knob_batch(jbase, jsim.engine_def(jbase), seeds,
                                  kmat)


def same_batch(got, want, where):
    """Every extract leaf (values and dtypes) and every window and latency
    series equal."""
    (out, flight), (jout, jflight) = got, want
    assert set(out) == set(jout), where
    for k, v in jout.items():
        np.testing.assert_array_equal(out[k], np.asarray(v),
                                      err_msg=f"{where} {k}")
        assert out[k].dtype == np.asarray(v).dtype, (where, k)
    for part in ("windows", "latency"):
        assert list(flight[part]) == list(jflight[part]), where
        for name, a in jflight[part].items():
            assert flight[part][name].dtype == np.int64, (where, name)
            np.testing.assert_array_equal(flight[part][name], a,
                                          err_msg=f"{where} {part} {name}")
    for key in ("engine", "window_rounds", "n_windows", "n_rounds",
                "bucket_lo"):
        assert flight[key] == jflight[key], (where, key)


def same_as_production(got, lane: int, cfg, seed: int, where):
    """Lane ``lane`` of the port's batch equals the port's production run
    of ``cfg`` (one sweep at ``seed``): extract and recorder."""
    out, flight = got
    stats: dict = {}
    one = dataclasses.replace(cfg, n_sweeps=1, seed=int(seed))
    ref = runner.run(one, "cpu", telemetry=True, stats=stats)
    for k, v in ref.items():
        np.testing.assert_array_equal(out[k][lane], v[0],
                                      err_msg=f"{where} lane {lane} {k}")
    for part in ("windows", "latency"):
        for name, v in stats["flight"][part].items():
            np.testing.assert_array_equal(
                flight[part][name][lane], v[0],
                err_msg=f"{where} lane {lane} {part} {name}")


@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_lane_cases_equal_jax_and_production(name):
    """LANE_CASES' base and variant rows and a row that zeroes a gated-on
    knob: the port's batch equals the JAX package's, and each lane equals
    the port's production run of its own config."""
    jbase, variant = LANE_CASES[name]
    jbase = dataclasses.replace(jbase, n_sweeps=3)
    base = port(jbase)
    cfgs = [base, dataclasses.replace(base, **variant),
            dataclasses.replace(base, **ZEROED[name])]
    kmat = np.array([knobs.base_row(c) for c in cfgs], np.uint32)
    assert len({tuple(r) for r in kmat.tolist()}) == 3, name
    seeds = jrunner.make_seeds(jbase)
    got = runner.run_knob_batch(base, seeds, kmat, device="cpu")
    same_batch(got, jax_batch(jbase, seeds, kmat), name)
    for lane, cfg in enumerate(cfgs):
        same_as_production(got, lane, cfg, seeds[lane], name)


def test_desync_column_ignored_without_the_gate():
    """A dense PBFT base with the SPEC §B desync off: lanes that vary the
    desync column (which JAX's gate table leaves out, so it does not raise)
    run as the base, in both packages."""
    jbase = dataclasses.replace(LANE_CASES["pbft"][0], n_sweeps=2,
                                n_rounds=32)
    base = port(jbase)
    assert not base.desync_on
    kmat = np.array([knobs.base_row(base)] * 2, np.uint32)
    kmat[1, COL["desync_cutoff"]] = 3 << 30
    seeds = np.array([9, 9], np.uint32)
    got = runner.run_knob_batch(base, seeds, kmat, device="cpu")
    same_batch(got, jax_batch(jbase, seeds, kmat), "desync off")
    for k, v in got[0].items():
        np.testing.assert_array_equal(v[0], v[1], err_msg=k)
