"""The port's SPEC §3c byzantine Raft nodes against the JAX package, on the
CPU: one round from a JAX carry, composed runs and the telemetry.

The same seeds go through ``consensus_tpu`` and through the port's plain
versions of kernels KC-KI (capped) and KL-KO (dense), tolerance 0: one
round from a converted JAX carry of each engine and mode
(``tests/test_raft_byz.py``'s cases, after the first elections); a run with
byzantine nodes, a crash and a delay on each engine, against the JAX
package and the C++ oracle; those runs' telemetry (the crash tail too)
with 4-round windows; and ``n_byzantine = 0`` runs the flat round in both
modes.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch.network import simulator  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_raft_byz import CONFIGS  # noqa: E402
from torch_byz_helpers import (one_round_from_jax, port,  # noqa: E402
                               run_and_hold, telemetry_holds)

STEP_CASES = {"capped-silent": CONFIGS[6][1],
              "capped-equivocate": CONFIGS[8][1],
              "dense-silent": CONFIGS[2][1],
              "dense-equivocate": CONFIGS[4][1]}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_round_from_jax_state(case):
    one_round_from_jax(STEP_CASES[case], 21, case)


# Byzantine nodes, a crash and a delay together, on each engine.
COMPOSED = {
    "dense-equivocate": dict(protocol="raft", n_nodes=9, n_rounds=64,
                             log_capacity=32, max_entries=24, n_sweeps=2,
                             seed=53, n_byzantine=3, byz_mode="equivocate",
                             drop_rate=0.3, crash_prob=0.1,
                             recover_prob=0.3, max_delay_rounds=3),
    "capped-silent": dict(protocol="raft", n_nodes=11, n_rounds=64,
                          log_capacity=32, max_entries=24, n_sweeps=2,
                          max_active=3, seed=59, n_byzantine=4,
                          drop_rate=0.3, churn_rate=0.05, crash_prob=0.1,
                          recover_prob=0.3, max_crashed=3,
                          max_delay_rounds=3),
}


@pytest.mark.parametrize("name", list(COMPOSED))
def test_composed_run_matches_jax_and_the_oracle(name):
    run_and_hold(JConfig(**COMPOSED[name]), name)


@pytest.mark.parametrize("name", list(COMPOSED))
def test_telemetry_matches_jax(name):
    tel = telemetry_holds({**COMPOSED[name], "n_rounds": 24}, name)
    assert np.asarray(tel["crashes"]).sum() > 0


@pytest.mark.parametrize("mode", ["silent", "equivocate"])
@pytest.mark.parametrize("max_active", [0, 2])
def test_no_byzantine_node_is_digest_neutral(mode, max_active):
    """n_byzantine = 0 runs the flat round whatever byz_mode says (the
    oracle's flat run); with byzantine nodes the silent run differs from
    it."""
    kw = dict(dataclasses.asdict(CONFIGS[1][1]), max_active=max_active,
              n_byzantine=0, byz_mode=mode, n_rounds=32, engine="tpu")
    cfg = port(JConfig(**kw))
    assert cfg.byz == 0
    got = simulator.run(cfg, device="cpu")
    assert got.payload == jsim.run(JConfig(**{**kw, "engine": "cpu"}),
                                   warmup=False).payload
    if mode == "silent":
        byz = simulator.run(dataclasses.replace(cfg, n_byzantine=2),
                            device="cpu")
        assert byz.payload != got.payload
