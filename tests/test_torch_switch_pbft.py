"""The port's SPEC §9 switch on PBFT, whole runs, against the JAX package
and the C++ oracle, on the CPU.

The five PBFT cases of the JAX package's switch parity grid
(``tests/test_aggregate.py:58-75``: the dense and the §6b engine under the
composed adversary of drops, partitions, churn, a §A.2 delay and §6c
crashes, and each with equivocating and the §6b engine with silent
byzantine nodes) go through the port's plain path (kernels KAL, KAM and
KAN's plain versions): every leaf of the extract and the decided payload
equal the JAX package's and the oracle's, and with telemetry and 4-round
windows every counter (the aggregation tail among them), window and
latency bucket equals the JAX package's, tolerance 0. The geometry and
the §9b scenario are in ``tests/test_torch_switch_pbft_geometry.py``, the
ladders in ``tests/test_torch_switch_pbft_ladder.py``, single rounds in
``tests/test_torch_switch_pbft_steps.py``.
"""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402

from torch_byz_helpers import run_and_hold, telemetry_holds  # noqa: E402

SW = dict(net_model="switch", n_aggregators=3, agg_fail_rate=0.15,
          agg_stale_rate=0.25, agg_max_stale=3)
# The parity grid's composed adversary (tests/test_aggregate.py:36-37).
ADV = dict(drop_rate=0.2, partition_rate=0.1, churn_rate=0.03,
           max_delay_rounds=2, crash_prob=0.08, recover_prob=0.3)
# tests/test_aggregate.py:58-75, the PBFT cases.
PARITY = {
    "pbft-edge": dict(protocol="pbft", f=2, n_nodes=7, n_rounds=64,
                      n_sweeps=2, log_capacity=16, seed=3, **ADV, **SW),
    "pbft-edge-byz-equiv": dict(protocol="pbft", f=3, n_nodes=10,
                                n_rounds=48, n_sweeps=2, log_capacity=16,
                                seed=6, drop_rate=0.15, partition_rate=0.1,
                                n_byzantine=2, byz_mode="equivocate", **SW),
    "pbft-bcast": dict(protocol="pbft", fault_model="bcast", f=2, n_nodes=7,
                       n_rounds=64, n_sweeps=2, log_capacity=16, seed=3,
                       **ADV, **SW),
    "pbft-bcast-byz-equiv": dict(protocol="pbft", fault_model="bcast", f=3,
                                 n_nodes=10, n_rounds=48, n_sweeps=2,
                                 log_capacity=16, seed=5, drop_rate=0.15,
                                 partition_rate=0.1, n_byzantine=2,
                                 byz_mode="equivocate", **SW),
    "pbft-bcast-byz-silent": dict(protocol="pbft", fault_model="bcast", f=3,
                                  n_nodes=10, n_rounds=48, n_sweeps=1,
                                  log_capacity=16, seed=9, drop_rate=0.2,
                                  n_byzantine=3, byz_mode="silent", **SW),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_whole_run_matches_jax_and_the_oracle(name):
    run_and_hold(JConfig(**PARITY[name]), name)


@pytest.mark.parametrize("name", list(PARITY))
def test_telemetry_matches_jax(name):
    """Every counter, window and bucket; the aggregation tail counts failed
    and stale aggregators, and the crash runs their crashes."""
    tel = telemetry_holds(PARITY[name], name)
    assert tel["agg_down_rounds"].sum() > 0, name
    assert tel["stale_serves"].sum() > 0, name
    assert tel["commits_adopted"].sum() > 0, name
    if "crash_prob" in PARITY[name]:
        assert tel["crashes"].sum() > 0, name
