"""The port's knob batch (``runner.run_knob_batch``, K23) on dense Raft and
Paxos under the SPEC §9 switch against the JAX package's, on the CPU.

Covered: raft-elections' and paxos-slots' gates (tools/advsearch/search.py:
147-175: drop, partition, churn, crash and recover, max_delay_rounds 4)
under the switch at K = 2 and 3, with the base's row, a row that varies
drop and partition and a row that zeroes a gated-on knob. Every leaf of
the extract and every window and latency series equals the JAX package's,
and each lane the port's production run of its config. Tolerance: exact.
"""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402

from test_torch_knobs_capped import _run  # noqa: E402

GATES = dict(drop_rate=0.3, partition_rate=0.1, churn_rate=0.02,
             crash_prob=0.1, recover_prob=0.3, max_crashed=3,
             max_delay_rounds=4, net_model="switch", agg_fail_rate=0.05,
             n_rounds=40, n_sweeps=3, telemetry_window=4, seed=0)
# name -> (base, the lanes' overrides)
CASES = {
    "raft": (JConfig(protocol="raft", n_nodes=7, log_capacity=32,
                     max_entries=24, n_aggregators=2, **GATES),
             ({}, dict(drop_rate=0.55, partition_rate=0.3),
              dict(crash_prob=0.0))),
    "paxos": (JConfig(protocol="paxos", n_nodes=9, log_capacity=32,
                      n_aggregators=3, **GATES),
              ({}, dict(drop_rate=0.5, partition_rate=0.0),
               dict(churn_rate=0.0))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_switch_gates_equal_jax_and_production(name):
    jbase, overrides = CASES[name]
    _run(jbase, overrides, (11, 0xFFFFFFFF, 5))
