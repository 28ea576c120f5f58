"""The port's knob batch (``runner.run_knob_batch``, K23) on the capped Raft
engine under the SPEC §9 switch against the JAX package's, on the CPU.

At N = 32 with A = 4 and K = 2 and 4 aggregators, the lanes vary drop and
partition, which feed kernel KAL's uplinks and kernel KB's SWITCH
instance's downlinks: the base's row, one with more drop and partition
and one with the partition zeroed. Every leaf of the extract and every
window and latency series equals the JAX package's, and each lane the
port's production run of its config. Tolerance: exact.
"""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402

from test_torch_knobs_capped import CAPPED, _run  # noqa: E402

SWITCH = dict(n_nodes=32, n_rounds=32, n_sweeps=3, drop_rate=0.2,
              partition_rate=0.1, churn_rate=0.03, net_model="switch",
              agg_fail_rate=0.05, **CAPPED)
LANES = ({}, dict(drop_rate=0.5, partition_rate=0.3),
         dict(partition_rate=0.0, drop_rate=0.05))


@pytest.mark.parametrize("k", (2, 4))
def test_capped_switch_equals_jax_and_production(k):
    """The SPEC §9 switch at K aggregators, drop and partition per lane."""
    _run(JConfig(n_aggregators=k, **SWITCH), LANES, (11, 3, 5))
