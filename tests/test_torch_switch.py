"""The port's SPEC §9 switch delivery, whole runs, against the JAX package
and the C++ oracle, on the CPU.

Every non-PBFT case of the JAX package's switch parity grid
(``tests/test_aggregate.py:39-91``: both Raft engines, their byzantine
cases, Paxos with all and with capped proposers, HotStuff with a byzantine
node, most under the composed adversary of drops, partitions, churn, a
§A.2 delay and §6c crashes) goes through the port's plain path: every leaf
of the extract and the decided payload equal the JAX package's and the
oracle's, and with telemetry and 4-round windows every counter (the
aggregation tail among them), window and latency bucket equals the JAX
package's, tolerance 0. Then the aggregation counters against a flat
run's, and the graph key. (The segment geometry, K = 1 to N, and the
switch without faults are in ``tests/test_torch_aggregate.py``.)
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402

from torch_byz_helpers import run_and_hold, telemetry_holds  # noqa: E402

SW = dict(net_model="switch", n_aggregators=3, agg_fail_rate=0.15,
          agg_stale_rate=0.25, agg_max_stale=3)
# The parity grid's composed adversary (tests/test_aggregate.py:36-37).
ADV = dict(drop_rate=0.2, partition_rate=0.1, churn_rate=0.03,
           max_delay_rounds=2, crash_prob=0.08, recover_prob=0.3)
# tests/test_aggregate.py:39-91 without its PBFT cases.
PARITY = {
    "raft-dense": dict(protocol="raft", n_nodes=9, n_rounds=64, n_sweeps=2,
                       log_capacity=32, max_entries=24, seed=5, **ADV, **SW),
    "raft-dense-byz-equiv": dict(protocol="raft", n_nodes=9, n_rounds=48,
                                 n_sweeps=2, log_capacity=32, max_entries=24,
                                 seed=7, drop_rate=0.15, n_byzantine=2,
                                 byz_mode="equivocate", **SW),
    "raft-dense-byz-silent": dict(protocol="raft", n_nodes=9, n_rounds=48,
                                  n_sweeps=1, log_capacity=32,
                                  max_entries=24, seed=8, drop_rate=0.15,
                                  n_byzantine=2, byz_mode="silent", **SW),
    "raft-capped": dict(protocol="raft", n_nodes=64, max_active=4,
                        n_rounds=64, n_sweeps=2, log_capacity=32,
                        max_entries=24, seed=11, max_crashed=5, **ADV, **SW),
    "raft-capped-byz": dict(protocol="raft", n_nodes=32, max_active=4,
                            n_rounds=48, n_sweeps=2, log_capacity=32,
                            max_entries=24, seed=13, drop_rate=0.15,
                            n_byzantine=5, byz_mode="equivocate", **SW),
    "paxos": dict(protocol="paxos", n_nodes=15, n_rounds=64, n_sweeps=2,
                  log_capacity=24, seed=4, **ADV, **SW),
    "paxos-capped-proposers": dict(protocol="paxos", n_nodes=21,
                                   n_proposers=4, n_rounds=64, n_sweeps=2,
                                   log_capacity=16, seed=6, drop_rate=0.25,
                                   **SW),
    "hotstuff": dict(protocol="hotstuff", f=2, n_nodes=7, n_rounds=64,
                     n_sweeps=2, log_capacity=64, seed=3, n_byzantine=1,
                     **ADV, **SW),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_whole_run_matches_jax_and_the_oracle(name):
    run_and_hold(JConfig(**PARITY[name]), name)


@pytest.mark.parametrize("name", list(PARITY))
def test_telemetry_matches_jax(name):
    """Every counter, window and bucket, the aggregation tail counting
    failed and stale aggregators."""
    tel = telemetry_holds(PARITY[name], name)
    assert tel["agg_down_rounds"].sum() > 0, name
    assert tel["stale_serves"].sum() > 0, name


def test_graph_key_holds_the_switch_knobs():
    cfg = Config(**PARITY["raft-capped"])
    dev = torch.device("cuda", 0)
    key = runner._graph_key(cfg, dev, False)
    for kw in (dict(n_aggregators=4), dict(agg_fail_rate=0.2),
               dict(agg_max_stale=2)):
        assert runner._graph_key(dataclasses.replace(cfg, **kw), dev,
                                 False) != key
    assert runner._graph_key(dataclasses.replace(cfg, seed=99), dev,
                             False) == key


def test_agg_telemetry_counters_match_jax():
    """tests/test_aggregate.py:235-255 on the port: fails and stale serves
    counted, a flat run's tail all 0."""
    kw = dict(protocol="hotstuff", f=2, n_nodes=7, n_rounds=64, n_sweeps=1,
              log_capacity=64, seed=11, net_model="switch",
              n_aggregators=2, agg_fail_rate=0.4, agg_stale_rate=0.4,
              agg_max_stale=4)
    tel = telemetry_holds(kw, "hotstuff agg counters")
    assert tel["agg_down_rounds"].sum() > 0
    assert tel["stale_serves"].sum() > 0
    flat = {k: v for k, v in kw.items()
            if k not in ("net_model", "n_aggregators", "agg_fail_rate",
                         "agg_stale_rate", "agg_max_stale")}
    tel0 = telemetry_holds(flat, "hotstuff flat")
    assert all(int(np.sum(tel0[k])) == 0 for k in (
        "agg_down_rounds", "stale_serves", "poisoned_serves"))
