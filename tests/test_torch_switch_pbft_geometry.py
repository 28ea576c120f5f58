"""The port's SPEC §9 switch on PBFT at its edges and §9b's
pbft-cert-poison, against the JAX package and the C++ oracle, on the CPU.

The 499-node §6b case of ``tests/test_aggregate.py:100-110`` (K = 8 over
real multi-segment geometry); K = 1 and K = N on both fault models
(``:112-122``, here on PBFT, with §9b); and the base of the JAX package's
``pbft-cert-poison`` search space (``tools/advsearch/search.py:217-221``)
at seeds 0, 1 and 2 with telemetry (the §7c safety counters, the poisoned
serves). Tolerance 0 throughout.
"""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402

from torch_byz_helpers import run_and_hold, telemetry_holds  # noqa: E402


def test_bcast_over_499_nodes_matches_jax_and_the_oracle():
    run_and_hold(JConfig(protocol="pbft", fault_model="bcast", f=166,
                         n_nodes=499, n_rounds=24, n_sweeps=1,
                         log_capacity=8, seed=2, drop_rate=0.1,
                         partition_rate=0.05, net_model="switch",
                         n_aggregators=8, agg_fail_rate=0.1,
                         agg_stale_rate=0.2, agg_max_stale=2), "499 nodes")


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("model", ["edge", "bcast"])
def test_k1_and_kn_geometry(model, k):
    """One global aggregator and one node a segment, with a delay,
    partitions and §9b's poisoned combines and lies."""
    run_and_hold(JConfig(protocol="pbft", fault_model=model, f=3,
                         n_nodes=10, n_rounds=40, n_sweeps=2,
                         log_capacity=8, seed=21, drop_rate=0.2,
                         partition_rate=0.2, max_delay_rounds=2,
                         net_model="switch", n_aggregators=k,
                         agg_fail_rate=0.2, agg_stale_rate=0.3,
                         agg_max_stale=2, n_byzantine=2, agg_byz=1,
                         agg_poison_rate=0.3, byz_uplink_rate=0.4),
                 f"{model} K={k}")


# tools/advsearch/search.py:217-221 with its _ADV (:117): 96 rounds,
# 4-round windows.
CERT_POISON = dict(protocol="pbft", f=2, n_nodes=7, log_capacity=96,
                   net_model="switch", n_aggregators=2, agg_byz=1,
                   n_byzantine=2, byz_mode="equivocate",
                   agg_poison_rate=0.3, byz_uplink_rate=0.2, drop_rate=0.1,
                   n_rounds=96)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cert_poison_matches_jax_and_the_oracle(seed):
    """The decided payload (JAX and the oracle), and every counter with the
    §7c safety tail, window and bucket (JAX): poisoned combines are served,
    and, as the JAX package's search found, PBFT's two-phase certificates
    hold (docs/RESILIENCE.md:598-611)."""
    kw = dict(CERT_POISON, seed=seed)
    run_and_hold(JConfig(**kw), f"cert-poison seed {seed}")
    tel = telemetry_holds(kw, f"cert-poison seed {seed}")
    assert tel["poisoned_serves"].sum() > 0
    assert tel["commit_quorums"].sum() > 0
