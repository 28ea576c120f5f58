"""The port's knob batch (``runner.run_knob_batch``, K23) under the SPEC
§A.3 sticky attack with per-lane targets, on the capped Raft engine and on
dense Raft under the SPEC §9 switch, against the JAX package's, on the CPU.

Each batch's lanes carry the targets 3, 0, N - 1, N + 3, 0xFFFFFFFD and
0xFFFFFFFF. The last three are out of range: the role read takes node
N - 1, N - 3 and N - 1 (the JAX package's traced index, normalised and
clamped), while the jam (capped: kernel KB's cut; under the switch: the
cut on the target's votes) matches no node, and the rounds whose read
target led while the attack fired still count as attack_rounds. Every leaf
of the extract and every window and latency series equals the JAX
package's, the in-range lanes also the port's production runs of their
configs, and every lane counts attacked rounds. Tolerance: exact.
"""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402

from test_torch_knobs_capped import _run  # noqa: E402

STICKY = dict(n_rounds=96, n_sweeps=6, drop_rate=0.05, attack="sticky",
              attack_rate=0.9, attack_target=3, log_capacity=32,
              max_entries=24, telemetry_window=4, seed=0)
# name -> (base, the seeds under which each lane's read target leads and
# the attack fires)
BASES = {
    "capped": (JConfig(protocol="raft", n_nodes=8, max_active=4, **STICKY),
               (2, 3, 29, 29, 0, 29)),
    "dense-switch": (JConfig(protocol="raft", n_nodes=7, net_model="switch",
                             n_aggregators=2, **STICKY),
                     (2, 3, 27, 27, 17, 27)),
}

@pytest.mark.parametrize("name", sorted(BASES))
def test_sticky_targets_equal_jax(name):
    """The six targets, in and out of range: the JAX package's batch, the
    in-range lanes' production runs, and attacked rounds on every lane."""
    jbase, seeds = BASES[name]
    n = jbase.n_nodes
    got = _run(jbase, [{}] * 6, seeds,
               (3, 0, n - 1, n + 3, 0xFFFFFFFD, 0xFFFFFFFF))
    attacked = got[1]["windows"]["attack_rounds"].sum(1)
    assert (attacked > 0).all(), attacked
