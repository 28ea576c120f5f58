"""The port's SPEC §9 switch on both PBFT f-ladders, against the JAX
package and the C++ oracle, on the CPU.

Both ladders (``tests/test_aggregate.py:125-142``) with and without §9b:
every rung's payload equals its standalone run's and the JAX ladder's, and
the whole padded carry (padded ids too, which adopt in the decide gossip)
equals the JAX package's; and the oversized K rejected with the JAX
package's message (``:144-150``). Tolerance 0 throughout.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.engines import pbft_sweep as jsweep  # noqa: E402
from consensus_tpu_torch.core import serialize  # noqa: E402
from consensus_tpu_torch.engines import pbft_sweep  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402

from torch_byz_helpers import port  # noqa: E402

SW = dict(net_model="switch", n_aggregators=3, agg_fail_rate=0.15,
          agg_stale_rate=0.25, agg_max_stale=3)
NINE_B = dict(n_byzantine=1, byz_mode="equivocate", agg_byz=1,
              agg_poison_rate=0.4, byz_uplink_rate=0.5)
LEAVES = ("view", "timer", "pp_seen", "pp_view", "pp_val", "prepared",
          "committed", "dval")


@pytest.mark.parametrize("nine_b", [False, True], ids=["switch", "9b"])
@pytest.mark.parametrize("model", ["edge", "bcast"])
def test_ladder_rungs_equal_standalone_runs(model, nine_b):
    fs = [1, 2, 3]
    base = JConfig(protocol="pbft", fault_model=model, f=1, n_nodes=4,
                   n_rounds=48, n_sweeps=2, log_capacity=12, seed=7,
                   drop_rate=0.15, partition_rate=0.1, churn_rate=0.02,
                   max_delay_rounds=2, **SW, **(NINE_B if nine_b else {}))
    want = jsweep.pbft_fsweep_run(base, fs)
    got = pbft_sweep.pbft_fsweep_run(port(base), fs, device="cpu")
    assert pbft_sweep.fsweep_payload(got) == jsweep.fsweep_payload(want)
    for k, (f, payload) in enumerate(zip(fs, pbft_sweep.rung_payloads(got))):
        solo = port(dataclasses.replace(base, f=f, n_nodes=3 * f + 1,
                                        seed=base.seed + k))
        assert serialize.digest(payload) == simulator.run(
            solo, device="cpu").digest, (model, f)
    # The whole padded carry, padded ids included.
    stj = jsweep._fsweep_device(base, fs)
    _, cfg_pad = pbft_sweep._fsweep_static(port(base), fs)
    st = runner.run_device(cfg_pad, "cpu", rungs=fs).state
    for leaf in LEAVES:
        np.testing.assert_array_equal(getattr(st, leaf).numpy(),
                                      np.asarray(getattr(stj, leaf)), leaf)


def test_ladder_rejects_oversized_k_with_the_jax_message():
    base = JConfig(protocol="pbft", fault_model="bcast", f=5, n_nodes=16,
                   n_rounds=16, n_sweeps=1, log_capacity=8, seed=1,
                   net_model="switch", n_aggregators=8)
    with pytest.raises(ValueError, match="n_aggregators") as want:
        jsweep.pbft_fsweep_run(base, [1, 3])
    with pytest.raises(ValueError) as got:
        pbft_sweep.pbft_fsweep_run(port(base), [1, 3], device="cpu")
    assert str(got.value) == str(want.value)
