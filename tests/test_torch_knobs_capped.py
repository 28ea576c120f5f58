"""The port's knob batch (``runner.run_knob_batch``, K23) on the capped Raft
engine against the JAX package's, on the CPU.

The port's ``run_knob_batch(device="cpu")`` must give the JAX package's
``run_knob_batch`` bit for bit: every leaf of the extract and every window
and latency series of the flight recorder. Covered, at N = 32 with A = 4:
raft-elections' gates (tools/advsearch/search.py:147-159: drop, partition,
churn, crash and recover, max_delay_rounds 4) with the base's row, a
variant row and a row that zeroes a gated-on knob, and the SPEC §A.3
elect attack. Each lane also equals the port's production run of its
config (``_run``, which tests/test_torch_knobs_capped_switch.py,
_targets.py and _switch.py share). Tolerance: exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu_torch.core import knobs  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402

from test_torch_knobs_count import (COL, jax_batch,  # noqa: E402
                                    same_as_production, same_batch)
from torch_byz_helpers import port  # noqa: E402

CAPPED = dict(protocol="raft", max_active=4, log_capacity=32,
              max_entries=24, telemetry_window=4, seed=0)
# name -> (JAX base, the lanes' overrides, the lanes' seeds)
CASES = {
    # raft-elections' base and gates on the capped engine.
    "elections": (
        JConfig(n_nodes=32, n_rounds=32, n_sweeps=3, drop_rate=0.3,
                partition_rate=0.1, churn_rate=0.02, crash_prob=0.1,
                recover_prob=0.3, max_crashed=3, max_delay_rounds=4,
                **CAPPED),
        ({}, dict(drop_rate=0.55, churn_rate=0.1, partition_rate=0.3),
         dict(crash_prob=0.0)),
        (11, 0xFFFFFFFF, 5)),
    # raft-attack-elect's base on the capped engine.
    "elect": (
        JConfig(n_nodes=32, n_rounds=32, n_sweeps=3, drop_rate=0.05,
                attack="elect", attack_rate=0.9, **CAPPED),
        ({}, dict(attack_rate=0.3, drop_rate=0.2), dict(attack_rate=0.0)),
        (11, 0xFFFFFFFF, 5)),
}
def _run(jbase, overrides, seeds, targets=None):
    """The port's batch of the lanes ``overrides`` of ``jbase`` (with the
    attack ``targets`` where given) held to the JAX package's; each lane
    with a config of its own held to the port's production run of it.
    Returns the port's batch."""
    base = port(jbase)
    cfgs = [dataclasses.replace(base, **o) for o in overrides]
    kmat = np.array([knobs.base_row(c) for c in cfgs], np.uint32)
    for b, t in enumerate(targets or ()):
        kmat[b, COL["attack_target"]] = t
        cfgs[b] = dataclasses.replace(cfgs[b], attack_target=t) \
            if t < base.n_nodes else None
    seeds = np.array(seeds, np.uint32)
    got = runner.run_knob_batch(base, seeds, kmat, device="cpu")
    same_batch(got, jax_batch(jbase, seeds, kmat), jbase)
    for lane, cfg in enumerate(cfgs):
        if cfg is not None:
            assert knobs.base_row(cfg) == [int(x) for x in kmat[lane]]
            same_as_production(got, lane, cfg, seeds[lane], lane)
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_capped_gates_equal_jax_and_production(name):
    """raft-elections' gates and the elect attack on the capped engine:
    the base's row, a variant and a row that zeroes a gated-on knob."""
    jbase, overrides, seeds = CASES[name]
    got = _run(jbase, overrides, seeds)
    if name == "elect":
        attacked = got[1]["windows"]["attack_rounds"].sum(1)
        assert attacked[0] > 0 and attacked[2] == 0, attacked
