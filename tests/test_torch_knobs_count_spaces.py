"""The port's knob batch (``runner.run_knob_batch``, K23) against the JAX
package's on the bases of tools/advsearch's six search spaces on the count
engines, on the CPU.

The spaces dpos-delivery, raft-elections, pbft-quorum, paxos-slots,
pbft-cert-poison (dense PBFT under the switch with §9b) and
raft-attack-elect run at population 4, cut to 32 rounds: generation 0's
rows from ``search.knob_row``, lane 0 set to the base's row and the last
lane to a row that zeroes a gated-on knob. Every leaf of the extract and
every window and latency series equals the JAX package's, and those two
lanes equal the port's production runs of their own configs. Tolerance:
exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu_torch.core import knobs  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402
from tools.advsearch import search  # noqa: E402

from test_torch_knobs_count import (jax_batch, same_as_production,  # noqa: E402
                                    same_batch)
from torch_byz_helpers import port  # noqa: E402

SEARCH_SEED = 7
# space -> the knob-off config's overrides (the column it zeroes).
SPACES = {
    "dpos-delivery": dict(miss_rate=0.0),
    "raft-elections": dict(partition_rate=0.0),
    "pbft-quorum": dict(crash_prob=0.0),
    "paxos-slots": dict(churn_rate=0.0),
    "pbft-cert-poison": dict(agg_poison_rate=0.0),
    "raft-attack-elect": dict(attack_rate=0.0),
}


@pytest.mark.parametrize("name", sorted(SPACES))
def test_space_base_equals_jax(name):
    space = search.SPACES[name]
    jbase = dataclasses.replace(space.base, n_sweeps=4, n_rounds=32)
    base = port(jbase)
    rows = [search.knob_row(space, c)
            for c in search.next_population(space, SEARCH_SEED, 0, 4, None)]
    off = dataclasses.replace(base, **SPACES[name])
    rows[0], rows[-1] = knobs.base_row(base), knobs.base_row(off)
    kmat = np.array(rows, np.uint32)
    assert kmat[0].tolist() != kmat[-1].tolist(), name
    seeds = np.array([search.eval_seed(SEARCH_SEED, 0, c) for c in range(4)],
                     np.uint32)
    got = runner.run_knob_batch(base, seeds, kmat, device="cpu")
    same_batch(got, jax_batch(jbase, seeds, kmat), name)
    same_as_production(got, 0, base, seeds[0], name)
    same_as_production(got, 3, off, seeds[3], name)
