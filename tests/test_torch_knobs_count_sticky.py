"""The port's knob batch (``runner.run_knob_batch``, K23) against the JAX
package's on the CPU: dense Raft under the SPEC §A.3 sticky attack with
per-lane targets, the SPEC §6b PBFT engine under the SPEC §9 switch with
§9b, and a one-lane batch across generations.

raft-attack-elect's base turned to ``attack="sticky"`` runs lanes whose
targets are in range, at N + 3 and at 0xFFFFFFFD (out of range: the role
read clamps, the jam matches no node, as the JAX package's traced index
does); the §6b case is pbft-cert-poison's switch and §9b over the broadcast
engine with partitions; a one-lane batch is run for two generations with
different rows. Every leaf of the extract and every window and latency
series equals the JAX package's, and the lanes that have a config of their
own equal the port's production runs of it. Tolerance: exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu_torch.core import knobs  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402
from tools.advsearch import search  # noqa: E402

from test_torch_knobs_count import (COL, LANE_CASES, jax_batch,  # noqa: E402
                                    same_as_production, same_batch)
from torch_byz_helpers import port  # noqa: E402


def sticky_base(n_sweeps: int, rounds: int = 64):
    """raft-attack-elect's base (tools/advsearch/search.py:302-313) under
    the sticky attack on node 2, cut to ``rounds`` rounds."""
    space = search.SPACES["raft-attack-elect"]
    return dataclasses.replace(space.base, attack="sticky", attack_target=2,
                               n_sweeps=n_sweeps, n_rounds=rounds)


# Each lane's (target, attack cutoff): the base's, other targets in range,
# N + 3 and 0xFFFFFFFD (-3 as int32: the role read takes node N - 3), one
# at rate 1 and one that zeroes the attack.
STICKY_LANES = ((2, None), (5, None), (0, 0xFFFFFFFF), (7 + 3, None),
                (0xFFFFFFFD, None), (6, 0))
# Seeds under which each lane's read target leads and the attack fires
# (the zeroed lane's aside).
STICKY_SEEDS = (180, 141, 182, 103, 384, 5)


def sticky_kmat(base):
    rows = []
    for tgt, cut in STICKY_LANES:
        row = knobs.base_row(base)
        row[COL["attack_target"]] = tgt
        if cut is not None:
            row[COL["attack_cutoff"]] = cut
        rows.append(row)
    return np.array(rows, np.uint32)


def test_sticky_targets_equal_jax():
    """The sticky base with per-lane targets and cutoffs equals the JAX
    package's batch; the in-range lanes equal production runs of their
    configs; the out-of-range targets jam nothing but count the rounds
    whose read target led (attack_rounds), as the JAX package does."""
    jbase = sticky_base(len(STICKY_LANES))
    base = port(jbase)
    seeds = np.array(STICKY_SEEDS, np.uint32)
    kmat = sticky_kmat(base)
    got = runner.run_knob_batch(base, seeds, kmat, device="cpu")
    same_batch(got, jax_batch(jbase, seeds, kmat), "sticky")
    for lane, (tgt, cut) in enumerate(STICKY_LANES):
        if tgt >= base.n_nodes:
            continue
        rate = {None: base.attack_rate, 0xFFFFFFFF: 1.0, 0: 0.0}[cut]
        cfg = dataclasses.replace(base, attack_target=tgt, attack_rate=rate)
        assert knobs.base_row(cfg) == [int(x) for x in kmat[lane]], lane
        same_as_production(got, lane, cfg, seeds[lane], "sticky")
    attacked = got[1]["windows"]["attack_rounds"].sum(1)
    assert (attacked[:-1] > 0).all() and attacked[-1] == 0, attacked


def test_bcast_switch_equals_jax():
    """§6b under the switch with §9b (poison and lies) and partitions: the
    base's row, the poison zeroed, more lies and drops, the partition
    zeroed."""
    jbase = JConfig(protocol="pbft", f=2, n_nodes=7, fault_model="bcast",
                    log_capacity=48, net_model="switch", n_aggregators=2,
                    agg_byz=1, n_byzantine=2, byz_mode="equivocate",
                    agg_poison_rate=0.3, byz_uplink_rate=0.2, drop_rate=0.1,
                    partition_rate=0.1, telemetry_window=4, n_rounds=32,
                    seed=0, n_sweeps=4)
    base = port(jbase)
    cfgs = [base, dataclasses.replace(base, agg_poison_rate=0.0),
            dataclasses.replace(base, byz_uplink_rate=0.75, drop_rate=0.25),
            dataclasses.replace(base, partition_rate=0.0)]
    kmat = np.array([knobs.base_row(c) for c in cfgs], np.uint32)
    seeds = np.arange(4, dtype=np.uint32) + 9
    got = runner.run_knob_batch(base, seeds, kmat, device="cpu")
    same_batch(got, jax_batch(jbase, seeds, kmat), "bcast switch")
    for lane in (0, 1):
        same_as_production(got, lane, cfgs[lane], seeds[lane],
                           "bcast switch")


@pytest.mark.parametrize("name", ("raft", "dpos"))
def test_one_lane_batch_across_generations(name):
    """A one-lane batch run for two generations with different rows gives
    each row's own result: the JAX package's for that row, and the port's
    production run of that row's config (no value of the first row is
    kept)."""
    jbase, variant = LANE_CASES[name]
    jbase = dataclasses.replace(jbase, n_sweeps=1, n_rounds=32)
    base = port(jbase)
    seeds = np.array([17], np.uint32)
    for cfg in (base, dataclasses.replace(base, **variant)):
        kmat = np.array([knobs.base_row(cfg)], np.uint32)
        got = runner.run_knob_batch(base, seeds, kmat, device="cpu")
        same_batch(got, jax_batch(jbase, seeds, kmat), name)
        same_as_production(got, 0, cfg, 17, name)
