"""The port's knob batch (``runner.run_knob_batch``, K23) against the JAX
package's, on the CPU.

A generation of adversary-search candidates runs as the lanes of one run,
each lane with its own row of u32 cutoffs over a static base config. The
port's ``run_knob_batch(device="cpu")`` must give the JAX package's
``run_knob_batch`` bit for bit: every leaf of the extract and every window
and latency series of the flight recorder. Covered: the bases of the
advsearch spaces hotstuff-views, hotstuff-forked-qc and hotstuff-view-desync
at population 4, pbft-quorum-1k's cut to 13 nodes with its gates kept and
hotstuff-forked-qc-1k's at N = 1024 cut to 16 rounds and 2 lanes. Each
generation's rows come from ``search.knob_row``, with one row equal to the
base and one that zeroes a gated-on knob; those two lanes also equal port
production runs of their own configs. Then the usage errors of
tests/test_advsearch.py:111-137 with the JAX package's messages, small
bases of the capped Raft engine and of dense Raft and Paxos under the
switch against the JAX package's batch, the view itself and the graph key.
Tolerance: exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.core import knobs as jknobs  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch.core import knobs  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402
from tools.advsearch import search  # noqa: E402

from torch_byz_helpers import port  # noqa: E402

SEARCH_SEED = 7


def _row_with(space, **cutoffs) -> list[int]:
    """The base's knob row with the named columns set (for a column whose
    off value has no Config of its own in the JAX package: desync_rate 0
    under max_skew_rounds)."""
    row = search.knob_row(space, {})
    for name, v in cutoffs.items():
        row[knobs.KNOB_COLUMNS.index(name)] = v
    return row


# space -> (population, rounds, overrides of the base, the knob-off config's
# overrides and the column it zeroes)
CASES = {
    "hotstuff-views": (4, 96, {}, dict(partition_rate=0.0),
                       "partition_cutoff"),
    "hotstuff-forked-qc": (4, 96, {}, dict(agg_poison_rate=0.0),
                           "agg_poison_cutoff"),
    # The Config takes no skew depth without a desync: the knob-off config
    # has the default depth.
    "hotstuff-view-desync": (4, 96, {},
                             dict(desync_rate=0.0, max_skew_rounds=1),
                             "desync_cutoff"),
    "pbft-quorum-1k": (4, 48, dict(f=4, n_nodes=13, max_crashed=4),
                       dict(partition_rate=0.0), "partition_cutoff"),
    "hotstuff-forked-qc-1k": (2, 16, {}, dict(agg_poison_rate=0.0),
                              "agg_poison_cutoff"),
}


def _generation(name: str):
    """(space, JAX base, seeds, kmat, the knob-off config) of ``name``'s
    case: generation 0 of the search at SEARCH_SEED, its lane 0's row set to
    the base's and its last lane's to the knob-off row."""
    pop, rounds, cut, off, col = CASES[name]
    space = search.SPACES[name]
    space = dataclasses.replace(space, base=dataclasses.replace(
        space.base, **cut))
    base = dataclasses.replace(space.base, n_sweeps=pop, n_rounds=rounds)
    rows = [search.knob_row(space, c)
            for c in search.next_population(space, SEARCH_SEED, 0, pop,
                                            None)]
    rows[0] = search.knob_row(space, {})
    rows[-1] = _row_with(space, **{col: 0})
    seeds = np.array([search.eval_seed(SEARCH_SEED, 0, c)
                      for c in range(pop)], np.uint32)
    return space, base, seeds, np.array(rows, np.uint32), off


def _same_flight(got, want, where):
    assert set(got) == set(want), where
    for key in want:
        if key in ("windows", "latency"):
            assert list(got[key]) == list(want[key]), where
            for name, a in want[key].items():
                assert got[key][name].dtype == np.int64, (where, name)
                np.testing.assert_array_equal(got[key][name], a,
                                              err_msg=f"{where} {name}")
        else:
            assert got[key] == want[key], (where, key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_knob_batch_equals_jax(name):
    """Every leaf of ``out`` and every series of ``flight`` equal the JAX
    package's on the same base, seeds and rows; the base's lane and the
    knob-off lane equal the port's production runs of their configs."""
    _, jbase, seeds, kmat, off = _generation(name)
    jout, jflight = jrunner.run_knob_batch(jbase, jsim.engine_def(jbase),
                                           seeds, kmat)
    base = port(jbase)
    out, flight = runner.run_knob_batch(base, seeds, kmat, device="cpu")
    assert set(out) == set(jout), name
    for k, v in jout.items():
        np.testing.assert_array_equal(out[k], np.asarray(v),
                                      err_msg=f"{name} {k}")
        assert out[k].dtype == np.asarray(v).dtype, (name, k)
    _same_flight(flight, jflight, name)
    pop = len(seeds)
    for lane, cfg in ((0, base), (pop - 1, dataclasses.replace(base, **off))):
        assert knobs.base_row(cfg) == [int(x) for x in kmat[lane]], lane
        one = dataclasses.replace(cfg, n_sweeps=1, seed=int(seeds[lane]))
        stats: dict = {}
        ref = runner.run(one, "cpu", telemetry=True, stats=stats)
        for k, v in ref.items():
            np.testing.assert_array_equal(out[k][lane], v[0],
                                          err_msg=f"{name} lane {lane} {k}")
        for part in ("windows", "latency"):
            for cname, v in stats["flight"][part].items():
                np.testing.assert_array_equal(
                    flight[part][cname][lane], v[0],
                    err_msg=f"{name} lane {lane} {part} {cname}")


def _views_base():
    space = search.SPACES["hotstuff-views"]
    return space, port(dataclasses.replace(space.base, n_sweeps=2,
                                           n_rounds=8))


def test_knob_batch_usage_errors():
    """The JAX package's checks with its messages (tests/test_advsearch.py
    :111-137), on a HotStuff base."""
    space, base = _views_base()
    seeds = runner.make_seeds(base)
    kmat = np.array([knobs.base_row(base)] * 2, np.uint32)
    with pytest.raises(ValueError, match="telemetry_window"):
        runner.run_knob_batch(dataclasses.replace(base, telemetry_window=0),
                              seeds, kmat, device="cpu")
    with pytest.raises(ValueError, match="KNOB_COLUMNS"):
        runner.run_knob_batch(base, seeds, kmat[:, :3], device="cpu")
    with pytest.raises(ValueError, match="n_sweeps"):
        runner.run_knob_batch(base, seeds[:1], kmat[:1], device="cpu")
    # A lane that varies a knob the base gates off would be ignored.
    for name in ("miss_cutoff", "crash_cutoff", "agg_poison_cutoff"):
        bad = kmat.copy()
        bad[1, knobs.KNOB_COLUMNS.index(name)] = 12345
        with pytest.raises(ValueError, match=name):
            runner.run_knob_batch(base, seeds, bad, device="cpu")


def test_knob_batch_gate_check_matches_jax():
    """A column the base gates off raises in both packages alike, and the
    columns it gates on may vary in both: the gate tables agree."""
    for name in ("hotstuff-forked-qc", "hotstuff-view-desync",
                 "pbft-quorum-1k"):
        jbase = dataclasses.replace(search.SPACES[name].base, n_sweeps=2)
        assert knobs.gates(port(jbase)) == _jax_gates(jbase), name


def _jax_gates(cfg):
    return {"crash_cutoff": cfg.crash_on, "recover_cutoff": cfg.crash_on,
            "miss_cutoff": cfg.miss_on, "suppress_cutoff": cfg.suppress_on,
            "partition_cutoff": not cfg.no_partition,
            "attack_cutoff": cfg.attack != "none",
            "attack_target": cfg.attack != "none",
            "agg_poison_cutoff": cfg.agg_poison_on,
            "byz_uplink_cutoff": cfg.uplink_lies_on}


# Three small bases of the capped Raft engine, and of dense Raft and Paxos
# under the SPEC §9 switch.
CAPPED_AND_SWITCH = {
    "raft-capped": dict(protocol="raft", n_nodes=16, max_active=4,
                        log_capacity=32, max_entries=24),
    "raft-switch": dict(protocol="raft", n_nodes=7, log_capacity=32,
                        max_entries=24, net_model="switch", n_aggregators=2),
    "paxos-switch": dict(protocol="paxos", n_nodes=9, log_capacity=32,
                         net_model="switch", n_aggregators=2),
}


@pytest.mark.parametrize("name", sorted(CAPPED_AND_SWITCH))
def test_knob_batch_capped_and_switch_engines_equal_jax(name):
    """The capped Raft engine, and dense Raft and Paxos under the switch,
    run a knob batch as the JAX package's does: no engine raises, and two
    lanes (the base's row and one with another drop) equal JAX's batch."""
    jcfg = JConfig(n_rounds=8, n_sweeps=2, seed=1, telemetry_window=4,
                   **CAPPED_AND_SWITCH[name])
    cfg = port(jcfg)
    assert runner.engine(cfg).name in runner.KNOB_ENGINES
    kmat = np.array([knobs.base_row(cfg),
                     knobs.base_row(dataclasses.replace(cfg,
                                                        drop_rate=0.4))],
                    np.uint32)
    seeds = runner.make_seeds(cfg)
    out, flight = runner.run_knob_batch(cfg, seeds, kmat, device="cpu")
    jout, jflight = jrunner.run_knob_batch(jcfg, jsim.engine_def(jcfg),
                                           seeds, kmat)
    assert set(out) == set(jout), name
    for k, v in jout.items():
        np.testing.assert_array_equal(out[k], np.asarray(v),
                                      err_msg=f"{name} {k}")
        assert out[k].dtype == np.asarray(v).dtype, (name, k)
    _same_flight(flight, jflight, name)


def test_knob_view_rejects_unknown_knob():
    """The view's names, values, delegation and gates, as the JAX
    package's KnobView (tests/test_advsearch.py:132-140)."""
    space = search.SPACES["pbft-quorum"]
    base = port(space.base)
    with pytest.raises(ValueError, match="unknown traced knobs"):
        knobs.KnobView(base, n_rounds=5)
    view = knobs.KnobView(base, drop_cutoff=7)
    assert view.drop_cutoff == 7
    assert view.churn_cutoff == base.churn_cutoff
    assert view.n_nodes == base.n_nodes
    assert view.crash_on is True
    assert knobs.KNOB_COLUMNS == jknobs.KNOB_COLUMNS
    table = torch.tensor([knobs.base_row(base), [0] * 12], dtype=torch.int64)
    view = knobs.KnobView(base, table)
    assert view.drop_cutoff.shape == (2, 1)
    assert int(view.drop_cutoff[0, 0]) == base.drop_cutoff
    assert int(view.drop_cutoff[1, 0]) == 0
    assert view.crash_on is True and view.no_partition is False
    with pytest.raises(ValueError, match="not both"):
        knobs.KnobView(base, table, drop_cutoff=7)
    with pytest.raises(ValueError, match="int64"):
        knobs.KnobView(base, table.to(torch.int32))
    # A u32 cutoff near the top survives the table.
    top = np.array([[0xFFFFFFFF] * 12], np.uint32)
    assert int(knobs.lane_table(top, "cpu")[0, 0]) == 0xFFFFFFFF


def test_knob_graph_key_leaves_out_knob_values_only():
    """A knob batch's graph key: the same for bases that differ in their
    seed or knob values only, different from the production run's key of
    the same config, and different where a gate differs."""
    _, base = _views_base()
    dev = torch.device("cpu")
    key = runner._knob_graph_key(base, dev)
    assert runner._knob_graph_key(
        dataclasses.replace(base, seed=9, drop_rate=0.5, churn_rate=0.0,
                            partition_rate=0.3), dev) == key
    assert key != runner._graph_key(base, dev, True)
    assert runner._knob_graph_key(
        dataclasses.replace(base, partition_rate=0.0), dev) != key
    assert runner._knob_graph_key(
        dataclasses.replace(base, n_rounds=9), dev) != key
