"""The plain versions of the KNOBS instances of kernels KE, KB, KM, KY and
KZ, lane by lane, on the CPU.

In a knob batch each lane reads its own adversary cutoffs: the plain
versions of KE (with a ``KnobView`` whose knobs are [B, 1] columns), KB
(with the view's table) and the SWITCH instances of KM, KY and KZ (with
the view). For rounds 3 and 20 of six built knob batches, every call of
those wrappers is recorded; its plain version on all lanes at once must
equal, lane by lane, the flat plain version given that lane's own config
(KB: its scalar cutoffs, a sticky attack's target and no table) on that
lane's slice of the same inputs: each result and each input updated in
place. The batches: capped Raft under §6c crash with a cap, partitions,
churn and §A.2 (KE's CRASH, KB's src and dst DELAY and CRASH instances);
capped Raft under the §A.3 elect attack and under the sticky attack with
the lanes' targets differing (KE's and KB's ATTACK instances); capped Raft
under the §9 switch with §6c (KB's SWITCH instance); dense Raft under the
switch and the sticky attack (KM's SWITCH instance); Paxos under the
switch with §6c (KY's and KZ's SWITCH instances). Each batch's lanes are
the base's row, a row that zeroes a gated-on knob and a row with other
cutoffs. Tolerance: exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.core import knobs  # noqa: E402
from consensus_tpu_torch.engines import paxos, raft, raft_sparse  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402
from consensus_tpu_torch.ops import adversary  # noqa: E402

from test_torch_knobs_steps import _as_tuple, _clone, _lane, _tensors  # noqa: E402

# The wrappers with the new KNOBS instances, by the module the rounds call
# them through, and the module of each plain version.
WRAPPERS = ((raft_sparse, "candidacy"), (raft_sparse, "delivery_edges"),
            (raft, "dense_elect"), (paxos, "paxos_promise"),
            (paxos, "paxos_accept_learn"))
PLAIN = {"candidacy": raft_sparse, "delivery_edges": adversary,
         "dense_elect": raft, "paxos_promise": paxos,
         "paxos_accept_learn": paxos}
TEL = dict(telemetry_window=4, n_sweeps=3, seed=0, n_rounds=24)
CAPPED = dict(protocol="raft", n_nodes=16, max_active=4, log_capacity=32,
              max_entries=24)
SWITCH = dict(net_model="switch", n_aggregators=2, agg_fail_rate=0.05)
# name -> (base, the lanes' overrides: lane 0 is the base, lane 1 zeroes a
# gated-on knob, lane 2 has other cutoffs; the wrappers each batch calls)
BATCHES = {
    "capped-gated": (
        Config(**CAPPED, drop_rate=0.3, partition_rate=0.2, churn_rate=0.1,
               crash_prob=0.15, recover_prob=0.3, max_crashed=3,
               max_delay_rounds=2, **TEL),
        (dict(), dict(partition_rate=0.0),
         dict(drop_rate=0.55, churn_rate=0.3, crash_prob=0.3,
              recover_prob=0.1)),
        ("candidacy", "delivery_edges")),
    "capped-elect": (
        Config(**CAPPED, drop_rate=0.05, churn_rate=0.05, attack="elect",
               attack_rate=0.9, **TEL),
        (dict(), dict(attack_rate=0.0),
         dict(attack_rate=0.4, drop_rate=0.2, churn_rate=0.2)),
        ("candidacy", "delivery_edges")),
    "capped-sticky": (
        Config(**CAPPED, drop_rate=0.05, churn_rate=0.2, attack="sticky",
               attack_rate=0.9, attack_target=2, **TEL),
        (dict(), dict(attack_rate=0.0),
         dict(attack_target=5, attack_rate=1.0, drop_rate=0.1)),
        ("candidacy", "delivery_edges")),
    "capped-switch": (
        Config(**CAPPED, drop_rate=0.2, partition_rate=0.2, churn_rate=0.05,
               crash_prob=0.1, recover_prob=0.3, max_crashed=3,
               max_delay_rounds=2, **SWITCH, **TEL),
        (dict(), dict(partition_rate=0.0),
         dict(drop_rate=0.5, crash_prob=0.2, churn_rate=0.2)),
        ("candidacy", "delivery_edges")),
    "raft-switch": (
        Config(protocol="raft", n_nodes=9, log_capacity=32, max_entries=24,
               drop_rate=0.1, partition_rate=0.2, churn_rate=0.05,
               attack="sticky", attack_rate=0.9, attack_target=2,
               **SWITCH, **TEL),
        (dict(), dict(partition_rate=0.0),
         dict(attack_target=6, drop_rate=0.4, churn_rate=0.15)),
        ("dense_elect",)),
    "paxos-switch": (
        Config(protocol="paxos", n_nodes=9, log_capacity=32, drop_rate=0.3,
               partition_rate=0.15, churn_rate=0.05, crash_prob=0.1,
               recover_prob=0.3, max_delay_rounds=2, **SWITCH, **TEL),
        (dict(), dict(partition_rate=0.0),
         dict(drop_rate=0.5, churn_rate=0.2, recover_prob=0.1)),
        ("paxos_promise", "paxos_accept_learn")),
}


def _batch(name: str):
    """(base, the lanes' configs, seeds, the [B, 12] table)."""
    base, overrides, _ = BATCHES[name]
    lanes = [dataclasses.replace(base, n_sweeps=1, **o) for o in overrides]
    table = torch.tensor([knobs.base_row(c) for c in lanes],
                         dtype=torch.int64)
    seeds = np.array([11, 0xFFFFFFFF, 5], np.uint32)
    return base, lanes, seeds, table


def _round_calls(name: str, r: int, monkeypatch) -> dict:
    """{wrapper: [arguments]}: every call of the KNOBS wrappers in round
    ``r`` of ``name``'s knob batch, from its state after rounds 0..r-1,
    with telemetry and the recorder; the arguments cloned as they
    arrive."""
    base, _, seeds, table = _batch(name)
    lanes = {k: torch.from_numpy(v) for k, v in {
        **runner.lane_inputs(base), "seed": seeds}.items()}
    lanes["knobs"] = table
    out = runner._rounds(base, lanes, r, True)
    got: dict = {}
    for mod, wrapper in WRAPPERS:
        fn = getattr(mod, wrapper)

        def record(*args, _fn=fn, _name=wrapper):
            got.setdefault(_name, []).append(_clone(args))
            return _fn(*args)
        monkeypatch.setattr(mod, wrapper, record)
    runner.engine(base).round(knobs.KnobView(base, table), out.state, r,
                              telem=out.telem, flight=(out.win, out.lat))
    monkeypatch.undo()
    return got


def _flat_args(name: str, args, b: int, B: int, cfg):
    """Lane b's arguments of the flat plain version: its slice, its own
    config, and for KB its scalar cutoffs, a sticky attack's target and no
    table."""
    one = list(_lane(args, b, B, cfg))
    if name == "delivery_edges":
        one[4], one[5] = cfg.drop_cutoff, cfg.partition_cutoff
        if len(one) > 9 and one[9] is not None and one[9][1] >= 0:
            one[9] = (one[9][0], cfg.attack_target)
        one = one[:11]
        while len(one) > 8 and one[-1] is None:
            one.pop()
    return tuple(one)


@pytest.mark.parametrize("r", (3, 20))
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_knobs_plain_equals_flat_lane_by_lane(name, r, monkeypatch):
    _, lane_cfgs, _, table = _batch(name)
    B = len(lane_cfgs)
    calls = _round_calls(name, r, monkeypatch)
    assert sorted(calls) == sorted(BATCHES[name][2]), name
    for wrapper, arg_list in calls.items():
        plain = getattr(PLAIN[wrapper], wrapper + "_plain")
        for args in arg_list:
            if wrapper == "delivery_edges":
                assert torch.equal(args[11], table)
                assert isinstance(args[4], int)
            else:
                assert isinstance(args[0], knobs.KnobView)
            batched = _clone(args)
            got = _as_tuple(plain(*batched))
            for b in range(B):
                one = _flat_args(wrapper, args, b, B, lane_cfgs[b])
                want = _as_tuple(plain(*one))
                where = f"{name} round {r} {wrapper} lane {b}"
                assert len(got) == len(want), where
                for g, w in zip(got, want):
                    assert torch.equal(g[b:b + 1], w), where
                after = _flat_args(wrapper, batched, b, B, lane_cfgs[b])
                for g, w in zip(_tensors(after), _tensors(one),
                                strict=True):
                    assert torch.equal(g, w), f"{where} (in place)"


def test_lanes_differ():
    """The batches' lanes differ in what their cutoffs decide: three
    different rows, and round 20's state differs between lane 0 and lane 2
    in every batch."""
    for name in BATCHES:
        base, _, _, table = _batch(name)
        assert len({tuple(row) for row in table.tolist()}) == 3, name
        lanes = {k: torch.from_numpy(v) for k, v in {
            **runner.lane_inputs(base), "seed": np.full(3, 5, np.uint32)
        }.items()}
        lanes["knobs"] = table
        st = runner._rounds(base, lanes, 20, True).state
        leaves = runner.engine(base).extract(st)
        assert any(not torch.equal(v[0], v[2]) for v in leaves.values()), \
            name


def test_knob_wrappers_are_registered():
    """Each new KNOBS instance is counted apart: its wrapper is among the
    runner's KNOB_KERNELS and starts at 0 launches of it; every engine
    runs a knob batch."""
    names = {name for _, name in runner.KNOB_KERNELS}
    for wrapper in PLAIN:
        assert wrapper in names, wrapper
        assert isinstance(getattr(PLAIN[wrapper], wrapper).knob_launches,
                          int), wrapper
    assert raft_sparse.NAME in runner.KNOB_ENGINES
    assert len(set(runner.KNOB_ENGINES)) == 7
