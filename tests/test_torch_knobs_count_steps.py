"""The plain versions of the count engines' KNOBS instances, lane by lane,
on the CPU.

In a knob batch each lane reads its own adversary cutoffs: the plain
versions of kernels KL (with the view's table), KQ, KAM, KAN, KM, KY, KZ,
KX and KAB (with a ``KnobView`` whose knobs are [B, 1] columns). For rounds
3 and 20 of seven built knob batches, every call of those wrappers is
recorded; its plain version on all lanes at once must equal, lane by lane,
the flat plain version given that lane's own config (KL: its scalar
cutoffs, sticky target and attack cutoff, and no table) on that lane's
slice of the same inputs: each result and each input updated in place.
The batches: dense Raft under §6c crash with a cap, partitions, churn and
§A.2 (KL's CRASH and DELAY instances, KM); dense Raft under the §A.3
sticky attack, the lanes' targets differing (KL's STICKY and KM's ATTACK
instances); dense PBFT under §6c, partitions and the §B desync (KQ's
DESYNC instance); dense PBFT and §6b PBFT under the §9 switch with §9b
(KAM, KAN); Paxos under §6c and partitions (KY, KZ); DPoS under §A.1,
§A.4 and §A.2 (KX's and KAB's GATES instances). Each batch's lanes are
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
from consensus_tpu_torch.engines import (dpos, paxos, pbft,  # noqa: E402
                                         pbft_bcast, raft)
from consensus_tpu_torch.network import runner  # noqa: E402
from consensus_tpu_torch.ops import adversary, switch_tally  # noqa: E402

from test_torch_knobs_steps import _as_tuple, _clone, _lane, _tensors  # noqa: E402

# The wrappers with the new KNOBS instances, by the modules the rounds call
# them through.
WRAPPERS = ((raft, "delivery"), (pbft, "delivery"), (paxos, "delivery"),
            (pbft, "pbft_view_preprepare"), (switch_tally, "switch_combine"),
            (switch_tally, "switch_receive"), (raft, "dense_elect"),
            (paxos, "paxos_promise"), (paxos, "paxos_accept_learn"),
            (dpos, "dpos_round"), (dpos, "dpos_telemetry"))
PLAIN = {"delivery": adversary, "pbft_view_preprepare": pbft,
         "switch_combine": switch_tally, "switch_receive": switch_tally,
         "dense_elect": raft, "paxos_promise": paxos,
         "paxos_accept_learn": paxos, "dpos_round": dpos,
         "dpos_telemetry": dpos}
TEL = dict(telemetry_window=4, n_sweeps=3, seed=0, n_rounds=24)
SWITCH_9B = dict(net_model="switch", n_aggregators=2, agg_byz=1,
                 n_byzantine=2, byz_mode="equivocate", agg_poison_rate=0.3,
                 byz_uplink_rate=0.2, drop_rate=0.1, partition_rate=0.1)
# name -> (base, the lanes' overrides: lane 0 is the base, lane 1 zeroes a
# gated-on knob, lane 2 has other cutoffs; the wrappers each batch calls)
BATCHES = {
    "raft-gated": (
        Config(protocol="raft", n_nodes=9, log_capacity=32, max_entries=24,
               drop_rate=0.3, partition_rate=0.2, churn_rate=0.05,
               crash_prob=0.15, recover_prob=0.3, max_crashed=3,
               max_delay_rounds=2, **TEL),
        (dict(), dict(partition_rate=0.0),
         dict(drop_rate=0.55, churn_rate=0.1, crash_prob=0.3,
              recover_prob=0.1)),
        ("delivery", "dense_elect")),
    "raft-sticky": (
        Config(protocol="raft", n_nodes=7, log_capacity=32, max_entries=24,
               drop_rate=0.05, attack="sticky", attack_rate=0.9,
               attack_target=2, **TEL),
        (dict(), dict(attack_rate=0.0),
         dict(attack_target=5, attack_rate=1.0, drop_rate=0.1)),
        ("delivery", "dense_elect")),
    "pbft-gated": (
        Config(protocol="pbft", f=3, n_nodes=10, log_capacity=32,
               view_timeout=4, drop_rate=0.2, partition_rate=0.2,
               churn_rate=0.05, crash_prob=0.1, recover_prob=0.3,
               max_crashed=2, desync_rate=0.2, max_skew_rounds=3, **TEL),
        (dict(), dict(desync_rate=0.0, max_skew_rounds=1),
         dict(drop_rate=0.4, churn_rate=0.15, desync_rate=0.5,
              partition_rate=0.35)),
        ("delivery", "pbft_view_preprepare")),
    "pbft-switch": (
        Config(protocol="pbft", f=2, n_nodes=7, log_capacity=32,
               **SWITCH_9B, **TEL),
        (dict(), dict(agg_poison_rate=0.0),
         dict(agg_poison_rate=0.9, byz_uplink_rate=0.7, drop_rate=0.35,
              partition_rate=0.3)),
        ("delivery", "pbft_view_preprepare", "switch_combine",
         "switch_receive")),
    "bcast-switch": (
        Config(protocol="pbft", f=2, n_nodes=7, fault_model="bcast",
               log_capacity=32, **SWITCH_9B, **TEL),
        (dict(), dict(partition_rate=0.0),
         dict(agg_poison_rate=0.9, byz_uplink_rate=0.7, drop_rate=0.35)),
        ("switch_combine", "switch_receive")),
    "paxos-gated": (
        Config(protocol="paxos", n_nodes=9, log_capacity=32, drop_rate=0.3,
               partition_rate=0.15, churn_rate=0.05, crash_prob=0.1,
               recover_prob=0.3, max_delay_rounds=2, **TEL),
        (dict(), dict(crash_prob=0.0),
         dict(drop_rate=0.5, churn_rate=0.2, recover_prob=0.1)),
        ("delivery", "paxos_promise", "paxos_accept_learn")),
    "dpos-gated": (
        Config(protocol="dpos", n_nodes=24, log_capacity=48,
               n_candidates=12, n_producers=3, epoch_len=8, drop_rate=0.3,
               partition_rate=0.1, churn_rate=0.05, miss_rate=0.2,
               suppress_rate=0.2, suppress_window=4, max_delay_rounds=2,
               **TEL),
        (dict(), dict(miss_rate=0.0),
         dict(drop_rate=0.5, churn_rate=0.15, suppress_rate=0.6,
              miss_rate=0.05)),
        ("dpos_round", "dpos_telemetry")),
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
    inputs = {**runner.lane_inputs(base), "seed": seeds}
    lanes = {k: torch.from_numpy(v) for k, v in inputs.items()}
    lanes["knobs"] = table
    out = runner._rounds(base, lanes, r, True)
    view = knobs.KnobView(base, table)
    eng = runner.engine(base)
    rest = {k: v for k, v in lanes.items() if k not in ("seed", "knobs")}
    statics = eng.statics(base, None) if eng.statics else {}
    got: dict = {}
    for mod, wrapper in WRAPPERS:
        fn = getattr(mod, wrapper)

        def record(*args, _fn=fn, _name=wrapper):
            got.setdefault(_name, []).append(_clone(args))
            return _fn(*args)
        monkeypatch.setattr(mod, wrapper, record)
    eng.round(view, out.state, r, telem=out.telem,
              flight=(out.win, out.lat), **rest, **statics)
    monkeypatch.undo()
    return got


def _flat_args(name: str, args, b: int, B: int, cfg):
    """Lane b's arguments of the flat plain version: its slice, its own
    config, and for KL its scalar cutoffs, target and attack cutoff and no
    table."""
    one = list(_lane(args, b, B, cfg))
    if name == "delivery":
        one[3], one[4] = cfg.drop_cutoff, cfg.partition_cutoff
        if len(one) > 7 and one[7] is not None:
            one[7] = (one[7][0], cfg.attack_target, cfg.attack_cutoff)
        one = one[:8]
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
            if wrapper == "delivery":
                assert torch.equal(args[8], table)
                assert isinstance(args[3], int)
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
    runner's KNOB_KERNELS and starts at 0 launches of it."""
    names = {name for _, name in runner.KNOB_KERNELS}
    for wrapper in PLAIN:
        assert wrapper in names, wrapper
        assert isinstance(getattr(PLAIN[wrapper], wrapper).knob_launches,
                          int), wrapper
    assert pbft_bcast.NAME in runner.KNOB_ENGINES
