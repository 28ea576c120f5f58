"""The plain versions of the port's KNOBS instances, lane by lane, on the
CPU.

In a knob batch each lane reads its own adversary cutoffs: the plain
versions of kernels KAJ, KAD, KAE (flat and SWITCH), KAL, KAH and KT take a
``KnobView`` whose knobs are [B, 1] columns (KAH its columns and the
table). For one round (3 and 20) of four built knob batches, every call of
those six wrappers is recorded; its plain version on all lanes at once
must equal, lane by lane, the flat plain version given that lane's own
config (KAH: its scalar cutoffs and no table) on that lane's slice of the
same inputs: each result and each input updated in place. The batches:
HotStuff under §6c crash, §B desync, partitions and §A.2 (KAH, KAJ, KAD,
KAE's CRASH instance); hotstuff-forked-qc's base (KAL, KAE's SWITCH and
equivocate instance); pbft-quorum-1k's base cut to 13 nodes (KAH with its
cap, KT); and §6b PBFT under §B desync (KT's DESYNC instance). Each
batch's lanes are the base's row, a row that zeroes a gated-on knob and a
row with other cutoffs. Tolerance: exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.core import knobs  # noqa: E402
from consensus_tpu_torch.engines import hotstuff, pbft_bcast  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402
from consensus_tpu_torch.ops import adversary, aggregate  # noqa: E402

# The wrappers with KNOBS instances, by the module the rounds call them
# through.
WRAPPERS = ((hotstuff, "hotstuff_prologue"), (hotstuff, "hotstuff_propose"),
            (hotstuff, "hotstuff_vote"), (aggregate, "agg_round"),
            (adversary, "crash_transition"),
            (pbft_bcast, "bcast_view_preprepare"))
TEL = dict(telemetry_window=4, n_sweeps=3, seed=0)
# name -> (base, the lanes' knob overrides: lane 0 is the base, lane 1
# zeroes a gated-on knob, lane 2 has other cutoffs; the wrappers each
# batch must call)
BATCHES = {
    "hotstuff-gated": (
        Config(protocol="hotstuff", f=2, n_nodes=7, n_rounds=24,
               log_capacity=48, view_timeout=4, drop_rate=0.3,
               partition_rate=0.2, churn_rate=0.05, crash_prob=0.15,
               recover_prob=0.3, max_crashed=2, desync_rate=0.2,
               max_skew_rounds=3, max_delay_rounds=2, **TEL),
        (dict(), dict(partition_rate=0.0),
         dict(drop_rate=0.55, churn_rate=0.1, crash_prob=0.3,
              recover_prob=0.1, desync_rate=0.45)),
        ("hotstuff_prologue", "hotstuff_propose", "hotstuff_vote",
         "crash_transition")),
    "hotstuff-forked-qc": (
        Config(protocol="hotstuff", f=2, n_nodes=7, n_rounds=24,
               log_capacity=48, view_timeout=4, net_model="switch",
               n_aggregators=2, agg_byz=1, n_byzantine=2,
               byz_mode="equivocate", agg_poison_rate=0.3,
               byz_uplink_rate=0.2, drop_rate=0.1, partition_rate=0.1,
               **TEL),
        (dict(), dict(agg_poison_rate=0.0),
         dict(agg_poison_rate=0.9, byz_uplink_rate=0.7, drop_rate=0.35,
              partition_rate=0.3)),
        ("hotstuff_propose", "hotstuff_vote", "agg_round")),
    "pbft-quorum": (
        Config(protocol="pbft", f=4, n_nodes=13, fault_model="bcast",
               n_rounds=24, log_capacity=32, drop_rate=0.3,
               partition_rate=0.1, churn_rate=0.02, crash_prob=0.1,
               recover_prob=0.3, max_crashed=4, max_delay_rounds=2, **TEL),
        (dict(), dict(partition_rate=0.0),
         dict(drop_rate=0.5, churn_rate=0.12, crash_prob=0.25,
              recover_prob=0.08, partition_rate=0.35)),
        ("crash_transition", "bcast_view_preprepare")),
    "pbft-desync": (
        Config(protocol="pbft", f=4, n_nodes=13, fault_model="bcast",
               n_rounds=24, log_capacity=32, view_timeout=4,
               drop_rate=0.2, partition_rate=0.2, churn_rate=0.05,
               desync_rate=0.2, max_skew_rounds=3, **TEL),
        (dict(), dict(partition_rate=0.0),
         dict(drop_rate=0.4, churn_rate=0.15, desync_rate=0.5)),
        ("bcast_view_preprepare",)),
}


def _clone(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_clone(x) for x in a))
    if type(a) in (list, tuple):
        return type(a)(_clone(x) for x in a)
    return a


def _lane(a, b: int, B: int, cfg):
    """Lane ``b``'s slice of an argument: a tensor led by the lane axis,
    inside tuples too; a view becomes the lane's own config."""
    if isinstance(a, knobs.KnobView):
        return cfg
    if isinstance(a, torch.Tensor):
        return a[b:b + 1].clone() if a.dim() and a.shape[0] == B else a
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_lane(x, b, B, cfg) for x in a))
    if type(a) in (list, tuple):
        return type(a)(_lane(x, b, B, cfg) for x in a)
    return a


def _tensors(a):
    if isinstance(a, torch.Tensor):
        yield a
    elif type(a) in (list, tuple) or (isinstance(a, tuple)
                                      and hasattr(a, "_fields")):
        for x in a:
            yield from _tensors(x)


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
    config, and for KAH its scalar cutoffs and no table."""
    one = list(_lane(args, b, B, cfg))
    if name == "crash_transition":
        one[3], one[4], one[10] = cfg.crash_cutoff, cfg.recover_cutoff, None
    return tuple(one)


def _as_tuple(x):
    return (x,) if isinstance(x, torch.Tensor) else tuple(x or ())


@pytest.mark.parametrize("r", (3, 20))
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_knobs_plain_equals_flat_lane_by_lane(name, r, monkeypatch):
    _, lane_cfgs, _, table = _batch(name)
    B = len(lane_cfgs)
    calls = _round_calls(name, r, monkeypatch)
    assert sorted(calls) == sorted(BATCHES[name][2]), name
    for wrapper, arg_list in calls.items():
        plain = getattr(dict((n, m) for m, n in WRAPPERS)[wrapper],
                        wrapper + "_plain")
        for args in arg_list:
            if wrapper == "crash_transition":
                assert torch.equal(args[10], table)
                assert args[3].shape == (B, 1)
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
    """The batches' lanes differ in what their cutoffs decide: the lanes'
    rows are three different rows, and round 20's state differs between
    lane 0 and lane 2 in every batch."""
    for name in BATCHES:
        base, _, seeds, table = _batch(name)
        assert len({tuple(row) for row in table.tolist()}) == 3, name
        lanes = {k: torch.from_numpy(v) for k, v in {
            **runner.lane_inputs(base), "seed": np.full(3, 5, np.uint32)
        }.items()}
        lanes["knobs"] = table
        out = runner._rounds(base, lanes, 20, True)
        st = out.state
        assert not torch.equal(st.view[0], st.view[2]), name
