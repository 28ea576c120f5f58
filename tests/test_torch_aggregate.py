"""The port's SPEC §9 switch layer against the JAX package, on the CPU.

``consensus_tpu_torch/ops/aggregate.py``'s plain versions with a lane axis
against ``consensus_tpu/ops/aggregate.py``'s (K21), lane by lane, tolerance
0: ``agg_round`` (fail, stale and depth draws, counters), ``agg_poison``,
``uplink_lies``, ``uplink_edge``, ``downlink``, ``seg_sum``, ``take_seg``,
``seg_widths``, ``poison_count`` and ``agg_counts``, with partitions, the
§A.2 delay and stale aggregators on, at K = 1, a short last segment, an
empty trailing aggregator (N = 9, K = 6) and K = N; then kernel KAL's plain
version (:func:`aggregate.agg_round_plain`: the [B, K] table, the uplink
rounds, the uplink masks cut at down nodes, the telemetry tail) and the
inline downlink the SWITCH instances draw (:func:`aggregate.
agg_downlink_plain`) against the same JAX functions, on extreme seeds and
rounds 0, 1, 3 and 200. Whole runs against the JAX package and the oracle
at the degenerate segmentations K = 1 and K = N on every engine
(``tests/test_aggregate.py:112-122``) and K = 8 over 500 nodes, and each
engine with the switch's faults at rate 0: KAL's plain version runs every
round and the aggregation tail stays 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.ops import aggregate as jagg  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.ops import aggregate  # noqa: E402
from consensus_tpu_torch.ops.adversary import CRASH_DOWN  # noqa: E402

from torch_byz_helpers import run_and_hold, telemetry_holds  # noqa: E402

SEEDS = (0, 0xFFFFFFFF, 12345, 77)
ROUNDS = (0, 1, 3, 200)
# (name, config): the switch knobs on the engines they run on, with
# partitions, the §A.2 delay and stale aggregators on.
CASES = {
    "raft-k3": dict(protocol="raft", n_nodes=20, max_active=3,
                    net_model="switch", n_aggregators=3, drop_rate=0.3,
                    partition_rate=0.4, max_delay_rounds=3,
                    agg_fail_rate=0.3, agg_stale_rate=0.6, agg_max_stale=4),
    "raft-k1": dict(protocol="raft", n_nodes=11, net_model="switch",
                    n_aggregators=1, drop_rate=0.2, partition_rate=0.5,
                    agg_fail_rate=0.2, agg_stale_rate=0.9, agg_max_stale=8),
    "empty-tail": dict(protocol="raft", n_nodes=9, net_model="switch",
                       n_aggregators=6, drop_rate=0.25, partition_rate=0.5,
                       max_delay_rounds=2, agg_fail_rate=0.4,
                       agg_stale_rate=0.5, agg_max_stale=3),
    "k-eq-n": dict(protocol="paxos", n_nodes=7, log_capacity=8,
                   net_model="switch", n_aggregators=7, drop_rate=0.3,
                   partition_rate=0.3, agg_fail_rate=0.3,
                   agg_stale_rate=0.5, agg_max_stale=2),
    "hotstuff-9b": dict(protocol="hotstuff", f=4, n_nodes=13,
                        log_capacity=16, net_model="switch",
                        n_aggregators=4, drop_rate=0.2,
                        partition_rate=0.3, max_delay_rounds=2,
                        agg_fail_rate=0.2, agg_stale_rate=0.4,
                        agg_max_stale=4, n_byzantine=4, agg_byz=2,
                        agg_poison_rate=0.7, byz_uplink_rate=0.5),
    "no-faults": dict(protocol="hotstuff", f=2, n_nodes=7, log_capacity=8,
                      net_model="switch", n_aggregators=3),
}


def _cfgs(name):
    kw = CASES[name]
    return Config(**kw), JConfig(**kw)


def _seed():
    return torch.tensor(SEEDS, dtype=torch.int64).to(torch.uint32)


@pytest.mark.parametrize("r", ROUNDS)
@pytest.mark.parametrize("name", list(CASES))
def test_agg_round_matches_jax(name, r):
    cfg, jcfg = _cfgs(name)
    st = aggregate.agg_draws_plain(cfg, _seed(), r)
    K = cfg.n_aggregators
    for b, s in enumerate(SEEDS):
        j = jagg.agg_round(jcfg, jnp.uint32(s), jnp.uint32(r))
        if j.alive is None:
            assert st.alive is None
        else:
            np.testing.assert_array_equal(st.alive[b].numpy(),
                                          np.asarray(j.alive))
        q = np.broadcast_to(np.asarray(j.q).astype(np.int64), (K,))
        np.testing.assert_array_equal(st.q[b].numpy(), q)
        assert int(st.down_count[b]) == int(j.down_count)
        assert int(st.stale_count[b]) == int(j.stale_count)
        tail = aggregate.agg_counts_plain(st)[b].tolist()
        assert tail == [int(x) for x in jagg.agg_counts(j)]
    assert aggregate.agg_counts_plain(B=2).tolist() == [[0, 0, 0]] * 2


@pytest.mark.parametrize("r", ROUNDS)
@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_uplink_and_downlink_match_jax(name, phase, r):
    cfg, jcfg = _cfgs(name)
    seed = _seed()
    st = aggregate.agg_draws_plain(cfg, seed, r)
    up = aggregate.uplink_edge_plain(cfg, seed, st, phase)
    N = cfg.n_nodes
    dst = np.array([0, N - 1, -1, N // 2, 1 % N], np.int32)
    down = aggregate.downlink_plain(cfg, seed, r, st, phase, dst)
    for b, s in enumerate(SEEDS):
        j = jagg.agg_round(jcfg, jnp.uint32(s), jnp.uint32(r))
        ju = jagg.uplink_edge(jcfg, jnp.uint32(s), j, phase)
        np.testing.assert_array_equal(up[b].numpy(), np.asarray(ju))
        jd = jagg.downlink(jcfg, jnp.uint32(s), jnp.uint32(r), j, phase,
                           jnp.asarray(dst))
        np.testing.assert_array_equal(down[b].numpy(), np.asarray(jd))


@pytest.mark.parametrize("r", ROUNDS)
@pytest.mark.parametrize("name", ["hotstuff-9b", "no-faults", "raft-k3"])
def test_poison_and_lies_match_jax(name, r):
    cfg, jcfg = _cfgs(name)
    seed = _seed()
    N = cfg.n_nodes
    byz = torch.arange(N) >= N - cfg.n_byzantine
    for phase in (0, 1, 2):
        pz = aggregate.agg_poison_plain(cfg, seed, r, phase)
        jp = [jagg.agg_poison(jcfg, jnp.uint32(s), jnp.uint32(r), phase)
              for s in SEEDS]
        if jp[0] is None:
            assert pz is None
            continue
        np.testing.assert_array_equal(pz.numpy(),
                                      np.stack([np.asarray(x) for x in jp]))
    lie, fval = aggregate.uplink_lies_plain(cfg, seed, r, byz)
    for b, s in enumerate(SEEDS):
        jl, jv = jagg.uplink_lies(jcfg, jnp.uint32(s), jnp.uint32(r),
                                  jnp.asarray(byz.numpy()))
        if jl is None:
            assert lie is None
            continue
        np.testing.assert_array_equal(lie[b].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(fval[b].numpy(), np.asarray(jv))


@pytest.mark.parametrize("name", list(CASES))
def test_segment_helpers_match_jax(name):
    cfg, _ = _cfgs(name)
    N, K = cfg.n_nodes, cfg.n_aggregators
    gen = np.random.default_rng(N * 31 + K)
    sids = aggregate.agg_ids(N, K)
    np.testing.assert_array_equal(sids.numpy(),
                                  np.asarray(jagg.agg_ids(N, K)))
    assert aggregate.n_segments(N, K) == jagg.n_segments(N, K)
    x = gen.integers(-5, 9, (len(SEEDS), N, 3)).astype(np.int32)
    got = aggregate.seg_sum_plain(torch.from_numpy(x), sids, K)
    for b in range(len(SEEDS)):
        want = jagg.seg_sum(jnp.asarray(x[b]), jnp.asarray(sids.numpy()), K)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    valid = gen.random((len(SEEDS), N)) < 0.7
    wid = aggregate.seg_widths_plain(torch.from_numpy(valid), sids, K)
    for b in range(len(SEEDS)):
        want = jagg.seg_widths(jnp.asarray(valid[b]),
                               jnp.asarray(sids.numpy()), K)
        np.testing.assert_array_equal(wid[b].numpy(), np.asarray(want))
    table = gen.integers(0, 50, (len(SEEDS), K, 2)).astype(np.int32)
    got = aggregate.take_seg_plain(torch.from_numpy(table), sids, K)
    for b in range(len(SEEDS)):
        want = jagg.take_seg(jnp.asarray(table[b]),
                             jnp.asarray(sids.numpy()), K)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("r", ROUNDS)
@pytest.mark.parametrize("name", ["hotstuff-9b", "raft-k3", "empty-tail"])
def test_poison_count_matches_jax(name, r):
    cfg, jcfg = _cfgs(name)
    seed = _seed()
    st = aggregate.agg_draws_plain(cfg, seed, r)
    masks = [aggregate.agg_poison_plain(cfg, seed, r, ph) for ph in (0, 1)]
    got = aggregate.poison_count_plain(st, *masks)
    for b, s in enumerate(SEEDS):
        j = jagg.agg_round(jcfg, jnp.uint32(s), jnp.uint32(r))
        jm = [jagg.agg_poison(jcfg, jnp.uint32(s), jnp.uint32(r), ph)
              for ph in (0, 1)]
        assert int(got[b]) == int(jagg.poison_count(j, *jm))


@pytest.mark.parametrize("crash", [False, True])
@pytest.mark.parametrize("r", ROUNDS)
@pytest.mark.parametrize("name", list(CASES))
def test_kal_plain_matches_jax(name, r, crash):
    """KAL's plain version: the table words (alive, the side of N + a at
    r, the poison bits), q, the uplinks (cut at down nodes), and the
    AGG_TELEMETRY tail added into the totals and the window ring."""
    cfg, jcfg = _cfgs(name)
    seed = _seed()
    B, N, K = len(SEEDS), cfg.n_nodes, cfg.n_aggregators
    gen = np.random.default_rng(r + 7 * N)
    flags = None
    downm = np.zeros((B, N), bool)
    if crash:
        downm = gen.random((B, N)) < 0.3
        flags = torch.from_numpy(downm.astype(np.uint8) * CRASH_DOWN)
    t = torch.full((B, 12), 5, dtype=torch.int32)
    w = torch.zeros((B, 3, 12), dtype=torch.int32)
    cfgw = dataclasses.replace(cfg, telemetry_window=100)
    tabs = aggregate.agg_round_plain(cfgw, seed, r, flags, t, w, col=4)
    P = aggregate.n_phases(cfg)
    assert tabs.up.shape == (B, P, N)
    for b, s in enumerate(SEEDS):
        js, jr = jnp.uint32(s), jnp.uint32(r)
        j = jagg.agg_round(jcfg, js, jr)
        word = tabs.tab[b].numpy()
        alive = np.ones(K, bool) if j.alive is None else np.asarray(j.alive)
        np.testing.assert_array_equal((word & 1) != 0, alive)
        q = np.broadcast_to(np.asarray(j.q).astype(np.int64), (K,))
        np.testing.assert_array_equal(tabs.q[b].numpy(), q)
        pzs = []
        for ph in range(P):
            pz = jagg.agg_poison(jcfg, js, jr, ph)
            pzs.append(pz)
            bits = (word >> (2 + ph)) & 1
            want = np.zeros(K, bool) if pz is None else np.asarray(pz)
            np.testing.assert_array_equal(bits != 0, want)
            ju = np.asarray(jagg.uplink_edge(jcfg, js, j, ph)) & ~downm[b]
            np.testing.assert_array_equal(tabs.up[b, ph].numpy(), ju)
        tail = [int(x) for x in jagg.agg_counts(j, jagg.poison_count(j,
                                                                   *pzs))]
        assert t[b].tolist() == [5] * 4 + [5 + x for x in tail] + [5] * 5
        assert w[b, r // 100, 4:7].tolist() == tail
        # The inline downlink from the table at every (aggregator, node).
        a = torch.arange(K)[None, :, None].expand(1, K, N)
        dst = torch.arange(N)[None, None, :].expand(1, K, N)
        got = aggregate.agg_downlink_plain(cfg, seed[b:b + 1], r,
                                           tabs.tab[b:b + 1], 0, a, dst)
        want = jagg.downlink(jcfg, js, jr, j, 0, jnp.arange(N))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_kal_raises_off_the_switch():
    cfg = Config(protocol="raft", n_nodes=5)
    with pytest.raises(ValueError, match="switch"):
        aggregate.agg_round(cfg, _seed(), 0)


def test_switch_resp_is_the_two_hop():
    """switch_resp_plain: up(j) & down(a(j), dst) of the JAX functions."""
    cfg, jcfg = _cfgs("raft-k3")
    seed = _seed()
    r = 3
    tabs = aggregate.agg_round_plain(cfg, seed, r)
    dst = torch.tensor([[0, 5, -1]] * len(SEEDS))
    got = aggregate.switch_resp_plain(cfg, seed, r, tabs, 0, dst)
    sids = np.asarray(jagg.agg_ids(cfg.n_nodes, cfg.n_aggregators))
    for b, s in enumerate(SEEDS):
        j = jagg.agg_round(jcfg, jnp.uint32(s), jnp.uint32(r))
        up = np.asarray(jagg.uplink_edge(jcfg, jnp.uint32(s), j, 0))
        dn = np.asarray(jagg.downlink(jcfg, jnp.uint32(s), jnp.uint32(r),
                                      j, 0, jnp.asarray([0, 5, -1])))
        np.testing.assert_array_equal(got[b].numpy(),
                                      up[:, None] & dn[sids])


# --- segment geometry and KAL in whole runs -------------------------------------

# The parity grid's adversary (tests/test_aggregate.py:36-37) and switch
# knobs, on one config of each engine.
PARITY_SW = dict(net_model="switch", n_aggregators=3, agg_fail_rate=0.15,
                 agg_stale_rate=0.25, agg_max_stale=3, drop_rate=0.2,
                 partition_rate=0.1, churn_rate=0.03, max_delay_rounds=2,
                 crash_prob=0.08, recover_prob=0.3)
PARITY_KW = {
    "raft-dense": dict(protocol="raft", n_nodes=9, n_sweeps=2,
                       log_capacity=32, max_entries=24, seed=5, **PARITY_SW),
    "raft-capped": dict(protocol="raft", n_nodes=64, max_active=4,
                        n_sweeps=2, log_capacity=32, max_entries=24,
                        seed=11, max_crashed=5, **PARITY_SW),
    "paxos": dict(protocol="paxos", n_nodes=15, n_sweeps=2, log_capacity=24,
                  seed=4, **PARITY_SW),
    "hotstuff": dict(protocol="hotstuff", f=2, n_nodes=7, n_sweeps=2,
                     log_capacity=64, seed=3, n_byzantine=1, **PARITY_SW),
}


@pytest.mark.parametrize("k", [1, 9])
def test_k1_and_kn_geometry(k):
    """tests/test_aggregate.py:112-122: one global aggregator and one node
    a segment, on both Raft engines, Paxos and HotStuff (K <= 7 = N),
    against JAX and the oracle."""
    kw = dict(protocol="raft", n_nodes=9, n_rounds=32, n_sweeps=1,
              log_capacity=32, max_entries=24, seed=21, drop_rate=0.2,
              net_model="switch", n_aggregators=k, agg_fail_rate=0.2,
              agg_stale_rate=0.3, agg_max_stale=2)
    run_and_hold(JConfig(**kw), f"K={k}")
    run_and_hold(JConfig(**{**kw, "max_active": 3}), f"capped K={k}")
    run_and_hold(JConfig(**{**kw, "protocol": "paxos",
                            "log_capacity": 12}), f"paxos K={k}")
    run_and_hold(JConfig(**{**kw, "protocol": "hotstuff", "f": 2,
                            "n_nodes": 7, "log_capacity": 32,
                            "n_aggregators": min(k, 7)}),
                 f"hotstuff K={min(k, 7)}")


def test_multi_segment_capped_run():
    """K = 8 over 500 nodes with a short last segment (63 a segment)."""
    kw = dict(protocol="raft", n_nodes=500, max_active=6, n_rounds=32,
              n_sweeps=2, log_capacity=32, max_entries=24, seed=2,
              drop_rate=0.1, partition_rate=0.05, net_model="switch",
              n_aggregators=8, agg_fail_rate=0.1, agg_stale_rate=0.2,
              agg_max_stale=2)
    run_and_hold(JConfig(**kw), "capped K=8 N=500")


@pytest.mark.parametrize("name", ["raft-dense", "raft-capped", "paxos",
                                  "hotstuff"])
def test_switch_at_rate_zero_runs_kal(name):
    """The switch with no fault: KAL's plain version runs every round, the
    tail stays 0 and the run equals the JAX package's."""
    kw = {**PARITY_KW[name], "agg_fail_rate": 0.0, "agg_stale_rate": 0.0,
          "agg_max_stale": 1, "n_rounds": 24}
    from consensus_tpu_torch.ops import aggregate
    calls = []
    real = aggregate.agg_round_plain

    def spy(*args):
        calls.append(args[2])
        return real(*args)
    aggregate.agg_round_plain = spy
    try:
        tel = telemetry_holds(kw, name)
    finally:
        aggregate.agg_round_plain = real
    assert calls == list(range(24))
    assert tel["agg_down_rounds"].sum() == 0
    assert tel["stale_serves"].sum() == 0


# --- PBFT's value-matched tallies (KAL's PBFT modes, KAM, KAN) -------------

# (name, config): PBFT switch configs with partitions, the §A.2 delay,
# stale aggregators and the §9b axes; an empty trailing aggregator (N = 7,
# K = 6) and K = N.
PBFT_CASES = {
    "edge-9b": dict(protocol="pbft", f=3, n_nodes=10, log_capacity=6,
                    net_model="switch", n_aggregators=3, drop_rate=0.3,
                    partition_rate=0.4, max_delay_rounds=2,
                    agg_fail_rate=0.3, agg_stale_rate=0.6, agg_max_stale=4,
                    n_byzantine=3, byz_mode="equivocate", agg_byz=2,
                    agg_poison_rate=0.6, byz_uplink_rate=0.5),
    "bcast-9b": dict(protocol="pbft", fault_model="bcast", f=3, n_nodes=10,
                     log_capacity=6, net_model="switch", n_aggregators=4,
                     drop_rate=0.3, partition_rate=0.4, max_delay_rounds=2,
                     agg_fail_rate=0.3, agg_stale_rate=0.6, agg_max_stale=4,
                     n_byzantine=2, agg_byz=1, agg_poison_rate=0.7,
                     byz_uplink_rate=0.6),
    "empty-tail": dict(protocol="pbft", f=2, n_nodes=7, log_capacity=5,
                       net_model="switch", n_aggregators=6, drop_rate=0.2,
                       partition_rate=0.5, agg_fail_rate=0.2,
                       agg_stale_rate=0.5, agg_max_stale=2),
    "k-eq-n": dict(protocol="pbft", fault_model="bcast", f=2, n_nodes=7,
                   log_capacity=5, net_model="switch", n_aggregators=7,
                   drop_rate=0.25, agg_fail_rate=0.2, agg_stale_rate=0.4,
                   agg_max_stale=3, n_byzantine=2, byz_mode="equivocate",
                   agg_byz=3, agg_poison_rate=0.5, byz_uplink_rate=0.5),
}
# Per-lane populations of padded f-ladder lanes (N_pad = 13, at least every
# case's K): rungs f = 2, 3, 4 and a second full lane.
N_REALS = (7, 10, 13, 13)


def _pbft_cfgs(name):
    kw = PBFT_CASES[name]
    return Config(**kw), JConfig(**kw)


def _n_real(cfg, ladder: bool):
    if not ladder:
        return torch.full((len(SEEDS),), cfg.n_nodes, dtype=torch.int32)
    return torch.tensor(N_REALS, dtype=torch.int32)


def _ladder_cfg(cfg, ladder: bool):
    """The padded config (N_pad = 13, f = 4) of a ladder lane set, or
    ``cfg`` itself."""
    if not ladder:
        return cfg
    return dataclasses.replace(cfg, f=4, n_nodes=13)


def _jax_sids(N, K, n_real):
    idx = jnp.arange(N, dtype=jnp.int32)
    return jnp.minimum(idx // ((n_real + K - 1) // K), K - 1)


@pytest.mark.parametrize("traced", [False, True])
def test_seg_extremes_match_jax(traced):
    """seg_max and seg_min (static, and traced with padding and empty
    segments normalised to the identity) with int32 extremes among the
    values."""
    gen = np.random.default_rng(5 + traced)
    N, K = 13, 5
    x = gen.integers(-2**31, 2**31, (len(SEEDS), N, 3), dtype=np.int64)
    x[:, 0, 0], x[:, 1, 1] = -2**31, 2**31 - 1
    x = x.astype(np.int32)
    for b, nr in enumerate(N_REALS if traced else (N,) * len(SEEDS)):
        sids = _jax_sids(N, K, nr) if traced else jagg.agg_ids(N, K)
        for kind, ident in (("max", -2**31), ("min", 2**31 - 1)):
            fn = getattr(aggregate, f"seg_{kind}_plain")
            got = fn(torch.from_numpy(x[b:b + 1]),
                     torch.from_numpy(np.asarray(sids)).to(torch.int64), K,
                     ident)[0]
            want = getattr(jagg, f"seg_{kind}")(
                jnp.asarray(x[b]), sids, K, jnp.int32(ident), traced=traced)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _votes_inputs(gen, N, S, K, case):
    """Built value_votes inputs of one lane: few values (so segments are
    often uniform), every extreme of the int32 range among them."""
    vals = gen.choice(np.array([-2**31, 2**31 - 1, 0, 7], np.int32), (N, S))
    if case == "uniform":
        vals[:] = 7
    contrib = gen.random((N, S)) < 0.7
    up = gen.random(N) < 0.8
    down = gen.random((K, N)) < 0.7
    down_own = gen.random(N) < 0.7
    return vals, contrib, up, down, down_own


VOTE_CASES = ("plain", "uniform", "one-liar", "all-liars", "poisoned-own",
              "support", "everything")


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("case", VOTE_CASES)
def test_value_votes_matches_jax(case, traced):
    """value_votes_plain against value_votes on built inputs: value-uniform
    segments, one liar among honest senders, an all-liar segment, a
    poisoned own segment, equivocating support, all of them at once; the
    static and the ladder's traced segmentation (padded ids)."""
    gen = np.random.default_rng(VOTE_CASES.index(case) * 2 + traced)
    N, S, K = 13, 4, 4
    lanes = [_votes_inputs(gen, N, S, K, case) for _ in SEEDS]
    n_reals = N_REALS if traced else (N,) * len(SEEDS)
    extra = {}
    if case in ("one-liar", "all-liars", "everything"):
        lie = np.zeros((len(SEEDS), N), bool)
        for b, nr in enumerate(n_reals):
            seg = -(-nr // K)
            if case == "all-liars":
                lie[b, :seg] = True                   # segment 0 all liars
            else:
                lie[b, seg + 1] = True                # one liar in segment 1
        lie_val = gen.integers(-2**31, 2**31, (len(SEEDS), N)).astype(
            np.int32)
        lie_val[:, 0] = 7
        extra.update(lie=lie, lie_val=lie_val)
    if case in ("poisoned-own", "everything"):
        poison = np.zeros((len(SEEDS), K), bool)
        poison[:, 0] = True
        extra["poison"] = poison
    if case in ("support", "everything"):
        extra["eq_up"] = gen.random((len(SEEDS), N)) < 0.4
    stack = [np.stack(x) for x in zip(*lanes)]
    sids_l = [np.asarray(_jax_sids(N, K, nr) if traced else jagg.agg_ids(N, K))
              for nr in n_reals]
    sids_t = torch.from_numpy(np.stack(sids_l)).to(torch.int64)
    real = np.arange(N)[None, :] < np.asarray(n_reals)[:, None]
    t = {k: torch.from_numpy(v) for k, v in extra.items()}
    if "poison" in extra:
        t["widths"] = aggregate.seg_widths_plain(torch.from_numpy(real),
                                                 sids_t, K)
    got = aggregate.value_votes_plain(
        *(torch.from_numpy(x) for x in stack), sids_t, K, **t)
    for b in range(len(SEEDS)):
        kw = {k: jnp.asarray(v[b]) for k, v in extra.items()}
        if "poison" in extra:
            kw["widths"] = jagg.seg_widths(jnp.asarray(real[b]),
                                           jnp.asarray(sids_l[b]), K,
                                           traced=traced)
        want = jagg.value_votes(*(jnp.asarray(x[b]) for x in stack),
                                jnp.asarray(sids_l[b]), K, traced=traced,
                                **kw)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("traced", [False, True])
def test_min_id_votes_matches_jax(traced):
    """min_id_votes_plain against min_id_votes: deciders anywhere, no
    decider in a segment, padded receivers (which adopt too)."""
    gen = np.random.default_rng(11 + traced)
    N, S, K = 13, 5, 4
    n_reals = N_REALS if traced else (N,) * len(SEEDS)
    dec = gen.random((len(SEEDS), N, S)) < 0.3
    dec[:, :, 0] = False                                   # no decider
    dval = gen.integers(-2**31, 2**31, (len(SEEDS), N, S)).astype(np.int32)
    up = gen.random((len(SEEDS), N)) < 0.8
    down = gen.random((len(SEEDS), K, N)) < 0.6
    sids_l = [np.asarray(_jax_sids(N, K, nr) if traced else jagg.agg_ids(N, K))
              for nr in n_reals]
    imin, vad = aggregate.min_id_votes_plain(
        *(torch.from_numpy(x) for x in (dec, dval, up, down)),
        torch.from_numpy(np.stack(sids_l)).to(torch.int64), K, N)
    for b in range(len(SEEDS)):
        wi, wv = jagg.min_id_votes(*(jnp.asarray(x[b]) for x in (
            dec, dval, up, down)), jnp.asarray(sids_l[b]), K, N,
            traced=traced)
        np.testing.assert_array_equal(imin[b].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(vad[b].numpy(), np.asarray(wv))


@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("r", (0, 3, 200))
@pytest.mark.parametrize("name", list(PBFT_CASES))
def test_pbft_uplinks_and_downlinks_match_jax(name, r, ladder):
    """uplink_edge (each phase), uplink_bcast, downlink and downlink_self
    with the standalone vertex base and each ladder lane's n_real."""
    cfg, jcfg = _pbft_cfgs(name)
    cfg = _ladder_cfg(cfg, ladder)
    if ladder:
        jcfg = dataclasses.replace(jcfg, f=4, n_nodes=13)
    seed, N, K = _seed(), cfg.n_nodes, cfg.n_aggregators
    n_real = _n_real(cfg, ladder) if ladder else None
    st = aggregate.agg_draws_plain(cfg, seed, r)
    ub = aggregate.uplink_bcast_plain(cfg, seed, st, n_real)
    for b, s in enumerate(SEEDS):
        j = jagg.agg_round(jcfg, jnp.uint32(s), jnp.uint32(r))
        kw = {}
        if ladder:
            kw = dict(seg_ids=_jax_sids(N, K, N_REALS[b]),
                      n_vert=jnp.int32(N_REALS[b]))
        np.testing.assert_array_equal(ub[b].numpy(), np.asarray(
            jagg.uplink_bcast(jcfg, jnp.uint32(s), j, traced=ladder, **kw)))
        for ph in range(3):
            ue = aggregate.uplink_edge_plain(cfg, seed, st, ph, n_real)
            np.testing.assert_array_equal(ue[b].numpy(), np.asarray(
                jagg.uplink_edge(jcfg, jnp.uint32(s), j, ph, traced=ladder,
                                 **kw)))
            dn = aggregate.downlink_plain(cfg, seed, r, st, ph,
                                          np.arange(N), n_real)
            np.testing.assert_array_equal(dn[b].numpy(), np.asarray(
                jagg.downlink(jcfg, jnp.uint32(s), jnp.uint32(r), j, ph,
                              jnp.arange(N), n_vert=kw.get("n_vert"))))
            ds = aggregate.downlink_self_plain(cfg, seed, r, st, ph, n_real)
            np.testing.assert_array_equal(ds[b].numpy(), np.asarray(
                jagg.downlink_self(jcfg, jnp.uint32(s), jnp.uint32(r), j,
                                   ph, **kw)))


@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("r", (0, 3, 200))
@pytest.mark.parametrize("name", list(PBFT_CASES))
def test_kal_pbft_modes_match_jax(name, r, ladder):
    """KAL's plain version on PBFT: the poison bits of phases 0 and 1 only,
    the aggregators' sides at vertex n_real + a, and the uplinks (three on
    the edge model, the one §6b mask), cut at down nodes."""
    from consensus_tpu.core import rng as jrng
    from consensus_tpu.ops.adversary import draw as jdraw
    cfg, jcfg = _pbft_cfgs(name)
    cfg = _ladder_cfg(cfg, ladder)
    seed, N, K = _seed(), cfg.n_nodes, cfg.n_aggregators
    n_real = _n_real(cfg, True)
    flags = torch.from_numpy(
        (np.random.default_rng(r).random((len(SEEDS), N)) < 0.3)
        .astype(np.uint8) * CRASH_DOWN)
    got = aggregate.agg_round_plain(cfg, seed, r, flags, n_real=n_real)
    bcast = cfg.fault_model == "bcast"
    assert got.up.shape == (len(SEEDS), 1 if bcast else 3, N)
    for b, s in enumerate(SEEDS):
        nr = int(n_real[b])
        j = jagg.agg_round(jcfg, jnp.uint32(s), jnp.uint32(r))
        word = np.where(np.asarray(j.alive), 1, 0) if j.alive is not None \
            else np.ones(K, np.int64)
        if cfg.partition_cutoff:
            side = np.asarray(jdraw(jnp.uint32(s), jrng.STREAM_PARTITION,
                                    jnp.uint32(r), 1,
                                    jnp.uint32(nr) + jnp.arange(
                                        K, dtype=jnp.uint32))) & 1
            word = word | side * aggregate.AGG_SIDE
        for ph in (0, 1):
            pz = jagg.agg_poison(jcfg, jnp.uint32(s), jnp.uint32(r), ph)
            if pz is not None:
                word = word | np.asarray(pz) * (aggregate.AGG_POISON0 << ph)
        np.testing.assert_array_equal(got.tab[b].numpy(), word)
        kw = dict(seg_ids=_jax_sids(N, K, nr), n_vert=jnp.int32(nr),
                  traced=True)
        ups = [jagg.uplink_bcast(jcfg, jnp.uint32(s), j, **kw)] if bcast \
            else [jagg.uplink_edge(jcfg, jnp.uint32(s), j, ph, **kw)
                  for ph in range(3)]
        alive = (flags[b] & CRASH_DOWN).numpy() == 0
        for row, u in enumerate(ups):
            np.testing.assert_array_equal(got.up[b, row].numpy(),
                                          np.asarray(u) & alive)


@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("r", (1, 3, 200))
@pytest.mark.parametrize("name", list(PBFT_CASES))
def test_kam_kan_plain_match_jax(name, r, ladder):
    """KAM's and KAN's plain versions, composed, against the JAX package's
    P4, P5 and P6 on built states (value_votes, min_id_votes and the
    rounds' thresholds, ``pbft_sweep.py:110-134``), with the standalone
    vertex base and each ladder lane's n_real; prepared, committed, dval
    and the timers of every id, padded ones included."""
    from consensus_tpu.core import rng as jrng
    from consensus_tpu.ops.adversary import draw as jdraw
    from consensus_tpu_torch.ops import switch_tally
    cfg, jcfg = _pbft_cfgs(name)
    cfg = _ladder_cfg(cfg, ladder)
    if ladder:
        jcfg = dataclasses.replace(jcfg, f=4, n_nodes=13)
    seed, N, K, S = _seed(), cfg.n_nodes, cfg.n_aggregators, cfg.log_capacity
    B = len(SEEDS)
    n_real = _n_real(cfg, ladder)
    f = (n_real - 1) // 3
    gen = np.random.default_rng(r * 7 + ladder)
    pp_seen = gen.random((B, N, S)) < 0.8
    pp_val = gen.choice(np.array([3, -2**31, 2**31 - 1], np.int32), (B, N, S),
                        p=[0.8, 0.1, 0.1])
    prepared = pp_seen & (gen.random((B, N, S)) < 0.3)
    committed = prepared & (gen.random((B, N, S)) < 0.3)
    dval = gen.integers(-9, 9, (B, N, S)).astype(np.int32)
    timer = gen.integers(0, 5, (B, N)).astype(np.int32)
    reset = gen.random((B, N)) < 0.3
    real = np.arange(N)[None, :] < n_real.numpy()[:, None]
    for x in (pp_seen, prepared, committed):
        x &= real[:, :, None]
    agg = aggregate.agg_round_plain(cfg, seed, r, n_real=n_real)
    t = {k: torch.from_numpy(v) for k, v in dict(
        pp_seen=pp_seen, pp_val=pp_val, prepared=prepared,
        committed=committed, dval=dval, timer=timer, reset=reset).items()}
    got = switch_tally.switch_phases(cfg, seed, r, agg, n_real, f,
                                     t["pp_seen"], t["pp_val"], t["prepared"],
                                     t["committed"], t["dval"], t["timer"],
                                     t["reset"])
    nb = cfg.n_byzantine
    bcast = cfg.fault_model == "bcast"
    for b, s in enumerate(SEEDS):
        nr = int(n_real[b])
        honest = jnp.arange(N) < nr - nb
        byz = (jnp.arange(N) < nr) & ~honest
        js = jnp.uint32(s)
        if ladder:
            # The JAX package's ladder phases (K17), per lane.
            wp, wc, wd = _padded_switch_phases_lane(
                jcfg, js, r, nr, honest, pp_seen[b], pp_val[b], prepared[b],
                committed[b], dval[b], 2 * int(f[b]) + 1, byz, bcast)
        else:
            wp, wc, wd = _engine_switch_phases_lane(
                jcfg, js, r, honest, byz, pp_seen[b], pp_val[b],
                prepared[b], committed[b], dval[b], 2 * int(f[b]) + 1, bcast)
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(wp))
        np.testing.assert_array_equal(got[2][b].numpy(), np.asarray(wc))
        np.testing.assert_array_equal(got[3][b].numpy(), np.asarray(wd))
        new = np.asarray(wc & ~committed[b]).any(1)
        want_t = np.where(reset[b] | new, np.where(new, 0, timer[b]),
                          timer[b] + 1)
        np.testing.assert_array_equal(got[4][b].numpy(), want_t)


def _padded_switch_phases_lane(jcfg, seed, r, nr, honest, pp_seen, pp_val,
                               prepared, committed, dval, Q, byz, bcast):
    from consensus_tpu.engines.pbft_sweep import _padded_switch_phases
    equiv = jcfg.byz_mode == "equivocate" and jcfg.n_byzantine > 0
    return _padded_switch_phases(
        jcfg, seed, jnp.uint32(r), jnp.int32(nr), honest,
        jnp.asarray(pp_seen), jnp.asarray(pp_val), jnp.asarray(prepared),
        jnp.asarray(committed), jnp.asarray(dval), jnp.int32(Q),
        byz=byz if equiv else None, bcast_uplink=bcast)


def _engine_switch_phases_lane(jcfg, seed, r, honest, byz, pp_seen, pp_val,
                               prepared, committed, dval, Q, bcast):
    """The standalone engines' switch P4-P6 (``pbft.py:271-361``,
    ``pbft_bcast.py:564-642`` without a crash), transcribed from the JAX
    package's own functions."""
    from consensus_tpu.core import rng as jrng
    from consensus_tpu.ops.adversary import draw as jdraw
    N, K = jcfg.n_nodes, jcfg.n_aggregators
    ur = jnp.uint32(r)
    idx = jnp.arange(N, dtype=jnp.int32)
    aggst = jagg.agg_round(jcfg, seed, ur)
    sids = jagg.agg_ids(N, K)
    pz4 = jagg.agg_poison(jcfg, seed, ur, 0)
    pz5 = jagg.agg_poison(jcfg, seed, ur, 1)
    wid = jagg.seg_widths(jnp.ones(N, bool), sids, K) \
        if pz4 is not None else None
    lie, fval = jagg.uplink_lies(jcfg, seed, ur, ~honest)
    equiv = jcfg.byz_mode == "equivocate" and jcfg.n_byzantine > 0
    stance = (jdraw(seed, jrng.STREAM_EQUIV, ur, idx.astype(jnp.uint32),
                    jnp.uint32(0x80000000)) & jnp.uint32(1)).astype(bool)
    ups = [jagg.uplink_bcast(jcfg, seed, aggst)] * 3 if bcast else \
        [jagg.uplink_edge(jcfg, seed, aggst, ph) for ph in range(3)]
    pp_seen, pp_val = jnp.asarray(pp_seen), jnp.asarray(pp_val)
    prepared, committed = jnp.asarray(prepared), jnp.asarray(committed)
    dval = jnp.asarray(dval)

    def votes(ph, flag, pz):
        return jagg.value_votes(
            pp_val, honest[:, None] & flag, ups[ph],
            jagg.downlink(jcfg, seed, ur, aggst, ph, idx),
            jagg.downlink_self(jcfg, seed, ur, aggst, ph), sids, K,
            eq_up=(byz & stance & ups[ph]) if equiv else None, lie=lie,
            lie_val=fval, poison=pz, widths=wid) \
            + (honest[:, None] & flag).astype(jnp.int32)
    prepared = prepared | (pp_seen & (votes(0, pp_seen, pz4) >= Q))
    commit_now = prepared & (votes(1, prepared, pz5) >= Q) & ~committed
    dval = jnp.where(commit_now, pp_val, dval)
    committed = committed | commit_now
    imin, vad = jagg.min_id_votes(
        honest[:, None] & committed, dval, ups[2],
        jagg.downlink(jcfg, seed, ur, aggst, 2, idx), sids, K, N)
    adopt = (imin < N) & ~committed
    return prepared, committed | adopt, jnp.where(adopt, vad, dval)
