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
