"""The port's SPEC §6c crash-recover adversary against the JAX package, on
the CPU.

Each round a down node recovers where its draw (STREAM_CRASH, round, 1,
node) is below the recover cutoff, and a node up after the recoveries
crashes where its draw with c0 = 0 is below the crash cutoff, admitted in
ascending id order under ``max_crashed`` (``consensus_tpu/ops/
adversary.py`` ``crash_transition``). A recovered node's volatile state is
reset, a down node neither sends nor receives, and its state is frozen.
The same seeds go through ``consensus_tpu`` and through the port's plain
versions; everything must be equal, tolerance 0: the transition (kernel
KAH's plain version) on random masks, rounds and extreme seeds, caps that
bind with recoveries in the same round, the crash counts and the freeze
(KAI's plain version); whole runs of the six engines at
``tests/test_crash.py``'s shapes, uncapped and capped, against the JAX
package and the C++ oracle, one of each with telemetry and the flight
recorder; each with a §A.2 delay; and a config whose ``crash_prob`` is 0
gives the flat digest whatever ``recover_prob`` and ``max_crashed`` say.
HotStuff at ``tests/test_hotstuff.py``'s crash cases (capped, with a
delay) and with an uncapped crash, a SPEC §B skew and a delay together,
against the JAX package and the oracle; its telemetry with 4-round
windows under a crash and a skew; ``crash_prob = 0`` runs no KAH or KAJ;
and P1's key after kernel KAJ's prologue on built states (the highest
view down, every node down, a recovered node tied at view 0, a node
skewed and down in one round).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu.ops import adversary as jadv  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.core import rng  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402
from consensus_tpu_torch.ops import adversary  # noqa: E402

SEEDS = (0, 0xFFFFFFFF, 12345)
CUTS = ((0.12, 0.35), (0.99, 0.99), (0.5, 0.0))


def _masks(n: int, gen, p: float = 0.3) -> np.ndarray:
    return gen.random((len(SEEDS), n)) < p


def _jax_transition(seed, r, down, crash_cut, recover_cut, cap):
    return [np.asarray(x) for x in jadv.crash_transition(
        jnp.uint32(seed), jnp.uint32(r), jnp.asarray(down), crash_cut,
        recover_cut, cap)]


def _decode(flags):
    f = flags.numpy()
    return ((f & adversary.CRASH_DOWN) != 0, (f & adversary.CRASH_REC) != 0,
            (f & adversary.CRASH_NEW) != 0)


# --- the transition, the counts and the freeze ---------------------------------

@pytest.mark.parametrize("r", [0, 1, 200])
@pytest.mark.parametrize("cap", ["0", "1", "3", "N"])
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_crash_transition_matches_jax(n, cap, r):
    """KAH's plain version gives JAX's (down', rec, crashed) on every lane,
    and adds JAX's crash_counts into the totals and the window ring."""
    gen = np.random.default_rng(n * 1000 + r)
    cap_n = {"0": 0, "1": 1, "3": 3, "N": n}[cap]
    for crash_p, rec_p in CUTS:
        cc, rc = rng.prob_threshold_u32(crash_p), rng.prob_threshold_u32(rec_p)
        down = _masks(n, gen)
        seed = torch.tensor(SEEDS, dtype=torch.int64).to(torch.uint32)
        t = torch.zeros((len(SEEDS), 12), dtype=torch.int32)
        w = torch.zeros((len(SEEDS), 3, 12), dtype=torch.int32)
        new, flags = adversary.crash_transition_plain(
            seed, r, torch.from_numpy(down), cc, rc, cap_n, t, w, 5, 2)
        got = _decode(flags)
        assert np.array_equal(new.numpy(), got[0])
        for b, s in enumerate(SEEDS):
            want = _jax_transition(s, r, down[b], cc, rc, cap_n)
            for g, x in zip(got, want):
                assert np.array_equal(g[b], x), (s, crash_p, rec_p)
            counts = [int(c) for c in jadv.crash_counts(
                jnp.asarray(want[2]), jnp.asarray(want[1]),
                jnp.asarray(want[0]))]
            assert t[b, 5:8].tolist() == counts
            assert w[b, 2, 5:8].tolist() == counts
            assert int(t[b].sum()) == sum(counts)


def test_the_cap_binds_with_recoveries_in_the_round():
    """With max_crashed = 2 and most nodes down, the cap binds in rounds
    where nodes also recover: the count still down is taken after the
    recoveries, and only the lowest would-be crashers get in (an off-by-one
    in the inclusive rank changes these rounds)."""
    n, cap = 64, 2
    cc, rc = rng.prob_threshold_u32(0.5), rng.prob_threshold_u32(0.5)
    seed = torch.tensor(SEEDS, dtype=torch.int64).to(torch.uint32)
    gen = np.random.default_rng(7)
    binding = 0
    for r in range(40):
        down = np.zeros((len(SEEDS), n), bool)
        down[:, gen.choice(n, 1, replace=False)] = True
        new, flags = adversary.crash_transition_plain(
            seed, r, torch.from_numpy(down), cc, rc, cap)
        got = _decode(flags)
        for b, s in enumerate(SEEDS):
            want = _jax_transition(s, r, down[b], cc, rc, cap)
            for g, x in zip(got, want):
                assert np.array_equal(g[b], x)
            uncapped = _jax_transition(s, r, down[b], cc, rc, 0)
            if want[1].any() and uncapped[2].sum() > want[2].sum():
                binding += 1
                assert want[0].sum() == cap
    assert binding >= 10


def test_crash_counts_match_jax():
    gen = np.random.default_rng(3)
    masks = gen.random((3, 4, 50)) < 0.4
    got = adversary.crash_counts_plain(*(torch.from_numpy(m) for m in masks))
    for b in range(4):
        want = [int(c) for c in jadv.crash_counts(
            *(jnp.asarray(m[b]) for m in masks))]
        assert got[b].tolist() == want
    assert [int(c) for c in jadv.crash_counts()] == [0, 0, 0]


def test_freeze_down_matches_jax():
    """KAI's plain version is JAX's freeze_down with the frozen leaves read
    off the round's input and, where a recovered node's leaf is volatile,
    its reset value 0."""
    gen = np.random.default_rng(5)
    B, N, S = 3, 40, 6
    flags = gen.integers(0, 8, (B, N)).astype(np.uint8)
    down = (flags & adversary.CRASH_DOWN) != 0
    rec = (flags & adversary.CRASH_REC) != 0
    leaves = [gen.integers(-9, 9, (B, N)).astype(np.int32),
              gen.integers(-9, 9, (B, N, S)).astype(np.int32),
              gen.random((B, N, S)) < 0.5]
    frozen = [gen.integers(-9, 9, x.shape).astype(x.dtype) for x in leaves]
    resets = (True, False, False)
    dst = [torch.from_numpy(x.copy()) for x in leaves]
    adversary.freeze_down_plain(torch.from_numpy(flags), [
        (d, torch.from_numpy(o), z) for d, o, z in zip(dst, frozen, resets)])
    for b in range(B):
        held = [np.where(rec[b].reshape((N,) + (1,) * (o.ndim - 2)) & z, 0,
                         o[b]) for o, z in zip(frozen, resets)]
        want = jadv.freeze_down(jnp.asarray(down[b]),
                                tuple(jnp.asarray(h) for h in held),
                                tuple(jnp.asarray(x[b]) for x in leaves))
        for d, x in zip(dst, want):
            assert np.array_equal(d[b].numpy(), np.asarray(x))


@pytest.mark.parametrize("r", [0, 20])
def test_delivery_masks_cut_down_nodes_as_jax(r):
    """KL's and KB's plain versions with the round's flags are JAX's
    delivery masks cut by the new down mask at both ends."""
    gen = np.random.default_rng(r)
    n, cut = 9, rng.prob_threshold_u32(0.2)
    seed = torch.tensor(SEEDS, dtype=torch.int64).to(torch.uint32)
    down = _masks(n, gen, 0.4)
    flags = torch.from_numpy(down.astype(np.uint8) * adversary.CRASH_DOWN)
    dense = adversary.delivery_plain(seed, r, n, cut, 0, 0, flags)
    ids = torch.tensor([[0, 3, -1], [8, 2, 5], [1, -1, 4]], dtype=torch.int32)
    src = adversary.delivery_edges_plain(seed, r, ids, n, cut, 0, True, 0,
                                         flags)
    dst = adversary.delivery_edges_plain(seed, r, ids, n, cut, 0, False, 0,
                                         flags)
    for b, s in enumerate(SEEDS):
        up = ~down[b]
        want = np.asarray(jadv.delivery(jnp.uint32(s), n, jnp.uint32(r),
                                        cut, 0)) & up[:, None] & up[None, :]
        assert np.array_equal(dense[b].numpy(), want)
        for a, i in enumerate(ids[b].tolist()):
            if i < 0:
                assert not src[b, a].any() and not dst[b, :, a].any()
            else:
                assert np.array_equal(src[b, a].numpy(), want[i])
                assert np.array_equal(dst[b, :, a].numpy(), want[:, i])


@pytest.mark.parametrize("crash", [False, True])
def test_kaa_view_terms_match_jax(crash):
    """KAA's view terms (view_changes, the view-change waits) as the JAX
    tail takes them (``consensus_tpu/engines/pbft.py:406-421``): on the
    flat path over every node, wrapping in int32 at extreme views; under
    §6c from the round's views before the freeze and the new down mask,
    where the JAX tail reads the frozen views (a down node's entry view,
    or 0 where it recovered)."""
    from consensus_tpu.ops.flight import bucket_counts
    from consensus_tpu_torch.engines import pbft
    gen = np.random.default_rng(11 + crash)
    B, N, S, r = 4, 9, 3, 5
    lo, hi = (0, 40) if crash else (-2**31, 2**31 - 1)
    view_in = gen.integers(lo, hi, (B, N)).astype(np.int32)
    view = gen.integers(lo, hi, (B, N)).astype(np.int32)
    timer_in = gen.integers(0, 20, (B, N)).astype(np.int32)
    down = gen.random((B, N)) < (0.4 if crash else 0.0)
    rec = down & (gen.random((B, N)) < 0.5)
    frozen = np.where(down, np.where(rec, 0, view_in), view)
    cfg = Config(protocol="pbft", f=2, n_nodes=7, telemetry_window=W)
    K = len(pbft.PBFT_TELEMETRY)
    t = torch.zeros((B, K), dtype=torch.int32)
    w = torch.zeros((B, 2, K), dtype=torch.int32)
    lat = torch.zeros((B, 2, 16), dtype=torch.int32)
    slots = torch.zeros((B, N, S), dtype=torch.bool)
    pbft.pbft_telemetry_plain(
        cfg, r, torch.full((B,), N, dtype=torch.int32),
        torch.from_numpy(view_in), torch.from_numpy(timer_in),
        torch.from_numpy(view), torch.zeros((B, N), dtype=torch.bool),
        torch.from_numpy(down), *(slots,) * 6, t, w, lat,
        pbft.CRASH_VIEWS if crash else 0)
    for b in range(B):
        moved = jnp.sum(jnp.maximum(jnp.asarray(frozen[b])
                                    - jnp.asarray(view_in[b]), 0))
        waits = bucket_counts(jnp.asarray(timer_in[b]) + 1,
                              jnp.asarray(frozen[b] > view_in[b]))
        assert int(t[b, 5]) == int(moved)
        assert np.array_equal(lat[b, 0].numpy(), np.asarray(waits))


# --- whole runs ------------------------------------------------------------------

W = 6
# tests/test_crash.py's ADV, CRASH and CFGS (lines 31-50).
ADV = dict(drop_rate=0.1, partition_rate=0.05, churn_rate=0.05)
CRASH = dict(crash_prob=0.15, recover_prob=0.3)
CFGS = {
    "raft": dict(protocol="raft", n_nodes=5, n_rounds=48, n_sweeps=2,
                 log_capacity=32, max_entries=16, **ADV),
    "raft-sparse": dict(protocol="raft", n_nodes=16, max_active=4,
                        n_rounds=40, n_sweeps=2, log_capacity=16,
                        max_entries=8, **ADV),
    "pbft": dict(protocol="pbft", f=1, n_nodes=4, n_rounds=24,
                 log_capacity=8, **ADV),
    "pbft-bcast": dict(protocol="pbft", fault_model="bcast", f=2, n_nodes=7,
                       n_rounds=24, log_capacity=8, **ADV),
    "paxos": dict(protocol="paxos", n_nodes=7, n_rounds=24, log_capacity=8,
                  **ADV),
    "dpos": dict(protocol="dpos", n_nodes=24, n_rounds=32, log_capacity=48,
                 n_candidates=8, n_producers=3, epoch_len=8, **ADV),
}
# Uncapped (tests/test_crash.py's CRASH) and capped at 2 (the
# crash-churn-under-partition scenario's cap), each against the JAX package
# and the C++ oracle; the uncapped case with telemetry and the recorder.
CAPS = {"uncapped": 0, "capped": 2}


def _port(cfg, telemetry: bool):
    """The port's decided payload of ``cfg`` on the CPU, and its stats."""
    stats: dict = {}
    out = runner.run(cfg, "cpu", telemetry=telemetry, stats=stats)
    return simulator.decided_payload(cfg, out)[3], stats


def _same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    else:
        assert np.array_equal(np.asarray(got), np.asarray(want)), where


def _check_run(kw, telemetry: bool, oracle: bool = True):
    want = jsim.run(JConfig(**kw), warmup=False, telemetry=telemetry)
    payload, stats = _port(Config(**kw), telemetry)
    assert payload == want.payload
    if telemetry:
        _same(stats["telemetry"], want.extras["telemetry"]["per_sweep"],
              "telemetry")
        _same(stats["flight"], {k: v for k, v in want.extras["flight"]
                                .items() if k != "engine"}, "flight")
        assert stats["telemetry"]["crashes"].sum() > 0
        assert stats["telemetry"]["recoveries"].sum() > 0
    if oracle:
        cpu = jsim.run(JConfig(**{**kw, "telemetry_window": 0},
                               engine="cpu"), warmup=False)
        assert cpu.payload == payload
    return payload


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("name", list(CFGS))
def test_whole_run_matches_jax_and_the_oracle(name, cap):
    telemetry = cap == "uncapped"
    kw = {**CFGS[name], **CRASH, "max_crashed": CAPS[cap],
          "telemetry_window": W if telemetry else 0}
    _check_run(kw, telemetry)


@pytest.mark.parametrize("name", list(CFGS))
def test_crash_composes_with_a_delay(name):
    """§6c beside the §A.2 delay (chained-commit-stall composes them):
    JAX's digest and counters."""
    kw = {**CFGS[name], **CRASH, "max_delay_rounds": 4,
          "telemetry_window": W}
    _check_run(kw, True, oracle=False)


@pytest.mark.parametrize("name", list(CFGS))
def test_crash_off_is_digest_neutral(name):
    """crash_prob = 0 with recover_prob and max_crashed set is the flat run
    (after tests/test_crash.py's first test): no KAH, the flat kernels."""
    cfg = Config(**CFGS[name])
    off = Config(**{**CFGS[name], "recover_prob": 0.5, "max_crashed": 2})
    assert not off.crash_on
    calls = []
    real = adversary.crash_transition

    def counting(*args):
        calls.append(args)
        return real(*args)
    adversary.crash_transition = counting
    try:
        assert _port(off, False)[0] == _port(cfg, False)[0]
    finally:
        adversary.crash_transition = real
    assert not calls


def test_the_graph_key_holds_the_crash_knobs():
    a = Config(**{**CFGS["pbft"], **CRASH})
    dev = torch.device("cpu")
    for b in (dataclasses.replace(a, crash_prob=0.2),
              dataclasses.replace(a, recover_prob=0.1),
              dataclasses.replace(a, max_crashed=1)):
        assert runner._graph_key(a, dev, False, None) != \
            runner._graph_key(b, dev, False, None)


# --- HotStuff ------------------------------------------------------------------

# tests/test_hotstuff.py BASE and its crash cases (lines 22-24, 32-35 and
# 114), and the three SPEC gates the port runs on HotStuff together.
HS_BASE = dict(protocol="hotstuff", f=2, n_nodes=7, n_rounds=96, n_sweeps=3,
               log_capacity=96, seed=3)
HS_DESYNC = dict(desync_rate=0.15, max_skew_rounds=4, view_timeout=4)
HS_RUNS = {
    "crash-delay": {**HS_BASE, "drop_rate": 0.2, "crash_prob": 0.1,
                    "recover_prob": 0.3, "max_crashed": 2,
                    "max_delay_rounds": 3, "seed": 2},
    "n301": {**HS_BASE, "f": 100, "n_nodes": 301, "drop_rate": 0.1,
             "partition_rate": 0.05, "churn_rate": 0.01, "crash_prob": 0.05,
             "recover_prob": 0.3, "max_crashed": 10, "max_delay_rounds": 2,
             "seed": 7},
    "outage": {**HS_BASE, "crash_prob": 0.3, "recover_prob": 0.5,
               "max_crashed": 1, "view_timeout": 4, "seed": 9},
    "crash-desync-delay": {**HS_BASE, **CRASH, **HS_DESYNC,
                           "drop_rate": 0.2, "max_delay_rounds": 2,
                           "seed": 5},
}


@pytest.mark.parametrize("name", list(HS_RUNS))
def test_hotstuff_crash_run_matches_jax_and_the_oracle(name):
    """Every extract leaf, the digest and the oracle's digest."""
    from consensus_tpu.network import runner as jrunner
    kw = HS_RUNS[name]
    jcfg, cfg = JConfig(**kw), Config(**kw)
    want = jrunner.run(jcfg, jsim.engine_def(jcfg))
    got = runner.run(cfg, "cpu")
    _same(got, want, name)
    payload = simulator.decided_payload(cfg, got)[3]
    assert payload == jsim.decided_payload(jcfg, want)[3]
    cpu = jsim.run(dataclasses.replace(jcfg, engine="cpu"), warmup=False)
    assert cpu.payload == payload
    assert want["clen"].max() > 0


def test_hotstuff_crash_off_is_flat():
    """crash_prob = 0 with recover_prob and max_crashed set is HotStuff's
    flat round: no KAH and no KAJ, and the JAX package's digest."""
    from consensus_tpu_torch.engines import hotstuff
    kw = {**HS_BASE, "n_rounds": 24, "recover_prob": 0.5, "max_crashed": 2,
          "drop_rate": 0.2}
    cfg = Config(**kw)
    assert not hotstuff.gated(cfg)
    calls = []
    real = (adversary.crash_transition, hotstuff.hotstuff_prologue)

    def counting(*args):
        calls.append(args)
    adversary.crash_transition = hotstuff.hotstuff_prologue = counting
    try:
        got = _port(cfg, False)[0]
    finally:
        adversary.crash_transition, hotstuff.hotstuff_prologue = real
    assert not calls
    assert got == jsim.run(JConfig(**kw), warmup=False).payload


def test_hotstuff_crash_desync_telemetry_matches_jax():
    """Counters and recorder (4-round windows) under a crash and a skew:
    a down node's timeouts, premature ones included, and its waits count
    from its in-round timer; the spread is over the nodes up."""
    kw = {**HS_RUNS["crash-desync-delay"], "n_rounds": 40,
          "telemetry_window": 4}
    _check_run(kw, True, oracle=False)
    stats: dict = {}
    runner.run(Config(**kw), "cpu", telemetry=True, stats=stats)
    tel = stats["telemetry"]
    assert tel["view_spread_max"].sum() > 0 and tel["desync_rounds"].sum() > 0


def _jax_p1(jcfg, seed, r, down, view, timer):
    """The JAX round's prologue (consensus_tpu/engines/hotstuff.py:207-230)
    and P1's (vM, M) over the honest live nodes (lines 266-268), by the
    JAX package's own functions, on one lane: (vM, M, view, timer)."""
    from consensus_tpu.ops import viewsync as jviewsync
    ur = jnp.uint32(r)
    N = view.shape[0]
    dn, rec, _ = jadv.crash_transition(jnp.uint32(seed), ur,
                                       jnp.asarray(down), jcfg.crash_cutoff,
                                       jcfg.recover_cutoff, jcfg.max_crashed)
    v = jnp.where(rec, 0, jnp.asarray(view))
    t = jnp.where(rec, 0, jnp.asarray(timer))
    if jcfg.desync_on:
        t = t + jviewsync.desync_skew(jnp.uint32(seed), ur,
                                      jnp.arange(N, dtype=jnp.uint32),
                                      jcfg.desync_cutoff,
                                      jcfg.max_skew_rounds)
        pre = t >= jcfg.view_timeout
        v = v + pre.astype(jnp.int32)
        t = jnp.where(pre, 0, t)
    idx = jnp.arange(N, dtype=jnp.int32)
    alive = ~dn
    vM = jnp.max(jnp.where(alive, v, -1))
    M = jnp.min(jnp.where(alive & (v == vM), idx, N))
    return int(vM), int(M), np.asarray(v), np.asarray(t)


def _built_states(cfg, B: int, r: int, case: str):
    """Leaves of a HotStuff state of ``B`` lanes and ``cfg.n_nodes`` nodes
    built for ``case`` around round ``r``'s crash transition (which the
    state's down mask and seeds fix): "top-down" gives a node down at the
    round's end the unique highest view; "rec-tie" resets a recovered node
    that had the highest view, to tie with live nodes at view 0; "all" is
    any state (the all-down case is a config that downs every node);
    "skewed-down" gives the down nodes timers one short of the timeout."""
    from consensus_tpu_torch.engines import hotstuff as ths
    g = np.random.default_rng(r + len(case))
    N, S = cfg.n_nodes, cfg.log_capacity
    seeds = np.arange(90, 90 + B, dtype=np.uint32)
    down = g.random((B, N)) < 0.4
    _, flags = adversary.crash_transition_plain(
        torch.from_numpy(seeds), r, torch.from_numpy(down), cfg.crash_cutoff,
        cfg.recover_cutoff, cfg.max_crashed)
    f = flags.numpy()
    now_down = (f & adversary.CRASH_DOWN) != 0
    rec = (f & adversary.CRASH_REC) != 0
    view = g.integers(2, 9, (B, N)).astype(np.int32)
    timer = g.integers(0, 3, (B, N)).astype(np.int32)
    for b in range(B):
        if case == "top-down" and now_down[b].any():
            view[b, np.flatnonzero(now_down[b])[0]] = 40
        if case == "rec-tie" and rec[b].any():
            view[b] = np.where(now_down[b], view[b], 0)
            view[b, np.flatnonzero(rec[b])[0]] = 40
        if case == "skewed-down":
            timer[b] = np.where(now_down[b], cfg.view_timeout - 1, timer[b])
    leaves = {"seed": seeds, "b1_v": np.full(B, 3, np.int32),
              "b1_h": np.full(B, 2, np.int32),
              "b2_v": np.full(B, 2, np.int32),
              "b2_h": np.full(B, 1, np.int32),
              "b3_v": np.full(B, 1, np.int32),
              "b3_h": np.zeros(B, np.int32),
              "gcommit": np.ones(B, np.int32),
              "chain_v": np.where(np.arange(S) < 3, np.arange(S) + 1,
                                  -1).astype(np.int32)[None].repeat(B, 0),
              "chain_vid": np.zeros((B, S), np.int32),
              "fvec": np.zeros((B, N), np.int32),
              "ftab_v": np.full((B, ths.FORK_TABLE), -1, np.int32),
              "ftab_h": np.full((B, ths.FORK_TABLE), -1, np.int32),
              "fnum": np.zeros(B, np.int32), "view": view, "timer": timer,
              "clen": g.integers(0, 2, (B, N)).astype(np.int32),
              "down": down}
    return leaves, flags, now_down, rec


P1_CASES = {
    "top-down": {**HS_BASE, "f": 4, "n_nodes": 13, "log_capacity": 16,
                 "crash_prob": 0.3, "recover_prob": 0.5, "view_timeout": 4},
    "rec-tie": {**HS_BASE, "f": 4, "n_nodes": 13, "log_capacity": 16,
                "crash_prob": 0.3, "recover_prob": 0.5, "view_timeout": 4},
    "all-down": {**HS_BASE, "f": 4, "n_nodes": 13, "log_capacity": 16,
                 "crash_prob": 1.0, "recover_prob": 0.0, "view_timeout": 4},
    "skewed-down": {**HS_BASE, "f": 4, "n_nodes": 13, "log_capacity": 16,
                    "crash_prob": 0.3, "recover_prob": 0.5,
                    "desync_rate": 0.9, "max_skew_rounds": 4,
                    "view_timeout": 4},
}


@pytest.mark.parametrize("case", list(P1_CASES))
def test_hotstuff_p1_key_matches_jax_on_built_states(case):
    """KAJ's plain version gives the views, timers and P1 gossiper (vM, and
    M where vM >= 0) of the JAX round's prologue, and the whole round then
    JAX's state, on states built so that the highest view is down, every
    node is down (vM = -1: no gossip), a recovered node ties at view 0, or
    a node is skewed and down in one round (its frozen timer drops the
    skew)."""
    import jax
    from consensus_tpu.engines import hotstuff as jhs
    from consensus_tpu_torch.engines import hotstuff as ths
    kw = P1_CASES[case]
    jcfg, cfg = JConfig(**kw), Config(**kw)
    B, r = 6, 11
    leaves, flags, now_down, rec = _built_states(cfg, B, r, case.replace(
        "all-down", "all"))
    st = convert.state_from_numpy(leaves)
    lane = st.lane.clone()
    view, timer = ths.hotstuff_prologue_plain(cfg, st.seed, r, st.view,
                                              st.timer, lane, flags)
    vM, M = ths.gossiper(lane[:, ths.KEY], cfg.n_nodes)
    for b in range(B):
        want = _jax_p1(jcfg, int(leaves["seed"][b]), r, leaves["down"][b],
                       leaves["view"][b], leaves["timer"][b])
        assert np.array_equal(view[b].numpy(), want[2])
        assert np.array_equal(timer[b].numpy(), want[3])
        assert int(vM[b]) == max(want[0], -1)
        if want[0] >= 0:
            assert int(M[b]) == want[1], (case, b)
    if case == "top-down":
        assert all(now_down[b].any() and int(vM[b]) < 40 for b in range(B))
    if case == "all-down":
        assert now_down.all() and (vM == -1).all() and \
            (M == cfg.n_nodes).all()
    if case == "rec-tie":
        hit = [b for b in range(B) if rec[b].any()]
        assert hit and all(int(vM[b]) == 0 for b in hit)
        assert any(int(M[b]) == np.flatnonzero(rec[b])[0] for b in hit)
    got = convert.state_to_numpy(ths.hotstuff_round(cfg, st, r))
    one = jax.jit(jax.vmap(lambda s, rr: jhs.hotstuff_round(jcfg, s, rr),
                           in_axes=(0, None)))
    want = one(jhs.HotstuffState(**{k: jnp.asarray(v)
                                    for k, v in leaves.items()}),
               jnp.int32(r))
    for name, a in want._asdict().items():
        assert np.array_equal(got[name], np.asarray(a)), (case, name)
    if case == "skewed-down":
        frozen = now_down & ~rec
        assert frozen.any()
        assert np.array_equal(got["timer"][frozen], leaves["timer"][frozen])
