"""The port's chained HotStuff engine against the JAX package, on the CPU.

``Config(protocol="hotstuff")`` selects the SPEC §7b engine
(``consensus_tpu_torch/engines/hotstuff.py``). The same seeds go through
``consensus_tpu`` and through the port's plain versions of kernels KAD-KAG;
everything must be equal, tolerance 0 (all state is integer): whole runs
(digest and every extract leaf) at the flat cases of ``tests/test_hotstuff.py``
and at hotstuff-100k's knobs cut to N = 10 000, one of them also against the
C++ oracle; one round from a converted JAX carry and from random states
(views spread apart and tied, several proposers, the ``view <= V*``
boundary, a full chain, no proposer, timers at the timeout, int32 view
extremes); the extraction on an equivocating JAX carry with forks
(``tests/hotstuff_fork_carry.npz``); the telemetry counters, windows at W =
6 and latency buckets; and chip_smoke.py's HotStuff anchors made again by
the JAX package.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.engines import hotstuff as jhs  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.engines import hotstuff  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402

from helpers import run_cached  # noqa: E402

# tests/test_hotstuff.py's BASE and its flat cases (lines 13-52): the gates
# the port rejects (crash, delay, byzantine, desync) taken out.
BASE = dict(protocol="hotstuff", f=2, n_nodes=7, n_rounds=96, n_sweeps=3,
            log_capacity=96, seed=3)
CFGS = {
    "base": BASE,
    "lossy": {**BASE, "drop_rate": 0.2, "churn_rate": 0.05,
              "partition_rate": 0.1, "seed": 1},
    "n301": {**BASE, "f": 100, "n_nodes": 301, "drop_rate": 0.1,
             "partition_rate": 0.05, "churn_rate": 0.01, "seed": 7},
    "n1024": {**BASE, "f": 341, "n_nodes": 1024, "n_rounds": 32,
              "n_sweeps": 1, "log_capacity": 32, "view_timeout": 4,
              "drop_rate": 0.1, "partition_rate": 0.05, "seed": 17},
    # S < n_rounds: the chain fills, and from then on nobody proposes.
    "full-chain": {**BASE, "log_capacity": 24, "drop_rate": 0.05,
                   "view_timeout": 4, "seed": 5},
}
# hotstuff-100k (benchmarks/run_benchmarks.py CONFIGS) cut to N = 10 000
# (f = 3 333): the same knobs, rounds, sweeps and slots.
HOTSTUFF_100K_CUT = dict(protocol="hotstuff", f=3_333, n_nodes=10_000,
                         n_rounds=64, n_sweeps=8, log_capacity=64, seed=8,
                         drop_rate=0.01, churn_rate=0.001)
FORK_CARRY = pathlib.Path(__file__).resolve().parent / \
    "hotstuff_fork_carry.npz"


def _assert_leaves(got: dict, want: dict, where=""):
    assert set(got) == set(want), where
    for k in want:
        a = np.asarray(want[k])
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, (where, k)
        assert np.array_equal(got[k], a), (where, k)


def _port_config(jcfg) -> Config:
    return Config(**{f.name: getattr(jcfg, f.name)
                     for f in dataclasses.fields(Config)})


# --- whole runs --------------------------------------------------------------

@pytest.mark.parametrize("name", [*CFGS, "hotstuff-100k-cut"])
def test_whole_run_matches_jax(name):
    kw = HOTSTUFF_100K_CUT if name == "hotstuff-100k-cut" else CFGS[name]
    jcfg, cfg = JConfig(**kw), Config(**kw)
    assert jsim.engine_def(jcfg).name == simulator.engine_def(cfg).name
    want = jrunner.run(jcfg, jsim.engine_def(jcfg))
    got = runner.run(cfg, "cpu")
    _assert_leaves(got, want, name)
    assert simulator.decided_payload(cfg, got)[3] == \
        jsim.decided_payload(jcfg, want)[3]
    assert want["clen"].max() > 0
    if name == "full-chain":
        assert (want["chain_v"] >= 0).all()


def test_front_door_matches_jax_and_the_oracle():
    """``simulator.run``'s digest equals the JAX package's and the C++
    oracle's (``engine="cpu"``) on the lossy case."""
    jcfg = JConfig(**CFGS["lossy"])
    res = simulator.run(Config(**CFGS["lossy"]), device="cpu")
    assert res.digest == run_cached(jcfg).digest
    assert res.digest == run_cached(dataclasses.replace(jcfg,
                                                        engine="cpu")).digest
    assert res.node_round_steps == 3 * 7 * 96


# --- one round from a converted JAX carry ------------------------------------

def _leaves(carry) -> dict:
    return {k: np.array(v) for k, v in carry._asdict().items()}


# The hostile N = 301 run with a short chain: partitions, churn, views
# apart, and from round 20 on a full chain.
STEP_KW = {**CFGS["n301"], "drop_rate": 0.15, "partition_rate": 0.1,
           "churn_rate": 0.05, "view_timeout": 4, "log_capacity": 16,
           "n_rounds": 64}
STEPS = (0, 5, 17, 40, 63)


@pytest.fixture(scope="module")
def jax_steps():
    """{k: (leaves before round k, leaves after it)} from the JAX scan."""
    jcfg = JConfig(**STEP_KW)
    eng = jsim.engine_def(jcfg)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    out, r0 = {}, 0
    for k in STEPS:
        if k > r0:
            carry = jrunner._chunk_jit(jcfg, eng, k - r0, carry,
                                       jnp.int32(r0))
        before = _leaves(carry)
        carry = jrunner._chunk_jit(jcfg, eng, 1, carry, jnp.int32(k))
        out[k] = (before, _leaves(carry))
        r0 = k + 1
    return jcfg, out


@pytest.mark.parametrize("k", STEPS)
def test_one_round_from_jax_state(jax_steps, k):
    jcfg, steps = jax_steps
    before, after = steps[k]
    st = convert.state_from_numpy(before)
    assert isinstance(st, hotstuff.HotstuffState)
    got = convert.state_to_numpy(hotstuff.hotstuff_round(
        _port_config(jcfg), st, k))
    _assert_leaves(got, after, k)
    if k >= 40:
        assert (after["b1_h"] + 1 >= jcfg.log_capacity).all()


def test_lane_words_cross_launches(jax_steps):
    """P1's key is every lane's highest view and the lowest id holding it,
    and a round leaves the lane words at rest with the next round's key."""
    _, steps = jax_steps
    before, after = steps[STEPS[2]]
    st = convert.state_from_numpy(before)
    view = before["view"]
    top = st.lane[:, hotstuff.TOP].numpy()
    assert np.array_equal(top >> 32, view.max(1))
    N = view.shape[1]
    assert np.array_equal(N - 1 - (top & 0xFFFFFFFF),
                          (view == view.max(1, keepdims=True)).argmax(1))
    new = hotstuff.hotstuff_round(_port_config(jax_steps[0]), st, STEPS[2])
    rest = [1, 2, 3, 6, 7, hotstuff.KEY]
    assert torch.equal(new.lane[:, rest],
                       hotstuff.lane_at_rest(new.view)[:, rest])
    assert torch.equal(new.lane[:, hotstuff.TOP],
                       hotstuff.p1_key(torch.from_numpy(after["view"])))


# --- one round from random states --------------------------------------------

def _jax_round(jcfg, telem=False):
    def one(st, r):
        return jhs.hotstuff_round(jcfg, st, r, telem=telem, flight=telem)
    return jax.jit(jax.vmap(one, in_axes=(0, None)))


def _random_leaves(g, B, N, S, r, case):
    """A random batched JAX carry of N nodes and S heights: views in a
    small range (ties on the highest, several proposers, P1 catch-ups),
    timers at and around the timeout, prefixes below and at the commit;
    ``case`` "full" puts b1_h at S - 1 (no room: nobody proposes),
    "extremes" puts int32's ends among the views (V* + 1 wraps)."""
    view = g.integers(r, r + 6, (B, N)).astype(np.int32)
    view[:, ::5] = r + 5
    if case == "extremes":
        view[0, :3] = [2**31 - 1, -2**31, -7]
        view[1, 1] = 2**31 - 1
        view[2] = -3 - g.integers(0, 4, N)
    b1_h = g.integers(-1, S - 1, B).astype(np.int32)
    if case == "full":
        b1_h[:] = S - 1
        b1_h[0] = S
    gcommit = np.maximum(b1_h - g.integers(0, 4, B), 0).astype(np.int32)
    clen = np.minimum(g.integers(0, S, (B, N)), gcommit[:, None] + 1)
    clen[:, ::3] = gcommit[:, None]
    chain_v = np.where(np.arange(S) <= b1_h[:, None],
                       np.arange(S) + r // 2, -1).astype(np.int32)
    v1 = g.integers(0, r + 3, B).astype(np.int32)
    return {"seed": np.arange(50, 50 + B, dtype=np.uint32),
            "b1_v": v1, "b1_h": b1_h, "b2_v": (v1 - 1).astype(np.int32),
            "b2_h": (b1_h - 1).astype(np.int32),
            "b3_v": (v1 - g.integers(2, 4, B)).astype(np.int32),
            "b3_h": (b1_h - 2).astype(np.int32), "gcommit": gcommit,
            "chain_v": chain_v, "chain_vid": np.zeros((B, S), np.int32),
            "fvec": np.zeros((B, N), np.int32),
            "ftab_v": np.full((B, 8), -1, np.int32),
            "ftab_h": np.full((B, 8), -1, np.int32),
            "fnum": np.zeros(B, np.int32), "view": view,
            "timer": g.integers(0, 6, (B, N)).astype(np.int32),
            "clen": clen.astype(np.int32), "down": np.zeros((B, N), bool)}


@pytest.mark.parametrize("case", ["spread", "full", "extremes"])
@pytest.mark.parametrize("kw", [
    {**BASE, "drop_rate": 0.3, "partition_rate": 0.5, "view_timeout": 3,
     "log_capacity": 12},
    {**CFGS["n301"], "drop_rate": 0.05, "view_timeout": 4,
     "log_capacity": 12}], ids=["n7", "n301"])
def test_one_round_from_random_states(kw, case):
    jcfg, cfg = JConfig(**kw), Config(**kw)
    g = np.random.default_rng(len(case) + kw["n_nodes"])
    B, N, S = 6, cfg.n_nodes, cfg.log_capacity
    seen = {"proposal": 0, "no_proposal": 0, "boundary": 0, "catch_up": 0}
    for r in (0, 7, 30):
        leaves = _random_leaves(g, B, N, S, r, case)
        st = convert.state_from_numpy(leaves)
        lane = st.lane.clone()
        view1, adv = hotstuff.hotstuff_propose_plain(
            cfg, st.seed, r, st.view, st.b1_h, lane)
        vstar = lane[:, hotstuff.VMAX]
        seen["catch_up"] += int(adv.sum())
        seen["proposal"] += int((vstar >= 0).sum())
        seen["no_proposal"] += int((vstar < 0).sum())
        seen["boundary"] += int(((view1 == vstar[:, None])
                                 & (vstar >= 0)[:, None]).sum())
        got = convert.state_to_numpy(hotstuff.hotstuff_round(cfg, st, r))
        want = _jax_round(jcfg)(jhs.HotstuffState(
            **{k: jnp.asarray(v) for k, v in leaves.items()}), jnp.int32(r))
        _assert_leaves(got, _leaves(want), (case, r))
    if case == "full":
        assert seen["proposal"] == 0
    else:
        assert seen["proposal"] > 0 and seen["boundary"] > 0
        assert seen["no_proposal"] > 0 or case == "spread"
        assert seen["catch_up"] > 0


def test_a_full_chain_or_churn_leaves_no_proposer():
    """L = 0 when nobody proposes: b1_h + 1 >= S, or the round's churn."""
    kw = {**BASE, "churn_rate": 1.0, "log_capacity": 12}
    cfg = Config(**kw)
    g = np.random.default_rng(3)
    leaves = _random_leaves(g, 4, 7, 12, 9, "spread")
    st = convert.state_from_numpy(leaves)
    lane = st.lane.clone()
    hotstuff.hotstuff_propose_plain(cfg, st.seed, 9, st.view, st.b1_h, lane)
    assert (lane[:, hotstuff.VMAX] == -1).all()
    got = convert.state_to_numpy(hotstuff.hotstuff_round(cfg, st, 9))
    want = _jax_round(JConfig(**kw))(jhs.HotstuffState(
        **{k: jnp.asarray(v) for k, v in leaves.items()}), jnp.int32(9))
    _assert_leaves(got, _leaves(want))
    full = _random_leaves(g, 4, 7, 12, 9, "full")
    lane = convert.state_from_numpy(full).lane
    hotstuff.hotstuff_propose_plain(
        Config(**{**BASE, "log_capacity": 12}), torch.from_numpy(full["seed"]),
        9, torch.from_numpy(full["view"]), torch.from_numpy(full["b1_h"]),
        lane)
    assert (lane[:, hotstuff.VMAX] == -1).all()


# --- KAG on forks -------------------------------------------------------------

def test_extract_matches_jax_on_a_fork_carry():
    """The plain extraction against ``_extract`` on an equivocating JAX
    carry whose fork table holds entries (fnum 1 and 6) and whose deceived
    nodes committed past them; the carry's committed JAX extraction too."""
    data = dict(np.load(FORK_CARRY))
    want_c, want_d = data.pop("jax_committed"), data.pop("jax_dval")
    assert (data["fnum"] > 0).all() and data["fvec"].any()
    st = convert.state_from_numpy(data)
    got = {k: v.numpy() for k, v in hotstuff.extract(st).items()}
    want = jhs._extract(jhs.HotstuffState(
        **{k: jnp.asarray(v) for k, v in data.items()}))
    _assert_leaves(got, {k: np.asarray(v) for k, v in want.items()})
    assert np.array_equal(got["committed"], want_c)
    assert np.array_equal(got["dval"], want_d)
    # The overlays change values: variant 6 where a deceived node holds a
    # fork height.
    base_c, base_d = hotstuff.hotstuff_extract_plain(
        st.seed, st.chain_v, st.chain_vid, st.clen, torch.zeros_like(st.fvec),
        st.ftab_v, st.ftab_h, st.fnum)
    assert torch.equal(base_c, torch.from_numpy(want_c))
    assert (base_d.numpy() != want_d).any()


# --- telemetry and the flight recorder ----------------------------------------

W = 6
TELEMETRY_CASES = {
    "lossy": {**CFGS["lossy"], "n_rounds": 20, "telemetry_window": W},
    # 40 rounds: the chain fills at about round 20, and timeouts follow.
    "n301": {**STEP_KW, "n_rounds": 40, "n_sweeps": 2,
             "telemetry_window": W},
}


@pytest.mark.parametrize("case", list(TELEMETRY_CASES))
def test_telemetry_matches_jax(case):
    kw = TELEMETRY_CASES[case]
    want_stats, got_stats = {}, {}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    want = jrunner.run(jcfg, jsim.engine_def(jcfg), stats=want_stats,
                       telemetry=True)
    got = runner.run(cfg, "cpu", telemetry=True, stats=got_stats)
    _assert_leaves(got, want)
    _assert_leaves(got_stats["telemetry"], want_stats["telemetry"])
    w, g = want_stats["flight"], got_stats["flight"]
    assert set(g) == set(w)
    for k in w:
        if isinstance(w[k], dict):
            _assert_leaves(g[k], w[k], k)
        else:
            assert g[k] == w[k], k
    tel = got_stats["telemetry"]
    assert tel["qc_formed"].sum() > 0
    if case == "n301":
        assert tel["view_changes"].sum() > 0
    assert tel["view_spread_max"].sum() > 0
    assert tel["sync_msgs_delivered"].sum() > 0


@pytest.mark.parametrize("recorder", [False, True])
def test_one_round_telemetry_from_random_states(recorder):
    """KAF's tail against the JAX round's counter vector and histograms on
    random states (views apart and at int32's ends: the spread wraps)."""
    kw = {**BASE, "drop_rate": 0.3, "partition_rate": 0.5, "view_timeout": 3,
          "log_capacity": 12, "telemetry_window": W}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    g = np.random.default_rng(9)
    B, K = 6, len(hotstuff.HOTSTUFF_TELEMETRY)
    for r, case in ((4, "spread"), (13, "extremes"), (20, "full")):
        leaves = _random_leaves(g, B, 7, 12, r, case)
        t = torch.from_numpy(g.integers(0, 9, (B, K)).astype(np.int32))
        w = torch.from_numpy(g.integers(0, 9, (B, 5, K)).astype(np.int32))
        lat = torch.from_numpy(g.integers(0, 9, (B, 2, 16)).astype(np.int32))
        t0, w0, lat0 = t.clone(), w.clone(), lat.clone()
        flight = (w, lat) if recorder else None
        hotstuff.hotstuff_round(cfg, convert.state_from_numpy(leaves), r,
                                telem=t, flight=flight)
        _, vec, hist = _jax_round(jcfg, telem=True)(jhs.HotstuffState(
            **{k: jnp.asarray(v) for k, v in leaves.items()}), jnp.int32(r))
        vec, hist = np.asarray(vec), np.asarray(hist)
        assert np.array_equal(t.numpy(), t0.numpy() + vec)
        if recorder:
            w0[:, r // W] += torch.from_numpy(vec)
            assert torch.equal(w, w0)
            assert np.array_equal(lat.numpy(), lat0.numpy() + hist)
        else:
            assert torch.equal(w, w0) and torch.equal(lat, lat0)


# --- chip_smoke.py's anchors ---------------------------------------------------

def _smoke(name: str):
    """The constant ``name`` of the repo's chip_smoke.py, read by
    importing the script without running it."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return getattr(smoke, name)


def test_hostile_hotstuff_anchor_is_jax():
    """The anchor chip_smoke.py holds the hostile HotStuff run to is the
    JAX package's and the oracle's digest at its knobs; its chain fills."""
    kw = _smoke("HOTSTUFF_HOSTILE")
    jcfg = JConfig(**kw)
    res = run_cached(jcfg)
    assert res.digest == _smoke("HOTSTUFF_HOSTILE_DIGEST")
    assert run_cached(dataclasses.replace(jcfg, engine="cpu")).digest == \
        res.digest
    out = jrunner.run(jcfg, jsim.engine_def(jcfg))
    assert (out["chain_v"] >= 0).all()
