"""The port's dense PBFT engine and f-ladder against the JAX package, on the
CPU.

``Config(protocol="pbft")`` selects the dense SPEC §6 engine
(``consensus_tpu_torch/engines/pbft.py``), and ``engines/pbft_sweep.py``
runs an f-ladder as one run whose lanes carry their own population and
tolerance. The same inputs, made from seeds with numpy, go through
``consensus_tpu`` and through the port's plain versions; everything must
be equal, tolerance 0: whole standalone runs (digest, views, committed
flags, decided values where committed), one round from a converted JAX
carry, one round from random states (standalone and padded, per lane),
P1's statistic against ``_vth_select`` (and the order-statistic walk that
kernel KQ does instead of the binary search), the ladder rung by rung,
the committed oracle digests of ``benchmarks/RESULTS.json``, and the
ladder's rejections.
"""
import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.engines import pbft as jpbft  # noqa: E402
from consensus_tpu.engines import pbft_sweep as jsweep  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.core import serialize  # noqa: E402
from consensus_tpu_torch.engines import pbft as tpbft  # noqa: E402
from consensus_tpu_torch.engines import pbft_bcast as tpbft_bcast  # noqa: E402
from consensus_tpu_torch.engines import pbft_sweep as tsweep  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402

# tests/test_pbft_sweep.py's BASE knobs: views diverge, catch-ups fire.
HOSTILE = dict(protocol="pbft", n_rounds=24, log_capacity=8, seed=7,
               drop_rate=0.15, partition_rate=0.05, churn_rate=0.05)
# benchmarks/run_benchmarks.py ADV and the oracle rows' shape.
ADV = dict(protocol="pbft", n_rounds=32, log_capacity=32, seed=3,
           drop_rate=0.01, churn_rate=0.001)
RESULTS = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / \
    "RESULTS.json"


def pbft_kw(f, base=HOSTILE, **kw):
    return {**base, "f": f, "n_nodes": 3 * f + 1, **kw}


def standalone_lanes(cfg):
    """(n_real, f) of every lane of a standalone run on the CPU."""
    lanes = runner.device_lanes(cfg, None, "cpu")
    return lanes["n_real"], lanes["f"]


def _committed_equal(got, want):
    """committed, and dval where committed (elsewhere it is scratch the
    serializer never reads), as tests/test_pbft_sweep.py compares."""
    assert np.array_equal(got["committed"], want["committed"])
    c = np.asarray(want["committed"]).astype(bool)
    assert np.array_equal(np.asarray(got["dval"])[c].astype(np.uint32),
                          np.asarray(want["dval"])[c].astype(np.uint32))


# --- whole standalone runs ----------------------------------------------------

@pytest.mark.parametrize("kw", [
    pbft_kw(1, n_sweeps=2), pbft_kw(2, n_sweeps=2), pbft_kw(4),
    pbft_kw(8, ADV, n_rounds=24, n_sweeps=2)],
    ids=["f1-hostile", "f2-hostile", "f4-hostile", "f8-adv"])
def test_whole_run_matches_jax(kw):
    jcfg, cfg = JConfig(**kw), Config(**kw)
    assert jsim.engine_def(jcfg).name == simulator.engine_def(cfg).name
    want = jrunner.run(jcfg, jsim.engine_def(jcfg))
    got = runner.run(cfg, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
    assert np.array_equal(got["view"], want["view"])
    _committed_equal(got, want)
    assert simulator.decided_payload(cfg, got)[3] == \
        jsim.decided_payload(jcfg, want)[3]
    assert want["committed"].any()
    res = simulator.run(cfg, device="cpu")
    assert res.digest == jsim.run(jcfg, warmup=False).digest
    assert res.node_round_steps == kw.get("n_sweeps", 1) * \
        kw["n_nodes"] * kw["n_rounds"]


def _oracle_rows() -> dict:
    rows = json.loads(RESULTS.read_text())["rows"]
    return {r["name"]: r for r in rows}


@pytest.mark.parametrize("f", [1, 8, 32])
def test_standalone_digest_equals_the_oracle_row(f):
    """pbft-f<f> of benchmarks/RESULTS.json: the C++ oracle's digest of
    the standalone dense run at seed 3, 32 rounds, 32 slots."""
    row = _oracle_rows()[f"pbft-f{f}"]["oracle"]
    cfg = Config(**pbft_kw(f, ADV))
    for k in ("n_rounds", "log_capacity", "seed", "drop_rate", "churn_rate",
              "n_nodes", "f", "n_sweeps"):
        assert row["config"][k] == getattr(cfg, k), k
    assert simulator.run(cfg, device="cpu").digest == row["digest"]


# --- one round from a converted JAX carry -------------------------------------

STEP_KW = pbft_kw(2, n_sweeps=3, n_rounds=30)
STEPS = (3, 11, 20)


def _jax_round(jcfg, padded=False):
    if padded:
        fn = functools.partial(jsweep.pbft_round_padded, jcfg)
        return jax.jit(jax.vmap(fn, in_axes=(0, None, 0, 0)))
    fn = functools.partial(jpbft.pbft_round, jcfg)
    return jax.jit(jax.vmap(fn, in_axes=(0, None)))


def _leaves(st) -> dict:
    return {k: np.array(v) for k, v in st._asdict().items()}


@pytest.fixture(scope="module")
def jax_steps():
    """{k: (leaves before round k, leaves after it)} from JAX."""
    jcfg = JConfig(**STEP_KW)
    step = _jax_round(jcfg)
    st = jax.vmap(lambda s: jpbft.pbft_init(jcfg, s))(
        jnp.asarray(jrunner.make_seeds(jcfg)))
    out = {}
    for r in range(max(STEPS) + 1):
        before = _leaves(st)
        st = step(st, jnp.int32(r))
        if r in STEPS:
            out[r] = (before, _leaves(st))
    return out


@pytest.mark.parametrize("k", STEPS)
def test_one_round_from_jax_state(jax_steps, k):
    before, after = jax_steps[k]
    st = convert.state_from_numpy(before)
    assert isinstance(st, tpbft.PbftState)
    cfg = Config(**STEP_KW)
    got = convert.state_to_numpy(tpbft.pbft_round(cfg, st, k,
                                                  *standalone_lanes(cfg)))
    assert set(got) == set(after)
    for name in after:
        assert got[name].dtype == after[name].dtype, name
        assert np.array_equal(got[name], after[name]), name


def test_pbft_carry_roundtrip_keeps_every_dtype(jax_steps):
    before, _ = jax_steps[STEPS[0]]
    st = convert.state_from_numpy(before)
    assert st.seed.dtype == torch.uint32 and st.pp_seen.dtype == torch.bool
    assert st.dval.dtype == torch.int32 and st.pp_seen.shape == (3, 7, 8)
    back = convert.state_to_numpy(st)
    for name, a in before.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a)
    with pytest.raises(TypeError):
        convert.state_from_numpy(
            {**before, "committed": before["committed"].astype(np.int32)})


# --- one round from random states: each phase's leaves ------------------------

# The leaves each kernel writes last in a round: KQ's view and pre-prepare
# state, KR's prepared flags, KS's committed flags, decided values and
# timers. Held against the JAX round's output leaves.
PHASE_LEAVES = {"pbft_view_preprepare": ("view", "pp_seen", "pp_view",
                                         "pp_val"),
                "pbft_tally": ("prepared",),
                "pbft_decide": ("committed", "dval", "timer")}


def random_state(g, B, N, S, view_hi=6):
    """A batched PbftState as numpy leaves, over small alphabets: views
    and values collide, seen slots were pre-prepared in an older view,
    prepared and committed slots lie among the seen ones, so that
    re-proposals meet prepared slots of the same and of another value."""
    view = g.integers(0, view_hi, (B, N)).astype(np.int32)
    pp_seen = g.random((B, N, S)) < 0.6
    pp_view = np.minimum(g.integers(0, view_hi, (B, N, S)),
                         view[:, :, None]).astype(np.int32)
    pp_val = g.integers(0, 3, (B, N, S)).astype(np.int32)
    prepared = pp_seen & (g.random((B, N, S)) < 0.5)
    committed = prepared & (g.random((B, N, S)) < 0.4)
    return {"seed": np.arange(100, 100 + B, dtype=np.uint32), "view": view,
            "timer": g.integers(0, 10, (B, N)).astype(np.int32),
            "pp_seen": pp_seen, "pp_view": np.where(pp_seen, pp_view, 0)
            .astype(np.int32), "pp_val": pp_val, "prepared": prepared,
            "committed": committed,
            "dval": np.where(committed, pp_val, g.integers(0, 3, (B, N, S)))
            .astype(np.int32),
            "down": np.zeros((B, N), bool)}


@pytest.fixture(scope="module")
def random_rounds():
    """[(cfg kw, lanes or None, leaves before, JAX leaves after)]: the
    standalone round at f = 2 and the padded round of a [1, 2, 3] ladder
    with per-lane (n_real, f), from random states, at several rounds."""
    g = np.random.default_rng(5)
    cases = []
    kw = pbft_kw(2, n_sweeps=8, view_timeout=4, drop_rate=0.3,
                 partition_rate=0.3)
    jcfg = JConfig(**kw)
    step = _jax_round(jcfg)
    for r in (2, 9, 17):
        before = random_state(g, 8, 7, 8)
        after = step(jpbft.PbftState(**{k: jnp.asarray(v) for k, v in
                                        before.items()}), jnp.int32(r))
        cases.append((kw, r, None, before, _leaves(after)))
    fs = [1, 2, 3]
    kw_pad = pbft_kw(3, view_timeout=4, drop_rate=0.3, partition_rate=0.3)
    jcfg = JConfig(**kw_pad)
    step = _jax_round(jcfg, padded=True)
    n_real = np.repeat([3 * f + 1 for f in fs], 3).astype(np.int32)
    f_lanes = np.repeat(fs, 3).astype(np.int32)
    for r in (4, 13):
        before = random_state(g, 9, 10, 8)
        after = step(jpbft.PbftState(**{k: jnp.asarray(v) for k, v in
                                        before.items()}), jnp.int32(r),
                     jnp.asarray(n_real), jnp.asarray(f_lanes))
        cases.append((kw_pad, r, (n_real, f_lanes), before, _leaves(after)))
    return cases


def _lanes(cfg, lanes):
    """The round's (n_real, f): the ladder's given ones, or standalone."""
    if lanes is None:
        return standalone_lanes(cfg)
    return tuple(torch.from_numpy(a) for a in lanes)


def _port_round(kw, r, lanes, before):
    cfg = Config(**kw)
    st = convert.state_from_numpy(before)
    return convert.state_to_numpy(tpbft.pbft_round(cfg, st, r,
                                                   *_lanes(cfg, lanes)))


@pytest.mark.parametrize("name", list(PHASE_LEAVES))
def test_phase_leaves_from_random_states_match_jax(random_rounds, name):
    fired = 0
    for kw, r, lanes, before, want in random_rounds:
        got = _port_round(kw, r, lanes, before)
        for leaf in PHASE_LEAVES[name]:
            assert got[leaf].dtype == want[leaf].dtype, leaf
            assert np.array_equal(got[leaf], want[leaf]), (leaf, r)
            fired += int((got[leaf] != before[leaf]).sum())
    assert fired > 0


def test_random_states_reach_the_rare_paths(random_rounds):
    """The random rounds hold catch-ups (a view moved past the churn step
    with the timer short of its timeout), re-proposals refused for a
    prepared slot of another value (the same P3 with nothing prepared
    accepts more), and adoptions (slots committed without a prepare)."""
    refused = adopted = caught = 0
    for kw, r, lanes, before, want in random_rounds:
        cfg = Config(**kw)
        st = convert.state_from_numpy(before)
        n_real, f = _lanes(cfg, lanes)
        deliver = tpbft.delivery(st.seed, r, cfg.n_nodes, cfg.drop_cutoff,
                                 cfg.partition_cutoff)
        ch = tpbft.churn(st.seed, r, cfg.churn_cutoff)[:, None]
        args = (cfg, st.seed, r, deliver, n_real, f, st.view, st.timer,
                st.pp_seen, st.pp_view, st.pp_val)
        out = tpbft.pbft_view_preprepare_plain(*args, st.prepared,
                                               st.committed)
        free = tpbft.pbft_view_preprepare_plain(
            *args, torch.zeros_like(st.prepared), st.committed)
        timer0 = torch.where(ch, 0, st.timer)
        caught += int(((out[0] > st.view + ch.to(torch.int32))
                       & (timer0 < cfg.view_timeout)).sum())
        refused += int((free[5] != out[5]).sum())
        adopted += int((want["committed"] & ~before["committed"]
                        & ~want["prepared"]).sum())
    assert caught > 0 and refused > 0 and adopted > 0


# --- P1's statistic ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vth_select_matches_jax(seed):
    g = np.random.default_rng(seed)
    B, N, vmax = 5, 13, 20
    w = g.integers(-1, vmax + 1, (B, N, N)).astype(np.int32)
    w[0] = -1                                   # nothing delivered
    w[1, :, :3] = vmax                          # at the top of the range
    f = g.integers(0, N, B).astype(np.int32)
    f[2] = N - 1                                # the column's minimum
    got = tpbft.vth_select_plain(torch.from_numpy(w), torch.from_numpy(f),
                                 vmax).numpy()
    for b in range(B):
        want = np.asarray(jpbft._vth_select(jnp.asarray(w[b]), int(f[b]),
                                            vmax))
        assert np.array_equal(got[b], want), b


def _walk(views, counted, need, vmax):
    """Kernel KQ's P1 for one receiver, in numpy: the senders in order of
    their views (descending, ties by id), the need-th that counts gives
    the statistic, clamped to [-1, vmax]; -1 when fewer count, vmax when
    need <= 0."""
    if need <= 0:
        return vmax
    order = sorted(range(len(views)), key=lambda i: (-int(views[i]), i))
    count = 0
    for i in order:
        count += bool(counted[i])
        if counted[i] and count == need:
            return min(max(int(views[i]), -1), vmax)
    return -1


@pytest.mark.parametrize("seed", [3, 4])
def test_kernel_order_walk_equals_vth_select(seed):
    """KQ finds P1's statistic by walking the senders in view order until
    f + 1 count, where the JAX round binary-searches the value range: on
    random views (some past the range's top) and delivery, with every f
    from 0 to N, the two agree."""
    g = np.random.default_rng(seed)
    N, vmax = 11, 9
    for _ in range(40):
        views = g.integers(0, vmax + 4, N).astype(np.int32)
        deliver = g.random((N, N)) < g.random()
        for f in range(N + 1):
            w = np.where(deliver, views[:, None], -1)
            np.fill_diagonal(w, views)
            want = np.asarray(jpbft._vth_select(jnp.asarray(w), f, vmax))
            for j in range(N):
                counted = deliver[:, j].copy()
                counted[j] = True
                assert _walk(views, counted, f + 1, vmax) == want[j]


# --- the f-ladder -------------------------------------------------------------

FS = [1, 2, 4]


@pytest.mark.parametrize("n_sweeps", [1, 2])
def test_ladder_matches_jax_rung_by_rung(n_sweeps):
    kw = pbft_kw(1, n_sweeps=n_sweeps)
    want = jsweep.pbft_fsweep_run(JConfig(**kw), FS)
    got = tsweep.pbft_fsweep_run(Config(**kw), FS, device="cpu")
    assert len(got) == len(want)
    for g_, w in zip(got, want):
        for k in ("committed", "dval", "view"):
            assert g_[k].shape == w[k].shape and g_[k].dtype == w[k].dtype
        assert np.array_equal(g_["view"], w["view"])
        _committed_equal(g_, w)
    assert tsweep.fsweep_payload(got) == jsweep.fsweep_payload(want)
    assert serialize.digest(tsweep.fsweep_payload(got)) == \
        serialize.digest(jsweep.fsweep_payload(want))
    assert all(w["committed"].any() for w in want)


def test_ladder_rung_equals_its_standalone_run():
    got = tsweep.pbft_fsweep_run(Config(**pbft_kw(1, n_sweeps=2)), FS,
                                 device="cpu")
    for k, f in enumerate(FS):
        cfg = Config(**pbft_kw(f, n_sweeps=2, seed=HOSTILE["seed"] + k))
        alone = runner.run(cfg, device="cpu")
        assert np.array_equal(got[k]["view"], alone["view"])
        _committed_equal(got[k], alone)
        assert tsweep.rung_payloads(got)[k] == \
            simulator.decided_payload(cfg, alone)[3]


def test_ladder_lanes_match_jax_layout():
    cfg = Config(**pbft_kw(1, n_sweeps=3, seed=2**32 - 2))
    fs, cfg_pad = tsweep._fsweep_static(cfg, [2, 1, 5])
    _, jpad, _ = jsweep._fsweep_static(JConfig(**pbft_kw(1, n_sweeps=3)),
                                       [2, 1, 5])
    assert (cfg_pad.n_nodes, cfg_pad.f, cfg_pad.n_sweeps) == \
        (jpad.n_nodes, jpad.f, jpad.n_sweeps) == (16, 5, 9)
    lanes = runner.lane_inputs(cfg_pad, fs)
    assert lanes["seed"].dtype == np.uint32
    assert list(lanes["seed"]) == [(2**32 - 2 + k + j) % 2**32
                                   for k in range(3) for j in range(3)]
    assert list(lanes["n_real"]) == [7] * 3 + [4] * 3 + [16] * 3
    assert list(lanes["f"]) == [2] * 3 + [1] * 3 + [5] * 3


@pytest.mark.parametrize("fs", [[], [0], [2, -1, 3]])
def test_fsweep_static_rejections_match_jax(fs):
    kw = pbft_kw(1)
    with pytest.raises(ValueError) as want:
        jsweep._fsweep_static(JConfig(**kw), fs)
    with pytest.raises(ValueError) as got:
        tsweep._fsweep_static(Config(**kw), fs)
    assert str(got.value) == str(want.value)


def test_bcast_ladder_static_gives_jax_m_cap():
    """A §6b ladder is accepted, and the tallies' table width of its
    padded config and rungs is JAX's m_cap: the widest rung's (2 with
    f = 1 among the rungs, else 1)."""
    for fs in ([1, 2, 4], [2, 4], [8333, 16666, 33333]):
        kw = pbft_kw(1, fault_model="bcast")
        got = tsweep._fsweep_static(Config(**kw), fs)
        want = jsweep._fsweep_static(JConfig(**kw), fs)
        assert tpbft_bcast.table_cap(got[1], got[0]) == want[2] == \
            (2 if 1 in fs else 1)
        assert (got[1].n_nodes, got[1].f, got[1].fault_model) == \
            (want[1].n_nodes, want[1].f, "bcast")


def test_ladder_timed_counts_real_steps():
    kw = pbft_kw(1, n_sweeps=2, n_rounds=6)
    out, compile_s, best, steps = tsweep.pbft_fsweep_timed(
        Config(**kw), FS, repeats=2, device="cpu")
    assert steps == (4 + 7 + 13) * 6 * 2
    assert compile_s > 0 and best > 0
    assert tsweep.fsweep_payload(out) == tsweep.fsweep_payload(
        tsweep.pbft_fsweep_run(Config(**kw), FS, device="cpu"))


# --- the wrappers on the CPU and off it ---------------------------------------

WRAPPERS = ("pbft_view_preprepare", "pbft_tally", "pbft_decide")


@pytest.fixture(scope="module")
def wrapper_args():
    """{name: the arguments wrapper ``name`` got in round 9 of a padded
    [1, 2, 4] ladder}, recorded by a stand-in in the round's module."""
    cfg = tsweep._fsweep_static(Config(**pbft_kw(1)), FS)[1]
    lanes = runner.device_lanes(cfg, FS, "cpu")
    st = runner.advance(cfg, tpbft.pbft_init(cfg, lanes.pop("seed")), 0, 9,
                        lanes=lanes)
    out, originals = {}, {n: getattr(tpbft, n) for n in WRAPPERS}

    def recorder(name):
        def record(*args):
            out[name] = tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args)
            return originals[name](*args)
        record.launches = 0
        return record
    try:
        for name in WRAPPERS:
            setattr(tpbft, name, recorder(name))
        tpbft.pbft_round(cfg, st, 9, **lanes)
    finally:
        for name, fn in originals.items():
            setattr(tpbft, name, fn)
    return out


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_on_cpu_equals_plain_and_writes_no_input(wrapper_args, name):
    args = wrapper_args[name]
    ka = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
    got = getattr(tpbft, name)(*ka)
    want = getattr(tpbft, name + "_plain")(*args)
    for g_, w in zip(got, want):
        assert g_.dtype == w.dtype and torch.equal(g_, w)
    for k, a in zip(ka, args):
        if isinstance(a, torch.Tensor):
            assert torch.equal(k, a)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_off_the_cpu_raises(wrapper_args, name):
    args = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in wrapper_args[name])
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tpbft, name)(*args)


def test_round_calls_each_wrapper_once(monkeypatch):
    cfg = Config(**pbft_kw(1, n_rounds=5))
    calls = dict.fromkeys(("delivery",) + WRAPPERS, 0)

    def counting(name):
        fn = getattr(tpbft, name)

        def call(*args):
            calls[name] += 1
            return fn(*args)
        monkeypatch.setattr(tpbft, name, call)
    for name in calls:
        counting(name)
    runner.run(cfg, device="cpu")
    assert calls == dict.fromkeys(calls, cfg.n_rounds)


def test_engine_record_and_names_match_jax():
    kw = pbft_kw(1)
    assert simulator.engine_def(Config(**kw)) is runner.PBFT
    assert runner.PBFT.name == tpbft.NAME == \
        jsim.engine_def(JConfig(**kw)).name
    assert tpbft.PbftState._fields == jpbft.PbftState._fields
    st = runner.init(Config(**kw), runner.make_seeds(Config(**kw)), "cpu")
    jst = jpbft.pbft_init(JConfig(**kw), 0)
    for name in st._fields[1:]:
        a, b = getattr(st, name), np.asarray(getattr(jst, name))
        assert a.shape[1:] == b.shape and not a.any(), name
        assert convert.state_to_numpy(st)[name].dtype == b.dtype, name
    assert set(tpbft.extract(st)) == set(jpbft._pbft_extract(jst))
    assert dataclasses.replace(Config(**kw), max_active=2).max_active == 2


def test_pack_sparse_matches_jax():
    from consensus_tpu.core import serialize as jser
    g = np.random.default_rng(9)
    mask = g.random((3, 5, 7)) < 0.4
    vals = g.integers(-2**31, 2**31, (3, 5, 7)).astype(np.int32)
    for a, b in zip(serialize.pack_sparse(mask, vals),
                    jser.pack_sparse(mask, vals)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
