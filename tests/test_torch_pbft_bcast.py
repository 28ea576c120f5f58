"""The port's SPEC §6b broadcast PBFT engine and its f-ladder against the JAX
package, on the CPU.

``Config(protocol="pbft", fault_model="bcast")`` selects
``consensus_tpu_torch/engines/pbft_bcast.py``, and ``engines/pbft_sweep.py``
runs a bcast f-ladder through the same round with per-lane (n_real, f).
The same inputs, made from seeds with numpy, go through ``consensus_tpu``
and through the port's plain versions; everything must be equal,
tolerance 0: whole runs (digest, views, committed flags, decided values
where committed) with and without partitions at f = 0, 1, 2 and 5; one
round from a converted JAX carry and from random states (views past the
search range among them), every leaf; P1's statistic against
``_kth_largest``; the tallies' decisions against ``_aggregate_tallies``;
the ladder rung by rung against JAX and against standalone runs;
``chip_smoke.py``'s bcast ladder anchors against the JAX package's
ladders; one round at the pbft-100k-bcast knobs with N = 1 999.

Kernels KT, KU and KV compute what the plain versions compute in another
way (a per-side histogram for P1, Misra-Gries candidates and an exact
recount for P4-P5, per-tile deciders found by warp ballots for P6); numpy
models of those algorithms are held against the plain versions here on
adversarial inputs, tolerance 0: the only check of the kernels' logic
before the card.
"""
import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.core import serialize as jserialize  # noqa: E402
from consensus_tpu.engines import pbft as jpbft  # noqa: E402
from consensus_tpu.engines import pbft_bcast as jbcast  # noqa: E402
from consensus_tpu.engines import pbft_sweep as jsweep  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.core import serialize  # noqa: E402
from consensus_tpu_torch.engines import pbft as tpbft  # noqa: E402
from consensus_tpu_torch.engines import pbft_bcast as tb  # noqa: E402
from consensus_tpu_torch.engines import pbft_sweep as tsweep  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402

# tests/test_pbft_sweep.py's BASE knobs, S = 8.
HOSTILE = dict(protocol="pbft", fault_model="bcast", n_rounds=24,
               log_capacity=8, seed=7, drop_rate=0.15, partition_rate=0.05,
               churn_rate=0.05)
# benchmarks/run_benchmarks.py's pbft-100k-bcast knobs.
FLAGSHIP = dict(protocol="pbft", fault_model="bcast", n_rounds=64,
                n_sweeps=8, log_capacity=16, seed=7, drop_rate=0.01,
                churn_rate=0.001)
WRAPPERS = ("bcast_view_preprepare", "bcast_tally", "bcast_decide")


def bcast_kw(f, base=HOSTILE, **kw):
    return {**base, "f": f, "n_nodes": 3 * f + 1, **kw}


def _committed_equal(got, want):
    """committed, and dval where committed (elsewhere it is scratch the
    serializer never reads)."""
    assert np.array_equal(got["committed"], want["committed"])
    c = np.asarray(want["committed"]).astype(bool)
    assert np.array_equal(np.asarray(got["dval"])[c], np.asarray(want["dval"])[c])


def _leaves(st) -> dict:
    return {k: np.array(v) for k, v in st._asdict().items()}


def _port_round(kw, r, before, lanes=None, m=None):
    """One round of the port's plain path from numpy leaves: standalone
    (``lanes`` None) or with the given per-lane (n_real, f)."""
    cfg = Config(**kw)
    st = convert.state_from_numpy(before)
    if lanes is None:
        ln = runner.device_lanes(cfg, None, "cpu")
        n_real, f = ln["n_real"], ln["f"]
    else:
        n_real, f = (torch.from_numpy(a) for a in lanes)
    m = tb.table_cap(cfg) if m is None else m
    return convert.state_to_numpy(tb.pbft_bcast_round(cfg, st, r, n_real, f,
                                                      m))


def _jax_round(jcfg, padded=False, m_cap=None):
    if padded:
        fn = functools.partial(jsweep.pbft_bcast_round_padded, jcfg,
                               m_cap=m_cap)
        return jax.jit(jax.vmap(lambda s, r, n, f: fn(s, r, n, f),
                                in_axes=(0, None, 0, 0)))
    fn = functools.partial(jbcast.pbft_bcast_round, jcfg)
    return jax.jit(jax.vmap(fn, in_axes=(0, None)))


# --- whole runs ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    bcast_kw(0, n_sweeps=3, n_rounds=16),
    bcast_kw(1, n_sweeps=2),
    bcast_kw(1, n_sweeps=2, partition_rate=0.0),
    bcast_kw(2, n_sweeps=4, n_rounds=20, partition_rate=0.3,
             drop_rate=0.3, view_timeout=4),
    bcast_kw(5, n_sweeps=2, partition_rate=0.0, n_rounds=12, churn_rate=0.2),
    bcast_kw(5, n_sweeps=3, n_rounds=8, seed=2**32 - 2),
], ids=["f0", "f1-part", "f1-nopart", "f2-hostile", "f5-nopart", "f5-wrap"])
def test_whole_run_matches_jax(kw):
    jcfg, cfg = JConfig(**kw), Config(**kw)
    assert jsim.engine_def(jcfg).name == simulator.engine_def(cfg).name == \
        "pbft-bcast"
    want = jrunner.run(jcfg, jsim.engine_def(jcfg))
    got = runner.run(cfg, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert want["committed"].any()
    res = simulator.run(cfg, device="cpu")
    assert res.digest == jsim.run(jcfg, warmup=False).digest
    assert res.node_round_steps == kw["n_sweeps"] * kw["n_nodes"] * \
        kw["n_rounds"]


# --- one round from a converted JAX carry -------------------------------------

STEP_KW = bcast_kw(2, n_sweeps=3, n_rounds=30, partition_rate=0.2,
                   drop_rate=0.2)
STEPS = (3, 11, 20)


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
    got = _port_round(STEP_KW, k, before)
    assert set(got) == set(after)
    for name in after:
        assert got[name].dtype == after[name].dtype, name
        assert np.array_equal(got[name], after[name]), name


def test_bcast_carry_converts(jax_steps):
    before, _ = jax_steps[STEPS[-1]]
    st = convert.state_from_numpy(before)
    assert isinstance(st, tpbft.PbftState) and st.pp_seen.shape == (3, 7, 8)
    back = convert.state_to_numpy(st)
    for name, a in before.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a)


def test_flagship_knobs_round_at_2k_nodes():
    """pbft-100k-bcast's knobs (8 sweeps, S = 16, drop 0.01, churn 0.001)
    at f = 666, N = 1 999: round 9 from JAX's carry, every leaf."""
    kw = bcast_kw(666, FLAGSHIP)
    jcfg = JConfig(**kw)
    step = _jax_round(jcfg)
    st = jax.vmap(lambda s: jpbft.pbft_init(jcfg, s))(
        jnp.asarray(jrunner.make_seeds(jcfg)))
    for r in range(9):
        st = step(st, jnp.int32(r))
    before = _leaves(st)
    after = _leaves(step(st, jnp.int32(9)))
    got = _port_round(kw, 9, before)
    for name in after:
        assert np.array_equal(got[name], after[name]), name
    assert after["committed"].any()


# --- one round from random states ---------------------------------------------

def random_state(g, B, N, S, vmax, val_hi=3):
    """A batched PbftState as numpy leaves over small alphabets: views in
    [-2, vmax + 8] (past the P1 search's top, and below 0), values that
    collide, seen slots pre-prepared in an older view, prepared and
    committed slots among the seen ones and off them."""
    view = g.integers(-2, vmax + 9, (B, N)).astype(np.int32)
    view[:, : N // 2] = g.integers(0, 4, (B, N // 2))
    pp_seen = g.random((B, N, S)) < 0.6
    pp_view = np.minimum(g.integers(-1, vmax, (B, N, S)), view[:, :, None])
    pp_val = g.integers(0, val_hi, (B, N, S)).astype(np.int32)
    prepared = (pp_seen | (g.random((B, N, S)) < 0.05)) & \
        (g.random((B, N, S)) < 0.5)
    committed = prepared & (g.random((B, N, S)) < 0.4)
    return {"seed": np.arange(100, 100 + B, dtype=np.uint32), "view": view,
            "timer": g.integers(0, 10, (B, N)).astype(np.int32),
            "pp_seen": pp_seen,
            "pp_view": np.where(pp_seen, pp_view, 0).astype(np.int32),
            "pp_val": pp_val, "prepared": prepared, "committed": committed,
            "dval": np.where(committed, pp_val,
                             g.integers(0, val_hi, (B, N, S))).astype(np.int32),
            "down": np.zeros((B, N), bool)}


@pytest.fixture(scope="module")
def random_rounds():
    """[(cfg kw, r, lanes or None, m, leaves before, JAX leaves after)]:
    standalone rounds at f = 0, 1 and 2 and padded rounds of a [1, 2, 3]
    ladder, from random states."""
    g = np.random.default_rng(5)
    cases = []
    for f, B in ((0, 4), (1, 6), (2, 8)):
        kw = bcast_kw(f, n_sweeps=B, n_rounds=4, view_timeout=4,
                      drop_rate=0.3, partition_rate=0.4)
        jcfg = JConfig(**kw)
        step = _jax_round(jcfg)
        vmax = tb.view_bound(Config(**kw))
        for r in (2, 9, 17):
            before = random_state(g, B, 3 * f + 1, 8, vmax)
            after = step(jpbft.PbftState(**{k: jnp.asarray(v) for k, v in
                                            before.items()}), jnp.int32(r))
            cases.append((kw, r, None, None, before, _leaves(after)))
    fs = [1, 2, 3]
    kw_pad = bcast_kw(3, n_rounds=4, view_timeout=4, drop_rate=0.3,
                      partition_rate=0.4)
    cfg_pad, m_cap = jsweep._fsweep_static(JConfig(**kw_pad), fs)[1:]
    step = _jax_round(cfg_pad, padded=True, m_cap=m_cap)
    n_real = np.repeat([3 * f + 1 for f in fs], 3).astype(np.int32)
    f_lanes = np.repeat(fs, 3).astype(np.int32)
    for r in (4, 13):
        before = random_state(g, 9, 10, 8, tb.view_bound(Config(**kw_pad)))
        after = step(jpbft.PbftState(**{k: jnp.asarray(v) for k, v in
                                        before.items()}), jnp.int32(r),
                     jnp.asarray(n_real), jnp.asarray(f_lanes))
        cases.append((kw_pad, r, (n_real, f_lanes), m_cap, before,
                      _leaves(after)))
    return cases


def test_random_rounds_match_jax_every_leaf(random_rounds):
    moved = dict.fromkeys(("view", "pp_seen", "prepared", "committed",
                           "dval", "timer"), 0)
    for kw, r, lanes, m, before, want in random_rounds:
        got = _port_round(kw, r, before, lanes, m)
        for leaf in want:
            assert got[leaf].dtype == want[leaf].dtype, leaf
            assert np.array_equal(got[leaf], want[leaf]), (leaf, kw["f"], r)
        for leaf in moved:
            moved[leaf] += int((want[leaf] != before[leaf]).sum())
    assert all(moved.values()), moved


# --- P1's statistic -------------------------------------------------------------

def histogram_kth(w1: np.ndarray, k: int, vmax: int) -> int:
    """Kernel KT's P1 rule for one row: a histogram of the entries (w1 =
    view + 1) clamped into bins 1..vmax+1 (entries <= 0 in none), then
    down from the top bin until the suffix count reaches k: the bin less
    one, -1 when it never does (vmax when k <= 0)."""
    hist = np.zeros(vmax + 2, np.int64)
    for x in w1:
        if x >= 1:
            hist[min(int(x), vmax + 1)] += 1
    acc = 0
    for t in range(vmax + 1, 0, -1):
        acc += int(hist[t])
        if acc >= k:
            return t - 1
    return -1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kth_largest_matches_jax_and_the_histogram(seed):
    g = np.random.default_rng(seed)
    vmax = int(g.integers(3, 20))
    C, N = 12, 17
    w1 = g.integers(-3, vmax + 6, (C, N)).astype(np.int32)
    w1[0] = 0                                   # nothing but pads
    w1[1, :5] = vmax + 1                        # at the top of the range
    w1[2] = vmax + 4                            # every entry past the top
    ks = g.integers(0, N + 2, C).astype(np.int32)
    ks[3], ks[4] = 0, N
    got = tb.kth_largest_plain(torch.from_numpy(w1), torch.from_numpy(ks),
                               vmax).numpy()
    want = np.asarray(jbcast._kth_largest(jnp.asarray(w1), jnp.asarray(ks),
                                          vmax))
    assert np.array_equal(got, want)
    for c in range(C):
        assert histogram_kth(w1[c], int(ks[c]), vmax) == got[c], c


# --- P4-P5: the plain tallies and kernel KU's algorithm -------------------------

def tally_inputs(g, B, N, S, hot=2):
    """Tally inputs where quorums are close: each (lane, slot) column takes
    one of ``hot`` values for most nodes, and some columns sit at exactly
    the threshold or one short of it. Returns numpy arrays (pp_val,
    pp_seen, prepared, committed, honest, bcast, side, f)."""
    f = g.integers(0, (N - 1) // 3 + 1, B).astype(np.int32)
    n_real = 3 * f + 1
    pp_val = g.integers(0, hot, (B, N, S)).astype(np.int32)
    pp_val[:, :, 0] = 5                          # one value everywhere
    pp_seen = g.random((B, N, S)) < 0.8
    for b in range(B):                           # 2f seen, then 2f - 1
        for s, cnt in ((1, 2 * f[b]), (2, max(0, 2 * f[b] - 1))):
            pp_val[b, :, s] = 7
            pp_seen[b, :, s] = False
            pp_seen[b, g.permutation(int(n_real[b]))[:cnt], s] = True
    prepared = pp_seen & (g.random((B, N, S)) < 0.4)
    committed = prepared & (g.random((B, N, S)) < 0.3)
    idx = np.arange(N)
    honest = idx[None, :] < n_real[:, None]
    bcast = g.random((B, N)) < 0.85
    side = (g.random((B, N)) < 0.5).astype(np.int64)
    return pp_val, pp_seen, prepared, committed, honest, bcast, side, f


@pytest.mark.parametrize("partition", [False, True])
def test_aggregate_tallies_decisions_match_jax(partition):
    g = np.random.default_rng(11 + partition)
    B, N, S = 6, 13, 10
    pp_val, pp_seen, prepared, committed, honest, bcast, side, f = \
        tally_inputs(g, B, N, S)
    active = np.array([True, False] * (B // 2))
    own = np.where(active[:, None], side, 0)
    T = torch.from_numpy
    got = tb.aggregate_tallies_plain(
        T(pp_val), T(pp_seen), T(prepared), T(committed), T(honest),
        T(bcast), T(2 * f + 1), 2, T(own if partition else 0 * side))
    for b in range(B):
        m = tb.table_width(3 * int(f[b]) + 1, int(f[b]))
        want = jbcast._aggregate_tallies(
            jnp.asarray(pp_val[b]), jnp.asarray(pp_seen[b]),
            jnp.asarray(prepared[b]), jnp.asarray(committed[b]),
            jnp.asarray(honest[b]), jnp.asarray(bcast[b]),
            jnp.int32(2 * f[b] + 1), m,
            side=jnp.asarray(side[b]) if partition else None,
            part_active=jnp.asarray(active[b]) if partition else None)
        for k in range(3):
            assert np.array_equal(got[k][b].numpy(), np.asarray(want[k])), \
                (b, k)


def mg_insert(summ, x, m):
    """Misra-Gries: fold one occurrence of x into ``summ`` (a list of m
    [key, count] pairs), as csrc/bcast_tally.cu mg_insert."""
    for e in summ:
        if e[1] > 0 and e[0] == x:
            e[1] += 1
            return
    for e in summ:
        if e[1] == 0:
            e[0], e[1] = x, 1
            return
    for e in summ:
        e[1] -= 1


def mg_merge(a, b, m):
    """Merge summary ``b`` into ``a`` as csrc/bcast_tally.cu mg_merge: add
    equal keys' counts, take the (m+1)-th largest count from all, keep the
    positive ones."""
    ent = [[k, c] for k, c in a]
    rest = []
    for k, c in b:
        hit = next((e for e in ent if c > 0 and e[1] > 0 and e[0] == k), None)
        if hit is not None:
            hit[1] += c
        else:
            rest.append([k, c])
    cc = sorted((c for _, c in ent + rest), reverse=True)
    th = (cc + [0] * (m + 1))[m]
    keep = [[k, c - th] for k, c in ent + rest if c > th]
    assert len(keep) <= m
    return keep + [[0, 0]] * (m - len(keep))


def kernel_candidates(vals, counting, side, m, threads, chunk, rng=None):
    """Kernel KU's candidate pass for one lane and slot in numpy:
    {side: [keys]}. Blocks of ``chunk`` nodes; ``threads`` threads a block,
    each walking the block's nodes at a stride (the slot's share of a
    block); each block merges its threads' summaries in order; the lane's
    last block merges the blocks' summaries by 32 lanes and a shuffle
    tree. With ``rng``, every merge order is shuffled instead."""
    N = len(vals)
    out = {}
    for sd in (0, 1):
        blocks = []
        for i0 in range(0, N, chunk):
            thr = []
            for sub in range(threads):
                summ = [[0, 0] for _ in range(m)]
                for i in range(i0 + sub, min(i0 + chunk, N), threads):
                    if counting[i] and side[i] == sd:
                        mg_insert(summ, int(vals[i]), m)
                thr.append(summ)
            if rng is not None:
                rng.shuffle(thr)
            acc = thr[0]
            for t in thr[1:]:
                acc = mg_merge(acc, t, m)
            blocks.append(acc)
        if rng is not None:
            rng.shuffle(blocks)
        lanes = [[[0, 0] for _ in range(m)] for _ in range(32)]
        for k, blk in enumerate(blocks):
            lanes[k % 32] = mg_merge(lanes[k % 32], blk, m)
        off = 16
        while off:                      # every lane at once, as shuffles
            lanes = [mg_merge(lanes[lane], lanes[lane + off], m)
                     if lane + off < 32 else lanes[lane]
                     for lane in range(32)]
            off //= 2
        out[sd] = [k for k, c in lanes[0] if c > 0]
    return out


def kernel_tally(pp_val, pp_seen, prepared, committed, real, hb, side, q, m,
                 threads=4, chunk=5, rng=None):
    """Kernel KU for one lane in numpy: per phase and (slot, side) the
    candidates, their exact counts, then each node's lookup. Returns
    (prepared2, commit_now)."""
    N, S = pp_val.shape
    prepared2 = prepared.copy()
    commit_now = np.zeros_like(committed)
    for phase in (4, 5):
        rel = pp_seen if phase == 4 else prepared2
        for s in range(S):
            cands = kernel_candidates(pp_val[:, s], hb & rel[:, s], side, m,
                                      threads, chunk, rng)
            exact = {sd: {k: int(np.sum(hb & rel[:, s] & (side == sd)
                                        & (pp_val[:, s] == k)))
                          for k in cands[sd]} for sd in (0, 1)}
            for j in range(N):
                cnt = exact[side[j]].get(int(pp_val[j, s]), 0) + \
                    int(real[j] and not hb[j] and rel[j, s])
                if phase == 4:
                    prepared2[j, s] |= bool(pp_seen[j, s] and cnt >= q)
                else:
                    commit_now[j, s] = prepared2[j, s] and cnt >= q and \
                        not committed[j, s]
    return prepared2, commit_now


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kernel_tally_model_equals_plain(seed):
    """KU's candidates and recount decide as the plain tallies do: lanes of
    f = 0 .. 4 with m = 1 or 2 (and m = 2 on every lane, as a ladder's
    m_cap gives), one or two sides, quorums at the threshold and one
    short, and merges in the kernel's order and in shuffled orders."""
    g = np.random.default_rng(100 + seed)
    B, N, S = 5, 13, 6
    pp_val, pp_seen, prepared, committed, honest, bcast, side, f = \
        tally_inputs(g, B, N, S, hot=2 + seed % 2)
    own = side if seed % 2 else np.zeros_like(side)
    hb = honest & bcast
    T = torch.from_numpy
    for m_cap in (None, 2):
        ms = [tb.table_width(3 * int(x) + 1, int(x)) if m_cap is None
              else m_cap for x in f]
        want = [tb.aggregate_tallies_plain(
            T(pp_val[b:b + 1]), T(pp_seen[b:b + 1]), T(prepared[b:b + 1]),
            T(committed[b:b + 1]), T(honest[b:b + 1]), T(bcast[b:b + 1]),
            T(2 * f[b:b + 1] + 1), ms[b], side=T(own[b:b + 1]))
            for b in range(B)]
        for order in (None, np.random.default_rng(seed)):
            for b in range(B):
                p2, now = kernel_tally(pp_val[b], pp_seen[b], prepared[b],
                                       committed[b], honest[b], hb[b],
                                       own[b], 2 * int(f[b]) + 1, ms[b],
                                       rng=order)
                assert np.array_equal(p2, want[b][1][0].numpy()), (b, m_cap)
                assert np.array_equal(now, want[b][2][0].numpy()), (b, m_cap)


@pytest.mark.parametrize("f", [1, 2, 5])
def test_self_vote_decides_at_the_threshold(f):
    """Slot 0: value 7 seen by 2f senders and by one real node that sent
    nothing; that node prepares (2f + its own vote), the senders, one
    vote short, do not. Slot 1: one sender fewer, and nobody prepares.
    As the JAX package decides."""
    n = 3 * f + 1
    pp_val = np.full((1, n, 2), 8, np.int32)
    pp_seen = np.zeros((1, n, 2), bool)
    bcast = np.ones((1, n), bool)
    silent = n - 1                                # real, sent nothing
    bcast[0, silent] = False
    for s, senders in ((0, 2 * f), (1, 2 * f - 1)):
        pp_val[0, : senders, s] = pp_val[0, silent, s] = 7
        pp_seen[0, : senders, s] = pp_seen[0, silent, s] = True
    no = np.zeros((1, n, 2), bool)
    honest = np.ones((1, n), bool)
    T = torch.from_numpy
    hit = tb.aggregate_tallies_plain(T(pp_val), T(pp_seen), T(no), T(no),
                                     T(honest), T(bcast),
                                     T(np.array([2 * f + 1], np.int32)),
                                     tb.table_width(n, f),
                                     T(np.zeros((1, n), np.int64)))[0][0]
    hit = hit.numpy()
    want = np.asarray(jbcast._aggregate_tallies(
        jnp.asarray(pp_val[0]), jnp.asarray(pp_seen[0]), jnp.asarray(no[0]),
        jnp.asarray(no[0]), jnp.asarray(honest[0]), jnp.asarray(bcast[0]),
        jnp.int32(2 * f + 1), jbcast._table_width(n, f, 0))[0])
    assert np.array_equal(hit, want)
    assert hit[:, 0].tolist() == [False] * (n - 1) + [True]
    assert not hit[:, 1].any()
    p2, _ = kernel_tally(pp_val[0], pp_seen[0], no[0], no[0], honest[0],
                         bcast[0], np.zeros(n, np.int64), 2 * f + 1,
                         tb.table_width(n, f))
    assert np.array_equal(p2, hit)


# --- a numpy model of kernel KV ------------------------------------------------

NONE = 0x7FFFFFFF


def kernel_decide(bits, committed, dval, committed_start, timer, reset,
                  crash, byz, g, threads=256, warp=32, per_thread=16,
                  batch=4, chunk=32):
    """KV on numpy arrays, launch by launch. Launch 1: tiles of ``threads
    * per_thread`` nodes (blocks in a shuffled order); each thread holds
    ``per_thread`` consecutive nodes, reads the rows of its eligible ones
    ``batch`` at a time where its own nodes have not yet shown every slot
    of the side (``chunk`` slots a pass), keeps the slots newly shown, and
    the lowest lane of the warp that newly shows a slot at node u gives the
    warp's candidate; the warps' least is the tile's. Launch 2: the lane's
    least over its tiles, then a thread a node adopts and runs P7."""
    B, N, S = committed.shape
    tile = threads * per_thread
    tiles = -(-N // tile)
    imin = np.full((B, tiles, 2, S), NONE, np.int64)
    for b in range(B):
        top = N if byz is None else min(N, int(byz[0][b]) - byz[1])
        for t in g.permutation(tiles):
            first = t * tile + np.arange(threads) * per_thread
            for c0 in range(0, S, chunk):
                W = min(chunk, S - c0)
                low = np.full((threads // warp, 2, W), NONE, np.int64)
                have = np.zeros((threads, 2, W), bool)
                for u0 in range(0, per_thread, batch):
                    m = np.zeros((threads, batch, W), bool)
                    for th in range(threads):
                        for v in range(batch):
                            i = first[th] + u0 + v
                            if i >= N or not bits[b, i] & 1 or i >= top:
                                continue
                            sd = (bits[b, i] >> 1) & 1
                            if not have[th, sd].all():
                                m[th, v] = committed[b, i, c0:c0 + W]
                    for v in range(batch):
                        u = u0 + v
                        fresh = np.zeros((threads, 2, W), bool)
                        for th in range(threads):
                            i = first[th] + u
                            sd = (bits[b, i] >> 1) & 1 if i < N else 0
                            fresh[th, sd] = m[th, v] & ~have[th, sd]
                            have[th, sd] |= fresh[th, sd]
                        for w in range(threads // warp):
                            lanes = fresh[w * warp:(w + 1) * warp]
                            for x in range(2):
                                for q in np.flatnonzero(lanes[:, x].any(0)):
                                    lane = int(np.argmax(lanes[:, x, q]))
                                    who = t * tile + (w * warp + lane) * \
                                        per_thread + u
                                    low[w, x, q] = min(low[w, x, q], who)
                imin[b, t, :, c0:c0 + W] = low.min(0)
    lows = imin.min(1)                                        # [B, 2, S]
    com, dv, tm = committed.copy(), dval.copy(), timer.copy()
    for b in range(B):
        for i in range(N):
            side = (bits[b, i] >> 1) & 1
            takes = not (crash and bits[b, i] & 4)
            for s in range(S):
                lo = lows[b, side, s]
                if takes and not committed[b, i, s] and lo < N:
                    com[b, i, s] = True
                    dv[b, i, s] = dval[b, lo, s]
            changed = (com[b, i] & ~committed_start[b, i]).any()
            up = (timer[b, i:i + 1].view(np.uint32) + np.uint32(1)).view(
                np.int32)[0]                                  # wraps
            tm[b, i] = 0 if changed else timer[b, i] if reset[b, i] else up
    return com, dv, tm


def decide_inputs(g, B, N, S, nb):
    """Random P6-P7 inputs: node bytes with both sides (bit 2 marks down
    nodes), sparse commits with some slots committed by no node of a side;
    lane 0's side 1 has one node that broadcasts, its last honest one, and
    it commits every slot. With ``nb`` byzantine nodes, per-lane n_real
    (else None) and lane 0's last honest node."""
    n_real = None
    last = N - 1
    if nb:
        n_real = g.integers(N // 2, N + 1, B).astype(np.int32)
        n_real[0] = N
        last = N - 1 - nb
    bits = (g.random((B, N)) < 0.7).astype(np.uint8)
    bits |= (g.random((B, N)) < 0.4).astype(np.uint8) << 1
    bits |= (g.random((B, N)) < 0.2).astype(np.uint8) << 2
    side1 = (bits[0] >> 1) & 1 == 1
    bits[0, side1] &= ~np.uint8(1)
    bits[0, last] = 3
    committed = g.random((B, N, S)) < 0.08
    committed[:, :, S // 2:] &= g.random((B, 1, S - S // 2)) < 0.5
    committed[0, last] = True
    dval = g.integers(-5, 5, (B, N, S)).astype(np.int32)
    start = committed & (g.random((B, N, S)) < 0.7)
    timer = g.integers(-2, 9, (B, N)).astype(np.int32)
    timer[:, 0] = np.iinfo(np.int32).max
    reset = g.random((B, N)) < 0.3
    return bits, committed, dval, start, timer, reset, n_real, last


@pytest.mark.parametrize("S,N,crash,byz,threads,warp", [
    (16, 97, False, False, 256, 32), (16, 203, True, False, 4, 2),
    (40, 97, False, True, 2, 2), (40, 61, True, True, 256, 32),
    (1, 131, False, False, 4, 2), (1, 29, True, True, 2, 1)])
def test_kernel_decide_model_equals_plain(S, N, crash, byz, threads, warp):
    """KV's two launches (numpy) on random states: ragged N over tiles of
    the real width and of a few nodes, S of 1, 16 and 40 (one pass, two
    with a short last), slots without a decider, a side whose only
    decider is the lane's last node, CRASH and BYZ (per-lane n_real), each
    against bcast_decide_plain, tolerance 0."""
    g = np.random.default_rng(N * 100 + S)
    B = 3
    nb = 3 if byz else 0
    bits, committed, dval, start, timer, reset, n_real, last = \
        decide_inputs(g, B, N, S, nb)
    byz_np = (n_real, nb) if byz else None
    T = torch.from_numpy
    want = tb.bcast_decide_plain(
        T(bits), T(committed), T(dval), T(start), T(timer), T(reset), crash,
        (T(n_real), nb) if byz else None)
    got = kernel_decide(bits, committed, dval, start, timer, reset, crash,
                        byz_np, g, threads=threads, warp=warp)
    for a, w in zip(got, want):
        assert np.array_equal(a, w.numpy())
    adopted = got[0] & ~committed
    assert adopted.any() and not got[0].all()
    # Lane 0's side 1 adopts from its last honest node alone.
    side1 = ((bits[0] >> 1) & 1 == 1) & ~(crash & (bits[0] & 4 != 0))
    take = side1[:, None] & ~committed[0]
    assert got[0][0][side1].all() and take.any()
    assert np.array_equal(got[1][0][take],
                          np.broadcast_to(dval[0, last], (N, S))[take])


# --- the f-ladder -------------------------------------------------------------

FS = [1, 2, 3]


@pytest.mark.parametrize("n_sweeps", [1, 2])
def test_bcast_ladder_matches_jax_rung_by_rung(n_sweeps):
    kw = bcast_kw(1, n_sweeps=n_sweeps)
    want = jsweep.pbft_fsweep_run(JConfig(**kw), FS)
    got = tsweep.pbft_fsweep_run(Config(**kw), FS, device="cpu")
    assert len(got) == len(want)
    for g_, w in zip(got, want):
        for k in ("committed", "dval", "view"):
            assert g_[k].shape == w[k].shape and g_[k].dtype == w[k].dtype
        assert np.array_equal(g_["view"], w["view"])
        _committed_equal(g_, w)
    assert tsweep.fsweep_payload(got) == jsweep.fsweep_payload(want)
    assert all(w["committed"].any() for w in want)


def test_bcast_ladder_rung_equals_its_standalone_run():
    got = tsweep.pbft_fsweep_run(Config(**bcast_kw(1, n_sweeps=2)), FS,
                                 device="cpu")
    for k, f in enumerate(FS):
        cfg = Config(**bcast_kw(f, n_sweeps=2, seed=HOSTILE["seed"] + k))
        alone = runner.run(cfg, device="cpu")
        assert np.array_equal(got[k]["view"], alone["view"])
        _committed_equal(got[k], alone)
        assert tsweep.rung_payloads(got)[k] == \
            simulator.decided_payload(cfg, alone)[3]


def _smoke_anchor(name: str) -> str:
    """The constant ``name`` of the repo's chip_smoke.py, read by
    importing the script without running it."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return getattr(smoke, name)


# chip_smoke.py's bcast ladders: BASELINE config 3's knobs (fs = 1..128)
# and BASE's partitioned hostile ones (fs = 1..32).
SMOKE_LADDERS = {
    "config3": (dict(n_rounds=32, log_capacity=32, seed=3, drop_rate=0.01,
                     churn_rate=0.001), range(1, 129), "BCAST_LADDER_DIGEST"),
    "hostile": (dict(n_rounds=24, log_capacity=8, seed=7, drop_rate=0.15,
                     partition_rate=0.05, churn_rate=0.05), range(1, 33),
                "HOSTILE_BCAST_DIGEST"),
}


@pytest.mark.parametrize("name", sorted(SMOKE_LADDERS))
def test_bcast_ladder_anchor_is_jax(name):
    """The anchor chip_smoke.py holds a bcast ladder's replay on the card to
    is the JAX package's bcast ladder digest at its knobs."""
    kw, fs, const = SMOKE_LADDERS[name]
    cfg = JConfig(protocol="pbft", fault_model="bcast", f=1, n_nodes=4, **kw)
    want = jserialize.digest(jsweep.fsweep_payload(
        jsweep.pbft_fsweep_run(cfg, fs)))
    assert want == _smoke_anchor(const)


def test_hostile_bcast_anchor_tells_the_rounds_apart():
    """On the hostile ladder the port's bcast round on the CPU gives
    chip_smoke.py's anchor, and the dense (edge) round does not."""
    kw, fs, const = SMOKE_LADDERS["hostile"]
    base = dict(protocol="pbft", f=1, n_nodes=4, **kw)
    got = tsweep.pbft_fsweep_run(Config(fault_model="bcast", **base), fs,
                                 device="cpu")
    assert serialize.digest(tsweep.fsweep_payload(got)) == \
        _smoke_anchor(const)
    edge = jsweep.pbft_fsweep_run(JConfig(fault_model="edge", **base), fs)
    assert jserialize.digest(jsweep.fsweep_payload(edge)) != \
        _smoke_anchor(const)


def test_table_cap_matches_jax():
    for f in (0, 1, 2, 5, 33_333):
        kw = bcast_kw(f)
        assert tb.table_width(3 * f + 1, f) == \
            jbcast._table_width(3 * f + 1, f, 0)
        assert tb.table_cap(Config(**kw)) == \
            jbcast._table_width(3 * f + 1, f, 0)
    for fs in ([1, 2, 3], [2, 5], [8333, 16666, 33333]):
        fs, cfg_pad = tsweep._fsweep_static(Config(**bcast_kw(1)), fs)
        assert tb.table_cap(cfg_pad, fs) == \
            jsweep._fsweep_static(JConfig(**bcast_kw(1)), fs)[2]


# --- the wrappers, the engine record and the front door ------------------------

@pytest.fixture(scope="module")
def wrapper_args():
    """{name: the arguments wrapper ``name`` got in round 9 of a padded
    [1, 2, 3] bcast ladder}, recorded by a stand-in in the round's
    module."""
    fs, cfg = tsweep._fsweep_static(Config(**bcast_kw(1)), FS)
    lanes = runner.device_lanes(cfg, fs, "cpu")
    st = runner.advance(cfg, tpbft.pbft_init(cfg, lanes.pop("seed")), 0, 9,
                        lanes=lanes, rungs=fs)
    out, originals = {}, {n: getattr(tb, n) for n in WRAPPERS}

    def recorder(name):
        def record(*args):
            out[name] = tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args)
            return originals[name](*args)
        record.launches = 0
        return record
    try:
        for name in WRAPPERS:
            setattr(tb, name, recorder(name))
        tb.pbft_bcast_round(cfg, st, 9, m=tb.table_cap(cfg, fs), **lanes)
    finally:
        for name, fn in originals.items():
            setattr(tb, name, fn)
    return out


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_on_cpu_equals_plain_and_writes_no_input(wrapper_args, name):
    args = wrapper_args[name]
    ka = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
    got = getattr(tb, name)(*ka)
    want = getattr(tb, name + "_plain")(*args)
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
        getattr(tb, name)(*args)


def test_round_calls_each_wrapper_once(monkeypatch):
    cfg = Config(**bcast_kw(2, n_rounds=5))
    calls = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        def call(*args, _fn=getattr(tb, name), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(tb, name, call)
    for name in ("delivery", "pbft_view_preprepare", "pbft_tally",
                 "pbft_decide"):
        monkeypatch.setattr(tpbft, name, None)    # the dense round's
    runner.run(cfg, device="cpu")
    assert calls == dict.fromkeys(calls, cfg.n_rounds)


def test_engine_record_and_names_match_jax():
    kw = bcast_kw(1)
    cfg = Config(**kw)
    assert cfg.no_partition is JConfig(**kw).no_partition is False
    assert Config(**bcast_kw(1, partition_rate=0.0)).no_partition
    assert simulator.engine_def(cfg) is runner.PBFT_BCAST
    assert runner.PBFT_BCAST.name == tb.NAME == jsim.engine_def(
        JConfig(**kw)).name
    assert runner.engine(dataclasses.replace(cfg, fault_model="edge")) is \
        runner.PBFT
    assert {name for mod, name in runner.KERNELS if mod is tb} == \
        set(WRAPPERS) | {"bcast_equiv_support"}
    assert tb.view_bound(cfg) == jbcast.view_bound(JConfig(**kw))


def test_telemetry_on_the_bcast_engine_raises():
    """Telemetry on the §6b engine raises on an f-ladder, as the JAX
    package's ladder has none; a standalone run has it
    (tests/test_torch_telemetry_bft.py)."""
    cfg = Config(**bcast_kw(1))
    with pytest.raises(ValueError, match="f-ladder"):
        runner.run_device(cfg, "cpu", telemetry=True, rungs=FS)
    stats: dict = {}
    runner.run(cfg, "cpu", telemetry=True, stats=stats)
    assert stats["telemetry"]["prepare_quorums"].sum() > 0


def test_bcast_entry_points_default_to_cuda():
    """Without a device the entry points run on cuda, and raise where
    there is none (never a silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Config(**bcast_kw(1))
    for call in (lambda: simulator.run(cfg),
                 lambda: tsweep.pbft_fsweep_run(cfg, FS),
                 lambda: tsweep.pbft_fsweep_timed(cfg, FS)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_bcast_ladder_timed_counts_real_steps():
    kw = bcast_kw(1, n_sweeps=2, n_rounds=6)
    out, compile_s, best, steps = tsweep.pbft_fsweep_timed(
        Config(**kw), FS, repeats=2, device="cpu")
    assert steps == (4 + 7 + 10) * 6 * 2
    assert compile_s > 0 and best > 0
    assert tsweep.fsweep_payload(out) == tsweep.fsweep_payload(
        tsweep.pbft_fsweep_run(Config(**kw), FS, device="cpu"))

