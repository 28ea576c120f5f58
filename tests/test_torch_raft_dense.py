"""The port's dense Raft engine against the JAX package, on the CPU.

``Config(max_active=0)`` selects the dense engine (SPEC §3, [N, N]
replication state and delivery mask). The same Config runs through
``consensus_tpu.network.runner.run`` (JAX on the CPU) and through
``consensus_tpu_torch`` on the CPU (the kernels' plain versions): every
extracted leaf and the decided-log payload must be equal, tolerance 0.
Also: BASELINE config raft-5node at full shape gives its committed digest,
one round stepped from a converted JAX carry equals JAX's next carry, the
full delivery mask equals JAX's, each wrapper equals its plain version on
the CPU and raises off it, and the one-pass rules kernels KM and KN use
for the grants and the choice of leader, modelled in numpy, equal the
plain versions, and so does kernel KO's one block a sweep (phases A-D in
shuffled orders, each median by its warp's binary search, held to the
JAX round's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.core import rng as jrng  # noqa: E402
from consensus_tpu.engines.raft import RaftState as JState  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu.ops import adversary as jadv  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.engines import raft as trd  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402
from consensus_tpu_torch.ops import adversary as tadv  # noqa: E402

BASE = dict(protocol="raft", n_rounds=48, n_sweeps=2, log_capacity=32,
            max_entries=24, drop_rate=0.1, partition_rate=0.1,
            churn_rate=0.02)

CASES = {
    "n5": dict(n_nodes=5, seed=3),
    "n64": dict(n_nodes=64, seed=11),
    "n300": dict(n_nodes=300, seed=5),
    # Many candidates and stale leaders: heavy drops and partitions,
    # churn and short timeouts.
    "n64-hostile": dict(n_nodes=64, seed=9, t_min=1, t_max=4, drop_rate=0.3,
                        partition_rate=0.4, churn_rate=0.1),
}

RAFT_5NODE = dict(protocol="raft", n_nodes=5, n_rounds=160, n_sweeps=512,
                  log_capacity=128, max_entries=100, seed=1, drop_rate=0.01,
                  churn_rate=0.001)
RAFT_5NODE_DIGEST = \
    "51007288213f9b78e1e4fd2f3601105ff97f12210a2a0a3382a059e2b703940b"


@pytest.mark.parametrize("case", list(CASES))
def test_whole_run_matches_jax(case):
    kw = {**BASE, **CASES[case]}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    assert jsim.engine_def(jcfg).name == simulator.engine_def(cfg).name
    want = jrunner.run(jcfg, jsim.engine_def(jcfg))
    got = runner.run(cfg, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert simulator.decided_payload(cfg, got)[3] == \
        jsim.decided_payload(jcfg, want)[3]
    assert got["commit"].max() > 0


def test_full_raft_5node_digest():
    res = simulator.run(Config(**RAFT_5NODE), device="cpu")
    assert res.digest == RAFT_5NODE_DIGEST
    assert res.counts.shape == (512, 5) and res.rec_a.shape == (512, 5, 128)
    assert res.node_round_steps == 512 * 5 * 160


# --- one round from a converted JAX carry ------------------------------------

STEP_KW = {**BASE, **CASES["n64-hostile"], "n_rounds": 30}
STEPS = (3, 10, 20, 29)


def _leaves(carry) -> dict:
    return {k: np.array(v) for k, v in carry._asdict().items()}


@pytest.fixture(scope="module")
def jax_steps():
    """{k: (leaves after k rounds, leaves after k + 1 rounds)} from JAX."""
    jcfg = JConfig(**STEP_KW)
    eng = jsim.engine_def(jcfg)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    out, done = {}, 0
    for k in STEPS:
        carry = jrunner._chunk_jit(jcfg, eng, k - done, carry,
                                   jnp.int32(done))
        before = _leaves(carry)
        out[k] = (before, _leaves(jrunner._chunk_jit(
            jcfg, eng, 1, carry, jnp.int32(k))))
        # The step donated ``carry``: rebuild it from its copy.
        carry = JState(**{n: jnp.asarray(a) for n, a in before.items()})
        done = k
    return out


@pytest.mark.parametrize("k", STEPS)
def test_one_round_from_jax_state(jax_steps, k):
    before, after = jax_steps[k]
    st = convert.state_from_numpy(before)
    assert isinstance(st, trd.RaftState)
    got = convert.state_to_numpy(trd.raft_round(Config(**STEP_KW), st, k))
    assert set(got) == set(after)
    for name in after:
        assert got[name].dtype == after[name].dtype, name
        assert np.array_equal(got[name], after[name]), name


def test_dense_carry_roundtrip_keeps_every_dtype(jax_steps):
    before, _ = jax_steps[STEPS[0]]
    st = convert.state_from_numpy(before)
    assert st.seed.dtype == torch.uint32 and st.down.dtype == torch.bool
    assert st.match_idx.dtype == torch.uint8
    assert st.match_idx.shape == (2, 64, 64)
    back = convert.state_to_numpy(st)
    for name, a in before.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a)
    with pytest.raises(TypeError):
        convert.state_from_numpy(
            {**before, "next_idx": before["next_idx"].astype(np.int32)})


# --- kernel KL's plain version -----------------------------------------------

SEEDS = np.array([0, 0xFFFFFFFF, 12345], np.uint32)


@pytest.mark.parametrize("n", [1, 5, 97])
@pytest.mark.parametrize("r,drop,part", [
    (0, 0.0, 0.0), (7, 0.2, 0.0), (13, 0.1, 1.0), (0xFFFFFFFF, 0.3, 0.5),
    (29, 0.05, 0.9)])
def test_delivery_plain_matches_jax(n, r, drop, part):
    drop_cut, part_cut = (jrng.prob_threshold_u32(p) for p in (drop, part))
    got = tadv.delivery(torch.from_numpy(SEEDS), r, n, drop_cut,
                        part_cut).numpy()
    assert got.shape == (len(SEEDS), n, n) and got.dtype == np.bool_
    for b, s in enumerate(SEEDS):
        want = np.asarray(jadv.delivery(jnp.uint32(s), n, jnp.uint32(r),
                                        drop_cut, part_cut))
        assert np.array_equal(got[b], want)
    assert not got[:, np.arange(n), np.arange(n)].any()


# --- the wrappers on the CPU and off it --------------------------------------

ROUND_WRAPPERS = ("delivery", "dense_elect", "dense_append",
                  "dense_acks_commit")
IN_PLACE = ("dense_elect", "dense_append", "dense_acks_commit")


@pytest.fixture(scope="module")
def wrapper_args():
    """{name: the arguments wrapper ``name`` got in round 6 of the hostile
    case}, recorded by a stand-in in the round's module."""
    kw = {**BASE, **CASES["n64-hostile"], "n_rounds": 8}
    cfg = Config(**kw)
    st = runner.advance(cfg, runner.init(cfg, runner.make_seeds(cfg), "cpu"),
                        0, 6)
    out, originals = {}, {n: getattr(trd, n) for n in ROUND_WRAPPERS}

    def recorder(name):
        def record(*args):
            out[name] = tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args)
            return originals[name](*args)
        record.launches = 0
        return record
    try:
        for name in ROUND_WRAPPERS:
            setattr(trd, name, recorder(name))
        trd.raft_round(cfg, st, 6)
    finally:
        for name, fn in originals.items():
            setattr(trd, name, fn)
    return out


def _clone(args):
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.parametrize("name", ROUND_WRAPPERS)
def test_wrapper_on_cpu_equals_plain(wrapper_args, name):
    mod = tadv if name == "delivery" else trd
    args = wrapper_args[name]
    ka, pa = _clone(args), _clone(args)
    got = getattr(mod, name)(*ka)
    want = getattr(mod, name + "_plain")(*pa)
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    assert (got is None) == (want is None)
    for g, w in zip(got or (), want or ()):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for k, p, a in zip(ka, pa, args):
        if isinstance(a, torch.Tensor):
            assert torch.equal(k, p)
            if name not in IN_PLACE:
                assert torch.equal(k, a)


@pytest.mark.parametrize("name", ROUND_WRAPPERS)
def test_wrapper_off_the_cpu_raises(wrapper_args, name):
    mod = tadv if name == "delivery" else trd
    args = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in wrapper_args[name])
    with pytest.raises(ValueError, match="CUDA"):
        getattr(mod, name)(*args)


def test_round_calls_each_wrapper_once(monkeypatch):
    kw = {**BASE, **CASES["n5"], "n_rounds": 5}
    cfg = Config(**kw)
    calls = dict.fromkeys(ROUND_WRAPPERS, 0)

    def counting(name):
        fn = getattr(trd, name)

        def call(*args):
            calls[name] += 1
            return fn(*args)
        monkeypatch.setattr(trd, name, call)
    for name in ROUND_WRAPPERS:
        counting(name)
    runner.run(cfg, device="cpu")
    assert calls == dict.fromkeys(ROUND_WRAPPERS, cfg.n_rounds)


# --- the kernels' one-pass rules, modelled in numpy ---------------------------

def _one_pass(entries, delivered, term, up_to_date=None):
    """Kernels KM's and KN's walk over a sweep's table of (id, term)
    entries, in table order: the highest delivered term ``top`` and, among
    the delivered entries of that term (and up to date, for requests),
    their ids. Returns (t_in, the ids eligible after the catch-up)."""
    any_, top, ids = False, 0, []
    for q, (i, t) in enumerate(entries):
        if not delivered[i]:
            continue
        if not any_ or t > top:
            any_, top, ids = True, t, []
        if t == top and (up_to_date is None or up_to_date[q]):
            ids.append(i)
    t_in = max(top, 0) if any_ else 0
    return t_in, (ids if any_ and top == max(term, t_in) else [])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_one_pass_rules_equal_plain(seed):
    """KM's grant rule and KN's choice of leader, each one pass over its
    table in a shuffled order (the order the kernels' atomics give), equal
    the plain versions on random states with terms from a small alphabet,
    so that catch-ups, ties, re-grants and stale leaders all occur."""
    g = np.random.default_rng(seed)
    B, N, Lc = 8, 24, 8
    cfg = Config(protocol="raft", n_nodes=N, log_capacity=Lc, max_entries=8,
                 t_min=3, t_max=9)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    term = g.integers(0, 4, (B, N)).astype(np.int32)
    role = g.choice(3, (B, N), p=[0.65, 0.2, 0.15]).astype(np.int32)
    vf = np.where(g.random((B, N)) < 0.6, -1,
                  g.integers(0, N, (B, N))).astype(np.int32)
    log_len = g.integers(0, Lc + 1, (B, N)).astype(np.int32)
    log_term = g.integers(0, 3, (B, N, Lc)).astype(np.int32)
    deliver = g.random((B, N, N)) < 0.8
    # Sweep 0: candidate 0 alone holds the top term and a full log of the
    # top log term: it wins. Sweep 1: node 10 voted for candidate 7, and
    # both 7 and the lower candidate 3 are eligible: it grants 7 again.
    term[0], term[0, 0], vf[0] = 4, 5, -1
    log_term[0, 0], log_len[0, 0], role[0, 0] = 2, Lc, 1
    term[1, (3, 7, 10)], role[1, (3, 7, 10)] = 6, (1, 1, 0)
    vf[1, 10], log_len[1, (3, 7)], log_len[1, 10] = 7, Lc, 0
    deliver[1, (3, 7), 10] = True
    zeros = np.zeros((B, N), np.int32)
    seeds = t(np.arange(B, dtype=np.uint32))
    # P0-P1 change nothing: no churn, every timer below its timeout.
    got = trd.dense_elect_plain(
        cfg, seeds, 5, t(deliver), t(term), t(role), t(vf), t(zeros),
        t(zeros + 9), t(log_term), t(log_len),
        torch.zeros((B, N, N), dtype=torch.uint8),
        torch.ones((B, N, N), dtype=torch.uint8))
    lterm = np.where(log_len > 0, np.take_along_axis(
        log_term, np.clip(log_len - 1, 0, Lc - 1)[..., None], 2)[..., 0], 0)
    regrants = wins = 0
    for b in range(B):
        cands = [c for c in g.permutation(N) if role[b, c] == 1]
        votes, bumped = np.zeros(N, int), np.zeros(N, bool)
        for j in range(N):
            fresh = [lterm[b, c] > lterm[b, j] or (lterm[b, c] == lterm[b, j]
                     and log_len[b, c] >= log_len[b, j]) for c in cands]
            t_in, elig = _one_pass([(c, term[b, c]) for c in cands],
                                   deliver[b, :, j], term[b, j], fresh)
            tm, v, bumped[j] = term[b, j], vf[b, j], t_in > term[b, j]
            if bumped[j]:
                tm, v = t_in, -1
            grant = v if v >= 0 and v in elig else (
                min(elig) if v == -1 and elig else -1)
            regrants += grant >= 0 and grant == vf[b, j]
            assert int(got[0][b, j]) == tm
            assert int(got[2][b, j]) == (grant if grant >= 0 else v)
            if grant >= 0 and deliver[b, j, grant]:
                votes[grant] += 1
        won = {c for c in cands if int(got[1][b, c]) == 2}
        assert won == {c for c in cands
                       if not bumped[c] and 1 + votes[c] >= N // 2 + 1}
        wins += len(won)
    assert regrants > 0 and wins > 0

    # KN: the receivers' choice of leader among the P3b senders.
    got = trd.dense_append_plain(
        cfg, seeds, 5, t(deliver), t(term), t(role), t(vf), t(zeros),
        t(zeros + 9), torch.zeros((B, N), dtype=torch.bool),
        t(log_term), t(log_term), t(log_len), t(zeros),
        torch.zeros((B, N, N), dtype=torch.uint8),
        torch.ones((B, N, N), dtype=torch.uint8))
    stale = 0
    for b in range(B):
        leaders = [i for i in g.permutation(N) if role[b, i] == 2]
        for j in range(N):
            t_in2, valid = _one_pass([(i, term[b, i]) for i in leaders],
                                     deliver[b, :, j], term[b, j])
            assert int(got[0][b, j]) == max(term[b, j], t_in2)
            assert int(got[9][b, j]) == (min(valid) if valid else -1)
            stale += role[b, j] == 2 and t_in2 > term[b, j]
    assert stale > 0


# --- kernel KO's one-block pass, modelled in numpy ----------------------------

def _jax_median(row: np.ndarray, majority: int, E: int) -> int:
    """The JAX round's P3e binary search (consensus_tpu/engines/raft.py:
    509-518) on one u8 match row."""
    m = jnp.asarray(row)[None, :]
    lo, hi = jnp.zeros(1, jnp.int32), jnp.full(1, E + 1, jnp.int32)
    for _ in range((E + 1).bit_length()):
        mid = (lo + hi) // 2
        cnt = jnp.sum((m >= mid[:, None].astype(m.dtype)).astype(jnp.int32),
                      axis=1)
        ok = cnt >= majority
        lo, hi = jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)
    return int(lo[0])


def _warp_count_ge(row: np.ndarray, mid: int, g) -> int:
    """Phase D's count: 32 lanes, each over the row's 4-byte words k = lane
    + 32 i (bytes where N is not a multiple of 4), the per-byte compares
    summed in a shuffled lane order (the warp's reduction)."""
    n = row.shape[0]
    if n % 4 == 0:
        words = row.view("<u4")
        lane_sums = [sum(int(w) >> s & 0xFF >= mid for w in words[lane::32]
                         for s in (0, 8, 16, 24)) for lane in range(32)]
    else:
        lane_sums = [int((row[lane::32] >= mid).sum()) for lane in range(32)]
    return sum(lane_sums[i] for i in g.permutation(32))


def _ko_model(cfg, st: dict, g) -> dict:
    """Kernel KO's one block a sweep on numpy copies of ``st``: phases A-D
    with the nodes taken in a shuffled order in each phase, the processing
    list shuffled (the order the shared atomics give), each leader's median
    by phase D's binary search over word counts, checked against the JAX
    round's binary search. The block's first node that still leads (the
    candidate), when it processes, takes its row as it was before C with
    each node's successful ack to it applied, as phase D reads it, and its
    median off the suffix sums of a histogram, also held to JAX's."""
    st = {k: None if v is None else v.copy() for k, v in st.items()}
    B, N = st["term"].shape
    L = st["log_term"].shape[2]
    E, majority = min(cfg.max_entries, L), N // 2 + 1
    honest = N - cfg.n_byzantine if cfg.byz == trd.BYZ_SILENT else N
    span = cfg.t_max - cfg.t_min
    for b in range(B):
        term, role = st["term"][b], st["role"][b]
        deliver, ack_to = st["deliver"][b], st["ack_to"][b]
        tin = np.zeros(N, np.int64)
        for j in g.permutation(N):                                  # A
            l = ack_to[j]
            if j < honest and 0 <= l < N and deliver[j, l] and term[j] > 0:
                tin[l] = max(tin[l], term[j])
        proc, listed = np.zeros(N, bool), []
        for l in g.permutation(N):                                  # B
            still = st["was_leader"][b, l] and role[l] == 2
            if still and tin[l] > term[l]:
                term[l], role[l], st["voted_for"][b, l] = tin[l], 0, -1
                d = jrng.random_u32_np(int(st["seed"][b]),
                                       jrng.STREAM_TIMEOUT, np.uint32(tin[l]),
                                       0, np.uint32(l))
                st["timeout"][b, l] = np.int32(
                    np.uint32(cfg.t_min) + np.uint32(int(d) % span))
            elif still:
                proc[l] = True
                listed.append(l)
            if st["flags"] is not None and st["flags"][b, l] & tadv.CRASH_DOWN:
                continue
            if role[l] == 2:
                st["timer"][b, l] = 0
            elif not st["reset"][b, l]:
                st["timer"][b, l] = np.int32(
                    np.uint32(st["timer"][b, l]) + np.uint32(1))
        match, nxt = st["match_idx"][b], st["next_idx"][b]
        before = match.copy()
        still = st["was_leader"][b] & (st["role"][b] == 2)
        fast = set(np.flatnonzero(still)[:1].tolist())
        for j in g.permutation(N):                                  # C
            l = ack_to[j]
            if j >= honest or not (0 <= l < N) or not deliver[j, l] \
                    or not proc[l]:
                continue
            if st["ack_ok"][b, j]:
                match[l, j] = max(match[l, j], np.uint8(st["ack_match"][b, j]
                                                        & 0xFF))
                nxt[l, j] = np.uint8((int(match[l, j]) + 1) & 0xFF)
            else:
                nxt[l, j] = max((int(nxt[l, j]) - 1) & 0xFF, 1)
        for l in g.permutation(listed):                             # D
            row = match[l]
            if l in fast:
                row = before[l].copy()
                for j in range(N):
                    if j < honest and ack_to[j] == l and deliver[j, l] \
                            and st["ack_ok"][b, j]:
                        row[j] = max(row[j], st["ack_match"][b, j] & 0xFF)
                assert np.array_equal(row, match[l])
                # The candidate's suffix histogram (entries above E count
                # as E), its bins added in a shuffled order.
                hist = np.zeros(256, np.int64)
                for j in g.permutation(N):
                    hist[min(int(row[j]), E)] += 1
                suffix = np.cumsum(hist[::-1])[::-1]
                hist_med = max(m for m in range(E + 1)
                               if suffix[m] >= majority)
                assert hist_med == _jax_median(row, majority, E)
            lo, hi = 0, E + 1
            for _ in range((E + 1).bit_length()):
                mid = (lo + hi) // 2
                if _warp_count_ge(row, mid, g) >= majority:
                    lo = mid
                else:
                    hi = mid
            assert lo == _jax_median(match[l], majority, E)
            kmed = min(max(lo - 1, 0), L - 1)
            if lo > 0 and lo > st["commit"][b, l] \
                    and st["log_term"][b, l, kmed] == term[l]:
                st["commit"][b, l] = lo
    return st


KO_CASES = {
    "E-L": dict(n=24, E=8),
    "E-0": dict(n=24, E=0),
    "bytes": dict(n=37, E=8),            # N not a multiple of 4
    "crash": dict(n=24, E=8, crash=True),
    "silent": dict(n=24, E=8, nb=5),
}
KO_STATE = ("deliver", "was_leader", "ack_to", "ack_ok", "ack_match",
            "log_term", "term", "role", "voted_for", "timeout", "commit",
            "match_idx", "next_idx", "timer", "reset")


@pytest.mark.parametrize("case", list(KO_CASES))
def test_one_block_pass_equals_plain(case):
    """KO's one-block pass (phases A-D, shuffled node, list and lane
    orders, three shuffles a state) equals ``dense_acks_commit_plain`` on
    random states with several processing leaders a sweep, leaders bumped
    by a higher acked term, match entries above E, next entries at 0 and
    1, timers at the int32 edge, E in {0, L}; the medians equal the JAX
    round's binary search."""
    kw = KO_CASES[case]
    n, E = kw["n"], kw["E"]
    g = np.random.default_rng(n + 31 * E + len(case))
    B, Lc = 6, 8
    cfg = Config(protocol="raft", n_nodes=n, log_capacity=Lc, max_entries=E,
                 t_min=3, t_max=9, n_byzantine=kw.get("nb", 0),
                 byz_mode="silent")
    st = dict(
        seed=g.integers(0, 2**32, B).astype(np.uint32),
        deliver=g.random((B, n, n)) < 0.8,
        was_leader=g.random((B, n)) < 0.5,
        ack_to=g.integers(-1, n, (B, n)).astype(np.int32),
        ack_ok=g.random((B, n)) < 0.6,
        ack_match=g.integers(0, Lc + 1, (B, n)).astype(np.int32),
        log_term=g.integers(0, 3, (B, n, Lc)).astype(np.int32),
        term=g.integers(0, 4, (B, n)).astype(np.int32),
        role=g.choice(3, (B, n), p=[0.4, 0.1, 0.5]).astype(np.int32),
        voted_for=g.integers(-1, n, (B, n)).astype(np.int32),
        timeout=g.integers(3, 9, (B, n)).astype(np.int32),
        commit=g.integers(0, 3, (B, n)).astype(np.int32),
        match_idx=g.choice(np.array([0, 1, 2, 5, 8, 9, 200], np.uint8),
                           (B, n, n)),
        next_idx=g.choice(np.array([0, 1, 2, 7, 255], np.uint8), (B, n, n)),
        timer=g.choice(np.array([0, 3, 2**31 - 1], np.int32), (B, n)),
        reset=g.random((B, n)) < 0.3,
        flags=(g.integers(0, 8, (B, n)).astype(np.uint8)
               if kw.get("crash") else None))
    # Many acks to a few leaders, so that medians move and commits advance.
    st["ack_to"] = np.where(g.random((B, n)) < 0.7,
                            g.integers(0, 3, (B, n)), st["ack_to"]
                            ).astype(np.int32)
    st["ack_match"][:, : n // 2] = E
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    args = [t(st[k]) for k in KO_STATE]
    trd.dense_acks_commit_plain(cfg, t(st["seed"]), *args,
                                None if st["flags"] is None
                                else t(st["flags"]))
    want = dict(zip(KO_STATE, (a.numpy() for a in args)))
    for _ in range(3):
        got = _ko_model(cfg, st, g)
        for k in KO_STATE:
            assert np.array_equal(got[k], want[k]), (case, k)
    proc = (st["was_leader"] & (st["role"] == 2)
            & (want["term"] == st["term"]))
    assert proc.sum(1).max() >= 2                  # several leaders a sweep
    assert (st["was_leader"] & (st["role"] == 2)
            & (want["term"] > st["term"])).any()   # a bumped leader
    if E > 0:
        assert (want["commit"] > st["commit"]).any()
