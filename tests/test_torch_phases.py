"""The capped-Raft round's phase kernels KD-KK, on the CPU.

* The rule kernel KH uses for the P3e median: a 256-bin histogram of
  each [N] row of match bytes, then the largest m <= E whose suffix count
  reaches the majority. A numpy model of it must equal the plain version's
  fixed-depth binary search (the JAX round's), tolerance 0.
* Each phase wrapper, called on CPU tensors, equals its ``_plain`` twin
  and updates the same arguments in place; on tensors of another device it
  raises instead of falling back.
* The plain versions of KI (P3a-P3b) and of KD's receiver side on built
  edge inputs: a leader at log length E, one at L - 1, stale and empty
  slots; a receiver whose bump and step-down fire together, ties between
  slots, undelivered heartbeats. Draws are held to the JAX package's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.engines import raft_sparse as trs  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402

L = 128
PHASES = ("candidacy", "elect", "slots", "propose", "append_entries",
          "acks_commit", "telemetry")
# The wrappers that update some of their arguments in place.
IN_PLACE = ("propose", "append_entries", "acks_commit", "telemetry")


def histogram_median(rows: np.ndarray, majority: int, E: int) -> np.ndarray:
    """Kernel KH's P3e rule on [R, N] u8 rows, as the kernel runs it: the
    count of entries above E first, then down from E to 0 until the suffix
    count reaches the majority."""
    out = np.zeros(len(rows), np.int32)
    for i, row in enumerate(rows):
        hist = np.bincount(row, minlength=256)
        above = int(hist[E + 1:].sum())
        for m in range(E, -1, -1):
            above += int(hist[m])
            if above >= majority:
                out[i] = m
                break
    return out


def _rows(n: int, rng: np.random.Generator) -> np.ndarray:
    """u8 rows: uniform over 0..255, clustered around a few values, all
    equal, and rows whose majority-th largest value sits exactly at the
    majority or one entry short of it."""
    majority = n // 2 + 1
    rows = [rng.integers(0, 256, n), rng.integers(90, 140, n),
            rng.integers(0, 3, n), np.full(n, 7), np.full(n, 255),
            np.zeros(n, np.int64)]
    for v in (1, 60, 100, 101, 128, 200):
        for count in (majority, majority - 1):
            row = np.full(n, v - 1)
            row[rng.permutation(n)[:count]] = v
            rows.append(row)
    return np.stack(rows).astype(np.uint8)


# 999 and 1000: the capped engine's rows; 5 and 1024: the dense engine's
# widths (raft-5node, raft-1kx1k).
@pytest.mark.parametrize("n", [999, 1000, 5, 1024])
@pytest.mark.parametrize("E", [1, 100, L])
def test_histogram_rule_equals_binary_search(E, n):
    rows = _rows(n, np.random.default_rng(1000 * E + n))
    majority = n // 2 + 1
    want = trs.commit_median_plain(torch.from_numpy(rows)[None], majority,
                                   E)[0].numpy()
    assert np.array_equal(histogram_median(rows, majority, E), want)
    assert want.max() <= E


CFG = dict(protocol="raft", n_nodes=256, n_rounds=24, n_sweeps=2,
           log_capacity=32, max_entries=8, max_active=4, seed=21, t_min=3,
           t_max=8, drop_rate=0.2, partition_rate=0.1, churn_rate=0.02,
           telemetry_window=5)
ROUNDS = (3, 12, 23)


@pytest.fixture(scope="module")
def phase_args():
    """{(name, r): the arguments the phase wrapper got in round r}."""
    cfg = Config(**CFG)
    st = runner.init(cfg, runner.make_seeds(cfg), "cpu")
    telem, flight = runner.accumulators(cfg, "cpu")
    out, originals = {}, {n: getattr(trs, n) for n in PHASES}

    def recorder(name, r):
        def record(*args):
            out[name, r] = tuple(a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args)
            return originals[name](*args)
        record.launches = 0
        return record
    try:
        for r in range(cfg.n_rounds):
            for name in PHASES:
                setattr(trs, name, recorder(name, r))
            st = trs.raft_sparse_round(cfg, st, r, telem=telem,
                                       flight=flight)
    finally:
        for name, fn in originals.items():
            setattr(trs, name, fn)
    return {k: v for k, v in out.items() if k[1] in ROUNDS}


def _clone(args):
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.parametrize("r", ROUNDS)
@pytest.mark.parametrize("name", PHASES)
def test_wrapper_on_cpu_equals_plain(phase_args, name, r):
    args = phase_args[name, r]
    ka, pa = _clone(args), _clone(args)
    got = getattr(trs, name)(*ka)
    want = getattr(trs, name + "_plain")(*pa)
    assert (got is None) == (want is None)
    for g, w in zip(got or (), want or ()):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # The same arguments were updated in place, and only those.
    for k, p, a in zip(ka, pa, args):
        if isinstance(a, torch.Tensor):
            assert torch.equal(k, p)
    if name not in IN_PLACE:
        for k, a in zip(ka, args):
            if isinstance(a, torch.Tensor):
                assert torch.equal(k, a)


@pytest.mark.parametrize("name", PHASES)
def test_wrapper_off_the_cpu_raises(phase_args, name):
    args = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in phase_args[name, ROUNDS[0]])
    with pytest.raises(ValueError, match="CUDA"):
        getattr(trs, name)(*args)


def _jax_draws(seed, stream, ctx, c0, idx):
    from consensus_tpu.ops.adversary import draw
    import jax.numpy as jnp
    return np.array(draw(jnp.uint32(seed), stream, jnp.uint32(ctx), c0,
                         jnp.asarray(idx, jnp.uint32)))


def _jax_timeouts(seed, t_min, t_max, term, idx):
    from consensus_tpu.engines.raft import _draw_timeout
    import jax.numpy as jnp
    return np.array(_draw_timeout(jnp.uint32(seed), t_min, t_max,
                                  jnp.asarray(term, jnp.int32),
                                  jnp.asarray(idx, jnp.uint32)))


@pytest.mark.parametrize("max_entries", [6, 8])
def test_propose_plain_on_edge_inputs(max_entries):
    """Leaders at log length E (no append), at L - 1 (the last slot, when
    E = L), below; a follower; a slot whose leader stepped down and an
    empty slot. The value is the JAX package's STREAM_VALUE draw."""
    from consensus_tpu_torch.core import rng
    Lc, N, r, seed = 8, 6, 41, 0xFFFFFFF0
    cfg = Config(protocol="raft", n_nodes=N, log_capacity=Lc,
                 max_entries=max_entries, max_active=3)
    E = min(max_entries, Lc)
    gen = np.random.default_rng(max_entries)
    log_term = torch.from_numpy(gen.integers(0, 9, (1, N, Lc), np.int32))
    log_val = torch.from_numpy(gen.integers(-9, 9, (1, N, Lc), np.int32))
    log_len = torch.tensor([[E, Lc - 1, 0, 3, 2, E - 1]], dtype=torch.int32)
    lead = torch.tensor([[True, True, True, False, True, True]])
    term = torch.tensor([[5, 6, 7, 8, 9, 10]], dtype=torch.int32)
    commit = torch.tensor([[1, 2, 0, 3, 1, 4]], dtype=torch.int32)
    lead_id = torch.tensor([[1, 3, -1]], dtype=torch.int32)
    seeds = torch.tensor([seed], dtype=torch.uint32)
    lt, lv = log_term.clone(), log_val.clone()
    (new_len, was_lead_k, hb_ids, s_term, s_len, s_commit, s_logt,
     s_logv) = trs.propose_plain(cfg, seeds, r, lead, term, lt, lv, log_len,
                                 commit, lead_id)
    values = _jax_draws(seed, rng.STREAM_VALUE, r, 0, np.arange(N))
    want_t, want_v = log_term.clone(), log_val.clone()
    want_len = log_len.clone()
    for j in range(N):
        if lead[0, j] and log_len[0, j] < E:
            k = int(log_len[0, j])
            want_t[0, j, k] = term[0, j]
            want_v[0, j, k] = int(values[j].astype(np.int32))
            want_len[0, j] += 1
    assert torch.equal(lt, want_t) and torch.equal(lv, want_v)
    assert torch.equal(new_len, want_len)
    assert (E == Lc) == bool(want_len[0, 1] == Lc)      # the last slot
    assert was_lead_k.tolist() == [[True, False, False]]
    assert hb_ids.tolist() == [[1, -1, -1]]
    assert s_term.tolist() == [[6, 8, 5]]               # the empty slot: id 0
    assert s_len.tolist() == [[int(want_len[0, 1]), 3, E]]
    assert s_commit.tolist() == [[2, 3, 1]]
    for a, j in enumerate((1, 3, 0)):
        assert torch.equal(s_logt[0, a], want_t[0, j])
        assert torch.equal(s_logv[0, a], want_v[0, j])


def test_append_entries_plain_receivers_on_edge_inputs():
    """KD's receiver side: a candidate that hears a higher term (bump and
    step-down together), a candidate of the heartbeat's term (step-down
    alone), a follower with two slots of its term (the least leader id
    wins, not the first slot), one whose heartbeat was not delivered, and
    one whose only heartbeat is of an older term."""
    N, A, Lc, seed = 6, 3, 8, 77
    cfg = Config(protocol="raft", n_nodes=N, log_capacity=Lc, max_entries=8,
                 max_active=A, t_min=2, t_max=9)
    lead_id = torch.tensor([[4, 1, -1]], dtype=torch.int32)
    s_term = torch.tensor([[7, 7, 0]], dtype=torch.int32)
    del_lj = torch.zeros((1, A, N), dtype=torch.bool)
    del_lj[0, 0, [0, 2, 5]] = True          # leader 4 reaches 0, 2, 5
    del_lj[0, 1, [1, 2]] = True             # leader 1 reaches 1, 2
    term = torch.tensor([[5, 7, 7, 7, 7, 9]], dtype=torch.int32)
    role = torch.tensor([[1, 1, 0, 0, 2, 0]], dtype=torch.int32)
    voted_for = torch.tensor([[0, 1, 4, -1, 4, 5]], dtype=torch.int32)
    timer = torch.tensor([[3, 4, 5, 6, 0, 2]], dtype=torch.int32)
    timeout = torch.full((1, N), 8, dtype=torch.int32)
    reset = torch.tensor([[False, False, False, False, True, False]])
    log_len = torch.zeros((1, N), dtype=torch.int32)
    commit = torch.zeros((1, N), dtype=torch.int32)
    s_next = torch.ones((1, A, N), dtype=torch.uint8)
    s_len = torch.tensor([[2, 1, 0]], dtype=torch.int32)
    s_commit = torch.zeros((1, A), dtype=torch.int32)
    s_logt = torch.full((1, A, Lc), 7, dtype=torch.int32)
    s_logv = torch.arange(A * Lc, dtype=torch.int32).reshape(1, A, Lc)
    log_term = torch.zeros((1, N, Lc), dtype=torch.int32)
    log_val = torch.zeros((1, N, Lc), dtype=torch.int32)
    (t2, r2, vf2, tm2, to2, rs2, kstar, has_l, apply_, new_len,
     new_commit) = trs.append_entries_plain(
        cfg, torch.tensor([seed], dtype=torch.uint32), del_lj, lead_id,
        s_term, term, role, voted_for, timer, timeout, reset, log_term,
        log_val, log_len, commit, s_next, s_len, s_commit, s_logt, s_logv)
    assert t2.tolist() == [[7, 7, 7, 7, 7, 9]]
    assert r2.tolist() == [[0, 0, 0, 0, 2, 0]]
    assert vf2.tolist() == [[-1, 1, 4, -1, 4, 5]]
    bumped = _jax_timeouts(seed, 2, 9, [7], [0])[0]
    assert to2.tolist() == [[int(bumped), 8, 8, 8, 8, 8]]
    assert has_l.tolist() == [[True, True, True, False, False, False]]
    assert kstar.tolist() == [[0, 1, 1, 0, 0, 0]]
    assert tm2.tolist() == [[0, 0, 0, 6, 0, 2]]
    assert rs2.tolist() == [[True, True, True, False, True, False]]
    assert apply_.tolist() == has_l.tolist()
    assert new_len.tolist() == [[2, 1, 1, 0, 0, 0]]
    assert torch.equal(log_val[0, 0, :2], s_logv[0, 0, :2])
    assert torch.equal(log_val[0, 2, :1], s_logv[0, 1, :1])
