"""The capped-Raft round's phase kernels KE-KH, on the CPU.

* The rule kernel KH uses for the P3e median: a 256-bin histogram of each
  [N] row of match bytes, then the largest m <= E whose suffix count
  reaches the majority. A numpy model of it must equal the plain version's
  fixed-depth binary search (the JAX round's), tolerance 0.
* Each new wrapper, called on CPU tensors, equals its ``_plain`` twin and
  updates the same arguments in place; on tensors of another device it
  raises instead of falling back.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.engines import raft_sparse as trs  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402

L = 128
PHASES = ("candidacy", "elect", "slots", "acks_commit")


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


@pytest.mark.parametrize("n", [999, 1000])
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
           t_max=8, drop_rate=0.2, partition_rate=0.1, churn_rate=0.02)
ROUNDS = (3, 12, 23)


@pytest.fixture(scope="module")
def phase_args():
    """{(name, r): the arguments the phase wrapper got in round r}."""
    cfg = Config(**CFG)
    st = runner.init(cfg, runner.make_seeds(cfg), "cpu")
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
            st = trs.raft_sparse_round(cfg, st, r)
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
    if name != "acks_commit":
        for k, a in zip(ka, args):
            if isinstance(a, torch.Tensor):
                assert torch.equal(k, a)


@pytest.mark.parametrize("name", PHASES)
def test_wrapper_off_the_cpu_raises(phase_args, name):
    args = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in phase_args[name, ROUNDS[0]])
    with pytest.raises(ValueError, match="CUDA"):
        getattr(trs, name)(*args)
