"""The port's SPEC §3c/§7c byzantine nodes on the §6b broadcast PBFT engine
against the JAX package, on the CPU: telemetry, tallies and widths.

Beside ``tests/test_torch_byz_bcast.py`` and ``_steps.py``, tolerance 0:
the telemetry with 4-round windows; the safety tail of KAA's plain version
on built states; the plain tallies with honest senders and ``extra``
against ``_aggregate_tallies``, and a numpy model of kernel KU's
Misra-Gries candidates and exact recount against them, at table widths up
to 4 (four distinct values at the threshold at f = 1); the table widths
against ``_table_width`` and ``_fsweep_static``, and the width the round
hands KU; n_byzantine = 0 against the flat run; KAK launched only under
equivocation.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.engines import pbft_bcast as jbcast  # noqa: E402
from consensus_tpu.engines import pbft_sweep as jsweep  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.core.config import BYZ_EQUIV  # noqa: E402
from consensus_tpu_torch.engines import pbft  # noqa: E402
from consensus_tpu_torch.engines import pbft_bcast as tb  # noqa: E402
from consensus_tpu_torch.engines import pbft_sweep  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_byz import _pbft_safety  # noqa: E402
from test_torch_byz_bcast import RUNS  # noqa: E402
from test_torch_byz_bcast_steps import COMPOSED  # noqa: E402
from test_torch_pbft_bcast import kernel_candidates  # noqa: E402
from torch_byz_helpers import telemetry_holds  # noqa: E402

# Telemetry with 4-round windows, under equivocation with and without a
# crash (KAA's forked slots leave a down node's commits out on §6b).
TELEMETRY = {"equivocate": {**COMPOSED, "n_rounds": 24},
             "equivocate-nocrash": dict(
                 dataclasses.asdict(RUNS["f3-nopart-hostile"]), n_rounds=24),
             "silent": dict(dataclasses.asdict(RUNS["N64-byz-silent"]))}


@pytest.mark.parametrize("name", list(TELEMETRY))
def test_telemetry_matches_jax(name):
    telemetry_holds(TELEMETRY[name], name)


@pytest.mark.parametrize("crash", [False, True])
def test_safety_tail_on_built_states(crash):
    """KAA's plain version as the §6b round calls it (CRASH_COMMITS with a
    crash) counts forked_qc, conflict_commits and safety_violations as the
    JAX round's tail does (``pbft_bcast.py:694-710``): over the honest
    nodes of each lane, this round's commits by a node up at its end, and
    the decided values after the freeze."""
    g = np.random.default_rng(23 + crash)
    B, N, S = 4, 10, 12
    cfg = Config(protocol="pbft", fault_model="bcast", f=3, n_nodes=N,
                 n_rounds=16, n_sweeps=B, log_capacity=S, n_byzantine=2,
                 byz_mode="equivocate")
    n_real = torch.tensor([10, 10, 7, 4], dtype=torch.int32)
    rand = lambda p: torch.from_numpy(g.random((B, N, S)) < p)  # noqa: E731
    vals = lambda: torch.from_numpy(g.integers(-2, 2, (B, N, S))  # noqa: E731
                                    .astype(np.int32) * 2**30)
    committed_in, tallied = rand(0.3), rand(0.6)
    committed = tallied | rand(0.2)
    pp_val, dval_in, dval = vals(), vals(), vals()
    down = torch.from_numpy(g.random((B, N)) < 0.3) if crash \
        else torch.zeros((B, N), dtype=torch.bool)
    view = torch.zeros((B, N), dtype=torch.int32)
    t = torch.zeros((B, len(pbft.PBFT_TELEMETRY)), dtype=torch.int32)
    pbft.pbft_telemetry(cfg, 3, n_real, view, view, view, down, down,
                        rand(0.5), rand(0.3), rand(0.4), committed_in,
                        tallied, committed, t, None, None,
                        pbft.CRASH_VIEWS | pbft.CRASH_COMMITS if crash else 0,
                        (pp_val, dval_in, dval))
    col = pbft.PBFT_TELEMETRY.index("forked_qc")
    fz = down.numpy()[:, :, None]
    for b in range(B):
        honest = np.arange(N) < int(n_real[b]) - cfg.n_byzantine
        nf, nc = _pbft_safety(
            pp_val[b].numpy(),
            (tallied & ~committed_in)[b].numpy() & ~fz[b],
            np.where(fz[b], committed_in[b], committed[b]),
            np.where(fz[b], dval_in[b], dval[b]), honest)
        assert t[b, col:col + 3].tolist() == [nf, nc, int(nc > 0)], b
    assert (t[:, col] > 0).any() and (t[:, col + 1] > 0).any()


# --- KU with byzantine senders and extra: plain, JAX and the kernel's model ----

def tally_inputs(g, B, N, S, nb, hot):
    """Tally inputs at f = (N - 1) // 3 on every lane with nb byzantine
    nodes and ``extra`` up to nb: quorums close (value 0 at most nodes,
    the rest from ``hot`` - 1 others; nine nodes in ten on side 0).
    Returns numpy (pp_val, pp_seen, prepared, committed, honest, bcast,
    side, extra, f)."""
    f = (N - 1) // 3
    pp_val = np.where(g.random((B, N, S)) < 0.75, 0,
                      g.integers(1, hot, (B, N, S))).astype(np.int32)
    pp_seen = g.random((B, N, S)) < 0.85
    prepared = pp_seen & (g.random((B, N, S)) < 0.3)
    committed = prepared & (g.random((B, N, S)) < 0.3)
    honest = np.broadcast_to(np.arange(N) < N - nb, (B, N)).copy()
    bcast = g.random((B, N)) < 0.85
    side = (g.random((B, N)) < 0.1).astype(np.int64)
    extra = g.integers(0, nb + 1, (B, N)).astype(np.int32)
    return pp_val, pp_seen, prepared, committed, honest, bcast, side, extra, f


def kernel_tally(pp_val, pp_seen, prepared, committed, honest, bcast, side,
                 extra, q, m, rng=None):
    """Kernel KU's BYZ instance for one lane in numpy: per phase and (slot,
    side) the candidates of the honest broadcasting senders, their exact
    counts, then each node's lookup plus its own vote where honest and
    silent, plus its ``extra``. Returns (prepared2, commit_now)."""
    N, S = pp_val.shape
    hb = honest & bcast
    prepared2 = prepared.copy()
    commit_now = np.zeros_like(committed)
    for phase in (4, 5):
        rel = pp_seen if phase == 4 else prepared2
        for s in range(S):
            cands = kernel_candidates(pp_val[:, s], hb & rel[:, s], side, m,
                                      4, 5, rng)
            exact = {sd: {k: int(np.sum(hb & rel[:, s] & (side == sd)
                                        & (pp_val[:, s] == k)))
                          for k in cands[sd]} for sd in (0, 1)}
            cnt = np.array([exact[side[j]].get(int(pp_val[j, s]), 0)
                            + int(honest[j] and not bcast[j] and rel[j, s])
                            + int(extra[j]) for j in range(N)])
            if phase == 4:
                prepared2[:, s] |= pp_seen[:, s] & (cnt >= q)
            else:
                commit_now[:, s] = prepared2[:, s] & (cnt >= q) & \
                    ~committed[:, s]
    return prepared2, commit_now


@pytest.mark.parametrize("f,nb,hot", [(1, 1, 3), (2, 2, 3), (3, 3, 4),
                                      (4, 2, 3)])
def test_tallies_with_extra_match_jax_and_the_kernel_model(f, nb, hot):
    """Honest senders and ``extra`` at the JAX package's width (4 at f =
    nb = 1: every value of a slot; 3 at nb = f >= 2): the plain tallies
    decide as ``_aggregate_tallies`` does with ``extra`` (partitions on),
    and the numpy model of KU's candidates and recount decides as the
    plain tallies do, in the kernel's merge order and shuffled."""
    g = np.random.default_rng(10 * f + nb)
    B, N, S = 4, 3 * f + 1, 6
    pp_val, pp_seen, prepared, committed, honest, bcast, side, extra, _ = \
        tally_inputs(g, B, N, S, nb, hot)
    m = tb.table_width(N, f, nb)
    assert m == jbcast._table_width(N, f, nb)
    T = torch.from_numpy
    got = tb.aggregate_tallies_plain(
        T(pp_val), T(pp_seen), T(prepared), T(committed), T(honest),
        T(bcast), T(np.full(B, 2 * f + 1, np.int32)), m, T(side),
        extra=T(extra))
    hits = 0
    for b in range(B):
        want = jbcast._aggregate_tallies(
            jnp.asarray(pp_val[b]), jnp.asarray(pp_seen[b]),
            jnp.asarray(prepared[b]), jnp.asarray(committed[b]),
            jnp.asarray(honest[b]), jnp.asarray(bcast[b]),
            jnp.int32(2 * f + 1), m, side=jnp.asarray(side[b]),
            part_active=jnp.asarray(True), extra=jnp.asarray(extra[b]))
        for k in range(4):
            assert np.array_equal(got[k][b].numpy(), np.asarray(want[k])), \
                (b, k)
        hits += int(np.asarray(want[0]).sum())
        for order in (None, np.random.default_rng(b)):
            p2, now = kernel_tally(pp_val[b], pp_seen[b], prepared[b],
                                   committed[b], honest[b], bcast[b],
                                   side[b], extra[b], 2 * f + 1, m, order)
            assert np.array_equal(p2, got[1][b].numpy()), b
            assert np.array_equal(now, got[2][b].numpy()), b
    assert hits > 0


def test_four_values_at_the_threshold_at_f1():
    """f = nb = 1 (the width 4 of every f = 1 lane of an equivocating
    ladder): each of a slot's four nodes holds its own value, so the slot
    has four distinct values, two of them with one honest sender; every
    one of them is in a table of four. With ``extra`` 1 no node reaches
    Q = 3; with 2 each honest node does (its value's sender or its own
    vote, and the extra), the byzantine one (no own vote) does not."""
    N, S = 4, 4
    pp_val = np.tile(np.arange(N, dtype=np.int32)[:, None] * 7, (1, S))[None]
    pp_seen = np.ones((1, N, S), bool)
    no = np.zeros((1, N, S), bool)
    honest = (np.arange(N) < 3)[None]
    bcast = np.array([[True, False, True, True]])
    extra = np.array([[1, 1, 0, 1]], np.int32)
    T = torch.from_numpy
    bits = T((bcast.astype(np.uint8)))
    got = tb.bcast_tally_plain(4, T(np.array([4], np.int32)),
                               T(np.array([1], np.int32)), bits, T(pp_seen),
                               T(pp_val), T(no), T(no), T(pp_val * 0),
                               False, (1, T(extra)))[0][0].numpy()
    # 0: its own broadcast (1) + extra 1 < 3; 1: own vote + extra = 2; 2:
    # extra 0; 3: byzantine, its broadcast does not count, extra 1.
    assert not got.any()
    extra[0] = [2, 2, 2, 2]
    got = tb.bcast_tally_plain(4, T(np.array([4], np.int32)),
                               T(np.array([1], np.int32)), bits, T(pp_seen),
                               T(pp_val), T(no), T(no), T(pp_val * 0),
                               False, (1, T(extra)))[0][0].numpy()
    assert got[:3].all() and not got[3].any()
    p2, _ = kernel_tally(pp_val[0], pp_seen[0], no[0], no[0], honest[0],
                         bcast[0], np.zeros(N, np.int64), extra[0], 3, 4)
    assert np.array_equal(p2, got)


# --- table widths, the gates, the round's launches -----------------------------

def test_table_cap_matches_jax():
    """``table_cap`` is ``_table_width`` with eb = n_byzantine under
    equivocation (else 0), and on a ladder ``_fsweep_static``'s
    ``m_cap``."""
    for f in range(0, 7):
        for nb in range(0, f + 1):
            for mode in ("silent", "equivocate"):
                kw = dict(protocol="pbft", fault_model="bcast", f=f,
                          n_nodes=3 * f + 1, n_byzantine=nb, byz_mode=mode)
                eb = nb if mode == "equivocate" else 0
                assert tb.table_cap(Config(**kw)) == \
                    jbcast._table_width(3 * f + 1, f, eb)
    assert tb.table_width(4, 1, 1) == 4 and tb.table_width(7, 2, 2) == 3
    for fs, nb in (([1, 2, 3], 1), ([2, 5], 2), ([8, 16], 8),
                   ([8333, 16666, 33333], 8333)):
        for mode in ("silent", "equivocate"):
            kw = dict(protocol="pbft", fault_model="bcast", f=1, n_nodes=4,
                      n_byzantine=1, byz_mode=mode)
            base = {**kw, "f": min(fs), "n_nodes": 3 * min(fs) + 1,
                    "n_byzantine": nb}
            fs_, cfg_pad = pbft_sweep._fsweep_static(Config(**base), fs)
            assert tb.table_cap(cfg_pad, fs_) == \
                jsweep._fsweep_static(JConfig(**base), fs)[2]


@pytest.mark.parametrize("rungs", [None, (1, 2, 4)])
def test_the_width_reaching_ku_is_jax(rungs, monkeypatch):
    """The m that the round hands kernel KU is the JAX package's width:
    4 on a ladder with an f = 1 rung and one equivocator, 3 standalone at
    nb = f = 2."""
    seen = []
    fn = tb.bcast_tally

    def record(m, *args):
        seen.append(m)
        return fn(m, *args)
    monkeypatch.setattr(tb, "bcast_tally", record)
    kw = dict(protocol="pbft", fault_model="bcast", f=2, n_nodes=7,
              n_rounds=3, log_capacity=4, n_byzantine=1 if rungs else 2,
              byz_mode="equivocate")
    cfg = Config(**kw)
    if rungs:
        pbft_sweep.pbft_fsweep_run(cfg, rungs, device="cpu")
        want = jsweep._fsweep_static(JConfig(**kw), rungs)[2]
    else:
        runner.run(cfg, device="cpu")
        want = jbcast._table_width(7, 2, 2)
    assert seen == [want] * 3 and want == (4 if rungs else 3)


@pytest.mark.parametrize("mode", ["silent", "equivocate"])
def test_no_byzantine_node_is_digest_neutral(mode):
    """n_byzantine = 0 runs the flat round whatever byz_mode says, with no
    KAK call."""
    kw = dict(protocol="pbft", fault_model="bcast", f=2, n_nodes=7,
              n_rounds=24, log_capacity=16, n_sweeps=2, seed=5,
              drop_rate=0.2, partition_rate=0.2, byz_mode=mode)
    cfg = Config(**kw)
    assert cfg.byz == 0 and tb.table_cap(cfg) == 1
    got = simulator.run(cfg, device="cpu")
    assert got.payload == simulator.run(
        dataclasses.replace(cfg, byz_mode="silent"), device="cpu").payload
    assert got.payload == jsim.run(JConfig(**kw, engine="cpu"),
                                   warmup=False).payload


@pytest.mark.parametrize("mode", ["silent", "equivocate", None])
def test_kak_runs_only_under_equivocation(mode, monkeypatch):
    """The round calls KAK once a round under equivocation, and never in
    silent mode or without byzantine nodes; KT-KV once a round in all."""
    calls = dict.fromkeys(("bcast_view_preprepare", "bcast_tally",
                           "bcast_decide", "bcast_equiv_support"), 0)
    for name in calls:
        def call(*args, _fn=getattr(tb, name), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(tb, name, call)
    kw = dict(protocol="pbft", fault_model="bcast", f=2, n_nodes=7,
              n_rounds=5, log_capacity=8)
    if mode:
        kw.update(n_byzantine=2, byz_mode=mode)
    cfg = Config(**kw)
    runner.run(cfg, device="cpu")
    equiv = cfg.byz == BYZ_EQUIV
    assert calls == {"bcast_view_preprepare": 5, "bcast_tally": 5,
                     "bcast_decide": 5, "bcast_equiv_support": 5 * equiv}
