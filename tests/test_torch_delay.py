"""The port's SPEC §A.2 delayed retransmission (``max_delay_rounds``)
against the JAX package, on the CPU.

A flight dropped on edge i -> j at round q = r - d, d in 1..D, arrives at
round r when its retransmission draw survives the drop cutoff
(``consensus_tpu/ops/adversary.py`` ``delayed_open``). The same seeds go
through ``consensus_tpu`` and through the port's plain versions; everything
must be equal, tolerance 0: the retransmission draw and the OR-term on
edge ids that include 0 and 0xFFFFFFFF, rounds under and over D and the
extreme seeds; each mask the term enters (KL's, KB's, the §6b per-sender
flag of KT, the DPoS producer row of KX and the HotStuff rows and votes of
KAD and KAE); whole runs of every engine path with drops, partitions and
churn (digest, and telemetry counters and recorder where the engine has
them), against the C++ oracle where it covers the config; and a delay
without drops changes nothing.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.core import rng as jrng  # noqa: E402
from consensus_tpu.engines import dpos as jdpos  # noqa: E402
from consensus_tpu.engines import pbft_sweep as jsweep  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu.ops import adversary as jadv  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.core import rng  # noqa: E402
from consensus_tpu_torch.engines import dpos, hotstuff  # noqa: E402
from consensus_tpu_torch.engines import pbft_bcast, pbft_sweep  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402
from consensus_tpu_torch.ops import adversary  # noqa: E402

SEEDS = np.array([0, 0xFFFFFFFF, 12345], np.uint32)
EDGES = np.array([0, 1, 2, 6, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                  0xFFFFFFFF], np.uint32)
STORM = Config(drop_rate=0.55).drop_cutoff      # delay-storm's drop rate


def _u32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


# --- the draw and the OR-term --------------------------------------------------

def test_delay_draw_matches_jax():
    s, q, d, i, j = np.meshgrid(SEEDS, EDGES[:4], np.array([1, 8, 16],
                                                           np.uint32),
                                EDGES, EDGES, indexing="ij")
    want = jrng.delay_u32_np(s, q, d, i, j)
    got = rng.delay_u32_plain(_u32(s), _u32(q), _u32(d), _u32(i), _u32(j))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert rng.STREAM_DELAY == int(jrng.STREAM_DELAY)


@pytest.mark.parametrize("D", [1, 4, 16])
@pytest.mark.parametrize("at", ["0", "1", "D-1", "D", "200"])
def test_delayed_open_matches_jax(D, at):
    r = {"0": 0, "1": 1, "D-1": D - 1, "D": D, "200": 200}[at]
    gen = np.random.default_rng(D * 1000 + r)
    i = np.concatenate([EDGES, gen.integers(0, 2**32, 120, np.uint64)
                        .astype(np.uint32)])
    j = np.concatenate([EDGES[::-1], gen.integers(0, 2**32, 120, np.uint64)
                        .astype(np.uint32)])
    opened = 0
    for seed in SEEDS:
        for cut in (STORM, Config(drop_rate=0.99).drop_cutoff):
            want = np.asarray(jadv.delayed_open(
                jnp.uint32(seed), jnp.uint32(r), jnp.asarray(i),
                jnp.asarray(j), cut, D))
            got = adversary.delayed_open_plain(_u32([seed]), r, _u32(i),
                                               _u32(j), cut, D)
            assert np.array_equal(got.numpy(), want), (seed, cut)
            opened += int(want.sum())
    assert (opened > 0) == (r > 0)


# --- the masks the term enters -------------------------------------------------

@pytest.mark.parametrize("D", [1, 8, 16])
@pytest.mark.parametrize("r", [0, 3, 20])
def test_delivery_masks_match_jax(D, r):
    """KL's [N, N] mask and KB's edge masks (negative ids included)."""
    n, drop, part = 37, STORM, Config(partition_rate=0.5).partition_cutoff
    seeds = torch.from_numpy(SEEDS)
    got = adversary.delivery_plain(seeds, r, n, drop, part, D).numpy()
    ids = torch.tensor([[0, 5, -1, 36], [36, 2, 2, -3], [1, -1, 7, 0]],
                       dtype=torch.int32)
    src = adversary.delivery_edges_plain(seeds, r, ids, n, drop, part, True,
                                         D).numpy()
    dst = adversary.delivery_edges_plain(seeds, r, ids, n, drop, part, False,
                                         D).numpy()
    nodes = jnp.arange(n, dtype=jnp.int32)
    for b, s in enumerate(SEEDS):
        want = np.asarray(jadv.delivery(jnp.uint32(s), n, jnp.uint32(r),
                                        drop, part, D))
        assert np.array_equal(got[b], want)
        a = jnp.asarray(ids[b].numpy())
        assert np.array_equal(src[b], np.asarray(jadv.delivery_edges(
            jnp.uint32(s), jnp.uint32(r), a[:, None], nodes[None, :], drop,
            part, D)))
        assert np.array_equal(dst[b], np.asarray(jadv.delivery_edges(
            jnp.uint32(s), jnp.uint32(r), nodes[:, None], a[None, :], drop,
            part, D)))
    if r > 0:
        flat = adversary.delivery_plain(seeds, r, n, drop, part)
        assert (torch.from_numpy(got) & ~flat).any()


@pytest.mark.parametrize("D", [1, 8, 16])
def test_bcast_flag_matches_jax(D):
    """KT's per-sender flag: the self-edge key (i, i), real nodes only
    (``pbft_bcast.py:381-386``, ``pbft_sweep.py:316-321``)."""
    cfg = Config(protocol="pbft", fault_model="bcast", f=13, n_nodes=40,
                 drop_rate=0.55, partition_rate=0.5, max_delay_rounds=D)
    n_real = torch.tensor([40, 31, 4], dtype=torch.int32)
    uidx = jnp.arange(40, dtype=jnp.uint32)
    for r in (0, 3, D, 20):
        bits = pbft_bcast.node_bits(cfg, torch.from_numpy(SEEDS), r, n_real)
        for b, s in enumerate(SEEDS):
            seed, ur = jnp.uint32(s), jnp.uint32(r)
            want = (jrng.delivery_u32_jnp(seed, ur, uidx, uidx)
                    >= jadv.cutoff(cfg.drop_cutoff)) | jadv.delayed_open(
                        seed, ur, uidx, uidx, cfg.drop_cutoff, D)
            want = np.asarray(want) & (np.arange(40) < int(n_real[b]))
            assert np.array_equal((bits[b] & 1).numpy().astype(bool), want)


@pytest.mark.parametrize("D", [1, 8, 16])
def test_dpos_row_matches_jax(D):
    """KX's producer row: every validator the round's block reaches
    appends, on an empty chain and without churn."""
    kw = dict(protocol="dpos", n_nodes=300, n_candidates=20, n_producers=5,
              epoch_len=8, n_rounds=40, log_capacity=4, drop_rate=0.55,
              partition_rate=0.5, max_delay_rounds=D)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    seeds = torch.from_numpy(SEEDS)
    st = dpos.dpos_init(cfg, seeds)
    v = np.arange(300)
    for r in (0, 2, D, 33):
        _, _, chain_len = dpos.dpos_round_plain(
            cfg, seeds, r, st.producers, st.chain_r.clone(),
            st.chain_p.clone(), torch.zeros_like(st.chain_len))
        p = dpos.round_producer(cfg, st.producers, r)
        for b, s in enumerate(SEEDS):
            want = np.asarray(jdpos._producer_delivery(
                jcfg, jnp.uint32(s), r, jnp.int32(int(p[b])))) \
                | (v == int(p[b]))
            assert np.array_equal(chain_len[b].numpy().astype(bool), want)


@pytest.mark.parametrize("D", [1, 8, 16])
def test_hotstuff_rows_match_jax(D):
    """KAD's and KAE's broadcast rows (src, j) (``hotstuff.py:243-256``)
    and KAE's votes on the reverse edge (j, L) (``:303-309``), counted
    by the plain KAE."""
    N = 61
    cfg = Config(protocol="hotstuff", f=20, n_nodes=N, drop_rate=0.55,
                 partition_rate=0.5, max_delay_rounds=D)
    seeds = torch.from_numpy(SEEDS)
    uidx = jnp.arange(N, dtype=jnp.uint32)
    gen = torch.Generator().manual_seed(D)
    for r in (0, 2, D, 20):
        src = torch.tensor([0, 60, 17])
        got = hotstuff._open_from(cfg, seeds, r, src, N).numpy()
        view1 = torch.randint(0, 4 * N, (3, N), generator=gen,
                              dtype=torch.int32)
        lane = hotstuff.lane_at_rest(view1)
        lane[:, hotstuff.VMAX] = torch.tensor([-1, 3 * N + 5, 2 * N])
        zeros = torch.zeros(3, dtype=torch.int32)
        hotstuff.hotstuff_vote_plain(
            cfg, seeds, r, view1, lane, *(zeros.clone() for _ in range(7)),
            torch.zeros((3, cfg.log_capacity), dtype=torch.int32))
        for b, s in enumerate(SEEDS):
            seed, ur = jnp.uint32(s), jnp.uint32(r)
            part = jadv.draw(seed, jrng.STREAM_PARTITION, ur, 0, 0) \
                < jadv.cutoff(cfg.partition_cutoff)
            side = jadv.draw(seed, jrng.STREAM_PARTITION, ur, 1, uidx) & 1

            def bcast_open(u, seed=seed, ur=ur, part=part, side=side):
                o = ~(jrng.delivery_u32_jnp(seed, ur, u, uidx)
                      < jadv.cutoff(cfg.drop_cutoff))
                o |= jadv.delayed_open(seed, ur, u, uidx, cfg.drop_cutoff, D)
                side_s = jadv.draw(seed, jrng.STREAM_PARTITION, ur, 1, u) & 1
                return o & ((side == side_s) | ~part)

            assert np.array_equal(got[b], np.asarray(
                bcast_open(jnp.uint32(int(src[b])))))
            vstar = [-1, 3 * N + 5, 2 * N][b]
            L = vstar % N if vstar >= 0 else 0
            uL = jnp.uint32(L)
            open_v = ~(jrng.delivery_u32_jnp(seed, ur, uidx, uL)
                       < jadv.cutoff(cfg.drop_cutoff)) | jadv.delayed_open(
                           seed, ur, uidx, uL, cfg.drop_cutoff, D)
            is_l = np.arange(N) == L
            pdel = (vstar >= 0) & (is_l | np.asarray(bcast_open(uL))) \
                & (view1[b].numpy() <= vstar)
            votes = int((pdel & (is_l | np.asarray(open_v))).sum())
            assert int(lane[b, hotstuff.COUNTED]) == votes


# --- whole runs ------------------------------------------------------------------

W = 6
# tests/test_adversary_lib.py DELAY's knobs at delay-storm's drop rate.
HOSTILE = dict(drop_rate=0.55, partition_rate=0.1, churn_rate=0.05,
               max_delay_rounds=4)
# One case a path, after tests/test_adversary_lib.py CFGS and DELAY:
# (config, whether the C++ oracle covers it, the ladder's rungs or None).
# The standalone cases but raft-dense-d16 run with telemetry and W-round
# windows (a ladder has none).
RUNS = {
    "raft-dense": (dict(protocol="raft", n_nodes=9, n_rounds=40,
                        n_sweeps=2, log_capacity=16, max_entries=12,
                        seed=5), True, None),
    "raft-dense-d16": (dict(protocol="raft", n_nodes=7, n_rounds=32,
                            n_sweeps=2, log_capacity=16, max_entries=12,
                            seed=9, drop_rate=0.3, max_delay_rounds=16),
                       True, None),
    "raft-capped": (dict(protocol="raft", n_nodes=48, max_active=4,
                         n_rounds=32, n_sweeps=2, log_capacity=16,
                         max_entries=12, seed=5), True, None),
    "pbft": (dict(protocol="pbft", f=4, n_nodes=13, n_rounds=48,
                  n_sweeps=2, log_capacity=8, seed=5), True, None),
    "pbft-bcast": (dict(protocol="pbft", fault_model="bcast", f=33,
                        n_nodes=100, n_rounds=48, n_sweeps=2,
                        log_capacity=8, seed=5), True, None),
    "pbft-ladder": (dict(protocol="pbft", f=1, n_nodes=4, n_rounds=32,
                         log_capacity=8, seed=3), False, (1, 2, 5)),
    "bcast-ladder": (dict(protocol="pbft", fault_model="bcast", f=1,
                          n_nodes=4, n_rounds=32, log_capacity=8, seed=7),
                     False, (1, 4, 10)),
    "paxos": (dict(protocol="paxos", n_nodes=24, n_rounds=32, n_sweeps=2,
                   log_capacity=16, n_proposers=6, seed=5), True, None),
    "dpos": (dict(protocol="dpos", n_nodes=96, n_rounds=48,
                  log_capacity=48, n_candidates=24, n_producers=5,
                  epoch_len=8, n_sweeps=2, seed=5), True, None),
    "hotstuff": (dict(protocol="hotstuff", f=10, n_nodes=31, n_rounds=48,
                      n_sweeps=2, log_capacity=32, view_timeout=4, seed=7),
                 True, None),
}


def _kw(case, **over) -> dict:
    return {**HOSTILE, **RUNS[case][0], **over}


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


@pytest.mark.parametrize("case", list(RUNS))
def test_whole_run_matches_jax_and_the_oracle(case):
    _, oracle, rungs = RUNS[case]
    if rungs is not None:
        kw = _kw(case)
        want = jsweep.pbft_fsweep_run(JConfig(**kw), rungs)
        got = pbft_sweep.pbft_fsweep_run(Config(**kw), rungs, device="cpu")
        assert pbft_sweep.rung_payloads(got) == jsweep.rung_payloads(want)
        flat = pbft_sweep.pbft_fsweep_run(
            Config(**_kw(case, max_delay_rounds=0)), rungs, device="cpu")
        assert pbft_sweep.fsweep_payload(flat) != \
            pbft_sweep.fsweep_payload(got)
        return
    telemetry = case != "raft-dense-d16"
    kw = _kw(case, telemetry_window=W if telemetry else 0)
    want = jsim.run(JConfig(**kw), warmup=False, telemetry=telemetry)
    payload, stats = _port(Config(**kw), telemetry)
    assert payload == want.payload
    if telemetry:
        _same(stats["telemetry"], want.extras["telemetry"]["per_sweep"],
              "telemetry")
        _same(stats["flight"], {k: v for k, v in want.extras["flight"]
                                .items() if k != "engine"}, "flight")
    if oracle:
        cpu = jsim.run(JConfig(**_kw(case), engine="cpu"), warmup=False)
        assert cpu.payload == payload
    # The delay moved the run: its decided logs or its counters differ
    # from the flat run's (PBFT commits the same values either way).
    flat, flat_stats = _port(Config(**{**kw, "max_delay_rounds": 0}),
                             telemetry)
    assert flat != payload or any(
        not np.array_equal(flat_stats["telemetry"][k], v)
        for k, v in stats["telemetry"].items())


@pytest.mark.parametrize("case", list(RUNS))
def test_delay_without_drops_is_identity(case):
    """A retransmission repairs a drop; with drop_rate = 0 no flight is
    dropped, so any delay gives the D = 0 run (after
    ``tests/test_adversary_lib.py:91-101``), here over 16 rounds."""
    _, _, rungs = RUNS[case]

    def payload(d):
        cfg = Config(**_kw(case, drop_rate=0.0, max_delay_rounds=d,
                           n_rounds=16))
        if rungs is not None:
            return pbft_sweep.fsweep_payload(pbft_sweep.pbft_fsweep_run(
                cfg, rungs, device="cpu"))
        return _port(cfg, False)[0]

    assert payload(8) == payload(0)


def test_the_graph_key_holds_the_delay():
    """A CUDA graph is cached per config but its seed, so runs that differ
    in their delay never share one."""
    a = Config(**_kw("pbft"))
    b = dataclasses.replace(a, max_delay_rounds=2)
    c = dataclasses.replace(a, seed=99)
    dev = torch.device("cpu")
    assert runner._graph_key(a, dev, False, None) != \
        runner._graph_key(b, dev, False, None)
    assert runner._graph_key(a, dev, False, None) == \
        runner._graph_key(c, dev, False, None)
