"""The port's SPEC §3c/§7c byzantine nodes on HotStuff against the JAX
package, on the CPU, and what the byzantine slice shares.

The ids from N - n_byzantine up are byzantine: "silent" ones neither
propose nor vote, "equivocate" ones propose two block variants, showing
each receiver one (its STREAM_EQUIV stance), and vote for both; an honest
node votes for the variant it was shown, and each variant needs its own
2f + 1 quorum (SPEC §7c). The same seeds go through ``consensus_tpu`` and
through the port's plain versions of kernels KAD-KAF; everything must be
equal, tolerance 0: the stance draw and the safety tail; whole runs at the
JAX package's own byzantine cases (``tests/test_hotstuff.py`` CFGS and
LOCKSTEP_CONFIGS but the switch case) against the JAX package and the C++
oracle, one of them certifying variant-1 blocks; runs with byzantine
nodes, a crash, a delay and a desync; the telemetry with 4-round windows;
one round from a converted JAX carry in each mode; P1's key over the
honest nodes; the fork table and the conflict count on built lane states
against a line-for-line transcription of the JAX round (no flat run can
fork: both variants' quorums would need 4f + 2 votes of at most 4f + 1);
KAA's safety tail on built states likewise; and the gates: n_byzantine = 0
is the flat round in both modes, and the CUDA graph's key holds both
knobs. The other engines are in ``tests/test_torch_byz_pbft.py`` and
``tests/test_torch_byz_raft*.py``.
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
from consensus_tpu.core import rng as jrng  # noqa: E402
from consensus_tpu.engines import hotstuff as jhs  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu.ops import adversary as jadv  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.core.config import BYZ_EQUIV  # noqa: E402
from consensus_tpu_torch.engines import hotstuff  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402
from consensus_tpu_torch.ops import adversary  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_hotstuff import CFGS as HOTSTUFF_CFGS  # noqa: E402
from test_hotstuff import LOCKSTEP_CONFIGS  # noqa: E402
from torch_byz_helpers import (  # noqa: E402
    one_round_from_jax, port, run_and_hold, same, telemetry_holds)


# --- the shared ops ----------------------------------------------------------

def test_stances_and_safety_counts_match_jax():
    """equiv_stance_plain is the JAX package's STREAM_EQUIV stance bit on
    every (round, src, dst); safety_counts_plain its safety_counts."""
    seeds = (0, 0xFFFFFFFF, 12345)
    seed = torch.tensor(seeds, dtype=torch.int64).to(torch.uint32)
    ids = torch.arange(40)
    for r in (0, 1, 200):
        got = adversary.equiv_stance_plain(seed, r, ids[None, :, None],
                                           ids[None, None, :])
        want = (jadv.draw(jnp.asarray(seeds, jnp.uint32)[:, None, None],
                          jrng.STREAM_EQUIV, jnp.uint32(r),
                          jnp.arange(40, dtype=jnp.uint32)[None, :, None],
                          jnp.arange(40, dtype=jnp.uint32)[None, None, :])
                & 1).astype(bool)
        assert np.array_equal(got.numpy(), np.asarray(want))
    gen = np.random.default_rng(3)
    forked = gen.random((4, 9)) < 0.3
    conflicts = gen.random((4, 9)) < 0.2
    conflicts[0] = False
    got = adversary.safety_counts_plain(torch.from_numpy(forked),
                                        torch.from_numpy(conflicts))
    for b in range(4):
        want = [int(x) for x in jadv.safety_counts(forked[b], conflicts[b])]
        assert got[b].tolist() == want


# --- whole runs --------------------------------------------------------------

# tests/test_hotstuff.py:28 and :43, and :196-199 (LOCKSTEP_CONFIGS's
# byzantine cases but the switch one); "byz-equiv" certifies variant-1
# blocks (chain_vid = 1 at 34 heights over its lanes).
HOTSTUFF_BYZ = {"silent-n31": HOTSTUFF_CFGS[3],
                "composed-n31": HOTSTUFF_CFGS[6],
                **{t: c for t, c in LOCKSTEP_CONFIGS
                   if c.n_byzantine > 0 and c.net_model == "flat"}}


@pytest.mark.parametrize("name", list(HOTSTUFF_BYZ))
def test_run_matches_jax_and_the_oracle(name):
    run_and_hold(HOTSTUFF_BYZ[name], name)


def test_variant_one_blocks_are_certified():
    """The byz-equiv case's carry certifies variant-1 blocks (chain_vid =
    1), as the JAX carry does, and its decided values are theirs."""
    jcfg = HOTSTUFF_BYZ["byz-equiv"]
    cfg = port(jcfg)
    eng = jsim.engine_def(jcfg)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    carry = jrunner._chunk_jit(jcfg, eng, jcfg.n_rounds, carry, jnp.int32(0))
    lanes = {k: v for k, v in runner.device_lanes(cfg, None, "cpu").items()
             if k != "seed"}
    st = runner.advance(cfg, hotstuff.hotstuff_init(
        cfg, torch.from_numpy(np.array(carry.seed))), 0, cfg.n_rounds,
        lanes=lanes)
    vid = np.asarray(carry.chain_vid)
    assert (vid == 1).sum() > 0
    assert np.array_equal(st.chain_vid.numpy(), vid)
    same(hotstuff.extract(st), jhs._extract(carry), "extract")


# Byzantine nodes, a crash, a delay and a desync together, in each mode.
COMPOSED = {
    "equivocate": dict(protocol="hotstuff", f=3, n_nodes=10, n_rounds=64,
                       log_capacity=64, n_sweeps=2, seed=67, n_byzantine=3,
                       byz_mode="equivocate", drop_rate=0.15,
                       crash_prob=0.08, recover_prob=0.3,
                       max_delay_rounds=2, desync_rate=0.1,
                       max_skew_rounds=3, view_timeout=4),
    "silent": dict(protocol="hotstuff", f=3, n_nodes=10, n_rounds=64,
                   log_capacity=64, n_sweeps=2, seed=71, n_byzantine=2,
                   drop_rate=0.15, crash_prob=0.08, recover_prob=0.3,
                   max_delay_rounds=2, desync_rate=0.1, max_skew_rounds=3,
                   view_timeout=4),
}


@pytest.mark.parametrize("name", list(COMPOSED))
def test_composed_run_matches_jax_and_the_oracle(name):
    run_and_hold(JConfig(**COMPOSED[name]), name)


# Telemetry with 4-round windows: the variant-1 case and the silent
# composed one.
TELEMETRY = {
    "equivocate": dict(dataclasses.asdict(HOTSTUFF_BYZ["byz-equiv"]),
                       n_rounds=32),
    "silent": {**COMPOSED["silent"], "n_rounds": 24},
}


@pytest.mark.parametrize("name", list(TELEMETRY))
def test_telemetry_matches_jax(name):
    telemetry_holds(TELEMETRY[name], name)


@pytest.mark.parametrize("name", ["silent-n31", "byz-equiv"])
def test_one_round_from_jax_state(name):
    one_round_from_jax(HOTSTUFF_BYZ[name], 21, name)


def test_p1_key_is_over_the_honest_nodes():
    """The lane's TOP word at rest is P1's key over the honest nodes (the
    JAX round's alive_h), as kernel KAF leaves it."""
    view = torch.tensor([[3, 9, 9, 4, 9], [1, 1, 0, 7, 7]], dtype=torch.int32)
    top = hotstuff.lane_at_rest(view, 3)[:, hotstuff.TOP]
    vm, m = hotstuff.gossiper(top, 5)
    assert vm.tolist() == [9, 1] and m.tolist() == [1, 0]
    assert torch.equal(hotstuff.lane_at_rest(view)[:, hotstuff.TOP],
                       hotstuff.p1_key(view))


# --- the fork table and the conflict count on built states -------------------

FORK_N, FORK_F, FORK_S, FORK_B = 13, 4, 16, 6


def _fork_case(seed: int):
    """A built HotStuff lane state at N = 13 under equivocation (4
    byzantine nodes): lanes whose preset vote words force, whatever this
    round's votes, a forked QC (lanes 0-1), a variant-1 QC alone (2-3) or
    no QC (4-5); random fork bits, heights and prefixes around the old
    commit, so that fork rows fall inside the prefixes' growth."""
    g = np.random.default_rng(seed)
    N, S, B = FORK_N, FORK_S, FORK_B
    Q = 2 * FORK_F + 1
    cfg = Config(protocol="hotstuff", f=FORK_F, n_nodes=N, n_rounds=64,
                 n_sweeps=B, log_capacity=S, seed=seed, drop_rate=0.2,
                 n_byzantine=FORK_F, byz_mode="equivocate")
    i32 = torch.int32
    view1 = torch.from_numpy(g.integers(8, 14, (B, N))).to(i32)
    lane = hotstuff.lane_at_rest(view1, cfg.n_honest)
    vstar = torch.from_numpy(g.integers(9, 14, B))
    vstar[1] = N - 1 + N          # a byzantine leader (L = 12)
    lane[:, hotstuff.VMAX] = vstar
    big, none = Q, -2 * N
    lane[:, hotstuff.VOTES] = torch.tensor([big, big, none, none, none, none])
    lane[:, hotstuff.VOTES1] = torch.tensor([big, big, big, big, none, none])
    regs = [torch.from_numpy(x).to(i32) for x in (
        g.integers(3, 6, B), g.integers(4, 9, B), g.integers(2, 3, B),
        g.integers(2, 4, B), g.integers(1, 2, B), g.integers(0, 2, B),
        g.integers(2, 7, B))]
    fnum = torch.from_numpy(g.integers(0, 9, B)).to(i32)
    fnum[0] = 8                   # a full table: the fork takes no row
    fork = (torch.from_numpy(g.integers(0, 2, (B, S))).to(i32),
            torch.from_numpy(g.integers(-1, 12, (B, 8))).to(i32),
            torch.from_numpy(g.integers(0, 9, (B, 8))).to(i32), fnum)
    learn = dict(adv=torch.from_numpy(g.random((B, N)) < 0.2),
                 timer=torch.from_numpy(g.integers(0, 9, (B, N))).to(i32),
                 clen=torch.from_numpy(g.integers(0, 6, (B, N))).to(i32),
                 fvec=torch.from_numpy(g.integers(0, 256, (B, N))).to(i32))
    seeds = torch.from_numpy(g.integers(0, 2**32, B)).to(torch.uint32)
    chain_v = torch.from_numpy(g.integers(-1, 9, (B, S))).to(i32)
    return cfg, seeds, view1, lane, regs, chain_v, fork, learn


def _transcribe(cfg, Q, vstar, h_next, cnt0, cnt1, chain_vid, ftab_v, ftab_h,
                fnum, fvec, deceived, clen, clen2):
    """consensus_tpu/engines/hotstuff.py lines 410-453 and 494-502 for one
    lane, line for line in numpy."""
    S = chain_vid.shape[0]
    exists = vstar >= 0
    qc0 = exists and cnt0 >= Q
    qc1 = exists and cnt1 >= Q
    qc = qc0 or qc1
    forked = qc0 and qc1
    vid = 0 if qc0 else 1
    chain_vid = np.where((np.arange(S) == h_next) & qc, vid, chain_vid)
    can = forked and fnum < hotstuff.FORK_TABLE
    hot = (np.arange(hotstuff.FORK_TABLE) == fnum) & can
    ftab_v = np.where(hot, vstar, ftab_v)
    ftab_h = np.where(hot, h_next, ftab_h)
    fbit = 1 << min(fnum, hotstuff.FORK_TABLE - 1)
    fvec = np.where(can & deceived, fvec | fbit, fvec)
    fnum = fnum + int(can)
    conf = 0
    for k in range(hotstuff.FORK_TABLE):
        inw = (k < fnum) & (ftab_h[k] >= clen) & (ftab_h[k] < clen2)
        conf += int(np.sum((((fvec >> k) & 1).astype(bool) & inw)))
    return qc, forked, chain_vid, ftab_v, ftab_h, fnum, fvec, conf


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fork_table_and_conflicts_on_built_states(seed):
    """KAE's and KAF's plain versions on built lanes: the QC, chain_vid,
    the fork table, the deceived nodes' fork bits and the safety tail equal
    the transcription of the JAX round; a forked QC takes a table row
    unless the table is full."""
    cfg, seeds, view1, lane, regs, chain_v, fork, learn = _fork_case(seed)
    Q = 2 * cfg.f + 1
    pre0 = lane[:, hotstuff.VOTES].clone()
    pre1 = lane[:, hotstuff.VOTES1].clone()
    before = [x.clone() for x in fork]
    fvec0, clen0 = learn["fvec"].clone(), learn["clen"]
    pdel, b1_v, b1_h, b2_v, b2_h, b3_v, b3_h, gcommit, deceived = \
        hotstuff.hotstuff_vote(cfg, seeds, 5, view1, lane, *regs, chain_v,
                               None, fork)
    # The round's own votes, from its delivery: an honest node votes for
    # the variant it was shown, a byzantine one for both.
    counted = int(lane[0, hotstuff.COUNTED])
    assert counted >= pre0[0] + pre1[0]
    t = torch.zeros((cfg.n_sweeps, len(hotstuff.HOTSTUFF_TELEMETRY)),
                    dtype=torch.int32)
    view, timer, clen = hotstuff.hotstuff_learn(
        cfg, 5, view1, pdel, learn["adv"], learn["timer"], clen0, lane,
        regs[6], b1_h, gcommit, t, None, None, None,
        (deceived, learn["fvec"], fork[2], fork[3]))
    col = hotstuff.HOTSTUFF_TELEMETRY.index("forked_qc")
    for b in range(cfg.n_sweeps):
        vstar = int(lane[b, hotstuff.VSTAR])
        h_next = int(regs[1][b]) + 1
        big0, big1 = int(pre0[b]) >= Q, int(pre1[b]) >= Q
        cnt0 = Q if big0 else -1
        cnt1 = Q if big1 else -1
        qc, forked, cvid, fv, fh, fn, fvec, conf = _transcribe(
            cfg, Q, vstar, h_next, cnt0, cnt1, before[0][b].numpy(),
            before[1][b].numpy(), before[2][b].numpy(),
            int(before[3][b]), fvec0[b].numpy(), deceived[b].numpy(),
            clen0[b].numpy(), clen[b].numpy())
        assert int(lane[b, hotstuff.QCF]) == int(qc) | (int(forked) << 1)
        assert np.array_equal(fork[0][b].numpy(), cvid)
        assert np.array_equal(fork[1][b].numpy(), fv)
        assert np.array_equal(fork[2][b].numpy(), fh)
        assert int(fork[3][b]) == fn
        assert np.array_equal(learn["fvec"][b].numpy(), fvec)
        assert t[b, col:col + 3].tolist() == [int(forked), conf, int(conf > 0)]
        assert int(b1_v[b]) == (vstar if qc else int(regs[0][b]))
    assert (t[:, col + 1] > 0).any() and (t[:, col] > 0).any()
    assert fork[3][0] == 8 and int(fork[3][1]) == int(before[3][1]) + 1
    # Deceived: honest, delivered, shown variant 1 by a byzantine leader.
    L = int(lane[1, hotstuff.VSTAR]) % cfg.n_nodes
    assert L >= cfg.n_honest
    ids = torch.arange(cfg.n_nodes)
    shown = adversary.equiv_stance_plain(seeds[1:2], 5,
                                         torch.tensor([[L]]), ids[None])[0]
    assert torch.equal(deceived[1], pdel[1] & (ids < cfg.n_honest) & shown)
    for b in range(cfg.n_sweeps):      # an honest leader deceives nobody
        if int(lane[b, hotstuff.VSTAR]) % cfg.n_nodes < cfg.n_honest:
            assert not deceived[b].any()


def _pbft_safety(pp_val, commit_now, cm, dval, honest):
    """consensus_tpu/engines/pbft.py lines 393-405 for one lane, in numpy:
    (forked slots, conflicting slots)."""
    imin, imax = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    nw = commit_now & honest[:, None]
    forked = nw.any(0) & (np.where(nw, pp_val, imin).max(0)
                          != np.where(nw, pp_val, imax).min(0))
    cm = cm & honest[:, None]
    conflicts = cm.any(0) & (np.where(cm, dval, imin).max(0)
                             != np.where(cm, dval, imax).min(0))
    return int(forked.sum()), int(conflicts.sum())


@pytest.mark.parametrize("crash", [False, True])
def test_pbft_safety_tail_on_built_states(crash):
    """KAA's plain version under equivocation counts forked_qc,
    conflict_commits and safety_violations as the JAX round's tail does,
    over the honest nodes of each lane (n_real < N on some), with a down
    node's committed flag and dval read after the freeze (at round
    entry)."""
    from consensus_tpu_torch.engines import pbft
    g = np.random.default_rng(11 + crash)
    B, N, S = 4, 10, 12
    cfg = Config(protocol="pbft", f=3, n_nodes=N, n_rounds=16, n_sweeps=B,
                 log_capacity=S, n_byzantine=2, byz_mode="equivocate")
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
                        pbft.CRASH_VIEWS if crash else 0,
                        (pp_val, dval_in, dval))
    col = pbft.PBFT_TELEMETRY.index("forked_qc")
    fz = down.numpy()[:, :, None]
    for b in range(B):
        honest = np.arange(N) < int(n_real[b]) - cfg.n_byzantine
        nf, nc = _pbft_safety(
            pp_val[b].numpy(), (tallied & ~committed_in)[b].numpy(),
            np.where(fz[b], committed_in[b], committed[b]),
            np.where(fz[b], dval_in[b], dval[b]), honest)
        assert t[b, col:col + 3].tolist() == [nf, nc, int(nc > 0)], b
    assert (t[:, col] > 0).any() and (t[:, col + 1] > 0).any()


# --- the gates ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["silent", "equivocate"])
@pytest.mark.parametrize("protocol", ["pbft", "hotstuff"])
def test_no_byzantine_node_is_digest_neutral(protocol, mode):
    """n_byzantine = 0 runs the flat round whatever byz_mode says."""
    kw = dict(protocol=protocol, f=2, n_nodes=7, n_rounds=24,
              log_capacity=16, n_sweeps=2, seed=5, drop_rate=0.2,
              byz_mode=mode)
    cfg = Config(**kw)
    assert cfg.byz == 0
    got = simulator.run(cfg, device="cpu")
    assert got.payload == simulator.run(
        dataclasses.replace(cfg, byz_mode="silent"), device="cpu").payload
    assert got.payload == jsim.run(JConfig(**kw, engine="cpu"),
                                   warmup=False).payload


def test_the_graph_key_holds_both_byzantine_knobs():
    """A CUDA graph is cached per config but its seed, so runs that differ
    in their byzantine count or mode never share one."""
    a = Config(**COMPOSED["equivocate"])
    dev = torch.device("cpu")
    assert a.byz == BYZ_EQUIV
    for b in (dataclasses.replace(a, n_byzantine=2),
              dataclasses.replace(a, byz_mode="silent")):
        assert runner._graph_key(a, dev, False, None) != \
            runner._graph_key(b, dev, False, None)
    assert runner._graph_key(a, dev, False, None) == \
        runner._graph_key(dataclasses.replace(a, seed=5), dev, False, None)
