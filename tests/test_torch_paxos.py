"""The port's multi-decree Paxos engine against the JAX package, on the CPU.

``Config(protocol="paxos")`` selects the SPEC §5 engine
(``consensus_tpu_torch/engines/paxos.py``). The same seeds go through
``consensus_tpu`` and through the port's plain versions; everything must be
equal, tolerance 0: whole runs (digest and every extract leaf) at
``tests/test_paxos.py``'s configs and at paxos-10kx10k's knobs cut to N = S
= 256, one round from a converted JAX carry and from random states
(accepted ballots tied across acceptors, slots several proposers pick,
outbid promises), numpy models of kernels KY and KZ (the packed
(ballot, -acceptor) key merged over row tiles; the proceeding proposers'
slot buckets, each (row, slot)'s walk of its bucket for the accept maximum
and the lowest decider, the blocks' counts) held against the plain
versions with their work taken in shuffled orders, also at a round whose
ballots pass 2^31, and
chip_smoke.py's hostile Paxos anchor made again by the JAX package.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.engines import paxos as jpaxos  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.engines import paxos  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402
from consensus_tpu_torch.ops.adversary import delivery  # noqa: E402

from helpers import run_cached  # noqa: E402

# tests/test_paxos.py's BASE and CFGS.
BASE = dict(protocol="paxos", n_nodes=7, n_rounds=64, log_capacity=16,
            n_sweeps=4, seed=555)
CFGS = {
    "base": BASE,
    "drops": {**BASE, "drop_rate": 0.25, "seed": 1},
    "partitions": {**BASE, "partition_rate": 0.3, "seed": 2},
    "churn": {**BASE, "churn_rate": 0.15, "seed": 3},
    "hostile9": {**BASE, "n_nodes": 9, "drop_rate": 0.3,
                 "partition_rate": 0.2, "churn_rate": 0.1, "n_rounds": 96,
                 "seed": 4},
    "proposers3": {**BASE, "n_proposers": 3, "drop_rate": 0.2, "seed": 5},
}
# paxos-10kx10k (benchmarks/run_benchmarks.py CONFIGS) cut to N = S = 256.
PAXOS_10K_CUT = dict(protocol="paxos", n_nodes=256, n_rounds=16,
                     n_sweeps=1, log_capacity=256, seed=4, drop_rate=0.01,
                     churn_rate=0.001)
LEAVES = ("learned_mask", "learned_val", "promised", "acc_bal", "acc_val")


# --- whole runs --------------------------------------------------------------

@pytest.mark.parametrize("name", [*CFGS, "paxos-10kx10k-cut"])
def test_whole_run_matches_jax(name):
    kw = PAXOS_10K_CUT if name == "paxos-10kx10k-cut" else CFGS[name]
    jcfg, cfg = JConfig(**kw), Config(**kw)
    assert jsim.engine_def(jcfg).name == simulator.engine_def(cfg).name
    want = jpaxos.paxos_run(jcfg)
    got = runner.run(cfg, device="cpu")
    assert set(got) == set(want) == set(LEAVES)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert simulator.decided_payload(cfg, got)[3] == \
        jsim.decided_payload(jcfg, want)[3]
    assert want["learned_mask"].any()


def test_simulator_front_door_matches_jax():
    kw = CFGS["hostile9"]
    res = simulator.run(Config(**kw), device="cpu")
    assert res.digest == run_cached(JConfig(**kw)).digest
    assert res.counts.shape == (4, 9) and "lib" not in res.extras


# --- one round from a converted JAX carry ------------------------------------

STEP_KW = {**CFGS["hostile9"], "n_proposers": 6, "log_capacity": 5}
STEPS = (0, 1, 15, 40)


def _leaves(st) -> dict:
    return {k: np.array(v) for k, v in st._asdict().items()}


@pytest.fixture(scope="module")
def jax_steps():
    """{k: (leaves before round k, leaves after it)} from JAX."""
    jcfg = JConfig(**STEP_KW)
    eng = jsim.engine_def(jcfg)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    out, r0 = {}, 0
    for k in STEPS:
        if k > r0:
            carry = jrunner._chunk_jit(jcfg, eng, k - r0, carry, jnp.int32(r0))
        before = _leaves(carry)
        carry = jrunner._chunk_jit(jcfg, eng, 1, carry, jnp.int32(k))
        out[k] = (before, _leaves(carry))
        r0 = k + 1
    return out


@pytest.mark.parametrize("k", STEPS)
def test_one_round_from_jax_state(jax_steps, k):
    before, after = jax_steps[k]
    st = convert.state_from_numpy(before)
    assert isinstance(st, paxos.PaxosState)
    got = convert.state_to_numpy(paxos.paxos_round(Config(**STEP_KW), st, k))
    assert set(got) == set(after)
    for name in after:
        assert got[name].dtype == after[name].dtype, name
        assert np.array_equal(got[name], after[name]), name


# --- one round from random states --------------------------------------------

def random_state(g, B, N, S, r, hi=None):
    """A batched PaxosState as numpy leaves: accepted ballots from a small
    set (ties across acceptors), promises around round r's ballots (below
    ``hi``, by default the round's last ballot + 1: some outbid them),
    accepted values from a small set, half the slots learned."""
    hi = (r + 1) * N + 1 if hi is None else hi
    return {"seed": np.arange(70, 70 + B, dtype=np.uint32),
            "promised": g.integers(0, hi, (B, N, S)).astype(np.int32),
            "acc_bal": g.choice(np.array([0, 3, 5, hi], np.int32),
                                (B, N, S)),
            "acc_val": g.integers(-3, 3, (B, N, S)).astype(np.int32),
            "learned_val": g.integers(-9, 9, (B, N, S)).astype(np.int32),
            "learned_mask": g.random((B, N, S)) < 0.5,
            "down": np.zeros((B, N), bool)}


def _jax_round(jcfg):
    fn = jax.vmap(lambda st, r: jpaxos.paxos_round(jcfg, st, r),
                  in_axes=(0, None))
    return jax.jit(fn)


RANDOM = {
    # Two slots for eleven proposers: every slot is contended.
    "contended": dict(protocol="paxos", n_nodes=11, log_capacity=2,
                      drop_rate=0.1),
    "proposers4": dict(protocol="paxos", n_nodes=13, n_proposers=4,
                       log_capacity=3, partition_rate=0.5),
    "lossy": dict(protocol="paxos", n_nodes=16, log_capacity=7,
                  drop_rate=0.4, churn_rate=0.2),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_one_round_from_random_states(name):
    kw = RANDOM[name]
    jcfg, cfg = JConfig(**kw), Config(**kw)
    g = np.random.default_rng(len(name))
    step = _jax_round(jcfg)
    for r in (0, 2, 9):
        leaves = random_state(g, 5, cfg.n_nodes, cfg.log_capacity, r)
        got = convert.state_to_numpy(paxos.paxos_round(
            cfg, convert.state_from_numpy(leaves), r))
        want = step(jpaxos.PaxosState(
            **{k: jnp.asarray(v) for k, v in leaves.items()}), jnp.int32(r))
        for k, a in want._asdict().items():
            a = np.asarray(a)
            assert got[k].dtype == a.dtype and np.array_equal(got[k], a), \
                (r, k)


# --- numpy models of kernels KY and KZ ---------------------------------------

TILE_ROWS = 64


def _pack(bal, a):
    """KY's 64-bit key: the ballot with its sign bit flipped, over the
    complement of the acceptor id, so that an unsigned maximum picks the
    largest ballot and, among equal ones, the lowest acceptor."""
    hi = (np.asarray(bal, np.int64).astype(np.uint32) ^ np.uint32(2**31))
    lo = np.uint32(0xFFFFFFFF) - np.asarray(a, np.uint32)
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _unpack(key):
    bal = ((key >> np.uint64(32)).astype(np.uint32) ^ np.uint32(2**31))
    a = np.uint32(0xFFFFFFFF) - (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return bal.astype(np.int32), a.astype(np.int32)


def _props(cfg, seed, r, N, S):
    is_prop, slot, ballot, v_own = paxos.proposals(
        cfg, torch.tensor([seed], dtype=torch.uint32), r, N, S)
    return (is_prop[0].numpy(), slot[0].numpy(), ballot[0].numpy(),
            v_own[0].numpy())


def promise_model(cfg, seed, r, D, promised, acc_bal, g):
    """KY on one lane: the row block's prepare maxima (proposers taken in a
    shuffled order), then tiles of TILE_ROWS acceptor rows, each merging
    its count and its best packed key into the proposer's, tiles in a
    shuffled order."""
    N, S = promised.shape
    is_prop, slot, ballot, _ = _props(cfg, seed, r, N, S)
    prep = D.T
    new_promised = np.empty_like(promised)
    for a in range(N):
        pm = np.zeros(S, np.int32)
        for p in g.permutation(N):
            if is_prop[p] and prep[a, p]:
                pm[slot[p]] = max(pm[slot[p]], ballot[p])
        new_promised[a] = np.maximum(promised[a], pm)
    n_prom = np.zeros(N, np.int32)
    keys = np.zeros(N, np.uint64)
    for a0 in g.permutation(np.arange(0, N, TILE_ROWS)):
        a = np.arange(a0, min(a0 + TILE_ROWS, N))[:, None]
        prom = (is_prop & prep[a[:, 0]] & D[a[:, 0]]
                & (ballot > promised[a, slot])
                & (ballot == new_promised[a, slot]))
        n_prom += prom.sum(0, dtype=np.int32)
        rep = np.where(prom, acc_bal[a, slot], 0)
        keys = np.maximum(keys, _pack(rep, a).max(0))
    best_bal, best_a = _unpack(keys)
    return new_promised, n_prom, best_bal, best_a


def accept_learn_model(cfg, seed, r, D, new_promised, n_prom, best_bal,
                       best_a, acc_bal, acc_val, learned_val, learned_mask,
                       g, blocks=3):
    """KZ on one lane, launch by launch. Launch 1: the gate, and the
    proceeding proposers' counting sort by slot, scattered in a shuffled
    order (the order inside a bucket is free). Launch 2: ``blocks`` blocks
    take acceptor rows j, j + blocks, ...; per (row, slot) the bucket's
    walk keeps the largest eligible ballot from 0 and its holder, and a
    winner's delivered response counts at its list position; the blocks'
    counts merge into n_acc in a shuffled order. Launch 3: the decided
    proposers by list position, then per (row, slot) the walk for the
    lowest decider that reached the row or is it. Returns the five leaves
    and (n_acc, decided)."""
    N, S = new_promised.shape
    maj = N // 2 + 1
    is_prop, slot, ballot, v_own = _props(cfg, seed, r, N, S)
    prep = D.T
    go = is_prop & (n_prom >= maj)
    value = np.where(best_bal > 0, acc_val[best_a, slot], v_own)
    starts = np.concatenate([[0], np.cumsum(np.bincount(slot[go],
                                                        minlength=S))])
    cursor = starts[:-1].copy()
    ids = np.empty(starts[-1], np.int64)
    for p in g.permutation(np.flatnonzero(go)):
        ids[cursor[slot[p]]] = p
        cursor[slot[p]] += 1
    bal_k, val_k = ballot[ids], value[ids]
    out = [np.empty_like(new_promised) for _ in range(3)]
    cnt = np.zeros((blocks, len(ids)), np.int32)
    for j in range(blocks):
        for a in range(j, N, blocks):
            for s in range(S):
                amax, best = 0, -1
                for k in range(starts[s], starts[s + 1]):
                    bal = bal_k[k]
                    if bal < new_promised[a, s] or bal < amax or (
                            bal == amax and best >= 0):
                        continue
                    if prep[a, ids[k]]:
                        amax, best = bal, k
                if best >= 0 and D[a, ids[best]]:
                    cnt[j, best] += 1
                has = amax > 0
                out[0][a, s] = amax if has else new_promised[a, s]
                out[1][a, s] = amax if has else acc_bal[a, s]
                out[2][a, s] = val_k[best] if has else acc_val[a, s]
    n_acc = np.zeros(N, np.int32)
    for j in g.permutation(blocks):
        np.add.at(n_acc, ids, cnt[j])
    dec = np.where(n_acc[ids] >= maj, ids, -1)
    lv, lm = learned_val.copy(), learned_mask.copy()
    for n in range(N):
        for s in range(S):
            low, at = N, -1
            for k in range(starts[s], starts[s + 1]):
                p = dec[k]
                if 0 <= p < low and (p == n or prep[n, p]):
                    low, at = p, k
            if at >= 0:
                lm[n, s] = True
                if not learned_mask[n, s]:
                    lv[n, s] = val_k[at]
    decided = (go & (n_acc >= maj)).astype(np.int32)
    return (*out, lv, lm), (n_acc, decided)


@pytest.mark.parametrize("name,N,S,r", [
    ("contended", 70, 3, 2), ("proposers4", 13, 2, 0), ("lossy", 130, 9, 5)])
def test_kernel_models_match_the_plain_versions(name, N, S, r):
    """On random states with accepted ballots tied across acceptors (and
    more than TILE_ROWS acceptors, so keys merge across tiles), the models
    of KY and KZ give the plain versions' outputs, leaf for leaf."""
    kw = {**RANDOM[name], "n_nodes": N, "log_capacity": S}
    cfg = Config(**kw)
    g = np.random.default_rng(N)
    leaves = random_state(g, 2, N, S, r)
    st = convert.state_from_numpy(leaves)
    deliver = delivery(st.seed, r, N, cfg.drop_cutoff, cfg.partition_cutoff)
    ky = paxos.paxos_promise(cfg, st.seed, r, deliver, st.promised,
                             st.acc_bal)
    kz = paxos.paxos_accept_learn(cfg, st.seed, r, deliver, ky[4], *ky[:4],
                                  st.acc_bal, st.acc_val, st.learned_val,
                                  st.learned_mask, True)
    ties = 0
    for b in range(2):
        D = deliver[b].numpy()
        seed = int(leaves["seed"][b])
        want = promise_model(cfg, seed, r, D, leaves["promised"][b],
                             leaves["acc_bal"][b], g)
        for got, w in zip(ky[:4], want):
            assert np.array_equal(got[b].numpy(), w)
        assert np.array_equal(ky[4][b].numpy(), D.T)
        want, counts = accept_learn_model(
            cfg, seed, r, D, *(t[b].numpy() for t in ky[:4]),
            *(leaves[k][b] for k in ("acc_bal", "acc_val", "learned_val",
                                     "learned_mask")), g)
        for got, w in zip(kz, want + counts):
            assert np.array_equal(got[b].numpy(), w)
        ties += int((ky[2][b] > 0).sum())
    assert ties > 0 and bool(kz[4].any())


def test_kernel_model_at_a_wrapping_round():
    """At round r = 2^31 // N the ballots r·N + p + 1 pass 2^31 within the
    round, so the largest ids hold the least (negative) ballots: the model
    of KZ equals the plain version, and the plain round equals JAX's
    paxos_round, every leaf."""
    kw = dict(protocol="paxos", n_nodes=70, log_capacity=5, drop_rate=0.1)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    N, S, r = 70, 5, 2**31 // 70
    g = np.random.default_rng(31)
    leaves = random_state(g, 2, N, S, r, hi=r * N)
    st = convert.state_from_numpy(leaves)
    _, _, ballot, _ = paxos.proposals(cfg, st.seed, r, N, S)
    assert int(ballot[0, 0]) > 0 > int(ballot[0, -1])
    deliver = delivery(st.seed, r, N, cfg.drop_cutoff, cfg.partition_cutoff)
    ky = paxos.paxos_promise(cfg, st.seed, r, deliver, st.promised,
                             st.acc_bal)
    kz = paxos.paxos_accept_learn(cfg, st.seed, r, deliver, ky[4], *ky[:4],
                                  st.acc_bal, st.acc_val, st.learned_val,
                                  st.learned_mask, True)
    for b in range(2):
        want, counts = accept_learn_model(
            cfg, int(leaves["seed"][b]), r, deliver[b].numpy(),
            *(t[b].numpy() for t in ky[:4]),
            *(leaves[k][b] for k in ("acc_bal", "acc_val", "learned_val",
                                     "learned_mask")), g)
        for got, w in zip(kz, want + counts):
            assert np.array_equal(got[b].numpy(), w)
    assert bool((kz[1] != st.acc_bal).any()) and int(kz[6].sum()) > 0
    got = convert.state_to_numpy(paxos.paxos_round(cfg, st, r))
    want = _jax_round(jcfg)(jpaxos.PaxosState(
        **{k: jnp.asarray(v) for k, v in leaves.items()}), jnp.int32(r))
    for k, a in want._asdict().items():
        a = np.asarray(a)
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k


def test_packed_key_breaks_ties_to_the_lowest_acceptor():
    bals = np.array([5, -7, 5, 2**31 - 1, -2**31, 0, 2**31 - 1], np.int32)
    for order in (range(7), reversed(range(7))):
        keys = np.zeros((), np.uint64)
        for a in order:
            keys = np.maximum(keys, _pack(bals[a], a))
        assert tuple(_unpack(keys)) == (2**31 - 1, 3)
    assert tuple(_unpack(_pack(np.int32(-2**31), 0))) == (-2**31, 0)
    assert _pack(0, 9) > _pack(-1, 0) and _pack(0, 1) > _pack(0, 2)


# --- chip_smoke.py's hostile anchor ------------------------------------------

def _smoke(name: str):
    """The constant ``name`` of the repo's chip_smoke.py, read by
    importing the script without running it."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return getattr(smoke, name)


def test_hostile_paxos_anchor_is_jax():
    """The anchor chip_smoke.py holds the hostile Paxos run on the card to
    is the JAX package's digest at its knobs."""
    res = run_cached(JConfig(**_smoke("PAXOS_HOSTILE")))
    assert res.digest == _smoke("PAXOS_HOSTILE_DIGEST")
    assert res.counts.max() > 0
