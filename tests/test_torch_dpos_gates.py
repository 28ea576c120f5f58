"""The port's SPEC §A.1 slot miss and SPEC §A.4 producer suppression on DPoS
against the JAX package and the C++ oracle, on the CPU.

Round r's scheduled producer p misses its slot where its draw (SLOTMISS,
r, 0, p) is below the miss cutoff, and is suppressed where its draw
(SUPPRESS, r // suppress_window, 0, p) is below the suppress cutoff; either
way no validator appends in round r (``consensus_tpu/engines/dpos.py``
lines 139-175), and the telemetry counts the raw draws (lines 186-189).
The same seeds go through ``consensus_tpu`` and through the port's plain
versions (kernels KX and KAB's GATES instances run them on the card);
everything must be equal, tolerance 0: the draws on extreme seeds, rounds,
producers and cutoffs; one round with its counters from a converted JAX
carry; whole runs with telemetry and the flight recorder (the miss, the
suppression, ``rolling-producer-outage``'s overrides, the adversary knobs
of ``tests/test_aggregate.py``'s SUPPRESS_BASE, everything composed with a
crash and a delay) against the JAX package and the oracle; and the JAX
package's own check that no block from a producer inside its suppressed
window reaches a chain.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.core import rng as jrng  # noqa: E402
from consensus_tpu.engines import dpos as jdpos  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu.ops import adversary as jadv  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.core import rng  # noqa: E402
from consensus_tpu_torch.engines import dpos  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402
from consensus_tpu_torch.ops import adversary  # noqa: E402

SEEDS = (0, 0xFFFFFFFF, 12345, 0x80000000)
PRODUCERS = (0, 3, 1023, 69_999)
CUTS = (0, 1, rng.prob_threshold_u32(0.35), 0xFFFFFFFE, 0xFFFFFFFF)
ROUNDS = (0, 1, 47, 200, 2**31 + 5)

# tests/test_adversary_lib.py's CFGS["dpos"], its CRASH and DELAY.
DPOS = dict(protocol="dpos", n_nodes=24, n_rounds=48, log_capacity=64,
            n_candidates=12, n_producers=5, epoch_len=8, seed=5,
            drop_rate=0.3)
CRASH = dict(crash_prob=0.15, recover_prob=0.3, max_crashed=3)
DELAY = dict(max_delay_rounds=4, partition_rate=0.1, churn_rate=0.05)
# tests/test_aggregate.py's SUPPRESS_BASE (lines 258-263).
SUPPRESS_BASE = dict(protocol="dpos", n_nodes=24, n_rounds=96, n_sweeps=2,
                     log_capacity=96, n_candidates=12, n_producers=3,
                     epoch_len=48, seed=5, drop_rate=0.2, churn_rate=0.02,
                     miss_rate=0.1, max_delay_rounds=2, crash_prob=0.05,
                     recover_prob=0.3, suppress_rate=0.3,
                     suppress_window=24)
# Whole runs, each with telemetry and 6-round windows, against the JAX
# package and the oracle, and the counters that must count.
RUNS = {
    "miss": (dict(DPOS, miss_rate=0.4, n_sweeps=2), ("missed_slots",)),
    "suppress": (dict(DPOS, suppress_rate=0.3, suppress_window=6,
                      n_sweeps=2), ("suppressed_slots",)),
    "suppress-window-1": (dict(DPOS, suppress_rate=0.5, suppress_window=1),
                          ("suppressed_slots",)),
    # consensus_tpu/scenarios/__init__.py rolling-producer-outage, at its
    # tuned shape.
    "rolling-producer-outage": (
        dict(protocol="dpos", n_nodes=24, n_rounds=96, log_capacity=96,
             n_candidates=12, n_producers=6, n_sweeps=2, seed=7,
             miss_rate=0.35, crash_prob=0.08, recover_prob=0.25,
             drop_rate=0.1), ("missed_slots", "crashes")),
    "suppress-base": (SUPPRESS_BASE, ("missed_slots", "suppressed_slots",
                                      "crashes")),
    "composed": (dict(DPOS, miss_rate=0.3, suppress_rate=0.2,
                      suppress_window=5, n_sweeps=2, **CRASH, **DELAY),
                 ("missed_slots", "suppressed_slots", "crashes")),
}
W = 6


def _seeds():
    return torch.tensor(SEEDS, dtype=torch.int64).to(torch.uint32)


# --- the draws ------------------------------------------------------------------

@pytest.mark.parametrize("r", ROUNDS)
def test_slot_missed_matches_jax(r):
    """adversary.slot_missed (the plain twin of ctt::slot_missed) gives
    K13 slot_missed's bit for every (seed, producer) pair and cutoff."""
    s = np.repeat(np.array(SEEDS, np.uint32), len(PRODUCERS))
    p = np.tile(np.array(PRODUCERS, np.int32), len(SEEDS))
    for cut in CUTS:
        want = np.asarray(jax.vmap(lambda a, b: jadv.slot_missed(
            a, jnp.uint32(r), b, cut))(jnp.asarray(s), jnp.asarray(p)))
        got = adversary.slot_missed(torch.from_numpy(s.astype(np.int64)),
                                    r, torch.from_numpy(p), cut,
                                    rng.random_u32_plain)
        assert np.array_equal(got.numpy(), want), cut


@pytest.mark.parametrize("window", [1, 6, 24, 16])
@pytest.mark.parametrize("r", ROUNDS)
def test_suppress_draw_matches_jax(r, window):
    """adversary.suppressed (the plain twin of ctt::suppressed) gives the
    JAX round's window-keyed draw (engines/dpos.py:157-163)."""
    s = np.repeat(np.array(SEEDS, np.uint32), len(PRODUCERS))
    p = np.tile(np.array(PRODUCERS, np.int32), len(SEEDS))
    for cut in CUTS:
        def one(a, b):
            return jadv.draw(a, jrng.STREAM_SUPPRESS,
                             jnp.uint32(r) // jnp.uint32(window), 0,
                             b.astype(jnp.uint32)) < jadv.cutoff(cut)
        want = np.asarray(jax.vmap(one)(jnp.asarray(s), jnp.asarray(p)))
        got = adversary.suppressed(torch.from_numpy(s.astype(np.int64)), r,
                                   window, torch.from_numpy(p), cut,
                                   rng.random_u32_plain)
        assert np.array_equal(got.numpy(), want), cut


def test_cutoffs_fire_as_strict_u32_compares():
    """A cutoff of 0 never fires; 0xFFFFFFFF fires on every draw but one of
    0xFFFFFFFF (the draw < cut compare stays in u32)."""
    seeds = _seeds()
    for p in range(64):
        col = torch.full((len(SEEDS),), p, dtype=torch.int32)
        assert not adversary.slot_missed(seeds, 9, col, 0,
                                         rng.random_u32_plain).any()
        draws = rng.random_u32_plain(seeds, rng.STREAM_SLOTMISS, 9, 0,
                                     col.to(torch.int64)[:, None])[:, 0]
        fired = adversary.slot_missed(seeds, 9, col, 0xFFFFFFFF,
                                      rng.random_u32_plain)
        assert torch.equal(fired, draws != 0xFFFFFFFF)


# --- one round from a converted JAX carry -----------------------------------

STEPS = (0, 5, 13, 31, 47)
ROUND_CFG = dict(DPOS, miss_rate=0.35, suppress_rate=0.4, suppress_window=4,
                 n_sweeps=3, **CRASH, **DELAY)


def _carry_leaves(carry) -> dict:
    producers, st = carry
    return convert.dpos_leaves(np.array(producers),
                               {k: np.array(v)
                                for k, v in st._asdict().items()})


@pytest.fixture(scope="module")
def jax_steps():
    """{k: (leaves before round k, JAX's leaves and counters after it)}."""
    jcfg = JConfig(**ROUND_CFG)
    eng = jsim.engine_def(jcfg)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    step = jax.jit(jax.vmap(lambda producers, st, r: jdpos.dpos_round(
        jcfg, producers, st, r, telem=True), in_axes=(0, 0, None)))
    out, r0 = {}, 0
    for k in STEPS:
        if k > r0:
            carry = jrunner._chunk_jit(jcfg, eng, k - r0, carry, jnp.int32(r0))
        before = _carry_leaves(carry)
        new, vec = step(carry[0], carry[1], jnp.int32(k))
        out[k] = (before, _carry_leaves((carry[0], new)), np.asarray(vec))
        carry = jrunner._chunk_jit(jcfg, eng, 1, carry, jnp.int32(k))
        r0 = k + 1
    return out


@pytest.mark.parametrize("k", STEPS)
def test_one_round_from_jax_state(jax_steps, k):
    """KX's and KAB's plain versions (with KAH's) on a JAX carry under
    both gates, a crash and a delay: the state after the round and the
    round's counter vector."""
    before, after, vec = jax_steps[k]
    cfg = Config(**ROUND_CFG)
    st = convert.state_from_numpy(before)
    t = torch.zeros((st.seed.shape[0], len(dpos.DPOS_TELEMETRY)),
                    dtype=torch.int32)
    got = convert.state_to_numpy(dpos.dpos_step(cfg, st, k, telem=t))
    for name in after:
        assert np.array_equal(got[name], after[name]), (k, name)
    assert np.array_equal(t.numpy(), vec), k


def test_the_steps_meet_both_gates(jax_steps):
    names = dpos.DPOS_TELEMETRY
    vecs = np.stack([v for _, _, v in jax_steps.values()])
    assert vecs[..., names.index("missed_slots")].sum() > 0
    assert vecs[..., names.index("suppressed_slots")].sum() > 0


# --- whole runs ---------------------------------------------------------------

def _same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    else:
        assert np.array_equal(np.asarray(got), np.asarray(want)), where


@pytest.mark.parametrize("name", list(RUNS))
def test_whole_run_matches_jax_and_the_oracle(name):
    kw, must = RUNS[name]
    kw = dict(kw, telemetry_window=W)
    want = jsim.run(JConfig(**kw), warmup=False, telemetry=True)
    stats: dict = {}
    cfg = Config(**kw)
    out = runner.run(cfg, "cpu", telemetry=True, stats=stats)
    payload = simulator.decided_payload(cfg, out)[3]
    assert payload == want.payload
    _same(stats["telemetry"], want.extras["telemetry"]["per_sweep"],
          "telemetry")
    _same(stats["flight"], {k: v for k, v in want.extras["flight"].items()
                            if k != "engine"}, "flight")
    for counter in must:
        assert stats["telemetry"][counter].sum() > 0, counter
    cpu = jsim.run(JConfig(**{**kw, "telemetry_window": 0}, engine="cpu"),
                   warmup=False)
    assert cpu.payload == payload
    res = simulator.run(cfg, device="cpu", telemetry=True)
    np.testing.assert_array_equal(res.extras["lib"], want.extras["lib"])


def test_gates_off_give_the_flat_run():
    """Rates of 0 (a window off its default needs a rate, so the window
    stays) run the flat instances: the flat digest and zero counters."""
    kw = dict(DPOS, n_sweeps=2, telemetry_window=W)
    flat = simulator.run(Config(**kw), device="cpu", telemetry=True)
    assert not dpos.gated(Config(**kw))
    tot = flat.extras["telemetry"]["totals"]
    assert tot["missed_slots"] == tot["suppressed_slots"] == 0
    assert flat.digest == jsim.run(JConfig(**kw), warmup=False,
                                   telemetry=True).digest


def test_no_block_from_a_suppressed_producer_inside_its_window():
    """tests/test_aggregate.py:271-290 on the port: a suppressed producer
    misses every slot of its window, so no chain holds a block (r, p)
    whose window draw for p fires."""
    base = dict(SUPPRESS_BASE, drop_rate=0.0, churn_rate=0.0, miss_rate=0.0,
                crash_prob=0.0, recover_prob=0.0, max_delay_rounds=0,
                suppress_rate=0.5, n_sweeps=1)
    cfg = Config(**base)
    out = runner.run(cfg, "cpu")
    chain_r, chain_p = out["chain_r"][0], out["chain_p"][0]
    n = out["chain_len"][0]
    seeds = torch.from_numpy(runner.make_seeds(cfg).astype(np.int64))
    blocks = 0
    for v in range(cfg.n_nodes):
        for r, p in zip(chain_r[v, :n[v]], chain_p[v, :n[v]]):
            blocks += 1
            fired = adversary.suppressed(
                seeds, int(r), cfg.suppress_window,
                torch.tensor([int(p)], dtype=torch.int32),
                cfg.suppress_cutoff, rng.random_u32_plain)
            assert not bool(fired[0]), (v, int(r), int(p))
    assert blocks > 0
    # ...and the suppression did skip slots.
    assert int(n.max()) < cfg.n_rounds


def test_gated_round_counts_draws_not_skips():
    """KAB's counters are the raw draws: a round that churn already
    skipped still counts its producer's miss (dpos.py:186-189)."""
    kw = dict(DPOS, churn_rate=1.0, miss_rate=1.0, n_rounds=8,
              telemetry_window=0)
    res = simulator.run(Config(**kw), device="cpu", telemetry=True)
    tot = res.extras["telemetry"]["totals"]
    assert tot["blocks_appended"] == 0
    assert tot["missed_slots"] == tot["churn_slots"] == kw["n_rounds"]
    want = jsim.run(JConfig(**kw), warmup=False, telemetry=True)
    assert tot == want.extras["telemetry"]["totals"]
    assert dataclasses.replace(Config(**kw), miss_rate=0.0).miss_on is False
