"""The port's SPEC §A.3 targeted Raft attacks against the JAX package, on the
CPU.

Each round draws one activation (ATTACK, r, 0, 0) below the attack cutoff
(K13 ``attack_fires``). "elect" jams every P2 request and response of a
round whose activation fires while a live node stands in P1; "sticky"
jams every edge into ``attack_target`` and skips its churn step-down in a
round whose activation fires while it led as the round began
(``consensus_tpu/engines/raft.py:236-253, 303-304, 320-330``,
``raft_sparse.py:177-199, 236-240, 268-276, 338-339``); attack_rounds
counts the jam or the activation. The same seeds go through
``consensus_tpu`` and through the port's plain versions (the ATTACK
instances of kernels KB, KE, KK on the capped engine and KL, KM, KP on the
dense one run them on the card); everything must be equal, tolerance 0:
the draw; whole runs of both engines, each attack alone and composed with
a crash and with a delay, with telemetry and the flight recorder; an
attack at rate 0 is the flat run. ``tests/test_torch_attack_steps.py``
holds elect beside equivocating byzantine nodes, single rounds (from a
JAX carry and on built states) and the JAX package's semantic checks. The C++
oracle does not implement §A.3, so nothing here is held to it.
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu.ops import adversary as jadv  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.core import rng  # noqa: E402
from consensus_tpu_torch.engines import raft  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402
from consensus_tpu_torch.ops import adversary  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_byz_helpers import telemetry_holds  # noqa: E402

# tests/test_adversary_lib.py's CFGS["raft"] and ["raft-sparse"], its CRASH
# and DELAY.
CFGS = {"dense": dict(protocol="raft", n_nodes=9, n_rounds=48, n_sweeps=2,
                      log_capacity=16, max_entries=12, seed=5,
                      drop_rate=0.3),
        "capped": dict(protocol="raft", n_nodes=64, max_active=6,
                       n_rounds=48, n_sweeps=2, log_capacity=16,
                       max_entries=12, seed=5, drop_rate=0.3)}
CRASH = dict(crash_prob=0.15, recover_prob=0.3, max_crashed=3)
DELAY = dict(max_delay_rounds=4, partition_rate=0.1, churn_rate=0.05)
# consensus_tpu/scenarios/__init__.py repeated-election-disruption's
# overrides; sticky at rate 1 on the first leader of the flat run's sweep 0
# (_first_leader), under churn so that its step-down skip shows.
ATTACKS = {"elect": dict(attack="elect", attack_rate=0.85, drop_rate=0.05),
           "sticky": dict(attack="sticky", churn_rate=0.2)}
COMPOSE = {"alone": {}, "crash": CRASH, "delay": DELAY}


def _first_leader(kw: dict) -> int:
    """The first node of sweep 0 to lead in the flat run of ``kw``."""
    cfg = Config(**kw)
    st = runner.init(cfg, torch.from_numpy(
        runner.make_seeds(cfg).astype(np.int64)).to(torch.uint32), "cpu")
    for r in range(cfg.n_rounds):
        st = runner.advance(cfg, st, r, 1)
        lead = torch.nonzero(st.role[0] == raft.ROLE_L)
        if lead.numel():
            return int(lead[0, 0])
    raise AssertionError("no leader in the flat run")


def _attack_kw(engine: str, attack: str, **extra) -> dict:
    kw = {**CFGS[engine], **ATTACKS[attack], **extra}
    if attack == "sticky":
        kw["attack_target"] = _first_leader(
            {k: v for k, v in kw.items() if k != "attack"})
    return kw


def _round_vectors(kw: dict) -> tuple:
    """Each round's counters of sweep 0 (1-round windows), by name."""
    stats: dict = {}
    runner.run(Config(**{**kw, "telemetry_window": 1}), "cpu",
               telemetry=True, stats=stats)
    return stats["flight"]["windows"]


# --- the draw -------------------------------------------------------------------

@pytest.mark.parametrize("r", [0, 1, 47, 200, 2**31 + 5])
def test_attack_fires_matches_jax(r):
    seeds = np.array([0, 0xFFFFFFFF, 12345, 0x80000000, 99], np.uint32)
    for cut in (0, 1, rng.prob_threshold_u32(0.85), 0xFFFFFFFF):
        want = np.asarray(jax.vmap(lambda s: jadv.attack_fires(
            s, jnp.uint32(r), cut))(jnp.asarray(seeds)))
        got = adversary.attack_fires(torch.from_numpy(seeds.astype(np.int64)),
                                     r, cut, rng.random_u32_plain)
        assert np.array_equal(got.numpy(), want), cut


# --- whole runs -----------------------------------------------------------------

@pytest.mark.parametrize("compose", list(COMPOSE))
@pytest.mark.parametrize("attack", list(ATTACKS))
@pytest.mark.parametrize("engine", list(CFGS))
def test_whole_run_matches_jax(engine, attack, compose):
    """Digest, every counter of every sweep, the windows and the latency
    buckets, with 4-round windows; the attack must count."""
    kw = _attack_kw(engine, attack, **COMPOSE[compose])
    tel = telemetry_holds(kw, f"{engine}/{attack}/{compose}")
    assert tel["attack_rounds"].sum() > 0
    if compose == "crash":
        assert tel["crashes"].sum() > 0


@pytest.mark.parametrize("engine", list(CFGS))
def test_attack_at_rate_zero_and_none_are_flat(engine):
    """"none" is the flat round; an attack at rate 0 runs its instances but
    never fires: both give the flat digest, as in the JAX package."""
    kw = dict(CFGS[engine], n_rounds=24)
    flat = simulator.run(Config(**kw), device="cpu").digest
    assert flat == jsim.run(JConfig(**kw), warmup=False).digest
    for attack in ("elect", "sticky"):
        at0 = dict(kw, attack=attack, attack_rate=0.0)
        assert simulator.run(Config(**at0), device="cpu").digest == flat
