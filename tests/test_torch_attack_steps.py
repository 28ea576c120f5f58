"""The port's SPEC §A.3 targeted Raft attacks against the JAX package, on the
CPU: elect beside equivocating byzantine nodes (a whole run with
telemetry), one round from a converted JAX carry, rounds on built
states (an old candidacy alone, a down node's phantom candidacy, a sticky
target leading under churn), each with its counters, and the JAX package's
own checks that no leader wins a jammed round and that the sticky target
never steps down (``tests/test_adversary_lib.py:173-210``), on both Raft
engines, tolerance 0. The attacks' draw and whole runs are in
``tests/test_torch_attack.py``, whose configurations this file shares.
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
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.engines import raft  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_attack import (ATTACKS, CFGS, CRASH,  # noqa: E402
                               _attack_kw, _round_vectors)
from torch_byz_helpers import (one_round_from_jax, port,  # noqa: E402
                               telemetry_holds)


@pytest.mark.parametrize("engine", list(CFGS))
def test_elect_beside_equivocating_byzantine_nodes(engine):
    kw = _attack_kw(engine, "elect", n_byzantine=CFGS[engine]["n_nodes"] // 3,
                    byz_mode="equivocate")
    tel = telemetry_holds(kw, f"{engine} elect + equivocate")
    assert tel["attack_rounds"].sum() > 0


# --- one round from a converted JAX carry -------------------------------------

@pytest.mark.parametrize("attack", list(ATTACKS))
@pytest.mark.parametrize("engine", list(CFGS))
def test_one_round_from_jax_state(engine, attack):
    kw = _attack_kw(engine, attack, **CRASH)
    for step in (3, 21):
        one_round_from_jax(JConfig(**kw), step, f"{engine}/{attack}/{step}")


# --- rounds on built states ----------------------------------------------------

def _built(kw: dict, step: int, edit) -> tuple:
    """A JAX carry of ``kw`` after ``step`` rounds, its leaves edited by
    ``edit(leaves)``; then round ``step`` of the JAX package and of the
    port on it, with their counter vectors."""
    jcfg = JConfig(**kw)
    eng = jsim.engine_def(jcfg)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    carry = jrunner._chunk_jit(jcfg, eng, step, carry, jnp.int32(0))
    leaves = {k: np.array(v) for k, v in carry._asdict().items()}
    edit(leaves)
    # One round through the JAX runner's scan, whose counter accumulator
    # then holds the round's vector (a bare jit of the vmapped round is
    # the CPU backend's pathological case, runner.py:198-203).
    zeros = jnp.zeros((kw["n_sweeps"], len(raft.RAFT_TELEMETRY)), jnp.int32)
    new, vec = jrunner._chunk_jit(
        jcfg, eng, 1, type(carry)(**{k: jnp.asarray(v)
                                     for k, v in leaves.items()}),
        jnp.int32(step), zeros)
    want = {k: np.asarray(v) for k, v in new._asdict().items()}
    cfg = port(jcfg)
    t, _ = runner.accumulators(cfg, "cpu")
    st = runner.advance(cfg, convert.state_from_numpy(leaves), step, 1,
                        telem=t)
    got = convert.state_to_numpy(st)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert np.array_equal(t.numpy(), np.asarray(vec))
    return want, t.numpy()


def _quiet(leaves, nodes):
    """No leader and no timer near its timeout at ``nodes``'s lane."""
    leaves["role"][:] = np.where(leaves["role"] == raft.ROLE_L, raft.ROLE_F,
                                 leaves["role"])
    leaves["timer"][:] = 0


@pytest.mark.parametrize("engine", list(CFGS))
def test_an_old_candidacy_alone_does_not_jam(engine):
    """A candidate from an earlier round, and no new one: the jam's
    activation fires (rate 1) but no live candidacy stood in P1."""
    kw = dict(CFGS[engine], attack="elect", attack_rate=1.0)

    def edit(leaves):
        _quiet(leaves, None)
        leaves["role"][:, 1] = raft.ROLE_C
    _, vec = _built(kw, 6, edit)
    col = raft.RAFT_TELEMETRY.index("attack_rounds")
    assert (vec[:, col] == 0).all()


@pytest.mark.parametrize("engine", list(CFGS))
def test_a_down_nodes_candidacy_does_not_jam(engine):
    """The only node whose timer expired is down and stays down: its
    phantom candidacy must not fire the jam, while a live one does."""
    kw = dict(CFGS[engine], attack="elect", attack_rate=1.0,
              crash_prob=1e-9, recover_prob=0.0)

    def edit(leaves):
        _quiet(leaves, None)
        leaves["down"][:] = False
        leaves["down"][:, 2] = True
        leaves["timer"][:, 2] = leaves["timeout"][:, 2]
    _, vec = _built(kw, 6, edit)
    col = raft.RAFT_TELEMETRY.index("attack_rounds")
    assert (vec[:, col] == 0).all()

    def live(leaves):
        edit(leaves)
        leaves["down"][:, 2] = False
    _, vec = _built(kw, 6, live)
    assert (vec[:, col] == 1).all()


@pytest.mark.parametrize("engine", list(CFGS))
def test_a_sticky_target_leading_under_churn_stays(engine):
    """The target leads, churn fires every round: every other leader steps
    down, the target stays leader, and nothing reaches it."""
    kw = dict(CFGS[engine], attack="sticky", attack_target=4,
              churn_rate=1.0)

    def edit(leaves):
        leaves["role"][:, 4] = raft.ROLE_L
        leaves["role"][:, 5] = raft.ROLE_L
    want, vec = _built(kw, 8, edit)
    assert (want["role"][:, 4] == raft.ROLE_L).all()
    assert (want["role"][:, 5] != raft.ROLE_L).all()
    col = raft.RAFT_TELEMETRY.index("attack_rounds")
    assert (vec[:, col] == 1).all()


# --- the JAX package's semantic checks, on the port -----------------------------

@pytest.mark.parametrize("engine", list(CFGS))
def test_elect_jams_every_attacked_election(engine):
    """tests/test_adversary_lib.py:173-187: in a round whose jam fired no
    candidate wins, the attack fires, and elections still slip through."""
    kw = dict(CFGS[engine], n_rounds=64, drop_rate=0.05, attack="elect",
              attack_rate=0.8, seed=11)
    windows = _round_vectors(kw)
    atk, wins = windows["attack_rounds"], windows["leader_elections"]
    assert atk.sum() > 0, "attack never fired"
    assert wins[atk > 0].sum() == 0, "a leader won a jammed round"
    assert wins.sum() > 0


def _roles(kw: dict) -> np.ndarray:
    """[R, N] roles of sweep 0 after each round."""
    cfg = Config(**kw)
    st = runner.init(cfg, torch.from_numpy(
        runner.make_seeds(cfg).astype(np.int64)).to(torch.uint32), "cpu")
    out = []
    for r in range(cfg.n_rounds):
        st = runner.advance(cfg, st, r, 1)
        out.append(st.role[0].numpy().copy())
    return np.stack(out)


@pytest.mark.parametrize("max_active", [0, 2])
def test_sticky_leader_never_steps_down(max_active):
    """tests/test_adversary_lib.py:190-210 (and its capped twin): once the
    target leads it stays leader, while the control run's target loses
    the leadership."""
    base = dict(protocol="raft", n_nodes=5, n_rounds=96, log_capacity=64,
                max_entries=48, seed=3, churn_rate=0.3, drop_rate=0.1,
                max_active=max_active)
    role = _roles(dict(base, attack="sticky", attack_target=0))
    lead = np.nonzero(role[:, 0] == raft.ROLE_L)[0]
    assert lead.size, "target never led"
    assert (role[int(lead[0]):, 0] == raft.ROLE_L).all()
    ctrl = _roles(base)
    clead = np.nonzero(ctrl[:, 0] == raft.ROLE_L)[0]
    if clead.size:
        assert not (ctrl[int(clead[0]):, 0] == raft.ROLE_L).all()
    assert dataclasses.replace(Config(**base), attack="sticky").attack_mode \
        == 2
