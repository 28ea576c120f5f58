"""The port's SPEC §9 switch round by round, its §A.3 attacks and its §9b
scenarios, against the JAX package, on the CPU.

One round of each engine that runs the switch (both Raft engines, Paxos,
HotStuff, the last with §9b poisoned combines and uplink lies, with and
without equivocation) from a converted JAX carry, at rounds where an
aggregator is down, one serves stale state and, under §9b, one serves a
forged combine: the port's round gives the carry the JAX round gives, leaf
by leaf and dtype by dtype. Whole runs with telemetry of the §A.3 elect
and sticky attacks under the switch on both Raft engines (§A.3 has no
oracle). The scenarios stale-aggregator-inconsistency and
discovered-silent-qc-fork at their tuned shapes: the fork's runs at the
promoted seeds 11, 23 and 37 fork QCs, commit conflicting values and
flag safety violations, as the JAX package and the oracle do, with its
availability bound held. Tolerance 0 throughout.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu import scenarios  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.ops import aggregate  # noqa: E402

from torch_byz_helpers import (one_round_from_jax, port,  # noqa: E402
                               run_and_hold, telemetry_holds)

SW = dict(net_model="switch", n_aggregators=3, agg_fail_rate=0.3,
          agg_stale_rate=0.5, agg_max_stale=3)
ADV = dict(drop_rate=0.2, partition_rate=0.1, churn_rate=0.03,
           max_delay_rounds=2, crash_prob=0.08, recover_prob=0.3)
NINE_B = dict(agg_byz=1, agg_poison_rate=0.8, byz_uplink_rate=0.5)
# (config, rounds from which to look): the first round from each that has a
# failed, a stale and (§9b) a poisoned aggregator in some lane is stepped.
STEPS = {
    "raft-dense": (dict(protocol="raft", n_nodes=9, n_rounds=40,
                        n_sweeps=2, log_capacity=32, max_entries=24, seed=5,
                        **ADV, **SW), (9, 23)),
    "raft-dense-equiv": (dict(protocol="raft", n_nodes=9, n_rounds=40,
                              n_sweeps=2, log_capacity=32, max_entries=24,
                              seed=7, drop_rate=0.15, n_byzantine=2,
                              byz_mode="equivocate", **SW), (11, 30)),
    "raft-capped": (dict(protocol="raft", n_nodes=64, max_active=4,
                         n_rounds=40, n_sweeps=2, log_capacity=32,
                         max_entries=24, seed=11, max_crashed=5, **ADV,
                         **SW), (8, 21)),
    "raft-capped-equiv": (dict(protocol="raft", n_nodes=32, max_active=4,
                               n_rounds=40, n_sweeps=2, log_capacity=32,
                               max_entries=24, seed=13, drop_rate=0.15,
                               n_byzantine=5, byz_mode="equivocate", **SW),
                          (6, 19)),
    "paxos": (dict(protocol="paxos", n_nodes=15, n_rounds=40, n_sweeps=2,
                   log_capacity=24, seed=4, **ADV, **SW), (5, 17)),
    "hotstuff": (dict(protocol="hotstuff", f=2, n_nodes=7, n_rounds=40,
                      n_sweeps=2, log_capacity=48, seed=3, n_byzantine=1,
                      **ADV, **SW), (7, 26)),
    "hotstuff-9b-silent": (dict(protocol="hotstuff", f=3, n_nodes=10,
                                n_rounds=40, n_sweeps=2, log_capacity=48,
                                seed=9, n_byzantine=3, drop_rate=0.1,
                                partition_rate=0.2, **SW, **NINE_B),
                           (4, 18)),
    "hotstuff-9b-equiv": (dict(protocol="hotstuff", f=3, n_nodes=10,
                               n_rounds=40, n_sweeps=2, log_capacity=48,
                               seed=12, n_byzantine=3,
                               byz_mode="equivocate", drop_rate=0.05,
                               crash_prob=0.05, recover_prob=0.4,
                               desync_rate=0.1, max_skew_rounds=2,
                               **SW, **NINE_B), (5, 22)),
}


def _faulty_round(kw: dict, r0: int) -> int:
    """The first round from r0 on of ``kw`` with a failed and a stale
    aggregator in some lane, and, with §9b, a poisoned one."""
    cfg = Config(**kw)
    from consensus_tpu_torch.network import runner
    seed = torch.from_numpy(runner.make_seeds(cfg))
    for r in range(r0, cfg.n_rounds):
        st = aggregate.agg_draws_plain(cfg, seed, r)
        if (bool((~st.alive).any()) and bool((st.q != r).any())
                and (not cfg.agg_poison_on or bool(
                    aggregate.agg_poison_plain(cfg, seed, r, 0).any()))):
            return r
    raise AssertionError(f"no faulty round from {r0}")


@pytest.mark.parametrize("name", list(STEPS))
def test_one_round_from_a_jax_carry(name):
    kw, starts = STEPS[name]
    for r0 in starts:
        r = _faulty_round(kw, r0)
        one_round_from_jax(JConfig(**kw), r, f"{name} round {r}")


@pytest.mark.parametrize("name", ["hotstuff-9b-silent", "hotstuff-9b-equiv"])
def test_9b_runs_match_jax_and_the_oracle(name):
    kw = STEPS[name][0]
    run_and_hold(JConfig(**kw), name)
    tel = telemetry_holds(kw, name)
    assert tel["poisoned_serves"].sum() > 0


# --- SPEC §A.3 under the switch ----------------------------------------------

ATTACK_BASE = {
    "dense": dict(protocol="raft", n_nodes=9, n_rounds=48, n_sweeps=2,
                  log_capacity=32, max_entries=24, seed=5, drop_rate=0.05,
                  **SW),
    "capped": dict(protocol="raft", n_nodes=64, max_active=4, n_rounds=48,
                   n_sweeps=2, log_capacity=32, max_entries=24, seed=11,
                   drop_rate=0.05, **SW),
}


def _first_leader(kw: dict) -> int:
    """The first leader of sweep 0 in the run without the attack (the
    sticky target)."""
    from consensus_tpu_torch.network import runner
    cfg = Config(**{**kw, "n_rounds": 12})
    st = runner.run_device(cfg, "cpu").state
    lead = (st.role[0] == 2).nonzero()
    assert lead.numel(), "no leader in 12 rounds"
    return int(lead[0, 0])


@pytest.mark.parametrize("attack", ["elect", "sticky"])
@pytest.mark.parametrize("engine", list(ATTACK_BASE))
def test_attacks_under_the_switch_match_jax(engine, attack):
    kw = dict(ATTACK_BASE[engine], attack=attack)
    if attack == "elect":
        kw["attack_rate"] = 0.85
    else:
        kw["attack_target"] = _first_leader(ATTACK_BASE[engine])
    tel = telemetry_holds(kw, f"{engine} {attack}")
    assert tel["attack_rounds"].sum() > 0
    assert tel["agg_down_rounds"].sum() > 0


# --- the §9/§9b scenarios --------------------------------------------------------

def _scenario(name: str, seed: int) -> dict:
    sc = scenarios.get(name)
    cfg = JConfig(protocol="hotstuff", engine="tpu", n_sweeps=2, seed=seed,
                  **sc.tuned)
    applied = scenarios.apply(cfg, sc)
    return {k: v for k, v in dataclasses.asdict(applied).items()
            if k in Config.__dataclass_fields__}


@pytest.mark.parametrize("seed", [11, 23, 37])
def test_discovered_silent_qc_fork(seed):
    """The promoted seeds fork QCs and commit conflicting values on the
    port as in the JAX package and the oracle, with the scenario's
    availability floor held (its flight windows)."""
    kw = _scenario("discovered-silent-qc-fork", seed)
    run_and_hold(JConfig(**{**kw, "telemetry_window": 0}),
                 f"qc fork seed {seed}")
    tel = telemetry_holds({**kw, "telemetry_window": 0}, f"fork {seed}")
    for name in ("forked_qc", "conflict_commits", "safety_violations"):
        assert tel[name].sum() >= 1, (seed, name)
    from consensus_tpu_torch.network import runner
    stats: dict = {}
    cfg = Config(**kw)
    runner.run(cfg, "cpu", telemetry=True, stats=stats)
    commits = stats["flight"]["windows"]["commits_learned"]
    avail = float((1.0 - (np.asarray(commits) == 0).mean(axis=1)).mean())
    sc = scenarios.get("discovered-silent-qc-fork")
    assert avail >= sc.bounds.min_availability


def test_stale_aggregator_inconsistency():
    """The scenario at its tuned shape (seed 11, 2 sweeps): the port's run
    equals the JAX package's and the oracle's, and the JAX verdict on the
    same run passes."""
    kw = _scenario("stale-aggregator-inconsistency", 11)
    run_and_hold(JConfig(**{**kw, "telemetry_window": 0}), "stale agg")
    tel = telemetry_holds({**kw, "telemetry_window": 0}, "stale agg")
    assert tel["agg_down_rounds"].sum() > 0
    assert tel["stale_serves"].sum() > 0
    cfg = port(JConfig(**kw))
    assert cfg.switch_on and cfg.n_aggregators == 2
