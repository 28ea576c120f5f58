"""The port's SPEC §9 switch on PBFT round by round, against the JAX
package, on the CPU.

One round of each PBFT path under the switch (the dense engine, the §6b
engine, and both f-ladders) from a JAX carry, at rounds where an
aggregator is down, one serves stale state and, under §9b, one serves a
forged combine: the standalone engines under §6c crashes (the §6b round's
down receivers neither prepare nor adopt, the dense one's do) and §B timer
skew, with equivocating and silent byzantine nodes, their uplink lies and
poisoned aggregators; the ladders with §B and §9b (they reject §6c, as in
the JAX package) from the JAX package's padded carry, padded ids included.
The port's round gives the carry the JAX round gives, leaf by leaf and
dtype by dtype, tolerance 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.engines import pbft as jpbft  # noqa: E402
from consensus_tpu.engines import pbft_sweep as jsweep  # noqa: E402
from consensus_tpu_torch import Config, convert  # noqa: E402
from consensus_tpu_torch.engines import pbft_sweep  # noqa: E402
from consensus_tpu_torch.network import runner  # noqa: E402
from consensus_tpu_torch.ops import aggregate  # noqa: E402

from torch_byz_helpers import one_round_from_jax, port  # noqa: E402

SW = dict(net_model="switch", n_aggregators=3, agg_fail_rate=0.3,
          agg_stale_rate=0.5, agg_max_stale=3)
ADV = dict(drop_rate=0.2, partition_rate=0.1, churn_rate=0.03,
           max_delay_rounds=2, crash_prob=0.08, recover_prob=0.3)
NINE_B = dict(agg_byz=1, agg_poison_rate=0.8, byz_uplink_rate=0.5)
DESYNC = dict(desync_rate=0.15, max_skew_rounds=3)
# (config, rounds from which to look): the first round from each that has
# a failed, a stale and (§9b) a poisoned aggregator in some lane is stepped.
STEPS = {
    "pbft-edge": (dict(protocol="pbft", f=2, n_nodes=7, n_rounds=40,
                       n_sweeps=2, log_capacity=12, seed=3, **ADV, **SW),
                  (6, 21)),
    "pbft-edge-9b-equiv": (dict(protocol="pbft", f=3, n_nodes=10,
                                n_rounds=40, n_sweeps=2, log_capacity=12,
                                seed=6, drop_rate=0.1, partition_rate=0.1,
                                n_byzantine=3, byz_mode="equivocate",
                                crash_prob=0.05, recover_prob=0.4,
                                **DESYNC, **SW, **NINE_B), (5, 19)),
    "pbft-bcast": (dict(protocol="pbft", fault_model="bcast", f=2,
                        n_nodes=7, n_rounds=40, n_sweeps=2, log_capacity=12,
                        seed=3, **ADV, **SW), (6, 21)),
    "pbft-bcast-9b-equiv": (dict(protocol="pbft", fault_model="bcast", f=3,
                                 n_nodes=10, n_rounds=40, n_sweeps=2,
                                 log_capacity=12, seed=5, drop_rate=0.1,
                                 partition_rate=0.1, n_byzantine=3,
                                 byz_mode="equivocate", crash_prob=0.1,
                                 recover_prob=0.3, **DESYNC, **SW,
                                 **NINE_B), (4, 17)),
    "pbft-bcast-9b-silent": (dict(protocol="pbft", fault_model="bcast", f=3,
                                  n_nodes=10, n_rounds=40, n_sweeps=2,
                                  log_capacity=12, seed=9, drop_rate=0.15,
                                  n_byzantine=3, crash_prob=0.1,
                                  recover_prob=0.3, **SW, **NINE_B),
                             (5, 18)),
}


def _faulty_round(kw: dict, r0: int, seeds) -> int:
    """The first round from r0 on of ``kw`` with a failed and a stale
    aggregator in some lane of ``seeds``, and, with §9b, a poisoned one."""
    cfg = Config(**kw)
    seed = torch.from_numpy(np.asarray(seeds, np.uint32))
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
    seeds = runner.make_seeds(Config(**kw))
    for r0 in starts:
        r = _faulty_round(kw, r0, seeds)
        one_round_from_jax(JConfig(**kw), r, f"{name} round {r}")


LADDER = dict(protocol="pbft", f=1, n_nodes=4, n_rounds=40, n_sweeps=2,
              log_capacity=10, seed=7, drop_rate=0.15, partition_rate=0.1,
              churn_rate=0.02, max_delay_rounds=2, n_byzantine=1,
              byz_mode="equivocate", **DESYNC, **SW, **NINE_B)
FS = [1, 2, 3]


@pytest.mark.parametrize("model", ["edge", "bcast"])
def test_ladder_round_from_a_jax_carry(model):
    """Both ladders' round (``pbft_round_padded``,
    ``pbft_bcast_round_padded``: ``_padded_switch_phases``) from the JAX
    package's padded carry, vmapped over its lanes, at two faulty
    rounds."""
    base = JConfig(**LADDER, fault_model=model)
    _, jpad, m_cap = jsweep._fsweep_static(base, FS)
    _, cfg_pad = pbft_sweep._fsweep_static(port(base), FS)
    lanes = runner.lane_inputs(cfg_pad, FS)
    n_reals = jnp.asarray(lanes["n_real"])
    fs = jnp.asarray(lanes["f"])

    def one(st, r, n, f):
        if model == "bcast":
            return jsweep.pbft_bcast_round_padded(jpad, st, r, n, f, m_cap)
        return jsweep.pbft_round_padded(jpad, st, r, n, f)
    step = jax.jit(jax.vmap(one, in_axes=(0, None, 0, 0)))
    carry = jax.vmap(lambda s: jpbft.pbft_init(jpad, s))(
        jnp.asarray(lanes["seed"]))
    kw = {**LADDER, "fault_model": model}
    done = 0
    for r0 in (5, 19):
        r = _faulty_round(kw, r0, lanes["seed"])
        for q in range(done, r):
            carry = step(carry, jnp.int32(q), n_reals, fs)
        done = r
        before = {k: np.array(v) for k, v in carry._asdict().items()}
        carry = step(carry, jnp.int32(r), n_reals, fs)
        done = r + 1
        after = {k: np.array(v) for k, v in carry._asdict().items()}
        dev = {k: torch.from_numpy(v) for k, v in lanes.items()
               if k != "seed"}
        st = runner.advance(cfg_pad, convert.state_from_numpy(before), r, 1,
                            lanes=dev, rungs=FS)
        got = convert.state_to_numpy(st)
        for name in after:
            assert got[name].dtype == after[name].dtype, (model, r, name)
            np.testing.assert_array_equal(got[name], after[name],
                                          f"{model} round {r} {name}")
