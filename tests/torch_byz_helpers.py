"""What the port's SPEC §3c/§7c byzantine tests share
(``tests/test_torch_byz*.py``): the port's Config of a JAX one, leaf by
leaf equality, a whole run held to the JAX package and the C++ oracle, one
round from a converted JAX carry, and the telemetry held to the JAX
package's. Each holds the port's plain path (``device="cpu"``) to JAX with
tolerance 0."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from consensus_tpu import Config as JConfig
from consensus_tpu.network import runner as jrunner
from consensus_tpu.network import simulator as jsim
from consensus_tpu_torch import Config
from consensus_tpu_torch import convert
from consensus_tpu_torch.network import runner, simulator

# The flight recorder's window in the telemetry cases.
W = 4


def port(jcfg) -> Config:
    """The port's Config of a JAX one (same fields, the port's subset)."""
    return Config(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                     if k in Config.__dataclass_fields__})


def same(got, want, where=""):
    """Every leaf of the dict ``want`` equals ``got``'s, and no other."""
    assert set(got) == set(want), where
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), \
            f"{where}.{k}"


def run_and_hold(jcfg, where=""):
    """The port's whole run of ``jcfg`` on the CPU: every extract leaf and
    the decided payload equal the JAX package's, and the payload the C++
    oracle's. Returns the port's extract."""
    jcfg = dataclasses.replace(jcfg, engine="tpu")
    cfg = port(jcfg)
    want = jrunner.run(jcfg, jsim.engine_def(jcfg))
    got = runner.run(cfg, "cpu")
    same(got, want, where)
    payload = simulator.decided_payload(cfg, got)[3]
    assert payload == jsim.decided_payload(jcfg, want)[3], where
    cpu = jsim.run(dataclasses.replace(jcfg, engine="cpu"), warmup=False)
    assert cpu.payload == payload, where
    return got


def one_round_from_jax(jcfg, step: int, where=""):
    """Round ``step`` of the JAX scan from its converted carry: the port's
    round gives the carry JAX's round gives, leaf by leaf and dtype by
    dtype (HotStuff's lane words at rest, P1's key over the honest
    nodes)."""
    jcfg = dataclasses.replace(jcfg, engine="tpu")
    cfg = port(jcfg)
    eng = jsim.engine_def(jcfg)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    for r in range(step):
        carry = jrunner._chunk_jit(jcfg, eng, 1, carry, jnp.int32(r))
    before = {k: np.array(v) for k, v in carry._asdict().items()}
    carry = jrunner._chunk_jit(jcfg, eng, 1, carry, jnp.int32(step))
    after = {k: np.array(v) for k, v in carry._asdict().items()}
    lanes = {k: v for k, v in runner.device_lanes(cfg, None, "cpu").items()
             if k != "seed"}
    st = runner.advance(cfg, convert.state_from_numpy(
        before, n_byzantine=cfg.n_byzantine), step, 1, lanes=lanes)
    got = convert.state_to_numpy(st)
    assert set(got) == set(after), where
    for name in after:
        assert got[name].dtype == after[name].dtype, (where, name)
        assert np.array_equal(got[name], after[name]), (where, name)


def telemetry_holds(kw: dict, where=""):
    """A run of the Config fields ``kw`` with telemetry and W-round
    windows: the payload, every counter of every sweep, the windows and
    the latency buckets equal the JAX package's. Returns the port's
    per-sweep counters."""
    kw = {**kw, "telemetry_window": W, "engine": "tpu"}
    want = jsim.run(JConfig(**kw), warmup=False, telemetry=True)
    stats: dict = {}
    cfg = port(JConfig(**kw))
    out = runner.run(cfg, "cpu", telemetry=True, stats=stats)
    assert simulator.decided_payload(cfg, out)[3] == want.payload, where
    for k, v in want.extras["telemetry"]["per_sweep"].items():
        assert np.array_equal(np.asarray(stats["telemetry"][k]),
                              np.asarray(v)), (where, k)
    for part in ("windows", "latency"):
        for k, v in want.extras["flight"][part].items():
            assert np.array_equal(np.asarray(stats["flight"][part][k]),
                                  np.asarray(v)), (where, part, k)
    return stats["telemetry"]
