"""The port's capped-Raft main path against the JAX package, end to end.

The same Config runs through ``consensus_tpu.network.runner.run`` (JAX on
the CPU) and through ``consensus_tpu_torch`` on the CPU (the kernels' plain
versions): every extracted leaf and the decided-log digest must be equal,
tolerance 0. The round is a sequence of kernel-wrapper calls and nothing
else, with kernel KK's only when telemetry is on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.engines import raft_sparse as trs  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402

BASE = dict(protocol="raft", n_rounds=48, n_sweeps=2, log_capacity=32,
            max_entries=24, drop_rate=0.1, partition_rate=0.1,
            churn_rate=0.02)

CASES = {
    "cap4-n257": dict(n_nodes=257, max_active=4, seed=11),
    "cap8-n1024": dict(n_nodes=1024, max_active=8, seed=5),
    # t in [1, 3): most followers time out together, so more than A
    # candidates compete and the cap binds.
    "cap8-n1024-binding": dict(n_nodes=1024, max_active=8, seed=3, t_min=1,
                               t_max=3),
    "cap4-n257-hostile": dict(n_nodes=257, max_active=4, seed=9,
                              drop_rate=0.3, partition_rate=0.4,
                              churn_rate=0.1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_whole_run_matches_jax(case):
    kw = {**BASE, **CASES[case]}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    want = jrunner.run(jcfg, jsim.engine_def(jcfg))
    st = runner.init(cfg, runner.make_seeds(cfg), "cpu")
    most_candidates = 0
    for r in range(cfg.n_rounds):
        st = trs.raft_sparse_round(cfg, st, r)
        most_candidates = max(most_candidates,
                              int((st.role == 1).sum(1).max()))
    got = {k: v.numpy() for k, v in trs.extract(st).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    _, _, _, payload = simulator.decided_payload(cfg, got)
    assert payload == jsim.decided_payload(jcfg, want)[3]
    assert got["commit"].max() > 0
    if case.endswith("binding"):
        assert most_candidates > cfg.max_active


def test_run_front_door_matches_jax_digest():
    kw = {**BASE, **CASES["cap4-n257"]}
    got = simulator.run(Config(**kw), device="cpu")
    want = jsim.run(JConfig(**kw), warmup=False)
    assert got.digest == want.digest
    assert got.payload == want.payload
    assert got.node_round_steps == want.node_round_steps
    assert got.steps_per_sec > 0


ROUND_WRAPPERS = {"candidacy": 1, "top_active": 2, "delivery_edges": 4,
                  "elect": 1, "slots": 1, "propose": 1, "append_entries": 1,
                  "acks_commit": 1, "telemetry": 1}


@pytest.mark.parametrize("telemetry", [False, True])
def test_round_calls_each_wrapper_its_times(telemetry, monkeypatch):
    from consensus_tpu_torch.ops import adversary
    kw = {**BASE, **CASES["cap4-n257"], "n_rounds": 6}
    cfg = Config(**kw, telemetry_window=4 if telemetry else 0)
    st = runner.init(cfg, runner.make_seeds(cfg), "cpu")
    calls = dict.fromkeys(ROUND_WRAPPERS, 0)

    def counting(mod, name):
        fn = getattr(mod, name)

        def call(*args):
            calls[name] += 1
            return fn(*args)
        monkeypatch.setattr(mod, name, call)
    for name in ROUND_WRAPPERS:
        counting(adversary if name == "delivery_edges" else trs, name)
    # The round takes delivery_edges from its own module's namespace.
    monkeypatch.setattr(trs, "delivery_edges", adversary.delivery_edges)
    telem, flight = runner.accumulators(cfg, "cpu") if telemetry \
        else (None, None)
    for r in range(cfg.n_rounds):
        st = trs.raft_sparse_round(cfg, st, r, telem=telem, flight=flight)
    want = {k: v * cfg.n_rounds for k, v in ROUND_WRAPPERS.items()}
    want["telemetry"] *= telemetry
    assert calls == want
