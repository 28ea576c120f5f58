"""The port's Config and entry points refuse what they do not support.

Every knob of the JAX package's Config that the port does not implement yet
raises when set off its default, on the dense engine as on the capped one,
telemetry on the dense engine raises, and the entry points raise without a
GPU unless the caller asks for the CPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.core import config as tconfig  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402

OK = dict(protocol="raft", n_nodes=9, n_rounds=4, max_active=2)

OFF_DEFAULT = {
    "crash_prob": 0.1, "recover_prob": 0.1, "max_crashed": 1,
    "max_delay_rounds": 2, "attack": "elect", "attack_rate": 0.5,
    "attack_target": 1, "net_model": "switch", "n_aggregators": 2,
    "n_byzantine": 1, "byz_mode": "equivocate", "desync_rate": 0.1,
    "scan_chunk": 4, "sweep_chunk": 1,
    "mesh_shape": (2,),
}


def test_every_unsupported_knob_is_listed():
    assert set(OFF_DEFAULT) == set(tconfig.UNSUPPORTED)
    fields = {f.name for f in dataclasses.fields(Config)}
    assert set(tconfig.UNSUPPORTED) <= fields


@pytest.mark.parametrize("knob", sorted(OFF_DEFAULT))
def test_unsupported_knob_raises(knob):
    with pytest.raises(ValueError, match=knob):
        Config(**{**OK, knob: OFF_DEFAULT[knob]})


@pytest.mark.parametrize("knob", sorted(OFF_DEFAULT))
def test_unsupported_knob_raises_on_the_dense_engine(knob):
    with pytest.raises(ValueError, match=knob):
        Config(**{**OK, "max_active": 0, knob: OFF_DEFAULT[knob]})


def test_max_active_zero_selects_the_dense_engine():
    from consensus_tpu import Config as JConfig
    from consensus_tpu.network import simulator as jsim
    kw = {**OK, "max_active": 0}
    assert simulator.engine_def(Config(**kw)) is runner.DENSE
    assert simulator.engine_def(Config(**OK)) is runner.CAPPED
    assert runner.DENSE.name == jsim.engine_def(JConfig(**kw)).name
    st = runner.init(Config(**kw), runner.make_seeds(Config(**kw)), "cpu")
    assert st.match_idx.shape == (1, 9, 9)


def test_telemetry_on_the_dense_engine_raises():
    cfg = Config(**{**OK, "max_active": 0})
    for call in (lambda: simulator.run(cfg, device="cpu", telemetry=True),
                 lambda: runner.run(cfg, "cpu", telemetry=True, stats={})):
        with pytest.raises(ValueError, match="dense"):
            call()
    windowed = Config(**{**OK, "max_active": 0, "telemetry_window": 2})
    with pytest.raises(ValueError, match="dense"):
        simulator.run(windowed, device="cpu", telemetry=True)


@pytest.mark.parametrize("bad", [
    dict(max_active=-1),                # neither dense (0) nor capped
    dict(max_active=17),
    dict(max_active=10),                # more than n_nodes
    dict(protocol="pbft"),
    dict(log_capacity=255),
    dict(t_min=5, t_max=5),
    dict(n_rounds=0),
    dict(telemetry_window=-1),
])
def test_out_of_range_settings_raise(bad):
    with pytest.raises(ValueError):
        Config(**{**OK, **bad})


def test_knobs_of_other_protocols_are_not_fields():
    with pytest.raises(TypeError):
        Config(**OK, view_timeout=4)


def test_cutoffs_match_the_reference():
    from consensus_tpu import Config as JConfig
    kw = dict(OK, drop_rate=0.01, partition_rate=0.3, churn_rate=0.001)
    j, t = JConfig(**kw), Config(**kw)
    assert (t.drop_cutoff, t.partition_cutoff, t.churn_cutoff) == \
        (j.drop_cutoff, j.partition_cutoff, j.churn_cutoff)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(**OK)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.run(cfg)
    with pytest.raises(RuntimeError):
        runner.run_device(cfg)
    with pytest.raises(RuntimeError):
        runner.run_device(cfg, device="cuda")
    res = simulator.run(cfg, device="cpu")
    assert len(res.digest) == 64 and res.counts.shape == (1, 9)


def test_graph_replay_needs_cuda():
    with pytest.raises(ValueError, match="cuda"):
        runner.run_device(Config(**OK), device="cpu", graph=True)


def test_telemetry_window_is_supported():
    cfg = Config(**OK, telemetry_window=3)
    res = simulator.run(cfg, device="cpu", telemetry=True)
    flight = res.extras["flight"]
    assert flight["n_windows"] == 2 and flight["engine"] == "raft-sparse"
    assert flight["windows"]["leader_elections"].shape == (1, 2)


def test_graph_key_leaves_out_only_the_seed():
    cfg, dev = Config(**OK), torch.device("cuda", 0)
    key = runner._graph_key(cfg, dev, False)
    assert runner._graph_key(dataclasses.replace(cfg, seed=7), dev,
                             False) == key
    assert runner._graph_key(dataclasses.replace(cfg, n_nodes=11), dev,
                             False) != key
    assert runner._graph_key(cfg, dev, True) != key


def test_every_kernel_source_has_a_counted_wrapper():
    from consensus_tpu_torch import _build
    assert [name for _, name in runner.KERNELS] == list(_build.SOURCES)
    assert {"delivery", "dense_elect", "dense_append",
            "dense_acks_commit"} <= set(_build.SOURCES)
    for mod, name in runner.KERNELS:
        assert isinstance(getattr(mod, name).launches, int)
        assert callable(getattr(mod, name + "_plain"))
