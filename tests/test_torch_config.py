"""The port's Config and entry points refuse what they do not support.

Every knob of the JAX package's Config that the port does not implement yet
raises when set off its default, on the dense engine as on the capped one
and on the PBFT, Paxos, DPoS and HotStuff engines, alone and beside a SPEC
§A.2 delay (which the port runs, in [0, 16]), a SPEC §6c crash (which the
port runs on every engine, but an f-ladder, which raises with the JAX
package's message), a SPEC §B desync (which the port runs on both PBFT
engines, both f-ladders and HotStuff) or SPEC §3c/§7c byzantine nodes
(which the port runs on both Raft engines, dense PBFT, its f-ladder and
HotStuff); an out-of-range ``max_crashed``, a desync on another protocol,
an out-of-range or lone ``max_skew_rounds``, a byzantine count or mode, a
SPEC §A.1 or §A.4 knob off DPoS, a lone or out-of-range
``suppress_window`` and a SPEC §A.3 attack, rate or target that the JAX
package refuses raise with the JAX package's messages (alone, beside a
delay and beside a crash), while the gates the port runs (§A.1 and §A.4
on DPoS, §A.3 on both Raft engines) are accepted with the JAX package's
cutoffs, and
byzantine nodes on the §6b engine with the port's own; telemetry on a PBFT
f-ladder raises (as the JAX package's ladder has none), and the entry
points raise without a GPU unless the caller asks for the CPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch.core import config as tconfig  # noqa: E402
from consensus_tpu_torch.network import runner, simulator  # noqa: E402

OK = dict(protocol="raft", n_nodes=9, n_rounds=4, max_active=2)

OFF_DEFAULT = {
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


PBFT_OK = dict(protocol="pbft", f=2, n_nodes=7, n_rounds=4, log_capacity=8)


def test_telemetry_on_the_dense_engine_raises():
    """Telemetry on the dense PBFT engine raises on an f-ladder, with or
    without a window: the JAX package's ladder has no counter tail. A
    standalone run has it (tests/test_torch_telemetry_bft.py)."""
    cfg = Config(**PBFT_OK)
    windowed = Config(**{**PBFT_OK, "telemetry_window": 2})
    for c in (cfg, windowed):
        with pytest.raises(ValueError, match="f-ladder"):
            runner.run_device(c, "cpu", telemetry=True, rungs=[1, 2])
    res = simulator.run(windowed, device="cpu", telemetry=True)
    assert res.extras["telemetry"]["names"][0] == "prepare_quorums"


@pytest.mark.parametrize("knob", sorted(OFF_DEFAULT))
def test_unsupported_knob_raises_on_the_pbft_engine(knob):
    with pytest.raises(ValueError, match=knob):
        Config(**{**PBFT_OK, knob: OFF_DEFAULT[knob]})


def test_pbft_selects_its_engine_whatever_max_active():
    from consensus_tpu import Config as JConfig
    from consensus_tpu.network import simulator as jsim
    for max_active in (0, 3):
        kw = {**PBFT_OK, "max_active": max_active}
        assert simulator.engine_def(Config(**kw)) is runner.PBFT
        assert runner.PBFT.name == jsim.engine_def(JConfig(**kw)).name


@pytest.mark.parametrize("kw", [
    dict(n_nodes=8),                        # not 3f + 1
    dict(f=3),
    dict(fault_model="bcast", n_nodes=8),   # §6b: n_nodes 3f + 1 too
    dict(fault_model="wire"),
    dict(max_active=8),                     # more than n_nodes
])
def test_pbft_settings_that_raise(kw):
    with pytest.raises(ValueError):
        Config(**{**PBFT_OK, **kw})


def test_bcast_selects_its_engine():
    """fault_model="bcast" is accepted for pbft and selects the §6b engine,
    named as the JAX package names it."""
    from consensus_tpu import Config as JConfig
    from consensus_tpu.network import simulator as jsim
    kw = {**PBFT_OK, "fault_model": "bcast"}
    eng = simulator.engine_def(Config(**kw))
    assert eng is runner.PBFT_BCAST
    assert eng.name == jsim.engine_def(JConfig(**kw)).name == "pbft-bcast"


def test_pbft_rejections_match_jax():
    from consensus_tpu import Config as JConfig
    for kw in (dict(n_nodes=8), dict(f=3)):
        with pytest.raises(ValueError) as want:
            JConfig(**{**PBFT_OK, **kw})
        with pytest.raises(ValueError) as got:
            Config(**{**PBFT_OK, **kw})
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="pbft model"):
        Config(**{**OK, "fault_model": "bcast"})


def test_pbft_takes_any_slot_count():
    """The raft-only limits stay raft-only: PBFT's state is int32 and bool
    and its kernels take any slot count and max_active up to n_nodes."""
    cfg = Config(**{**PBFT_OK, "log_capacity": 300, "max_active": 7})
    assert cfg.log_capacity == 300
    with pytest.raises(ValueError):
        Config(**{**OK, "log_capacity": 300})


@pytest.mark.parametrize("bad", [
    dict(max_active=-1),                # neither dense (0) nor capped
    dict(max_active=17),
    dict(max_active=10),                # more than n_nodes
    dict(protocol="hotstuff", f=2),     # n_nodes 9 is not 3f + 1
    dict(log_capacity=255),
    dict(t_min=5, t_max=5),
    dict(n_rounds=0),
    dict(telemetry_window=-1),
    dict(protocol="pbft", f=2),         # n_nodes 9 is not 3f + 1
    dict(max_delay_rounds=17),          # SPEC §A.2: at most 16
    dict(max_delay_rounds=-1),
])
def test_out_of_range_settings_raise(bad):
    with pytest.raises(ValueError):
        Config(**{**OK, **bad})


@pytest.mark.parametrize("delay", [17, -1])
def test_max_delay_out_of_range_raises_with_the_jax_message(delay):
    from consensus_tpu import Config as JConfig
    with pytest.raises(ValueError) as want:
        JConfig(**{**OK, "max_delay_rounds": delay})
    with pytest.raises(ValueError) as got:
        Config(**{**OK, "max_delay_rounds": delay})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knob", sorted(OFF_DEFAULT))
def test_unsupported_knob_raises_beside_a_delay(knob):
    """A delay, which the port runs, lets no other gate through."""
    Config(**{**OK, "max_delay_rounds": 16})
    with pytest.raises(ValueError, match=knob):
        Config(**{**OK, "max_delay_rounds": 2, knob: OFF_DEFAULT[knob]})


HOTSTUFF_OK = dict(protocol="hotstuff", f=2, n_nodes=7, n_rounds=4,
                   view_timeout=4)
# Each gate of the JAX HotStuff engine that the port runs, the SPEC §9
# switch (consensus_tpu/engines/hotstuff.py lines 339-392), at a setting
# the JAX package refuses (K > n_nodes), which raises with its message;
# the SPEC §A.2 delay (lines 243-256, 303-309), the SPEC §6c crash, the
# SPEC §B skew (lines 204-230) and the SPEC §7c byzantine nodes (lines
# 237-238, 285-453) it runs too.
HOTSTUFF_GATES = {
    "switch": dict(net_model="switch", n_aggregators=8),
}
HOTSTUFF_GATE_MESSAGE = "requires 1 <= n_aggregators <= n_nodes"
HOTSTUFF_RUNS = {
    "crash": dict(crash_prob=0.1), "recover": dict(recover_prob=0.3),
    "max-crashed": dict(max_crashed=2),
    "desync": dict(desync_rate=0.1),
    "desync-depth": dict(desync_rate=0.1, max_skew_rounds=8),
}


def test_hotstuff_is_a_protocol_of_the_port():
    cfg = Config(**HOTSTUFF_OK)
    assert cfg.protocol in tconfig.PROTOCOLS
    assert runner.engine(cfg) is runner.HOTSTUFF
    with pytest.raises(ValueError, match="3f\\+1"):
        Config(**{**HOTSTUFF_OK, "n_nodes": 8})


@pytest.mark.parametrize("gate", list(HOTSTUFF_GATES))
def test_hotstuff_gates_raise(gate):
    with pytest.raises(ValueError, match=HOTSTUFF_GATE_MESSAGE):
        Config(**{**HOTSTUFF_OK, **HOTSTUFF_GATES[gate]})


@pytest.mark.parametrize("gate", list(HOTSTUFF_GATES))
def test_hotstuff_gates_raise_beside_a_delay(gate):
    Config(**{**HOTSTUFF_OK, "max_delay_rounds": 8})
    with pytest.raises(ValueError, match=HOTSTUFF_GATE_MESSAGE):
        Config(**{**HOTSTUFF_OK, "max_delay_rounds": 8,
                  **HOTSTUFF_GATES[gate]})


@pytest.mark.parametrize("gate", list(HOTSTUFF_RUNS))
def test_hotstuff_takes_crash_and_desync(gate):
    """The SPEC §6c and §B gates run on HotStuff: the config is accepted,
    its static gates are the JAX package's, and a round runs KAJ first."""
    from consensus_tpu import Config as JConfig
    from consensus_tpu_torch.engines import hotstuff
    kw = {**HOTSTUFF_OK, **HOTSTUFF_RUNS[gate]}
    cfg, jcfg = Config(**kw), JConfig(**kw)
    assert (cfg.crash_on, cfg.desync_on) == (jcfg.crash_on, jcfg.desync_on)
    assert cfg.desync_cutoff == jcfg.desync_cutoff
    assert hotstuff.gated(cfg) == (cfg.crash_on or cfg.desync_on)


@pytest.mark.parametrize("gate", list(HOTSTUFF_RUNS))
def test_hotstuff_takes_crash_and_desync_beside_a_delay(gate):
    Config(**{**HOTSTUFF_OK, "max_delay_rounds": 8, **HOTSTUFF_RUNS[gate]})


@pytest.mark.parametrize("beside", ["crash", "desync"])
@pytest.mark.parametrize("gate", list(HOTSTUFF_GATES))
def test_hotstuff_gates_raise_beside_a_crash_or_a_desync(gate, beside):
    on = HOTSTUFF_RUNS[beside]
    Config(**{**HOTSTUFF_OK, **on})
    with pytest.raises(ValueError, match=HOTSTUFF_GATE_MESSAGE):
        Config(**{**HOTSTUFF_OK, **on, **HOTSTUFF_GATES[gate]})


# --- SPEC §6c crash-recover --------------------------------------------------

CRASH = dict(crash_prob=0.15, recover_prob=0.3)
# The six engines that run §6c, each at a small shape.
CRASH_ENGINES = {
    "raft-capped": OK, "raft-dense": {**OK, "max_active": 0},
    "pbft": PBFT_OK, "pbft-bcast": {**PBFT_OK, "fault_model": "bcast"},
    "paxos": dict(protocol="paxos", n_nodes=7, n_rounds=4, log_capacity=30),
    "dpos": dict(protocol="dpos", n_nodes=50, n_rounds=30, log_capacity=8),
}


@pytest.mark.parametrize("knob", sorted(tconfig.CRASH_KNOBS))
@pytest.mark.parametrize("engine", list(CRASH_ENGINES))
def test_crash_knobs_are_accepted_on_six_engines(engine, knob):
    value = {"crash_prob": 0.15, "recover_prob": 0.3, "max_crashed": 2}[knob]
    cfg = Config(**{**CRASH_ENGINES[engine], knob: value})
    assert cfg.crash_on == (knob == "crash_prob")


@pytest.mark.parametrize("ladder", ["dense", "bcast"])
def test_crash_on_a_ladder_raises_with_the_jax_message(ladder):
    """Both f-ladders raise at crash_prob > 0 with the JAX package's
    message (consensus_tpu/engines/pbft_sweep.py:604-610); recover_prob
    and max_crashed alone do not make a crash."""
    from consensus_tpu import Config as JConfig
    from consensus_tpu.engines import pbft_sweep as jsweep
    from consensus_tpu_torch.engines import pbft_sweep
    kw = dict(protocol="pbft", f=1, n_nodes=4, n_rounds=4, log_capacity=8,
              fault_model="edge" if ladder == "dense" else "bcast")
    with pytest.raises(ValueError) as want:
        jsweep.pbft_fsweep_run(JConfig(**kw, **CRASH), [1, 2])
    with pytest.raises(ValueError) as got:
        pbft_sweep.pbft_fsweep_run(Config(**kw, **CRASH), [1, 2],
                                   device="cpu")
    assert str(got.value) == str(want.value)
    pbft_sweep.pbft_fsweep_run(Config(**kw, recover_prob=0.5, max_crashed=2),
                               [1, 2], device="cpu")


@pytest.mark.parametrize("at", ["-1", "n+1"])
@pytest.mark.parametrize("engine", list(CRASH_ENGINES))
def test_max_crashed_out_of_range_raises_with_the_jax_message(engine, at):
    from consensus_tpu import Config as JConfig
    kw = CRASH_ENGINES[engine]
    bad = {**kw, **CRASH,
           "max_crashed": -1 if at == "-1" else kw["n_nodes"] + 1}
    with pytest.raises(ValueError) as want:
        JConfig(**bad)
    with pytest.raises(ValueError) as got:
        Config(**bad)
    assert str(got.value) == str(want.value)
    Config(**{**bad, "max_crashed": kw["n_nodes"]})


@pytest.mark.parametrize("knob", sorted(OFF_DEFAULT))
@pytest.mark.parametrize("engine", list(CRASH_ENGINES))
def test_unsupported_knob_raises_beside_a_crash(engine, knob):
    """A crash, which the port runs on these engines, lets no other gate
    through."""
    kw = {**CRASH_ENGINES[engine], **CRASH, "max_crashed": 2}
    Config(**kw)
    with pytest.raises(ValueError, match=knob):
        Config(**{**kw, knob: OFF_DEFAULT[knob]})


# --- SPEC §3c/§7c byzantine nodes --------------------------------------------

BYZ = {"silent": dict(n_byzantine=2), "equivocate": dict(
    n_byzantine=2, byz_mode="equivocate")}
# The engines that run byzantine nodes, each at a small shape.
BYZ_ENGINES = {"raft-capped": OK, "raft-dense": {**OK, "max_active": 0},
               "pbft": PBFT_OK, "pbft-bcast": {**PBFT_OK, "fault_model": "bcast"},
               "hotstuff": HOTSTUFF_OK}


@pytest.mark.parametrize("mode", list(BYZ))
@pytest.mark.parametrize("engine", list(BYZ_ENGINES))
def test_byzantine_knobs_are_accepted(engine, mode):
    from consensus_tpu import Config as JConfig
    kw = {**BYZ_ENGINES[engine], **BYZ[mode]}
    cfg = Config(**kw)
    JConfig(**kw)
    assert cfg.byz == (tconfig.BYZ_SILENT if mode == "silent"
                       else tconfig.BYZ_EQUIV)
    assert cfg.n_honest == cfg.n_nodes - 2
    assert Config(**{**kw, "n_byzantine": 0}).byz == tconfig.BYZ_NONE


@pytest.mark.parametrize("beside", ["delay", "crash", "desync"])
@pytest.mark.parametrize("mode", list(BYZ))
@pytest.mark.parametrize("engine", list(BYZ_ENGINES))
def test_byzantine_knobs_are_accepted_beside_the_other_gates(engine, mode,
                                                             beside):
    on = {"delay": dict(max_delay_rounds=8), "crash": CRASH,
          "desync": DESYNC}[beside]
    kw = {**BYZ_ENGINES[engine], **BYZ[mode], **on}
    if beside == "desync" and engine.startswith("raft"):
        with pytest.raises(ValueError, match="desync_rate"):
            Config(**kw)
    else:
        Config(**kw)


# The JAX package's SPEC §3c/§7c rejections (consensus_tpu/core/config.py:
# 193-209): more byzantine nodes than f on pbft and hotstuff, a count out of
# [0, n_nodes], byzantine nodes on another protocol, an unknown mode.
BYZ_REJECTIONS = {
    "pbft-above-f": dict(PBFT_OK, n_byzantine=3),
    "hotstuff-above-f": dict(HOTSTUFF_OK, n_byzantine=3,
                             byz_mode="equivocate"),
    "raft-negative": dict(OK, n_byzantine=-1),
    "raft-above-n": dict(OK, n_byzantine=10),
    "paxos": dict(protocol="paxos", n_nodes=7, n_rounds=4, log_capacity=30,
                  n_byzantine=1),
    "dpos": dict(protocol="dpos", n_nodes=50, n_rounds=30, log_capacity=8,
                 n_byzantine=1, byz_mode="equivocate"),
    "unknown-mode": dict(OK, n_byzantine=1, byz_mode="crash"),
    "unknown-mode-alone": dict(PBFT_OK, byz_mode="lie"),
}


@pytest.mark.parametrize("case", list(BYZ_REJECTIONS))
def test_byzantine_rejections_match_jax(case):
    from consensus_tpu import Config as JConfig
    with pytest.raises(ValueError) as want:
        JConfig(**BYZ_REJECTIONS[case])
    with pytest.raises(ValueError) as got:
        Config(**BYZ_REJECTIONS[case])
    assert str(got.value) == str(want.value)


def test_byzantine_count_equal_to_f_or_n_is_accepted():
    Config(**{**PBFT_OK, "n_byzantine": 2})
    Config(**{**HOTSTUFF_OK, "n_byzantine": 2, "byz_mode": "equivocate"})
    Config(**{**OK, "n_byzantine": 9})


def test_byzantine_ladder_past_its_smallest_rung_raises_as_jax_does():
    from consensus_tpu import Config as JConfig
    from consensus_tpu.engines import pbft_sweep as jsweep
    from consensus_tpu_torch.engines import pbft_sweep
    kw = dict(protocol="pbft", f=2, n_nodes=7, n_rounds=4, log_capacity=8,
              n_byzantine=2)
    with pytest.raises(ValueError) as want:
        jsweep.pbft_fsweep_run(JConfig(**kw), [1, 2])
    with pytest.raises(ValueError) as got:
        pbft_sweep.pbft_fsweep_run(Config(**kw), [1, 2], device="cpu")
    assert str(got.value) == str(want.value)
    out = pbft_sweep.pbft_fsweep_run(Config(**{**kw, "n_byzantine": 1}),
                                     [1, 2], device="cpu")
    assert [o["committed"].shape[1] for o in out] == [4, 7]


@pytest.mark.parametrize("mode", list(BYZ))
def test_byzantine_nodes_on_the_bcast_engine_raise(mode):
    """The §6b engine runs byzantine nodes (SPEC §3c/§7c) and raises where
    the JAX package raises, with its message: more than f of them."""
    from consensus_tpu import Config as JConfig
    kw = {**PBFT_OK, "fault_model": "bcast", **BYZ[mode]}
    JConfig(**kw)
    assert Config(**kw).byz != tconfig.BYZ_NONE
    over = {**kw, "n_byzantine": 3}
    with pytest.raises(ValueError) as want:
        JConfig(**over)
    with pytest.raises(ValueError, match="n_byzantine must be <= f") as got:
        Config(**over)
    assert str(got.value) == str(want.value)
    runner.run(Config(**kw), device="cpu")


@pytest.mark.parametrize("knob", sorted(OFF_DEFAULT))
@pytest.mark.parametrize("engine", list(BYZ_ENGINES))
def test_unsupported_knob_raises_beside_byzantine_nodes(engine, knob):
    """Byzantine nodes, which the port runs on these engines, let no other
    gate through."""
    kw = {**BYZ_ENGINES[engine], **BYZ["equivocate"]}
    Config(**kw)
    with pytest.raises(ValueError, match=knob):
        Config(**{**kw, knob: OFF_DEFAULT[knob]})


def test_knobs_of_other_protocols_are_not_fields():
    with pytest.raises(TypeError):
        Config(**OK, engine="cpu")


# --- SPEC §B view desync -----------------------------------------------------

DESYNC = dict(desync_rate=0.15, max_skew_rounds=4)
# The engines that run §B, each at a small shape.
DESYNC_ENGINES = {"pbft": PBFT_OK,
                  "pbft-bcast": {**PBFT_OK, "fault_model": "bcast"},
                  "hotstuff": HOTSTUFF_OK}


@pytest.mark.parametrize("engine", list(DESYNC_ENGINES))
def test_desync_knobs_are_accepted(engine):
    from consensus_tpu import Config as JConfig
    kw = {**DESYNC_ENGINES[engine], **DESYNC}
    cfg, jcfg = Config(**kw), JConfig(**kw)
    assert cfg.desync_on and cfg.desync_cutoff == jcfg.desync_cutoff
    assert not Config(**DESYNC_ENGINES[engine]).desync_on
    Config(**{**kw, "max_skew_rounds": 8})


# The JAX package's SPEC §B rejections (consensus_tpu/core/config.py:
# 315-328): a desync on a protocol without per-node view timers, a depth
# out of [1, 8], a depth without a desync.
DESYNC_REJECTIONS = {
    "raft-capped": dict(OK, desync_rate=0.1),
    "raft-dense": dict(OK, max_active=0, desync_rate=0.1),
    "paxos": dict(protocol="paxos", n_nodes=7, n_rounds=4, log_capacity=30,
                  desync_rate=0.1),
    "dpos": dict(protocol="dpos", n_nodes=50, n_rounds=30, log_capacity=8,
                 desync_rate=0.1),
    **{f"{e}-depth-{d}": dict(DESYNC_ENGINES[e], desync_rate=0.1,
                              max_skew_rounds=d)
       for e in ("pbft", "hotstuff") for d in (0, 9)},
    **{f"{e}-depth-alone": dict(DESYNC_ENGINES[e], max_skew_rounds=2)
       for e in ("pbft", "hotstuff")},
}


@pytest.mark.parametrize("case", list(DESYNC_REJECTIONS))
def test_desync_rejections_match_jax(case):
    from consensus_tpu import Config as JConfig
    with pytest.raises(ValueError) as want:
        JConfig(**DESYNC_REJECTIONS[case])
    with pytest.raises(ValueError) as got:
        Config(**DESYNC_REJECTIONS[case])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knob", sorted(OFF_DEFAULT))
@pytest.mark.parametrize("engine", list(DESYNC_ENGINES))
def test_unsupported_knob_raises_beside_a_desync(engine, knob):
    """A desync, which the port runs on these engines, lets no other gate
    through."""
    kw = {**DESYNC_ENGINES[engine], **DESYNC}
    Config(**kw)
    with pytest.raises(ValueError, match=knob):
        Config(**{**kw, knob: OFF_DEFAULT[knob]})


@pytest.mark.parametrize("ladder", ["dense", "bcast"])
def test_desync_on_a_ladder_runs(ladder):
    """Both f-ladders run SPEC §B (the JAX package's padded rounds skew by
    absolute ids); tests/test_torch_desync.py holds them to JAX."""
    from consensus_tpu_torch.engines import pbft_sweep
    kw = dict(protocol="pbft", f=1, n_nodes=4, n_rounds=4, log_capacity=8,
              fault_model="edge" if ladder == "dense" else "bcast", **DESYNC)
    out = pbft_sweep.pbft_fsweep_run(Config(**kw), [1, 2], device="cpu")
    assert [o["committed"].shape[1] for o in out] == [4, 7]


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
    # A ladder's key holds its rung list; ladders that differ only in
    # their seed share one graph.
    pad = Config(protocol="pbft", f=4, n_nodes=13, n_sweeps=3)
    ladder = runner._graph_key(pad, dev, False, [1, 2, 4])
    assert runner._graph_key(dataclasses.replace(pad, seed=9), dev, False,
                             (1, 2, 4)) == ladder
    assert runner._graph_key(pad, dev, False, [1, 3, 4]) != ladder
    assert runner._graph_key(pad, dev, False) != ladder


def test_every_kernel_source_has_a_counted_wrapper():
    from consensus_tpu_torch import _build
    assert [name for _, name in runner.KERNELS] == list(_build.SOURCES)
    assert {"delivery", "dense_elect", "dense_append", "dense_acks_commit",
            "dense_telemetry", "pbft_view_preprepare", "pbft_tally",
            "pbft_decide"} <= set(_build.SOURCES)
    for mod, name in runner.KERNELS:
        assert isinstance(getattr(mod, name).launches, int)
        assert callable(getattr(mod, name + "_plain"))


# --- Paxos and DPoS ----------------------------------------------------------

PAXOS_OK = dict(protocol="paxos", n_nodes=7, n_rounds=4, log_capacity=300)
DPOS_OK = dict(protocol="dpos", n_nodes=50, n_rounds=300, log_capacity=8)


def test_paxos_and_dpos_defaults_match_jax():
    from consensus_tpu import Config as JConfig
    names = ("n_proposers", "n_candidates", "n_producers", "epoch_len",
             "miss_rate", "suppress_rate", "suppress_window")
    got, want = Config(**DPOS_OK), JConfig(**DPOS_OK)
    assert {k: getattr(got, k) for k in names} == \
        {k: getattr(want, k) for k in names}
    assert (got.n_proposers, got.n_candidates, got.n_producers,
            got.epoch_len, got.suppress_window) == (0, 16, 4, 16, 16)


@pytest.mark.parametrize("kw", [
    dict(n_candidates=60),                  # more candidates than nodes
    dict(n_producers=17),                   # more producers than candidates
    dict(n_producers=0),
    dict(epoch_len=0)])
def test_dpos_rejections_match_jax(kw):
    from consensus_tpu import Config as JConfig
    with pytest.raises(ValueError) as want:
        JConfig(**{**DPOS_OK, **kw})
    with pytest.raises(ValueError) as got:
        Config(**{**DPOS_OK, **kw})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("base", [PAXOS_OK, DPOS_OK], ids=["paxos", "dpos"])
@pytest.mark.parametrize("knob", sorted(OFF_DEFAULT))
def test_unsupported_knob_raises_on_paxos_and_dpos(base, knob):
    with pytest.raises(ValueError, match=knob):
        Config(**{**base, knob: OFF_DEFAULT[knob]})


@pytest.mark.parametrize("kw", [PAXOS_OK, DPOS_OK], ids=["paxos", "dpos"])
def test_paxos_and_dpos_select_their_engines(kw):
    """Each selects its engine, named as the JAX package names it, takes
    any slot count, and runs with telemetry."""
    from consensus_tpu import Config as JConfig
    from consensus_tpu.network import simulator as jsim
    cfg = Config(**kw)
    eng = simulator.engine_def(cfg)
    assert eng is {"paxos": runner.PAXOS, "dpos": runner.DPOS}[cfg.protocol]
    assert eng.name == jsim.engine_def(JConfig(**kw)).name
    res = simulator.run(cfg, device="cpu", telemetry=True)
    assert res.extras["telemetry"]["names"] == list(eng.telemetry_names)
    assert runner.lane_inputs(cfg).keys() == {"seed"}


# --- SPEC §A.1, §A.3 and §A.4: the one-engine gates --------------------------

# Every engine at a small shape (n_nodes 9 on both Raft engines).
GATE_ENGINES = {"raft-capped": OK, "raft-dense": {**OK, "max_active": 0},
                "pbft": PBFT_OK,
                "pbft-bcast": {**PBFT_OK, "fault_model": "bcast"},
                "paxos": PAXOS_OK, "dpos": DPOS_OK, "hotstuff": HOTSTUFF_OK}
RAFT_ENGINES = ("raft-capped", "raft-dense")
# The settings the port runs, each where the JAX package runs it.
GATE_RUNS = {
    **{f"{e}/{name}": (e, kw) for e in RAFT_ENGINES for name, kw in (
        ("elect", dict(attack="elect")),
        ("elect-rate", dict(attack="elect", attack_rate=0.85)),
        ("sticky", dict(attack="sticky")),
        ("sticky-target", dict(attack="sticky", attack_rate=0.5,
                               attack_target=8)))},
    "dpos/miss": ("dpos", dict(miss_rate=0.35)),
    "dpos/suppress": ("dpos", dict(suppress_rate=0.3)),
    "dpos/suppress-window": ("dpos", dict(suppress_rate=0.3,
                                          suppress_window=1)),
    "dpos/all": ("dpos", dict(miss_rate=0.1, suppress_rate=0.3,
                              suppress_window=24)),
}
# The other gates a gate is composed with, on every engine of GATE_RUNS.
BESIDE = {"alone": {}, "delay": dict(max_delay_rounds=2),
          "crash": dict(crash_prob=0.05, recover_prob=0.3, max_crashed=2)}


@pytest.mark.parametrize("beside", list(BESIDE))
@pytest.mark.parametrize("case", list(GATE_RUNS))
def test_gate_knobs_are_accepted_with_the_jax_cutoffs(case, beside):
    from consensus_tpu import Config as JConfig
    engine, gate = GATE_RUNS[case]
    kw = {**GATE_ENGINES[engine], **gate, **BESIDE[beside]}
    cfg, jcfg = Config(**kw), JConfig(**kw)
    for cut in ("miss_cutoff", "attack_cutoff", "suppress_cutoff"):
        assert getattr(cfg, cut) == getattr(jcfg, cut)
    assert (cfg.miss_on, cfg.suppress_on) == (jcfg.miss_on, jcfg.suppress_on)
    assert cfg.attack_mode == tconfig.ATTACKS.index(jcfg.attack)


@pytest.mark.parametrize("mode", list(BYZ))
@pytest.mark.parametrize("case", [c for c in GATE_RUNS if c[:4] == "raft"])
def test_attacks_are_accepted_beside_byzantine_nodes(case, mode):
    from consensus_tpu import Config as JConfig
    engine, gate = GATE_RUNS[case]
    kw = {**GATE_ENGINES[engine], **gate, **BYZ[mode]}
    assert Config(**kw).attack_cutoff == JConfig(**kw).attack_cutoff


def test_attack_rate_one_is_the_largest_strict_cutoff():
    """attack_rate's default 1.0 gives 0xFFFFFFFF, not 2**32: the kernels'
    u32 compare draw < cut, so a draw of 0xFFFFFFFF does not fire
    (consensus_tpu/core/rng.py:359-363)."""
    cfg = Config(**{**OK, "attack": "elect"})
    assert cfg.attack_cutoff == 0xFFFFFFFF
    assert Config(**OK).attack_mode == tconfig.ATTACK_NONE
    assert not Config(**DPOS_OK).miss_on and not Config(**DPOS_OK).suppress_on


def _gate_rejections() -> dict:
    """Each setting the JAX package's Config refuses for a gate of this
    slice (consensus_tpu/core/config.py:219-223, 229-253, 329-340), by
    name: one violation each."""
    out = {}
    for e, base in GATE_ENGINES.items():
        n = base["n_nodes"]
        if e != "dpos":
            out[f"{e}/miss"] = dict(base, miss_rate=0.1)
            out[f"{e}/suppress"] = dict(base, suppress_rate=0.1)
        out[f"{e}/window-alone"] = dict(base, suppress_window=8)
        out[f"{e}/unknown-attack"] = dict(base, attack="flood")
        out[f"{e}/rate-alone"] = dict(base, attack_rate=0.5)
        out[f"{e}/target-alone"] = dict(base, attack_target=1)
        if e in RAFT_ENGINES:
            out[f"{e}/elect-target"] = dict(base, attack="elect",
                                            attack_target=1)
            for at in (-1, n):
                out[f"{e}/sticky-target-{at}"] = dict(
                    base, attack="sticky", attack_target=at)
        else:
            for attack in ("elect", "sticky"):
                out[f"{e}/{attack}"] = dict(base, attack=attack)
    for window in (0, -1):
        out[f"dpos/window-{window}"] = dict(DPOS_OK, suppress_rate=0.1,
                                            suppress_window=window)
    return out


GATE_REJECTIONS = _gate_rejections()


@pytest.mark.parametrize("beside", list(BESIDE))
@pytest.mark.parametrize("case", list(GATE_REJECTIONS))
def test_gate_rejections_match_jax(case, beside):
    """The port raises what the JAX package raises, with its message, also
    beside a delay and a crash, which the port runs on every engine."""
    from consensus_tpu import Config as JConfig
    kw = {**GATE_REJECTIONS[case], **BESIDE[beside]}
    with pytest.raises(ValueError) as want:
        JConfig(**kw)
    with pytest.raises(ValueError) as got:
        Config(**kw)
    assert str(got.value) == str(want.value)



# --- SPEC §9 switch and §9b --------------------------------------------------

SWITCH = dict(net_model="switch", n_aggregators=3, agg_fail_rate=0.1,
              agg_stale_rate=0.2, agg_max_stale=4)
# The engines that run the switch, each at a small shape.
SWITCH_ENGINES = {
    "raft-capped": OK, "raft-dense": {**OK, "max_active": 0},
    "paxos": PAXOS_OK, "hotstuff": HOTSTUFF_OK, "pbft-edge": PBFT_OK,
    "pbft-bcast": {**PBFT_OK, "fault_model": "bcast"},
}
# Beside each gate the port composes the switch with.
SWITCH_BESIDE = {"none": {}, "delay": dict(max_delay_rounds=3),
                 "crash": dict(crash_prob=0.1, recover_prob=0.3),
                 "partition": dict(partition_rate=0.2)}
# SPEC §9b on HotStuff and PBFT: each axis alone and both.
SWITCH_9B = {
    "poison": dict(agg_byz=1, agg_poison_rate=0.5),
    "lies": dict(n_byzantine=2, byz_uplink_rate=0.4),
    "both": dict(agg_byz=2, agg_poison_rate=0.9, n_byzantine=2,
                 byz_mode="equivocate", byz_uplink_rate=0.4),
}
# Every SPEC §9/§9b check of the JAX package
# (consensus_tpu/core/config.py:254-315), on a config of each engine:
# (settings, a piece of the JAX package's message).
SWITCH_REJECTIONS = {
    "unknown-model": (dict(net_model="mesh"), "unknown net_model"),
    "k-zero": (dict(net_model="switch", n_aggregators=0),
               "requires 1 <= n_aggregators"),
    "k-above-n": (dict(net_model="switch", n_aggregators=100),
                  "requires 1 <= n_aggregators"),
    "agg-byz-above-k": (dict(SWITCH, agg_byz=4), "agg_byz must be in"),
    "agg-byz-negative": (dict(SWITCH, agg_byz=-1), "agg_byz must be in"),
    "poison-without-byz": (dict(SWITCH, agg_poison_rate=0.3),
                           "requires agg_byz > 0"),
    "k-on-flat": (dict(n_aggregators=2), "require net_model='switch'"),
    "fail-on-flat": (dict(agg_fail_rate=0.1), "require net_model='switch'"),
    "stale-on-flat": (dict(agg_stale_rate=0.1),
                      "require net_model='switch'"),
    "depth-on-flat": (dict(agg_max_stale=2), "require net_model='switch'"),
    "agg-byz-on-flat": (dict(agg_byz=1), "require net_model='switch'"),
    "poison-on-flat": (dict(agg_poison_rate=0.1),
                       "require net_model='switch'"),
    "lies-on-flat": (dict(byz_uplink_rate=0.1),
                     "require net_model='switch'"),
    "depth-zero": (dict(SWITCH, agg_max_stale=0), "agg_max_stale must be"),
    "depth-nine": (dict(SWITCH, agg_max_stale=9), "agg_max_stale must be"),
}


def _jax_message(kw):
    from consensus_tpu import Config as JConfig
    with pytest.raises(ValueError) as err:
        JConfig(**kw)
    return str(err.value)


@pytest.mark.parametrize("beside", list(SWITCH_BESIDE))
@pytest.mark.parametrize("engine", list(SWITCH_ENGINES))
def test_switch_is_accepted_with_the_jax_gates(engine, beside):
    from consensus_tpu import Config as JConfig
    kw = {**SWITCH_ENGINES[engine], **SWITCH_BESIDE[beside], **SWITCH}
    cfg, jcfg = Config(**kw), JConfig(**kw)
    for gate in ("switch_on", "agg_fail_on", "agg_stale_on",
                 "agg_poison_on", "uplink_lies_on", "agg_fail_cutoff",
                 "agg_stale_cutoff", "agg_poison_cutoff",
                 "byz_uplink_cutoff"):
        assert getattr(cfg, gate) == getattr(jcfg, gate), gate
    assert cfg.switch_on


@pytest.mark.parametrize("case", list(SWITCH_9B))
def test_switch_9b_is_accepted_on_hotstuff(case):
    from consensus_tpu import Config as JConfig
    kw = {**HOTSTUFF_OK, **SWITCH, **SWITCH_9B[case]}
    cfg, jcfg = Config(**kw), JConfig(**kw)
    assert (cfg.agg_poison_on, cfg.uplink_lies_on) == \
        (jcfg.agg_poison_on, jcfg.uplink_lies_on)
    assert (cfg.agg_poison_cutoff, cfg.byz_uplink_cutoff) == \
        (jcfg.agg_poison_cutoff, jcfg.byz_uplink_cutoff)


@pytest.mark.parametrize("case", list(SWITCH_REJECTIONS))
@pytest.mark.parametrize("engine", list(SWITCH_ENGINES))
def test_switch_rejections_match_jax(engine, case):
    kw, piece = SWITCH_REJECTIONS[case]
    kw = {**SWITCH_ENGINES[engine], **kw}
    msg = _jax_message(kw)
    assert piece in msg
    with pytest.raises(ValueError) as err:
        Config(**kw)
    assert str(err.value) == msg


@pytest.mark.parametrize("case", list(SWITCH_9B))
@pytest.mark.parametrize("engine", ["raft-capped", "raft-dense", "paxos"])
def test_switch_9b_off_the_bft_engines_raises_with_the_jax_message(engine,
                                                                   case):
    kw = {**SWITCH_ENGINES[engine], **SWITCH, **SWITCH_9B[case]}
    if engine == "paxos":
        kw.pop("n_byzantine", None), kw.pop("byz_mode", None)
    msg = _jax_message(kw)
    with pytest.raises(ValueError) as err:
        Config(**kw)
    assert str(err.value) == msg


def test_uplink_lies_without_byzantine_nodes_raise_with_the_jax_message():
    kw = {**HOTSTUFF_OK, **SWITCH, "byz_uplink_rate": 0.3}
    msg = _jax_message(kw)
    assert "requires n_byzantine > 0" in msg
    with pytest.raises(ValueError) as err:
        Config(**kw)
    assert str(err.value) == msg


def test_switch_on_dpos_raises_with_the_jax_message():
    kw = {**DPOS_OK, **SWITCH}
    msg = _jax_message(kw)
    with pytest.raises(ValueError) as err:
        Config(**kw)
    assert str(err.value) == msg


@pytest.mark.parametrize("case", list(SWITCH_9B))
@pytest.mark.parametrize("model", ["edge", "bcast"])
def test_switch_9b_is_accepted_on_pbft(model, case):
    """SPEC §9b on both PBFT fault models (and so both ladders), each axis
    alone and both, with the JAX package's gates and cutoffs."""
    from consensus_tpu import Config as JConfig
    kw = {**PBFT_OK, "fault_model": model, **SWITCH, **SWITCH_9B[case]}
    cfg, jcfg = Config(**kw), JConfig(**kw)
    for gate in ("switch_on", "agg_poison_on", "uplink_lies_on",
                 "agg_poison_cutoff", "byz_uplink_cutoff"):
        assert getattr(cfg, gate) == getattr(jcfg, gate), gate
    assert cfg.switch_on


@pytest.mark.parametrize("model", ["edge", "bcast"])
def test_ladder_rejects_more_aggregators_than_its_least_rung(model):
    """``_fsweep_static``'s K <= 3 min(fs) + 1 with the JAX package's
    message (consensus_tpu/engines/pbft_sweep.py:618-624); K at the bound
    is accepted."""
    from consensus_tpu import Config as JConfig
    from consensus_tpu.engines import pbft_sweep as jsweep
    from consensus_tpu_torch.engines import pbft_sweep
    kw = dict(protocol="pbft", fault_model=model, f=5, n_nodes=16,
              n_rounds=4, log_capacity=8, net_model="switch",
              n_aggregators=8)
    with pytest.raises(ValueError) as want:
        jsweep._fsweep_static(JConfig(**kw), [1, 3])
    with pytest.raises(ValueError) as got:
        pbft_sweep._fsweep_static(Config(**kw), [1, 3])
    assert str(got.value) == str(want.value)
    assert "n_aggregators=8" in str(got.value)
    at = {**kw, "n_aggregators": 4}
    assert pbft_sweep._fsweep_static(Config(**at), [1, 3])[1].switch_on


@pytest.mark.parametrize("k", [1, 5, 9])
def test_switch_takes_any_k_from_one_to_n(k):
    for base in (OK, {**OK, "max_active": 0}):
        assert Config(**{**base, **SWITCH, "n_aggregators": k}).switch_on
