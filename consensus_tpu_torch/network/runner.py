"""The batched round loop: the port of ``consensus_tpu/network/runner.py``'s
plain path (``EngineDef``, ``make_seeds``, ``_init_jit``, the scan of
``_chunk_jit`` with ``_chunk_body``'s telemetry accumulators, ``run``), for
the dense and the capped Raft engine, the dense and the §6b broadcast
PBFT engine, the Paxos, the DPoS and the HotStuff engine alike, and of
``consensus_tpu/engines/pbft_sweep.py``'s ``_fsweep_jit``: a PBFT f-ladder
is one run whose lanes carry their own population and tolerance. And of
the JAX runner's ``run_knob_batch`` (``_knob_batch_jit``, K23) on every
engine, with the switch too: a generation of adversary-search candidates
as the lanes of one run, each lane with its own row of adversary cutoffs
(``core/knobs.py``).

Sweeps (lanes) are the leading batch axis of every state tensor. A run's
per-lane inputs are its seeds and, for PBFT, each lane's ``n_real`` and
``f`` (:func:`lane_inputs`). On the CPU a Python loop over rounds takes
the place of ``lax.scan``. On ``cuda`` the whole run (init from the seed
tensor, the ``n_rounds`` rounds and the accumulators) is captured once as
one CUDA graph and then replayed after the lane inputs are copied into the
graph's static input tensors: the counterpart of JAX's compile-then-execute
of one scan. The eager loop stays available on the card as ``graph=False``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _build
from ..core import knobs, rng
from ..core.config import Config
from ..engines import (dpos, hotstuff, paxos, pbft, pbft_bcast, pbft_sweep,
                       raft, raft_sparse)
from ..engines.raft import RAFT_LATENCY, RAFT_TELEMETRY
from ..ops import adversary, aggregate, switch_tally
from ..ops.flight import BUCKET_LO, N_BUCKETS

# The kernel wrappers the runs launch, one for each source that
# ``_build.SOURCES`` lists, as (module, attribute): launches are counted on
# the attribute, so a stand-in put there counts its own.
_WRAPPER_MODULES = {"random_u32": rng, "delivery_edges": adversary,
                    "delivery": adversary, "dense_elect": raft,
                    "dense_append": raft, "dense_acks_commit": raft,
                    "dense_telemetry": raft, "pbft_view_preprepare": pbft,
                    "pbft_tally": pbft, "pbft_decide": pbft,
                    "bcast_view_preprepare": pbft_bcast,
                    "bcast_tally": pbft_bcast, "bcast_decide": pbft_bcast,
                    "bcast_equiv_support": pbft_bcast,
                    "dpos_schedule": dpos, "dpos_round": dpos,
                    "paxos_promise": paxos, "paxos_accept_learn": paxos,
                    "pbft_telemetry": pbft, "dpos_telemetry": dpos,
                    "paxos_telemetry": paxos, "hotstuff_propose": hotstuff,
                    "hotstuff_vote": hotstuff, "hotstuff_learn": hotstuff,
                    "hotstuff_extract": hotstuff,
                    "crash_transition": adversary, "freeze_down": adversary,
                    "hotstuff_prologue": hotstuff, "agg_round": aggregate,
                    "switch_combine": switch_tally,
                    "switch_receive": switch_tally}
KERNELS = tuple((_WRAPPER_MODULES.get(name, raft_sparse), name)
                for name in _build.SOURCES)
# The wrappers with SPEC §9 SWITCH instances, whose launches of those are
# counted apart on the wrapper's ``switch_launches`` (and in ``launches``),
# and PBFT's switch kernels KAM and KAN, all of whose launches are.
SWITCH_KERNELS = tuple((_WRAPPER_MODULES[name], name) for name in (
    "delivery_edges", "dense_elect", "paxos_promise", "paxos_accept_learn",
    "hotstuff_vote", "switch_combine", "switch_receive"))
# The wrappers with KNOBS instances (a knob batch's lanes read their own
# cutoffs), whose launches of those are counted apart on the wrapper's
# ``knob_launches`` (and in ``launches``).
KNOB_KERNELS = tuple((_WRAPPER_MODULES.get(name, raft_sparse), name)
                     for name in (
    "hotstuff_prologue", "hotstuff_propose", "hotstuff_vote", "agg_round",
    "crash_transition", "bcast_view_preprepare", "delivery",
    "pbft_view_preprepare", "switch_combine", "switch_receive",
    "dense_elect", "paxos_promise", "paxos_accept_learn", "dpos_round",
    "dpos_telemetry", "candidacy", "delivery_edges"))


class Engine(NamedTuple):
    """An engine as the runner sees it, after the JAX package's
    ``EngineDef``: ``init(cfg, seeds)`` gives the batched state,
    ``round(cfg, st, r, **lanes, **accumulators, **statics)`` the next one
    (the lane inputs but the seeds, the accumulators only with telemetry,
    and ``statics(cfg, rungs)``: the run's fixed arguments of the round,
    where the engine has any), and ``extract(st)`` the leaves the digest
    reads. ``telemetry_names`` name the counters of the telemetry vector
    and ``latency_names`` the flight recorder's histograms; every engine
    of the port has them."""
    name: str
    init: Callable
    round: Callable
    extract: Callable
    telemetry_names: tuple[str, ...]
    latency_names: tuple[str, ...]
    statics: Callable | None = None


DENSE = Engine(raft.NAME, raft.raft_init, raft.raft_round, raft.extract,
               RAFT_TELEMETRY, RAFT_LATENCY)
CAPPED = Engine(raft_sparse.NAME, raft_sparse.raft_sparse_init,
                raft_sparse.raft_sparse_round, raft_sparse.extract,
                RAFT_TELEMETRY, RAFT_LATENCY)
PBFT = Engine(pbft.NAME, pbft.pbft_init, pbft.pbft_round, pbft.extract,
              pbft.PBFT_TELEMETRY, pbft.PBFT_LATENCY)
# The §6b round takes its tallies' table width m (the widest rung's on a
# ladder).
PBFT_BCAST = Engine(pbft_bcast.NAME, pbft.pbft_init,
                    pbft_bcast.pbft_bcast_round, pbft.extract,
                    pbft.PBFT_TELEMETRY, pbft.PBFT_LATENCY,
                    statics=lambda cfg, rungs: {
                        "m": pbft_bcast.table_cap(cfg, rungs)})
PAXOS = Engine(paxos.NAME, paxos.paxos_init, paxos.paxos_round,
               paxos.extract, paxos.PAXOS_TELEMETRY, paxos.PAXOS_LATENCY)
DPOS = Engine(dpos.NAME, dpos.dpos_init, dpos.dpos_step, dpos.extract,
              dpos.DPOS_TELEMETRY, dpos.DPOS_LATENCY)
HOTSTUFF = Engine(hotstuff.NAME, hotstuff.hotstuff_init,
                  hotstuff.hotstuff_round, hotstuff.extract,
                  hotstuff.HOTSTUFF_TELEMETRY, hotstuff.HOTSTUFF_LATENCY)


def engine(cfg: Config) -> Engine:
    """The engine ``cfg`` selects (``consensus_tpu/network/simulator.py``
    engine_def): by protocol (paxos, dpos, hotstuff), then, for pbft, by
    fault model (the §6b
    broadcast engine at ``fault_model="bcast"``), for raft dense at
    ``max_active = 0``, else the §3b capped one."""
    if cfg.protocol == "paxos":
        return PAXOS
    if cfg.protocol == "dpos":
        return DPOS
    if cfg.protocol == "hotstuff":
        return HOTSTUFF
    if cfg.protocol == "pbft":
        return PBFT_BCAST if cfg.fault_model == "bcast" else PBFT
    return DENSE if cfg.max_active == 0 else CAPPED


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launch count, by wrapper name."""
    return {name: getattr(mod, name).launches for mod, name in KERNELS}


def switch_launch_counts() -> dict[str, int]:
    """Each SWITCH instance's launch count, by wrapper name."""
    return {name: getattr(mod, name).switch_launches
            for mod, name in SWITCH_KERNELS}


def knob_launch_counts() -> dict[str, int]:
    """Each KNOBS instance's launch count, by wrapper name."""
    return {name: getattr(mod, name).knob_launches
            for mod, name in KNOB_KERNELS}


def _all_counts() -> dict[tuple, int]:
    return {**{(n, "launches"): v for n, v in launch_counts().items()},
            **{(n, "switch_launches"): v
               for n, v in switch_launch_counts().items()},
            **{(n, "knob_launches"): v
               for n, v in knob_launch_counts().items()}}


def _add_launches(counts: dict[tuple, int]) -> None:
    wrappers = {name: mod for mod, name in KERNELS}
    for (name, attr), n in counts.items():
        fn = getattr(wrappers[name], name)
        setattr(fn, attr, getattr(fn, attr) + n)


class RunOutput(NamedTuple):
    """A run's final state and accumulators (None where switched off)."""
    state: (raft.RaftState | raft_sparse.RaftSparseState | pbft.PbftState
            | paxos.PaxosState | dpos.DposState | hotstuff.HotstuffState)
    telem: torch.Tensor | None   # [B, K] i32 counter totals
    win: torch.Tensor | None     # [B, n_windows, K] i32 window ring
    lat: torch.Tensor | None     # [B, H, N_BUCKETS] i32 latency buckets


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when the
    chosen device is a GPU that is not there (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


def make_seeds(cfg: Config) -> np.ndarray:
    """Per-sweep u32 seeds; sweep b uses lo32(seed + b) (SPEC §1)."""
    return ((np.uint64(cfg.seed) + np.arange(cfg.n_sweeps, dtype=np.uint64))
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def lane_inputs(cfg: Config, rungs=None) -> dict[str, np.ndarray]:
    """A run's per-lane inputs as numpy arrays: ``seed`` ([B] u32) and, for
    PBFT, ``n_real`` and ``f`` ([B] i32). ``rungs`` (PBFT only) makes the
    run an f-ladder (``engines/pbft_sweep.py`` :func:`ladder_lanes`: rung
    k, sweep j); without it every lane is ``cfg``'s own population."""
    if cfg.protocol != "pbft":
        if rungs is not None:
            raise ValueError("an f-ladder (rungs) is a pbft run")
        return {"seed": make_seeds(cfg)}
    if rungs is not None:
        return pbft_sweep.ladder_lanes(cfg, rungs)
    full = np.full(cfg.n_sweeps, 1, np.int32)
    return {"seed": make_seeds(cfg), "n_real": full * cfg.n_nodes,
            "f": full * cfg.f}


def n_windows(cfg: Config) -> int:
    """Window count of the flight recorder's ring:
    ceil(n_rounds / telemetry_window)."""
    return -(-cfg.n_rounds // cfg.telemetry_window)


def init(cfg: Config, seeds: np.ndarray, device):
    """A fresh batched state of ``cfg``'s engine, one sweep per seed."""
    return engine(cfg).init(
        cfg, torch.from_numpy(np.asarray(seeds, np.uint32)).to(device))


def device_lanes(cfg: Config, rungs, device) -> dict[str, torch.Tensor]:
    """:func:`lane_inputs` as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in lane_inputs(cfg, rungs).items()}


def advance(cfg: Config, st, r0: int, n_rounds: int, *, telem=None,
            flight=None, lanes=None, rungs=None):
    """Rounds r0 .. r0 + n_rounds - 1 of every sweep of ``cfg``'s engine,
    adding into the accumulators ``telem`` and ``flight`` where given (see
    :func:`raft_sparse.raft_sparse_round`). ``lanes`` holds the round's
    per-lane tensors but the seeds: PBFT's ``n_real`` and ``f``
    (:func:`device_lanes`); ``rungs`` is a ladder's rung list, which the
    §6b engine's table width reads."""
    eng = engine(cfg)
    acc = {} if telem is None else dict(telem=telem, flight=flight)
    acc.update(lanes or {})
    if eng.statics is not None:
        acc.update(eng.statics(cfg, rungs))
    for r in range(r0, r0 + n_rounds):
        st = eng.round(cfg, st, r, **acc)
    return st


def accumulators(cfg: Config, device) -> tuple:
    """Zeroed telemetry accumulators of ``cfg``'s run, as the round takes
    them: ``(telem [B, K], flight)``, where ``flight`` is the window ring
    and latency buckets ``([B, n_windows, K], [B, H, N_BUCKETS])``, or
    None when ``cfg.telemetry_window`` is 0. All int32; K and H are the
    counts of the engine's telemetry and latency names."""
    eng = engine(cfg)
    z = dict(dtype=torch.int32, device=device)
    B, K = cfg.n_sweeps, len(eng.telemetry_names)
    flight = None
    if cfg.telemetry_window > 0:
        flight = (torch.zeros((B, n_windows(cfg), K), **z),
                  torch.zeros((B, len(eng.latency_names), N_BUCKETS), **z))
    return torch.zeros((B, K), **z), flight


def _rounds(cfg: Config, lanes: dict[str, torch.Tensor], n_rounds: int,
            telemetry: bool, rungs=None) -> RunOutput:
    """Init from the [B] u32 ``lanes["seed"]`` tensor, zeroed
    accumulators, then rounds 0 .. n_rounds - 1 with the other lane
    tensors: everything on the device, nothing from the host, so that it
    can be captured as a graph. A knob batch's ``lanes["knobs"]`` ([B, 12]
    int64) runs the rounds on a :class:`~consensus_tpu_torch.core.knobs.
    KnobView` of ``cfg`` over that table."""
    seeds = lanes["seed"]
    view = cfg if "knobs" not in lanes else knobs.KnobView(cfg,
                                                            lanes["knobs"])
    telem, flight = (accumulators(cfg, seeds.device) if telemetry
                     else (None, None))
    st = advance(view, engine(cfg).init(view, seeds), 0, n_rounds,
                 telem=telem, flight=flight,
                 lanes={k: v for k, v in lanes.items()
                        if k not in ("seed", "knobs")},
                 rungs=rungs)
    return RunOutput(st, telem, *(flight or (None, None)))


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    lanes: dict[str, torch.Tensor]  # the graph's static inputs
    out: RunOutput               # the graph's static outputs
    launches: dict[tuple, int]   # launches of one replay, by (wrapper,
    #                              counter)


# The most recently captured runs, by :func:`_graph_key`, oldest first.
# Each holds its run's state (at the flagship shape about 0.9 GB), so only
# GRAPH_CACHE_SIZE are kept.
GRAPH_CACHE_SIZE = 1
_GRAPHS: collections.OrderedDict[tuple, _Captured] = collections.OrderedDict()
# Graphs captured in this process.
captures = 0


def _graph_key(cfg: Config, dev: torch.device, telemetry: bool,
               rungs=None) -> tuple:
    """The cache key of ``cfg``'s captured run, with a PBFT ladder's rung
    list. The seed is left out: it reaches the graph only through its
    static seed tensor, which is set before each replay, so runs that
    differ only in their seed share one capture."""
    return (dataclasses.replace(cfg, seed=0), dev, telemetry,
            None if rungs is None else tuple(int(f) for f in rungs))


def clear_graphs() -> None:
    """Drop every cached graph and, once the caller holds none of their
    outputs, the device memory they keep."""
    _GRAPHS.clear()


def _capture(cfg: Config, dev: torch.device, telemetry: bool,
             rungs, inputs: dict[str, np.ndarray]) -> _Captured:
    """Capture ``cfg``'s whole run on ``dev`` as one CUDA graph, with the
    per-lane ``inputs`` as its static input tensors. One eager round first
    builds and loads every kernel, so that nothing is loaded and no host
    data is copied while the stream is captured. A capture records no
    launch on the device, so the counts its wrappers took are taken back
    and added at each replay instead. A failed capture raises."""
    global captures
    lanes = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
    _rounds(cfg, lanes, 1, telemetry, rungs)
    torch.cuda.synchronize(dev)
    before = _all_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _rounds(cfg, lanes, cfg.n_rounds, telemetry, rungs)
    recorded = {k: v - before[k] for k, v in _all_counts().items()}
    _add_launches({k: -v for k, v in recorded.items()})
    captures += 1
    return _Captured(graph, lanes, out, recorded)


def run_device(cfg: Config, device=None, *, telemetry: bool = False,
               graph: bool | None = None, rungs=None) -> RunOutput:
    """Run ``cfg.n_rounds`` rounds from a fresh state and return the final
    state and accumulators on the device, after the device has finished.

    ``telemetry`` accumulates the counters (and, with
    ``cfg.telemetry_window > 0``, the flight recorder), on every engine
    but a PBFT f-ladder, which has none in the JAX package either (its
    CLI rejects a window on one). ``rungs`` runs a PBFT f-ladder
    (:func:`lane_inputs`). ``graph`` (default: on ``cuda``,
    and only there) replays the run as one CUDA graph, captured at the
    first call for this (cfg but its seed, device, telemetry, rungs) and
    kept until a run of another configuration is captured; the returned
    tensors are then the graph's static outputs, which the next replay of
    the same configuration, with any seed, overwrites: copy them before
    that.
    ``graph=False`` runs the rounds eagerly, one launch at a time."""
    dev = resolve_device(device)
    if telemetry and not engine(cfg).telemetry_names:
        raise ValueError(f"the {engine(cfg).name} engine has no telemetry")
    if telemetry and rungs is not None:
        raise ValueError("an f-ladder (rungs) has no telemetry: run each "
                         "rung's config on its own")
    if cfg.telemetry_window > 0 and not telemetry:
        raise ValueError(
            "telemetry_window > 0 without telemetry=True: the window ring "
            "is the telemetry counter series, windowed")
    return _execute(cfg, dev, telemetry, graph, rungs,
                    lane_inputs(cfg, rungs),
                    lambda d: _graph_key(cfg, d, telemetry, rungs))


def _execute(cfg: Config, dev: torch.device, telemetry: bool, graph,
             rungs, inputs: dict[str, np.ndarray], key) -> RunOutput:
    """:func:`run_device`'s run of ``cfg`` with the per-lane ``inputs``:
    eager, or as the replay of the CUDA graph cached under ``key(dev)``,
    captured where it is not, after ``inputs`` are copied into its static
    input tensors."""
    if graph is None:
        graph = dev.type == "cuda"
    if not graph:
        out = _rounds(cfg, {k: torch.from_numpy(v).to(dev)
                            for k, v in inputs.items()}, cfg.n_rounds,
                      telemetry, rungs)
    elif dev.type != "cuda":
        raise ValueError("graph=True replays a CUDA graph: it needs a cuda "
                         "device")
    else:
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        k = key(dev)
        with torch.cuda.device(dev):
            if k not in _GRAPHS:
                while len(_GRAPHS) >= GRAPH_CACHE_SIZE:
                    _GRAPHS.popitem(last=False)
                _GRAPHS[k] = _capture(cfg, dev, telemetry, rungs, inputs)
            _GRAPHS.move_to_end(k)
            cap = _GRAPHS[k]
            for name, a in inputs.items():
                cap.lanes[name].copy_(torch.from_numpy(a))
            cap.graph.replay()
        _add_launches(cap.launches)
        out = cap.out
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def telemetry_stats(cfg: Config, out: RunOutput) -> dict:
    """The ``stats["telemetry"]`` and ``stats["flight"]`` dicts of the JAX
    package's ``run`` (keys, shapes and int64 values), from a run's
    accumulators; empty where they were off."""
    stats: dict = {}
    eng = engine(cfg)
    if out.telem is not None:
        tarr = out.telem.cpu().numpy().astype(np.int64)
        stats["telemetry"] = {name: tarr[:, k]
                              for k, name in enumerate(eng.telemetry_names)}
    if out.win is not None:
        warr = out.win.cpu().numpy().astype(np.int64)
        larr = out.lat.cpu().numpy().astype(np.int64)
        stats["flight"] = {
            "window_rounds": cfg.telemetry_window,
            "n_windows": n_windows(cfg),
            "n_rounds": cfg.n_rounds,
            "bucket_lo": list(BUCKET_LO),
            "windows": {name: warr[:, :, k]
                        for k, name in enumerate(eng.telemetry_names)},
            "latency": {name: larr[:, h, :]
                        for h, name in enumerate(eng.latency_names)},
        }
    return stats


def run(cfg: Config, device=None, *, telemetry: bool = False,
        stats: dict | None = None,
        graph: bool | None = None) -> dict[str, np.ndarray]:
    """Run ``cfg.n_rounds`` rounds (:func:`run_device`) and return the
    extract dict as numpy arrays, as the JAX package's ``run`` does. With a
    ``stats`` dict, fill ``start_round`` and ``executed_rounds``, and with
    ``telemetry`` the per-sweep counters (``stats["telemetry"]``) and,
    with ``cfg.telemetry_window > 0``, the flight recorder
    (``stats["flight"]``)."""
    if telemetry and stats is None:
        raise ValueError("telemetry=True needs a stats dict to receive "
                         "the counters (stats['telemetry'])")
    out = run_device(cfg, device, telemetry=telemetry, graph=graph)
    result = {k: v.cpu().numpy()
              for k, v in engine(cfg).extract(out.state).items()}
    if stats is not None:
        stats.update(start_round=0, executed_rounds=cfg.n_rounds,
                     **telemetry_stats(cfg, out))
    return result


# --- K23: a generation of adversary-search candidates as one run --------------

# The engines a knob batch runs: all seven, each with the switch too, as the
# JAX package's run_knob_batch.
KNOB_ENGINES = (hotstuff.NAME, pbft.NAME, pbft_bcast.NAME, raft.NAME,
                raft_sparse.NAME, paxos.NAME, dpos.NAME)


def _knob_graph_key(cfg: Config, dev: torch.device) -> tuple:
    """The cache key of a knob batch of base ``cfg``: marked as a knob
    batch, so that neither it nor a production run of the same config
    replays the other's graph, and without the seed or any knob value (the
    config fields the knob columns derive from), which reach the graph
    only through its static input tensors. The base's gates, which pick
    the kernels and their instances, stay in."""
    skip = {"seed", *knobs.KNOB_FIELDS.values()}
    fields = tuple((f.name, getattr(cfg, f.name))
                   for f in dataclasses.fields(cfg) if f.name not in skip)
    gates = tuple(sorted(knobs.gates(cfg).items())) + (
        ("desync_on", cfg.desync_on),)
    return ("knob_batch", fields, gates, dev)


def knob_batch_device(cfg: Config, seeds, kmat, device=None) -> RunOutput:
    """:func:`run_knob_batch`'s run, with its checks: the final state and
    accumulators on the device, after the device has finished (on
    ``cuda`` the static outputs of the generation's graph, which its next
    replay overwrites, as :func:`run_device`'s)."""
    if cfg.telemetry_window <= 0:
        raise ValueError("run_knob_batch needs telemetry_window > 0: "
                         "candidate fitness is read off the flight "
                         "recorder series (obs/timeline)")
    seeds = np.asarray(seeds, dtype=np.uint32)
    kmat = np.asarray(kmat, dtype=np.uint32)
    if seeds.ndim != 1 or kmat.shape != (seeds.shape[0], knobs.N_KNOBS):
        raise ValueError(
            f"seeds {seeds.shape} / kmat {kmat.shape}: expected [C] and "
            f"[C, {knobs.N_KNOBS}] (KNOB_COLUMNS order)")
    if seeds.shape[0] != cfg.n_sweeps:
        raise ValueError(
            f"{seeds.shape[0]} candidate lanes but cfg.n_sweeps = "
            f"{cfg.n_sweeps} — the lane axis IS the sweep axis; size "
            "the base config to the generation's lane count")
    gates = knobs.gates(cfg)
    for i, name in enumerate(knobs.KNOB_COLUMNS):
        if not gates.get(name, True) \
                and (kmat[:, i] != np.uint32(getattr(cfg, name))).any():
            raise ValueError(
                f"kmat column {name!r} varies from the base value but "
                "the base config gates that adversary OFF — its "
                "machinery is untraced and the lane values would be "
                "silently ignored; make the base gate-representative "
                "(core/knobs.KnobView)")
    dev = resolve_device(device)
    inputs = {**lane_inputs(cfg), "seed": seeds,
              "knobs": kmat.astype(np.int64)}
    return _execute(cfg, dev, True, None, None, inputs,
                    lambda d: _knob_graph_key(cfg, d))


def run_knob_batch(cfg: Config, seeds, kmat, *, device=None,
                   generation: int = 0):
    """Run ``len(seeds)`` adversary-knob candidates as the lanes of one run
    and return ``(out, flight)``: the port of the JAX runner's
    ``run_knob_batch`` (``consensus_tpu/network/runner.py:1057-1152``).

    ``cfg`` is the static base: shapes, the engine and the adversary gates,
    which must be representative for the knobs the lanes vary (a column
    that differs from the base's value where the base gates that adversary
    off raises, as in the JAX package). ``seeds`` is the [C] u32 seed
    vector, one a lane; ``kmat[c]`` is lane c's row of u32 cutoffs in
    :data:`~consensus_tpu_torch.core.knobs.KNOB_COLUMNS` order, and C must
    be ``cfg.n_sweeps``. A lane whose row is a config's cutoffs reproduces
    that config's run from the lane's seed bit for bit. Every engine runs
    one: HotStuff, dense and §6b PBFT, dense and capped Raft (with the
    §A.3 attacks; a lane's attack target is the int32 of its column, read
    as the JAX package's traced index reads it, so an out-of-range one
    jams nothing but its rounds still count), Paxos and DPoS, each with
    the switch too. On ``cuda`` a generation is the replay of one CUDA
    graph
    (:func:`knob_batch_device`), whose static inputs are the seeds, the
    knob table and, for PBFT, each lane's full ``n_real`` and ``f``;
    generations of one base share its capture; the CPU runs the rounds
    eagerly. ``generation`` is the JAX signature's label of the dispatch
    (its trace span), not read here.

    ``out`` is the engine's extract as numpy arrays batched over lanes;
    ``flight`` holds ``engine``, ``window_rounds``, ``n_windows``,
    ``n_rounds``, ``bucket_lo``, ``windows`` ([C, n_windows] int64 a
    counter) and ``latency`` ([C, N_BUCKETS] int64 a histogram). The run
    also keeps the counter totals, which it does not return."""
    res = knob_batch_device(cfg, seeds, kmat, device)
    eng = engine(cfg)
    out = {k: v.cpu().numpy() for k, v in eng.extract(res.state).items()}
    warr = res.win.cpu().numpy().astype(np.int64)
    larr = res.lat.cpu().numpy().astype(np.int64)
    flight = {
        "engine": eng.name,
        "window_rounds": cfg.telemetry_window,
        "n_windows": n_windows(cfg),
        "n_rounds": cfg.n_rounds,
        "bucket_lo": list(BUCKET_LO),
        "windows": {name: warr[:, :, k]
                    for k, name in enumerate(eng.telemetry_names)},
        "latency": {name: larr[:, h, :]
                    for h, name in enumerate(eng.latency_names)},
    }
    return out, flight
