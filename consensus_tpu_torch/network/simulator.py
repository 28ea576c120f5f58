"""The simulator's front door: the port of ``consensus_tpu/network/simulator.py``
for raft, dense (``max_active = 0``) or under the §3b cap, pbft, dense
(SPEC §6) or under the §6b broadcast fault model, paxos (SPEC §5), dpos
(SPEC §7) and hotstuff (SPEC §7b): every protocol of the JAX package, on
its flat path.

    result = run(Config(protocol="raft", max_active=8, ...))
    run(Config(protocol="pbft", f=8, n_nodes=25, ...))
    run(Config(protocol="pbft", fault_model="bcast", f=33_333,
               n_nodes=100_000, ...))
    run(Config(protocol="paxos", n_nodes=10_000, log_capacity=10_000, ...))
    run(Config(protocol="dpos", n_nodes=100_000, n_candidates=1024, ...))
    run(Config(protocol="hotstuff", f=33_333, n_nodes=100_000, ...))
    result.digest          # SHA-256 of the canonical decided-log bytes
    result.steps_per_sec   # node-round-steps per second of the timed run
    result.extras["lib"]   # dpos: the SPEC §7 last-irreversible index
    run(cfg, telemetry=True).extras["telemetry"]["totals"]
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np

from ..core import serialize
from ..core.config import Config
from ..engines import dpos
from . import runner


@dataclass
class RunResult:
    config: Config
    payload: bytes          # canonical decided-log serialization
    digest: str
    wall_s: float           # the timed run, from its start to the device's end
    node_round_steps: int
    counts: np.ndarray      # [B, N]
    rec_a: np.ndarray       # [B, N, L]
    rec_b: np.ndarray
    # "telemetry" (names, per_sweep, totals) and "flight" (the recorder's
    # windows and latency buckets) of a run with telemetry=True; for dpos
    # "lib", the last-irreversible index of each chain ([B, V] int64).
    extras: dict = dataclasses.field(default_factory=dict)
    # The timed run's extract dict (numpy), which ``payload`` packs.
    extract: dict = dataclasses.field(default_factory=dict)

    @property
    def steps_per_sec(self) -> float:
        return self.node_round_steps / self.wall_s if self.wall_s > 0 else 0.0


def engine_def(cfg: Config) -> runner.Engine:
    """The engine a config resolves to: for pbft the §6b broadcast engine
    at ``fault_model="bcast"``, else the dense SPEC §6 one; dense raft at
    ``max_active = 0``, else the §3b capped one; paxos's, dpos's and
    hotstuff's own."""
    return runner.engine(cfg)


def decided_payload(cfg: Config, out: dict):
    """Canonical packing of an extract dict: for raft the records are
    (log_term[k], log_val[k]) for k < commit, for pbft (slot, dval) of each
    committed slot (hotstuff: of each committed height), for paxos (slot,
    learned_val) of each learned slot, slots ascending, for dpos (chain_r[k], chain_p[k]) for k < chain_len.
    Returns (counts, rec_a, rec_b, payload)."""
    if cfg.protocol in ("pbft", "hotstuff"):
        counts, rec_a, rec_b = serialize.pack_sparse(
            np.asarray(out["committed"]).astype(bool),
            np.asarray(out["dval"]))
    elif cfg.protocol == "paxos":
        counts, rec_a, rec_b = serialize.pack_sparse(
            np.asarray(out["learned_mask"]).astype(bool),
            np.asarray(out["learned_val"]))
    elif cfg.protocol == "dpos":
        counts = np.asarray(out["chain_len"])
        rec_a, rec_b = np.asarray(out["chain_r"]), np.asarray(out["chain_p"])
    else:
        counts = np.asarray(out["commit"])
        rec_a, rec_b = np.asarray(out["log_term"]), np.asarray(out["log_val"])
    payload = serialize.serialize_decided(cfg.protocol, counts, rec_a, rec_b)
    return counts, rec_a, rec_b, payload


def run(cfg: Config, device=None, telemetry: bool = False) -> RunResult:
    """Run a config of any protocol (raft, pbft, paxos, dpos, hotstuff) on
    ``device`` (``cuda`` unless the caller says ``cpu``).
    The run is made once untimed first (on ``cuda`` that builds the
    kernels and captures the run's graph), so that ``wall_s`` is one
    replay up to the device's end. ``telemetry=True`` fills
    ``extras["telemetry"]`` and, with ``cfg.telemetry_window > 0``,
    ``extras["flight"]``, as the JAX package's ``run`` does; a dpos run
    fills ``extras["lib"]``."""
    dev = runner.resolve_device(device)
    runner.run_device(cfg, dev, telemetry=telemetry)
    t0 = time.perf_counter()
    out = runner.run_device(cfg, dev, telemetry=telemetry)
    wall = time.perf_counter() - t0
    # Copied at once: on cuda these are the graph's outputs, which the next
    # replay overwrites.
    host = {k: v.cpu().numpy()
            for k, v in engine_def(cfg).extract(out.state).items()}
    stats = runner.telemetry_stats(cfg, out)
    counts, rec_a, rec_b, payload = decided_payload(cfg, host)
    extras = {}
    if "telemetry" in stats:
        tstats = stats["telemetry"]
        extras["telemetry"] = {
            "names": list(tstats),
            "per_sweep": dict(tstats),
            "totals": {k: int(v.sum()) for k, v in tstats.items()}}
    if "flight" in stats:
        extras["flight"] = {"engine": engine_def(cfg).name, **stats["flight"]}
    if cfg.protocol == "dpos":
        # The decided records are the chains (counts = chain_len, rec_b =
        # chain_p), as the JAX package derives lib from them.
        extras["lib"] = dpos.lib_index(rec_b, counts, cfg.n_candidates,
                                       cfg.n_producers)
    return RunResult(config=cfg, payload=payload,
                     digest=serialize.digest(payload), wall_s=wall,
                     node_round_steps=cfg.n_sweeps * cfg.n_nodes
                     * cfg.n_rounds,
                     counts=counts, rec_a=rec_a, rec_b=rec_b, extras=extras,
                     extract=host)
