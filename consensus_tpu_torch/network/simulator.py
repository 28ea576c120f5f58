"""The simulator's front door: the port of ``consensus_tpu/network/simulator.py``
for raft under the §3b cap.

    result = run(Config(protocol="raft", max_active=8, ...))
    result.digest          # SHA-256 of the canonical decided-log bytes
    result.steps_per_sec   # node-round-steps per second of the timed run
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..core import serialize
from ..core.config import Config
from ..engines import raft_sparse
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

    @property
    def steps_per_sec(self) -> float:
        return self.node_round_steps / self.wall_s if self.wall_s > 0 else 0.0


def engine_def(cfg: Config):
    """The engine module a config resolves to: the port has only the §3b
    capped raft engine (Config rejects everything else)."""
    return raft_sparse


def decided_payload(cfg: Config, out: dict):
    """Canonical packing of an extract dict: for raft the records are
    (log_term[k], log_val[k]) for k < commit. Returns (counts, rec_a, rec_b,
    payload)."""
    counts = np.asarray(out["commit"])
    rec_a, rec_b = np.asarray(out["log_term"]), np.asarray(out["log_val"])
    payload = serialize.serialize_decided(cfg.protocol, counts, rec_a, rec_b)
    return counts, rec_a, rec_b, payload


def run(cfg: Config, device=None) -> RunResult:
    """Run a config on ``device`` (``cuda`` unless the caller says ``cpu``).
    The run is made once untimed first, so that ``wall_s`` excludes kernel
    builds and first-call costs."""
    dev = runner.resolve_device(device)
    runner.run_device(cfg, device=dev)
    t0 = time.perf_counter()
    st = runner.run_device(cfg, device=dev)
    wall = time.perf_counter() - t0
    out = {k: v.cpu().numpy() for k, v in engine_def(cfg).extract(st).items()}
    counts, rec_a, rec_b, payload = decided_payload(cfg, out)
    return RunResult(config=cfg, payload=payload,
                     digest=serialize.digest(payload), wall_s=wall,
                     node_round_steps=cfg.n_sweeps * cfg.n_nodes
                     * cfg.n_rounds,
                     counts=counts, rec_a=rec_a, rec_b=rec_b)
