"""The PBFT f-ladder: a whole ladder of tolerances f as one run.

The port of ``consensus_tpu/engines/pbft_sweep.py`` (``_fsweep_static``,
the lane layout of ``_fsweep_device``, ``_fsweep_slice``,
``rung_payloads``, ``fsweep_payload``, ``pbft_fsweep_run`` and
``pbft_fsweep_timed``) for both fault models: ``fault_model="edge"`` runs
the dense SPEC §6 round (``engines/pbft.py``) and ``fault_model="bcast"``
the §6b broadcast round (``engines/pbft_bcast.py``, its tallies as wide as
the widest rung needs: ``m_cap``). Every lane is padded to N_pad =
3 max(fs) + 1 nodes and carries its own ``n_real = 3f + 1`` and ``f``,
which the round's kernels read per lane: one run, and on the card one
captured CUDA graph, serves the whole ladder. Every draw is keyed by
absolute ids, never by N, so the real nodes of a padded lane see exactly
what a standalone 3f+1 run sees, and padded nodes neither send nor
receive.

Lane (rung k, sweep j) seeds at lo32(seed + k + j): the seed vector of a
standalone ``f = fs[k], seed = seed + k`` run with ``cfg.n_sweeps`` sweeps,
so each rung's decided payload equals that run's. The JAX package's
``seed_offset`` (the repeat knob of its timed runs) is a shifted
``cfg.seed`` here: the seed is no part of a captured graph's key.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core import serialize
from ..core.config import Config


def _fsweep_static(cfg: Config, fs):
    """Validate a ladder request and derive its padded config: one lane
    per (rung, sweep), ``n_nodes`` the padded size, ``f`` the largest
    rung. Returns ``(fs, cfg_pad)``; the JAX package's third value, the
    §6b tallies' ``m_cap``, is
    :func:`~consensus_tpu_torch.engines.pbft_bcast.table_cap` of the two,
    which the runner takes. A ladder with ``crash_prob > 0``, with more
    byzantine nodes than its smallest rung tolerates, or under the SPEC §9
    switch with more aggregators than its smallest rung has nodes, raises
    with the JAX package's message (``consensus_tpu/engines/
    pbft_sweep.py:604-624``)."""
    fs = [int(f) for f in fs]
    if not fs or min(fs) < 1:
        raise ValueError(f"f-sweep rungs must be >= 1, got {fs!r}")
    if cfg.crash_on:
        raise ValueError("the pbft f-sweep does not implement the SPEC "
                         "§6c crash-recover adversary; run per-f configs "
                         "instead of --f-sweep with crash_prob > 0")
    if cfg.n_byzantine > min(fs):
        raise ValueError(f"n_byzantine={cfg.n_byzantine} exceeds the "
                         f"smallest rung f={min(fs)}; every rung must "
                         f"satisfy the pbft n_byzantine <= f invariant")
    if cfg.switch_on and cfg.n_aggregators > 3 * min(fs) + 1:
        raise ValueError(
            f"n_aggregators={cfg.n_aggregators} exceeds the smallest "
            f"rung's population 3*{min(fs)}+1 (SPEC §9: K <= n_nodes "
            "must hold for every rung's standalone twin)")
    n_pad = 3 * max(fs) + 1
    cfg_pad = dataclasses.replace(cfg, protocol="pbft", f=max(fs),
                                  n_nodes=n_pad,
                                  n_sweeps=len(fs) * cfg.n_sweeps)
    return fs, cfg_pad


def ladder_lanes(cfg_pad: Config, fs) -> dict[str, np.ndarray]:
    """The per-lane inputs of the ladder ``fs`` on its padded config:
    lane k * K + j (rung k, sweep j, K = cfg_pad.n_sweeps / len(fs)) has
    seed lo32(cfg_pad.seed + k + j), ``n_real`` 3 fs[k] + 1 and ``f``
    fs[k]. Raises unless every rung fits the padded population."""
    fs = [int(f) for f in fs]
    if not fs or cfg_pad.n_sweeps % len(fs):
        raise ValueError(f"{cfg_pad.n_sweeps} lanes do not split into "
                         f"{len(fs)} rungs")
    if min(fs) < 1 or 3 * max(fs) + 1 > cfg_pad.n_nodes:
        raise ValueError(f"rungs {fs!r} do not fit {cfg_pad.n_nodes} nodes")
    K = cfg_pad.n_sweeps // len(fs)
    ks = np.repeat(np.arange(len(fs), dtype=np.uint64), K)
    js = np.tile(np.arange(K, dtype=np.uint64), len(fs))
    seeds = ((np.uint64(cfg_pad.seed) + ks + js)
             & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return {"seed": seeds,
            "n_real": np.repeat([3 * f + 1 for f in fs], K).astype(np.int32),
            "f": np.repeat(fs, K).astype(np.int32)}


def _fsweep_slice(st, fs, n_sweeps: int) -> list[dict]:
    """Per-rung host arrays of a ladder's final state ``st``: each rung's
    lanes and its real 3f+1 nodes of ``committed``, ``dval`` and
    ``view``. Each padded tensor is copied to the host once."""
    committed = st.committed.cpu().numpy()
    dval = st.dval.cpu().numpy()
    view = st.view.cpu().numpy()
    out = []
    for k, f in enumerate(fs):
        n = 3 * int(f) + 1
        lanes = slice(k * n_sweeps, (k + 1) * n_sweeps)
        out.append({"committed": committed[lanes, :n],
                    "dval": dval[lanes, :n], "view": view[lanes, :n]})
    return out


def rung_payloads(out) -> list[bytes]:
    """Per-rung canonical decided payloads: rung k's bytes are exactly
    what a standalone ``f = fs[k], seed = seed + k`` run serializes
    (``network/simulator.py`` decided_payload, the same pack_sparse)."""
    payloads = []
    for o in out:
        c, s, v = serialize.pack_sparse(o["committed"].astype(bool),
                                        o["dval"])
        payloads.append(serialize.serialize_decided("pbft", c, s, v))
    return payloads


def fsweep_payload(out) -> bytes:
    """The rungs' canonical decided payloads, concatenated: the handle a
    ladder run's digest is taken of."""
    return b"".join(rung_payloads(out))


def pbft_fsweep_run(cfg: Config, fs, device=None, *,
                    graph: bool | None = None) -> list[dict]:
    """Run the f ladder ``fs``, ``cfg.n_sweeps`` sweeps a rung, as one run
    on ``device`` (``cuda`` unless the caller says ``cpu``; on ``cuda``
    one CUDA graph replay unless ``graph=False``): rung k sweep j uses
    f = fs[k], seed = lo32(cfg.seed + k + j). ``cfg.f`` and
    ``cfg.n_nodes`` are replaced by the padded ones. Returns one dict a
    rung of host arrays, batched over its sweeps and cut to its real
    nodes, as a standalone run of the rung gives them."""
    from ..network import runner
    fs, cfg_pad = _fsweep_static(cfg, fs)
    out = runner.run_device(cfg_pad, device, graph=graph, rungs=fs)
    return _fsweep_slice(out.state, fs, cfg.n_sweeps)


def pbft_fsweep_timed(cfg: Config, fs, repeats: int = 1, device=None):
    """The ladder's measurement: returns ``(out, compile_s, best_wall_s,
    real_steps)``. The first run (on ``cuda``: the kernels' build, an eager
    warm-up round, the graph's capture and a replay) is timed as
    ``compile_s``, and ``out`` is its result at the base seeds, copied to
    the host. Each of ``repeats`` timed runs then replays the graph with
    every lane's seed shifted by (repeat + 1) * len(fs), up to
    ``torch.cuda.synchronize()``; ``best_wall_s`` is the best.
    ``real_steps`` counts the real 3f+1 nodes only, times ``n_rounds`` and
    ``cfg.n_sweeps``: padded nodes are wasted work, not simulated work."""
    from ..network import runner
    fs, cfg_pad = _fsweep_static(cfg, fs)
    dev = runner.resolve_device(device)
    t0 = time.perf_counter()
    first = runner.run_device(cfg_pad, dev, rungs=fs)
    compile_s = time.perf_counter() - t0
    out = _fsweep_slice(first.state, fs, cfg.n_sweeps)
    best = float("inf")
    for rep in range(max(1, repeats)):
        shifted = dataclasses.replace(cfg_pad,
                                      seed=cfg.seed + (rep + 1) * len(fs))
        t0 = time.perf_counter()
        runner.run_device(shifted, dev, rungs=fs)
        best = min(best, time.perf_counter() - t0)
    real_steps = (sum(3 * f + 1 for f in fs) * cfg.n_rounds
                  * cfg.n_sweeps)
    return out, compile_s, best, real_steps
