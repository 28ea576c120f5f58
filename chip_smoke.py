#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (consensus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device    — a CUDA device is present; the card's name and power limit as
               ``nvidia-smi`` reports them.
2. build     — nvcc builds every kernel of ``consensus_tpu_torch/csrc``.
3. kernels   — each hand-written kernel against its plain PyTorch version
               on the card. KA-KK (the capped engine) at the flagship shapes
               (B = 8 sweeps, N = 100 000 nodes, A = 8, L = 128) on random
               and built edge inputs, the round's phase kernels (KD-KK) also
               on the flagship's own inputs of round 20. KL-KO (the dense
               engine) on rounds 3 (the first election) and 20 or 100 (a
               leader in every sweep) of raft-1kx1k and raft-5node, on
               rounds of hostile runs, on random states and on built ones
               (a re-grant, two leaders of different terms in one P3c).
               Tolerance: none, the results are integers and must be
               equal. Times are device time per call (torch.profiler
               kernel durations).
4. flagship  — ``simulator.run`` of raft-100k (benchmarks/run_benchmarks.py
               CONFIGS["raft-100k"], seed 6), replayed as one CUDA graph: the
               decided-log digest must be the committed anchor, and every
               kernel of the capped path must have launched (KK must not:
               telemetry is off; nor KL-KO). Seed 7 then replays the same
               graph (no new capture) and must equal the eager loop; seed 6
               again the anchor.
5. telemetry — raft-100k with telemetry and a flight recorder of 8-round
               windows: the same digest, KA-KK launched, windows that sum
               to the totals, one election wait a leader election, graph
               replay and eager loop equal; and the same run at
               N = 10 000, whose counters and recorder must equal an anchor
               made by the JAX package.
6. dense     — ``simulator.run`` of BASELINE configs raft-5node and
               raft-1kx1k (CONFIGS["raft-5node"], ["raft-1kx1k"]), each
               replayed as one CUDA graph: the committed digests, KA and
               KL-KO launched and no other kernel, steps per second, busy
               share and graph memory; seed 3 of raft-1kx1k replays the
               same graph and must equal the eager loop.
7. bench     — bench.py's flagship shape (seed 42, max_entries 112):
               node-round-steps per second; something must commit.
8. profile   — the flagship's graph replay under torch.profiler: device busy
               share, launches a round, device time by kernel, graph memory;
               and an eager capped run and an eager dense run with each
               kernel wrapper in a named range, which must show no PyTorch
               compute op in any phase of the round.

Then the card's name and power limit, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Any failure, or no GPU, exits
non-zero without that last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

FLAGSHIP_DIGEST = \
    "0e9cc1ddc8b04d96240cdeb5f19877bbd3aad2b23883a585fa1e1c78a961ca5b"
B, N, A, L = 8, 100_000, 8, 128
WINDOW = 8                      # the telemetry phase's flight-recorder window

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth, and the
# 67 TFLOP/s float32 rate outside the tensor cores, which counts a fused
# multiply-add as two operations: one 32-bit lane instruction a lane and
# clock, 33.5e12 a second, is the ceiling taken for 32-bit integer
# operations (each add, xor, shift or multiply one operation).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12
L2_BYTES = 50 * 2**20
THREEFRY_OPS = 119     # 20 x (add, 3-op rotate, xor) + key schedule
EDGE_OPS = 23          # one mixer absorb (11) + fmix (8) + 4 tests an edge


class SmokeError(RuntimeError):
    pass


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def device_ms(fn, args, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of one call of ``fn(*args)``: the summed durations
    of the kernels it launched, from torch.profiler. (CUDA events around
    calls this short would time the host's launch cost, not the device.)
    The calls rotate over clones of ``args`` that together exceed the L2
    cache twice over, so that no call finds its inputs left in L2 by the
    call before it. The profiler records from its second step on: it can
    miss the first launches of its first."""
    from torch.profiler import ProfilerActivity, profile, schedule
    size = sum(a.nbytes for a in args if isinstance(a, torch.Tensor))
    copies = [clone_args(args)
              for _ in range(min(16, max(2, -(-2 * L2_BYTES // size))))]
    for i in range(warm):
        fn(*copies[i % len(copies)])
    torch.cuda.synchronize()

    def session():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn(*copies[0])
            torch.cuda.synchronize()
            recorded_step(prof)
            for i in range(reps):
                fn(*copies[i % len(copies)])
            torch.cuda.synchronize()
        return prof
    _, device = profiled(session, getattr(fn, "__name__", "a kernel"))
    return sum(e.time_range.elapsed_us() for e in device) / 1e3 / reps


PROFILER_SESSIONS = 8
REDONE: list[str] = []          # the profiled work whose session was redone
# The profiler opens its recording window at a step, on the host's clock. A
# short kernel launched right after the step can map, from the device's
# clock, to a start before the window and be dropped: on the H100 the first
# of 20 torch.kthvalue launches (4 us each) went missing in 8 sessions of 8.
# Recorded work starts this long after the step.
STEP_SETTLE_S = 0.01


def recorded_step(prof) -> None:
    """Step ``prof`` into its recorded step, and wait for its window to be
    open before the caller launches the work to record."""
    prof.step()
    time.sleep(STEP_SETTLE_S)


def profiled(session, what: str, graph: bool = False) -> tuple:
    """``session()``'s profiler and its device operations. CUPTI now and
    then delivers a session's device records only in part, or not at all,
    so a session counts only when it is complete: when it holds a device
    operation for each kernel launch, memset and copy that the host made in
    it; for a graph replay, which the host launches as one call, when it
    holds as many device operations as the session before. Otherwise the
    session is run again, up to PROFILER_SESSIONS times, and then this
    fails."""
    from torch.autograd import DeviceType
    counts = []
    for _ in range(PROFILER_SESSIONS):
        prof = session()
        device = device_events(prof)
        calls = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CPU
                    and any(c in e.name for c in RUNTIME_CALLS))
        counts.append((len(device), calls))
        if graph:
            complete = len(counts) > 1 and counts[-1][0] == counts[-2][0] > 0
        else:
            complete = 0 < len(device) == calls
        if complete:
            if len(counts) > 1 + graph:
                REDONE.append(what)
                print(f"chip_smoke: profiling {what}: (device operations, "
                      f"runtime calls) by session: {counts}",
                      file=sys.stderr, flush=True)
            return prof, device
    raise SmokeError(f"the profiler recorded the device operations of "
                     f"{what} in part only: (device operations, runtime "
                     f"calls) by session {counts}")


# The CUDA runtime calls that put one operation each on the device.
RUNTIME_CALLS = ("Launch", "Memset", "Memcpy")


def device_events(prof) -> list:
    """The profiled device operations (kernels, memsets, copies), without
    the ranges that the profiler's steps and the script's named wrapper
    ranges also put on the device timeline."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("ProfilerStep", "wrapper::"))]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(pairs) -> float:
    err = 0.0
    for got, want in pairs:
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"shape/dtype {tuple(got.shape)} {got.dtype} != "
                f"{tuple(want.shape)} {want.dtype}")
        d = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --- phase 3: each kernel against its plain version ---------------------------

def check_random_u32(dev, gen):
    from consensus_tpu_torch.core import rng
    seeds = torch.tensor([0, 0xFFFFFFFF, 6, 7, 8, 9, 10, 0x80000000],
                         dtype=torch.uint32, device=dev)
    term = torch.randint(0, 40, (B, N), generator=gen, device=dev,
                         dtype=torch.int32)
    term[0, :4] = torch.tensor([-1, 0, 2**31 - 1, -2**31], dtype=torch.int32)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    cases = [(rng.STREAM_TIMEOUT, 0, 0, idx),           # init's timeouts
             (rng.STREAM_TIMEOUT, term, 0, idx),        # _draw_timeout
             (rng.STREAM_VALUE, 63, 0, idx),
             (rng.STREAM_VALUE, 0xFFFFFFFF, 7, term),
             (rng.STREAM_CHURN, 5, 0, 0)]
    err = max_abs_err((rng.random_u32(seeds, *c), rng.random_u32_plain(
        seeds, *c)) for c in cases)
    call = cases[0]                     # the one call on the main path
    nbytes = 4 * B + 4 * N + 8 * B * N
    return dict(
        name="random_u32", route="cuda",
        source="consensus_tpu_torch/csrc/random_u32.cu",
        replaces="consensus_tpu/core/rng.py:232 random_u32_jnp",
        max_abs_err=err,
        ms=device_ms(rng.random_u32, (seeds, *call)),
        plain_ms=device_ms(rng.random_u32_plain, (seeds, *call)),
        bound=bound(nbytes, THREEFRY_OPS * B * N), library_ms=None)


def check_delivery_edges(dev, gen):
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.ops import adversary
    seeds = torch.tensor([0, 0xFFFFFFFF, 6, 7, 8, 9, 10, 11],
                         dtype=torch.uint32, device=dev)
    ids = torch.randint(-1, N, (B, A), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[0, :3] = torch.tensor([-1, N - 1, 0], dtype=torch.int32)
    ids[1] = -1
    drop = rng.prob_threshold_u32(0.01)
    pairs = []
    for r, part in ((17, 0), (0xFFFFFFFF, 0),
                    (3, rng.prob_threshold_u32(1.0)),
                    (4, rng.prob_threshold_u32(0.5))):
        for src in (True, False):
            args = (seeds, r, ids, N, drop, part, src)
            pairs.append((adversary.delivery_edges(*args),
                          adversary.delivery_edges_plain(*args)))
    err = max_abs_err(pairs)
    call = (seeds, 17, ids, N, drop, 0, True)
    return dict(
        name="delivery_edges", route="cuda",
        source="consensus_tpu_torch/csrc/delivery_edges.cu",
        replaces="consensus_tpu/ops/adversary.py:178 delivery_edges",
        max_abs_err=err,
        ms=device_ms(adversary.delivery_edges, call),
        plain_ms=device_ms(adversary.delivery_edges_plain, call),
        bound=bound(B * A * N + 4 * B * A + 4 * B, EDGE_OPS * B * A * N),
        library_ms=None)


def check_top_active(dev, gen):
    from consensus_tpu_torch.engines import raft_sparse as rs
    term = torch.randint(0, 30, (B, N), generator=gen, device=dev,
                         dtype=torch.int32)
    sparse = torch.rand((B, N), generator=gen, device=dev) < 2e-4
    masks = [sparse,
             torch.rand((B, N), generator=gen, device=dev) < 0.5,
             torch.ones((B, N), dtype=torch.bool, device=dev),
             torch.zeros((B, N), dtype=torch.bool, device=dev)]
    masks[0][0, N - 5:] = True                  # ties in term, high ids
    pairs = [(rs.top_active(m, term, a), rs.top_active_plain(m, term, a))
             for m in masks for a in (1, A, 16)]
    err = max_abs_err(pairs)
    # The yardstick: one torch.topk over the same (term desc, id asc) keys.
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    key = torch.where(sparse, ((2**31 - 1) - term.to(torch.int64)) * 2**31
                      + idx, 2**63 - 1)
    return dict(
        name="top_active", route="cuda",
        source="consensus_tpu_torch/csrc/top_active.cu",
        replaces="consensus_tpu/engines/raft_sparse.py:144 _top_active",
        max_abs_err=err,
        ms=device_ms(rs.top_active, (sparse, term, A)),
        plain_ms=device_ms(rs.top_active_plain, (sparse, term, A)),
        bound=bound(B * N * 5 + 4 * B * A, 4 * B * N),
        library_ms=device_ms(
            lambda k: torch.topk(k, A, dim=1, largest=False), (key,)))




# --- phase 3, continued: the round's phase kernels KD-KK ----------------------

PHASES = ("candidacy", "elect", "slots", "propose", "append_entries",
          "acks_commit", "telemetry")
REPLACES = {"candidacy": "consensus_tpu/engines/raft_sparse.py:236 "
                        "raft_sparse_round P0-P1",
           "elect": "consensus_tpu/engines/raft_sparse.py:255 "
                    "raft_sparse_round P2",
           "slots": "consensus_tpu/engines/raft_sparse.py:354 "
                    "raft_sparse_round slot lifecycle",
           "propose": "consensus_tpu/engines/raft_sparse.py:377 "
                      "raft_sparse_round P3a-P3b",
           "append_entries": "consensus_tpu/engines/raft_sparse.py:398 "
                             "raft_sparse_round P3c",
           "acks_commit": "consensus_tpu/engines/raft_sparse.py:441 "
                          "raft_sparse_round P3d-P4",
           "telemetry": "consensus_tpu/engines/raft_sparse.py:503 "
                        "raft_sparse_round telemetry and flight tail, "
                        "consensus_tpu/ops/flight.py:29 bucket_counts"}


def flagship_config(**kw):
    from consensus_tpu_torch.core.config import Config
    return Config(**{**dict(protocol="raft", n_nodes=N, n_rounds=64,
                            n_sweeps=B, log_capacity=L, max_entries=100,
                            max_active=A, seed=6, drop_rate=0.01,
                            churn_rate=0.001), **kw})


def clone_args(args):
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


@contextlib.contextmanager
def standing_in(module, names, make):
    """Replace each wrapper ``names`` of the round's ``module`` by
    ``make(name, wrapper)`` while the block runs. A wrapper counts its
    launches on the module attribute it is called by, so each stand-in
    carries a ``launches`` of its own."""
    originals = {name: getattr(module, name) for name in names}
    try:
        for name, fn in originals.items():
            stand_in = make(name, fn)
            stand_in.launches = 0
            setattr(module, name, stand_in)
        yield
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def recording(got: dict):
    """A ``make`` for :func:`standing_in` whose stand-ins put a clone of
    their arguments into ``got`` by wrapper name and call the wrapper."""
    def recorder(name, fn):
        def record(*args):
            got[name] = clone_args(args)
            return fn(*args)
        return record
    return recorder


def capture_phase_inputs(cfg, r: int, device="cuda") -> dict:
    """The arguments each phase wrapper (KD-KK) receives in round ``r`` of
    ``cfg``'s run on ``device`` (with its telemetry on), cloned as they
    arrive."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    from consensus_tpu_torch.network import runner
    telem, flight = runner.accumulators(cfg, device)
    st = runner.advance(cfg, runner.init(cfg, runner.make_seeds(cfg),
                                         device), 0, r, telem=telem,
                        flight=flight)
    got = {}
    with standing_in(rs, PHASES, recording(got)):
        rs.raft_sparse_round(cfg, st, r, telem=telem, flight=flight)
    require(set(got) == set(PHASES), f"round {r} skipped a phase")
    return got


def kernel_module(name: str):
    """The module that defines wrapper ``name`` and its plain version."""
    from consensus_tpu_torch.network import runner
    return {n: mod for mod, n in runner.KERNELS}[name]


def run_pair(name: str, args) -> list:
    """The kernel and its plain version on separate clones of ``args``:
    pairs of their results and of every tensor argument afterwards, which
    covers the in-place updates and that nothing else was written."""
    mod = kernel_module(name)
    ka, pa = clone_args(args), clone_args(args)
    got = getattr(mod, name)(*ka)
    want = getattr(mod, name + "_plain")(*pa)
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    pairs = list(zip(got or (), want or ()))
    return pairs + [(k, p) for k, p in zip(ka, pa)
                    if isinstance(k, torch.Tensor)]


def edge_phase_inputs(dev, gen) -> dict:
    """Random and built inputs on which the phases' rare paths fire:
    {name: [args]}."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.engines import raft_sparse as rs
    from consensus_tpu_torch.network import runner
    from consensus_tpu_torch.ops import adversary

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def coin(p, shape):
        return torch.rand(shape, generator=gen, device=dev) < p

    def distinct_ids(n, empty):
        ids = torch.stack([torch.randperm(n, generator=gen, device=dev)[:A]
                           for _ in range(B)]).to(torch.int32)
        ids[coin(empty, (B, A))] = -1
        return ids

    seeds = torch.arange(11, 11 + B, dtype=torch.int64,
                         device=dev).to(torch.uint32)
    out = {name: [] for name in PHASES}

    # KE: every node timed out (so far more than A candidates), churn at
    # 0.5 so that some sweeps step their leaders down, terms at the i32
    # edge, empty and full logs.
    cfg = flagship_config(churn_rate=0.5, t_min=1, t_max=3)
    term, role = ri(0, 50, (B, N)), ri(0, 3, (B, N))
    term[0, :4] = torch.tensor([2**31 - 1, 0, -1, 5], dtype=torch.int32)
    log_len = ri(0, L + 1, (B, N))
    log_len[:, :100], log_len[:, 100:200] = 0, L
    ke = (cfg, seeds, 20, term, role, ri(-1, N, (B, N)), ri(3, 10, (B, N)),
          ri(1, 3, (B, N)), ri(0, 50, (B, N, L)), log_len)
    out["candidacy"].append(ke)

    # KF on KE's result: more than A candidates compete.
    (term, role, vf, timer, timeout, reset, own_lterm,
     cand) = rs.candidacy_plain(*ke)
    require(int(cand.sum(1).min()) > A, "edge inputs: too few candidates")
    cand_ids = rs.top_active_plain(cand, term, A)
    del_cj, del_jc = (adversary.delivery_edges_plain(
        seeds, 20, cand_ids, N, rng.prob_threshold_u32(0.01), 0, src)
        for src in (True, False))
    out["elect"].append((cfg, seeds, cand_ids, del_cj, del_jc, term, role,
                         vf, timer, timeout, reset, log_len, own_lterm))

    # KF at the majority: candidate 5 gets the grants of every node but
    # its rival 9; K of them are delivered, so that 1 + K is the majority
    # in even sweeps and one short of it in odd ones. N even and odd.
    for n in (N, N - 1):
        cfg_n = flagship_config(n_nodes=n)
        maj = n // 2 + 1
        cand_ids = torch.full((B, A), -1, dtype=torch.int32, device=dev)
        cand_ids[:, 0], cand_ids[:, 1] = 5, 9
        role = torch.zeros((B, n), dtype=torch.int32, device=dev)
        role[:, 5] = role[:, 9] = 1
        vf = torch.full((B, n), -1, dtype=torch.int32, device=dev)
        vf[:, 5], vf[:, 9] = 5, 9
        del_cj = torch.zeros((B, A, n), dtype=torch.bool, device=dev)
        del_cj[:, 0] = True
        del_cj[:, 0, 5] = False
        del_jc = torch.zeros((B, n, A), dtype=torch.bool, device=dev)
        for b in range(B):
            k = maj - 1 if b % 2 == 0 else maj - 2
            del_jc[b, 10:10 + k, 0] = True
        z = torch.zeros((B, n), dtype=torch.int32, device=dev)
        out["elect"].append((cfg_n, seeds, cand_ids, del_cj, del_jc,
                             z + 7, role, vf, z.clone(), z + 1,
                             torch.zeros((B, n), dtype=torch.bool,
                                         device=dev), z.clone(), z.clone()))

    # KG: old and new tracked ids drawn from a small pool, so that slots
    # are carried from other slot indices, dropped and started; empty
    # slots; leaders at log length E (no self-match) and below.
    cfg = flagship_config()
    E = min(cfg.max_entries, L)
    old = torch.stack([torch.randperm(16, generator=gen, device=dev)[:A]
                       for _ in range(2 * B)]).to(torch.int32)
    lead_id, new_ids = old[:B].clone(), old[B:].clone()
    lead_id[coin(0.25, (B, A))] = -1
    new_ids[coin(0.25, (B, A))] = -1
    role, log_len = ri(0, 2, (B, N)), ri(0, L + 1, (B, N))
    role[:, :16] = 2
    log_len[:, :4], log_len[:, 4:8] = E, E - 1
    out["slots"].append((cfg, new_ids, lead_id, ri(0, 256, (B, A, N),
                                                   torch.uint8),
                         ri(0, 256, (B, A, N), torch.uint8), role, log_len))

    # KI: a third of the nodes lead; leaders at log length E (no append)
    # and at L - 1 (the last slot, when E = L), tracked among others that
    # do not lead; empty slots. E = 100 and E = L.
    lead = coin(0.3, (B, N))
    lead[:, :200] = True
    for max_entries in (100, L):
        cfg = flagship_config(max_entries=max_entries)
        log_len = ri(0, L + 1, (B, N))
        log_len[:, :100] = min(max_entries, L)
        log_len[:, 100:200] = L - 1
        lead_id = distinct_ids(400, 0.2)
        out["propose"].append((cfg, seeds, 20, lead, ri(0, 50, (B, N)),
                               ri(0, 50, (B, N, L)),
                               ri(-2**31, 2**31 - 1, (B, N, L)), log_len,
                               ri(0, 50, (B, N)), lead_id))

    # KD: heartbeats from half the slots, snapshot terms and follower terms
    # from a small alphabet, so that bumps, ties between slots, candidates
    # stepping down with and without a bump all fire; log terms from a
    # small alphabet, so that log-match checks pass often; prev = 0,
    # full-log copies, prev past any log.
    cfg = flagship_config()
    lead_id = distinct_ids(N, 0.1)
    s_term, term = ri(0, 4, (B, A)), ri(0, 4, (B, N))
    role = ri(0, 3, (B, N))
    s_next = ri(1, L + 2, (B, A, N), torch.uint8)
    s_len = ri(0, L + 1, (B, A))
    s_next[:, 0, :1000] = 1                      # prev = 0
    s_len[:, 0] = L                              # full-log copies
    s_next[:, 1, :1000] = 255                    # prev past any log
    kd = (cfg, seeds, coin(0.5, (B, A, N)), lead_id, s_term, term, role,
          ri(-1, N, (B, N)), ri(0, 9, (B, N)), ri(3, 10, (B, N)),
          coin(0.3, (B, N)), ri(0, 3, (B, N, L)),
          ri(-2**31, 2**31 - 1, (B, N, L)), ri(0, L + 1, (B, N)),
          ri(0, 20, (B, N)), s_next, s_len, ri(0, L + 1, (B, A)),
          ri(0, 3, (B, A, L)), ri(-2**31, 2**31 - 1, (B, A, L)))
    got = rs.append_entries_plain(*clone_args(kd))
    both = (role == 1) & (got[0] > term) & got[7]
    require(int(both.sum()) > 0 and int(((role == 1) & (got[0] == term)
                                         & got[7]).sum()) > 0,
            "edge inputs: no candidate stepped down with and without a bump")
    out["append_entries"].append(kd)

    # KH: tiny terms so that acked terms bump leaders (bump3); a third of
    # the leaders' log entries of their own term; match rows with values
    # above E; next at 0 and 1 under failed acks. Sweep 0 acks no slot 0
    # or 2, whose rows sit exactly at the majority (60) and one short.
    lead_id = torch.stack([torch.randperm(N, generator=gen, device=dev)[:A]
                           for _ in range(B)]).to(torch.int32)
    lead_id[1:][coin(0.1, (B - 1, A))] = -1
    role = ri(0, 3, (B, N))
    role.scatter_(1, lead_id.clamp(min=0).to(torch.int64),
                  torch.full((B, A), 2, dtype=torch.int32, device=dev))
    kstar = ri(0, A, (B, N))
    kstar[0] = torch.where(coin(0.5, (N,)), 1, 3)
    lead_match = ri(0, 256, (B, A, N), torch.uint8)
    lead_match[1:, :4] = ri(90, 140, (B - 1, 4, N), torch.uint8)
    maj = N // 2 + 1
    lead_match[0, 0], lead_match[0, 2] = 59, 59
    lead_match[0, 0, :maj] = lead_match[0, 2, :maj - 1] = 60
    lead_next = ri(0, 256, (B, A, N), torch.uint8)
    lead_next[:, 4:] = ri(0, 3, (B, A - 4, N), torch.uint8)
    term, log_term = ri(0, 4, (B, N)), ri(0, 4, (B, N, L))
    lid = lead_id.clamp(min=0).to(torch.int64)
    log_term[0, lid[0, 0], 59] = term[0, lid[0, 0]]
    log_term[0, lid[0, 2], 58:60] = term[0, lid[0, 2]]
    commit = ri(0, 50, (B, N))
    commit[0, lid[0, 0]] = commit[0, lid[0, 2]] = 0
    timer = ri(-3, 2**31 - 1, (B, N))
    timer[:, :10] = 2**31 - 1                   # P4's add wraps
    kh = (seeds, lead_id, coin(0.9, (B, A)) & (lead_id >= 0),
          coin(0.9, (B, N, A)),
          coin(0.8, (B, N)), kstar, coin(0.7, (B, N)), ri(0, L + 1, (B, N)),
          log_term, term, role, ri(-1, N, (B, N)), ri(1, 9, (B, N)), commit,
          lead_match, lead_next, timer, coin(0.5, (B, N)))
    kh[2][0, [0, 2]] = True
    for max_entries in (100, L):
        out["acks_commit"].append((flagship_config(max_entries=max_entries),
                                   *kh))

    # KK: 20 rounds in windows of 6, so that round 19 adds into the
    # ragged last window; winners whose wait is <= 0, at 2^14 - 1, 2^14
    # and past it (and one that wraps); leaders whose lag is <= 0 or
    # >= 2^14; down nodes. Accumulators start nonzero. Round 0, and the
    # recorder off.
    cfg = flagship_config(n_rounds=20, telemetry_window=6)
    cand_ids = distinct_ids(64, 0.2)
    win = coin(0.6, (B, A))
    timer_in = ri(-5, 40, (B, N))
    timer_in[:, :8] = torch.tensor([-6, -1, 0, 2**14 - 2, 2**14 - 1, 2**14,
                                    2**20, 2**31 - 1], dtype=torch.int32)
    cand_ids[:, :3] = torch.randint(0, 8, (B, 3), generator=gen, device=dev,
                                    dtype=torch.int32)
    log_len = ri(0, 2**16, (B, N))
    commit_in = ri(0, 100, (B, N))
    t, (w, lat) = runner.accumulators(cfg, dev)
    t += ri(0, 1000, t.shape)
    w += ri(0, 1000, w.shape)
    lat += ri(0, 1000, lat.shape)
    kk = (cand_ids, win, timer_in, coin(0.5, (B, N)), coin(0.5, (B, N)),
          commit_in, commit_in + ri(0, 3, (B, N)), ri(0, 3, (B, N)),
          log_len, coin(0.1, (B, N)))
    for r, acc in ((19, (t, w, lat)), (0, (t, w, lat)), (19, (t,))):
        out["telemetry"].append((cfg, r, *kk, *acc))
    return out


def acks_work(args) -> dict:
    """What KH must touch on its arguments ``args``: ``has_l`` and
    ``delivered``, the nodes that ack a slot and those whose ack was
    delivered (P3d reads their slot and the mask byte, and the term of the
    delivered); ``rows``, the processing slots, whose [N] match bytes it
    reads; ``acks`` and ``applied``, the delivered acks to a processing slot
    and those of them applied (each reads its apply flag, an applied one
    the new log length and writes match and next, another reads and
    writes next); ``leaders`` and ``counting``, after the bump, the leaders
    (P4 writes their timer) and the other nodes whose timer counts up (P4
    reads and writes it)."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    (_, _, lead_id, was_lead_k, del_jl, has_l, kstar, apply_, _, _, term,
     role, *_rest) = args
    reset = args[18]
    n = term.shape[1]
    lid = lead_id.clamp(0, n - 1).to(torch.int64)
    ackm = (torch.where(has_l, kstar, A)[:, :, None]
            == torch.arange(A, device=term.device)) & del_jl
    t_in3 = torch.where(ackm, term[:, :, None], 0).amax(1)
    proc = was_lead_k & (role.gather(1, lid) == 2) \
        & ~(t_in3 > term.gather(1, lid))
    acks = ackm & proc[:, None, :]
    after = clone_args(args)
    rs.acks_commit_plain(*after)
    lead = after[11] == 2
    return dict(has_l=int(has_l.sum()), delivered=int(ackm.sum()),
                rows=int(proc.sum()), acks=int(acks.sum()),
                applied=int((acks & apply_[:, :, None]).sum()),
                leaders=int(lead.sum()), counting=int((~lead & ~reset).sum()))


def phase_bound(name: str, args) -> tuple[float, str]:
    """The least time of phase ``name``'s work on ``args`` (flagship
    shapes): the bytes it must move and the 32-bit operations it must do
    for these inputs."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    nodes = B * N
    if name == "candidacy":
        moved = int(rs.candidacy_plain(*clone_args(args))[5].sum())
        return bound(54 * nodes, 20 * nodes + THREEFRY_OPS * moved)
    if name == "elect":
        return bound((67 + 2 * (A - 8)) * nodes, 12 * A * nodes)
    if name == "slots":
        new_ids, lead_id = args[1], args[2]
        carried = int(((new_ids[:, :, None] == lead_id[:, None, :])
                       & (new_ids >= 0)[:, :, None]).any(2).sum())
        return bound(2 * B * A * N + 2 * carried * N, 4 * B * A * N)
    if name == "propose":
        cfg, lead, log_len = args[0], args[3], args[7]
        app = int((lead & (log_len < min(cfg.max_entries, L))).sum())
        return bound(9 * nodes + 12 * app + B * A * (16 * L + 20),
                     4 * nodes + THREEFRY_OPS * app)
    if name == "append_entries":
        term = args[5]
        got = rs.append_entries_plain(*clone_args(args))
        new_term, kstar, has_l, applied = got[0], got[6], got[7], got[8]
        s_next, s_len = args[15], args[16]
        k = kstar.to(torch.int64)
        prev = s_next.gather(1, k[:, None, :])[:, 0].to(torch.int64) - 1
        l_len = s_len.gather(1, k).to(torch.int64)
        copied = torch.where(applied, (l_len - prev.clamp(min=0))
                             .clamp(min=0), 0).sum()
        bumped = int((new_term > term).sum())
        return bound(nodes * (A + 29 + 35) + 5 * int(has_l.sum())
                     + B * A * (8 * L + 12) + 8 * int(copied),
                     (4 * A + 30) * nodes + THREEFRY_OPS * bumped)
    if name == "acks_commit":
        # P3d-P3e as acks_work counts them; P4 reads every role, the reset
        # flag of each node that does not lead, and the timers it changes.
        k = acks_work(args)
        followers = nodes - k["leaders"]
        p3 = (nodes + 5 * k["has_l"] + 4 * k["delivered"] + k["rows"] * N
              + 3 * k["acks"] + 4 * k["applied"])
        p4 = 4 * nodes + followers + 8 * k["counting"] + 4 * k["leaders"]
        return bound(p3 + p4, 9 * nodes + 8 * k["rows"] * N)
    # KK reads every apply flag and both commits, has_l where not applied,
    # the winner flags; with the recorder also every role, the down flag
    # of each leader and the log length of each live one, and each
    # winner's id and round-entry timer.
    (_, _, _, win, _, _, apply_, _, _, role, _, down) = args[:12]
    n_apply = int(apply_.sum())
    nbytes = 9 * nodes + (nodes - n_apply) + B * A
    if len(args) == 15:                         # w and lat given
        lead = role == 2
        nbytes += (4 * nodes + int(lead.sum()) + 4 * int((lead & ~down).sum())
                   + 8 * int(win.sum()))
    return bound(nbytes, 10 * nodes)


def check_phases(dev, gen, cfg) -> list[dict]:
    """KD-KK against their plain versions on round 20 of the flagship (with
    its telemetry on) and on the random and built edge inputs; times and
    bounds on the flagship's inputs."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    real = capture_phase_inputs(cfg, 20)
    edges = edge_phase_inputs(dev, gen)
    rows = []
    for name in PHASES:
        err = max(max_abs_err(run_pair(name, args))
                  for args in [real[name], *edges[name]])
        args = real[name]
        fn, plain = getattr(rs, name), getattr(rs, name + "_plain")
        library = None
        if name == "acks_commit":
            rank = N - (N // 2 + 1) + 1
            library = device_ms(lambda m: torch.kthvalue(m, rank, dim=2),
                                (args[15],))
        rows.append(dict(name=name, route="cuda",
                         source=f"consensus_tpu_torch/csrc/{name}.cu",
                         replaces=REPLACES[name], max_abs_err=err,
                         ms=device_ms(fn, args),
                         plain_ms=device_ms(plain, args),
                         bound=phase_bound(name, args), library_ms=library))
    return rows


# --- phase 3, continued: the dense round's kernels KL-KO ---------------------

DENSE = ("delivery", "dense_elect", "dense_append", "dense_acks_commit")
DENSE_REPLACES = {
    "delivery": "consensus_tpu/ops/adversary.py:61 delivery",
    "dense_elect": "consensus_tpu/engines/raft.py:301 raft_round P0-P2",
    "dense_append": "consensus_tpu/engines/raft.py:422 raft_round P3a-P3c",
    "dense_acks_commit": "consensus_tpu/engines/raft.py:480 raft_round "
                         "P3d-P4"}
# BASELINE configs 1 and 2 (benchmarks/run_benchmarks.py CONFIGS) and
# their committed digests (benchmarks/parts/<name>.json).
DENSE_CONFIGS = {
    "raft-5node": dict(n_nodes=5, n_rounds=160, n_sweeps=512, seed=1),
    "raft-1kx1k": dict(n_nodes=1024, n_rounds=1024, n_sweeps=8, seed=2)}
DENSE_DIGESTS = {
    "raft-5node":
        "51007288213f9b78e1e4fd2f3601105ff97f12210a2a0a3382a059e2b703940b",
    "raft-1kx1k":
        "8748ac4fce3ad51b006d1d6542aa853f6d2f25839915ead9327bf7ca948f3308"}
# The rounds phase 3 records of each: the first election (every sweep's
# nodes of timeout 3 stand at once), and a round with a leader in every
# sweep. The kernels are timed on raft-1kx1k's second.
DENSE_ROUNDS = {"raft-5node": (3, 100), "raft-1kx1k": (3, 20)}


def dense_config(name: str, **kw):
    from consensus_tpu_torch.core.config import Config
    return Config(**{**dict(protocol="raft", log_capacity=L, max_entries=100,
                            drop_rate=0.01, churn_rate=0.001),
                     **DENSE_CONFIGS[name], **kw})


def capture_dense_inputs(cfg, rounds, device="cuda") -> dict:
    """{r: {wrapper: arguments}}: what each wrapper of the dense round
    (KL-KO) receives in each round r of ``rounds`` of ``cfg``'s eager run
    on ``device``, cloned as it arrives."""
    from consensus_tpu_torch.engines import raft
    from consensus_tpu_torch.network import runner
    st = runner.init(cfg, runner.make_seeds(cfg), device)
    out, r0 = {}, 0
    for r in sorted(rounds):
        st = runner.advance(cfg, st, r0, r - r0)
        got = out[r] = {}
        with standing_in(raft, DENSE, recording(got)):
            st = raft.raft_round(cfg, st, r)
        require(set(got) == set(DENSE), f"round {r} skipped a phase")
        r0 = r + 1
    return out


def dense_edge_inputs(dev, gen) -> dict:
    """Inputs on which the dense kernels' rare paths fire: {name: [args]}.
    KL: seeds and rounds at the u32 edges, partitions never, always and in
    some sweeps, N = 1024, 1000, 5, 3 and 1. KM-KO: the rounds of hostile
    runs (drops 0.3, partitions 0.4, churn 0.1, timeouts 1-3) at N = 64
    and 999, and random states over small alphabets, with two built
    sweeps: a re-grant in KM, and in KN two leaders of different terms,
    the older one bumped by the newer while a follower of its own term
    copies its row."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.engines import raft
    out = {name: [] for name in DENSE}

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def coin(p, shape):
        return torch.rand(shape, generator=gen, device=dev) < p

    seeds = torch.tensor([0, 0xFFFFFFFF, 1, 2, 3, 4, 5, 0x80000000],
                         dtype=torch.uint32, device=dev)
    half = rng.prob_threshold_u32(0.5)
    active = rng.random_u32_plain(seeds, rng.STREAM_PARTITION, 7, 0, 0) < half
    require(0 < int(active.sum()) < B, "edge inputs: no sweep whose "
            "partition is active and one whose is not")
    for n in (1024, 1000, 5, 3, 1):
        for r, drop, part in ((0, 0.01, 0.0), (0xFFFFFFFF, 0.3, 1.0),
                              (7, 0.3, 0.5), (7, 0.0, 0.5)):
            out["delivery"].append((seeds, r, n, rng.prob_threshold_u32(drop),
                                    rng.prob_threshold_u32(part)))

    for n in (64, 999):
        cfg = dense_config("raft-1kx1k", n_nodes=n, n_sweeps=B, seed=5,
                           t_min=1, t_max=4, drop_rate=0.3,
                           partition_rate=0.4, churn_rate=0.1)
        for got in capture_dense_inputs(cfg, (2, 5, 9, 17, 30),
                                        dev).values():
            for name in DENSE[1:]:
                out[name].append(got[name])

    n = 1024
    cfg = dense_config("raft-1kx1k")
    seeds = torch.arange(11, 11 + B, dtype=torch.int64,
                         device=dev).to(torch.uint32)
    logt, logv = ri(0, 4, (B, n, L)), ri(-2**31, 2**31 - 1, (B, n, L))
    term, role, vf = ri(0, 4, (B, n)), ri(0, 3, (B, n)), ri(-1, n, (B, n))
    timer, timeout = ri(0, 9, (B, n)), ri(1, 9, (B, n))
    log_len, commit = ri(0, L + 1, (B, n)), ri(0, 50, (B, n))
    match, nxt = ri(0, 256, (B, n, n), torch.uint8), \
        ri(0, 256, (B, n, n), torch.uint8)
    deliver, reset = coin(0.5, (B, n, n)), coin(0.3, (B, n))

    # KM. Sweep 0: node 10 voted for candidate 7 and hears it and the
    # lower candidate 3, both eligible: it grants 7 again.
    t0 = (term, role, vf, timer, timeout)
    term, role, vf, timer, timeout = (t.clone() for t in t0)
    deliver_m = deliver.clone()
    for node, (tm, rl, v) in {3: (5, 1, 3), 7: (5, 1, 7),
                              10: (5, 0, 7)}.items():
        term[0, node], role[0, node], vf[0, node] = tm, rl, v
        timer[0, node], timeout[0, node] = 0, 9
    log_len[0, (3, 7)], log_len[0, 10] = L, 0
    deliver_m[0, :, 10] = False
    deliver_m[0, (3, 7), 10] = True
    km = (cfg, seeds, 20, deliver_m, term, role, vf, timer, timeout, logt,
          log_len, match, nxt)
    got = raft.dense_elect_plain(*clone_args(km))
    require(int(got[2][0, 10]) == 7, "edge inputs: no re-grant")
    out["dense_elect"].append(km)
    term, role, vf, timer, timeout = t0

    # KN. Sweep 0: leader 5 (term 3) hears leader 9 (term 4), bumps and
    # copies its log from 0; follower 20 (term 3) hears only leader 5 and
    # copies 5's log from 0: as it was after P3a, not as 9 left it.
    term, role = term.clone(), role.clone()
    log_len, nxt, deliver_n = log_len.clone(), nxt.clone(), deliver.clone()
    role[0][role[0] == 2] = 0
    term[0, (5, 9, 20)] = torch.tensor([3, 4, 3], dtype=torch.int32,
                                       device=dev)
    role[0, (5, 9, 20)] = torch.tensor([2, 2, 0], dtype=torch.int32,
                                       device=dev)
    log_len[0, (5, 9)] = 60
    nxt[0, 9, 5], nxt[0, 5, 20] = 1, 1
    deliver_n[0, :, (5, 20)] = False
    deliver_n[0, 9, 5], deliver_n[0, 5, 20] = True, True
    kn = (cfg, seeds, 20, deliver_n, term, role, vf, timer, timeout, reset,
          logt, logv, log_len, commit, match, nxt)
    after = clone_args(kn)
    got = raft.dense_append_plain(*after)
    require(int(got[9][0, 5]) == 9 and int(got[9][0, 20]) == 5
            and bool(got[10][0, 5]) and bool(got[10][0, 20])
            and torch.equal(after[10][0, 20, :60], logt[0, 5, :60])
            and int(after[10][0, 20, 60]) == 3
            and not torch.equal(after[10][0, 5, :60], logt[0, 5, :60]),
            "edge inputs: no two leaders of different terms in one P3c")
    require(int(((got[9] >= 0) & ~got[10]).sum()) > 0,
            "edge inputs: no P3c reject")
    out["dense_append"].append(kn)

    # KO on random acks: bump3, decrements, matches above E.
    ko = (cfg, seeds, deliver, coin(0.3, (B, n)), ri(-1, n, (B, n)),
          coin(0.5, (B, n)), ri(0, L + 1, (B, n)), logt, term, role, vf,
          timeout, commit, match, nxt, timer, reset)
    after = clone_args(ko)
    raft.dense_acks_commit_plain(*after)
    require(int((after[14] < nxt).sum()) > 0, "edge inputs: no decrement")
    require(int((ko[3] & (role == 2) & (after[9] == 0)).sum()) > 0,
            "edge inputs: no bump3")
    out["dense_acks_commit"].append(ko)
    return out


def dense_ack_work(args) -> dict:
    """What KO must touch on its arguments: ``acks`` (nodes that ack),
    ``delivered`` (their delivered acks), the processing leaders
    ``proc`` ([B, N] bool), the delivered acks ``proc_acks`` to a
    processing leader, and ``bumped``, the leaders an acked term bumps."""
    (_, _, deliver, was_leader, ack_to, _, _, _, term, role, *_rest) = args
    n = term.shape[1]
    idx = torch.arange(n, device=term.device)
    ackm = (ack_to[:, :, None] == idx) & deliver                # [B, j, l]
    t_in3 = torch.where(ackm, term[:, :, None], 0).amax(1)
    still = was_leader & (role == 2)
    bumped = still & (t_in3 > term)
    proc = still & ~bumped
    return dict(acks=int((ack_to >= 0).sum()), delivered=int(ackm.sum()),
                proc=proc, proc_acks=int((ackm & proc[:, None, :]).sum()),
                bumped=int(bumped.sum()))


def dense_bound(name: str, args) -> tuple[float, str]:
    """The least time of dense kernel ``name``'s work on ``args``: the
    bytes it must move and the 32-bit operations it must do for these
    inputs (see each source's note)."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.engines import raft
    if name == "delivery":
        seed, r, n, _, part = args
        b = seed.shape[0]
        active = int((rng.random_u32_plain(seed, rng.STREAM_PARTITION, r, 0,
                                           0) < part).sum())
        draws = b + active * n if part else 0
        return bound(b * n * n + 4 * b,
                     EDGE_OPS * b * n * n + THREEFRY_OPS * draws)
    if name == "dense_elect":
        (_, _, _, _, term, role, vf, timer, timeout, *_rest) = args
        b, n = term.shape
        got = raft.dense_elect_plain(*clone_args(args))
        new = (role != 2) & (timer >= timeout)
        cand = (role == 1) | new
        pairs = int(cand.sum()) * n             # request bytes
        idx = torch.arange(n, device=term.device)
        granted = int(((got[2] >= 0) & (got[2] != idx) & got[5]).sum())
        won = int((cand & (got[1] == 2)).sum())
        bumped = int((got[0] > term + new.to(torch.int32)).sum())
        return bound(49 * b * n + pairs + granted + 2 * n * won,
                     20 * b * n + 10 * pairs
                     + THREEFRY_OPS * (int(new.sum()) + bumped))
    if name == "dense_append":
        (cfg, _, _, _, term, role, _, _, _, _, _, _, log_len, _, _,
         nxt) = args
        b, n = term.shape
        got = raft.dense_append_plain(*clone_args(args))
        lead = role == 2
        app = int((lead & (log_len < min(cfg.max_entries, L))).sum())
        pairs = int(lead.sum()) * n             # heartbeat bytes
        has_l, applied = got[9] >= 0, got[10]
        ls = got[9].clamp(min=0).to(torch.int64)
        prev = nxt.gather(1, ls[:, None, :])[:, 0].to(torch.int64) - 1
        copied = int(torch.where(applied, (got[6] - prev.clamp(min=0))
                                 .clamp(min=0), 0).sum())
        bumped = int((got[0] > term).sum())
        return bound(70 * b * n + pairs + 9 * int(has_l.sum()) + 9 * app
                     + 16 * copied,
                     30 * b * n + 8 * pairs + THREEFRY_OPS * (app + bumped))
    work = dense_ack_work(args)
    b, n = args[8].shape
    rows = int(work["proc"].sum())
    return bound(18 * b * n + work["delivered"] + 7 * work["proc_acks"]
                 + n * rows,
                 10 * b * n + 8 * n * rows + THREEFRY_OPS * work["bumped"])


def check_dense_kernels(dev, gen) -> list[dict]:
    """KL-KO against their plain versions on the rounds DENSE_ROUNDS of
    raft-1kx1k and raft-5node and on the edge inputs; times and bounds on
    raft-1kx1k's round with a leader in every sweep."""
    from consensus_tpu_torch.engines import raft
    real = {}
    for name, rounds in DENSE_ROUNDS.items():
        for r, got in capture_dense_inputs(dense_config(name),
                                           rounds).items():
            real[name, r] = got
    for name, (first, later) in DENSE_ROUNDS.items():
        won = raft.dense_elect_plain(*clone_args(
            real[name, first]["dense_elect"]))[1] == 2
        require(bool(won.any()), f"{name} round {first}: no election")
        lead = real[name, later]["dense_append"][5] == 2
        require(bool(lead.any(1).all()),
                f"{name} round {later}: a sweep without a leader")
    edges = dense_edge_inputs(dev, gen)
    timed = real["raft-1kx1k", DENSE_ROUNDS["raft-1kx1k"][1]]
    rows = []
    for name in DENSE:
        err = max(max_abs_err(run_pair(name, args)) for args in
                  [got[name] for got in real.values()] + edges[name])
        args, mod = timed[name], kernel_module(name)
        library = None
        if name == "dense_acks_commit":
            # One torch.kthvalue over the processing leaders' match rows.
            match, n = args[13], args[8].shape[1]
            leader_rows = match[dense_ack_work(args)["proc"]]
            library = device_ms(
                lambda m: torch.kthvalue(m, n - (n // 2 + 1) + 1, dim=1),
                (leader_rows,))
        rows.append(dict(name=name, route="cuda",
                         source=f"consensus_tpu_torch/csrc/{name}.cu",
                         replaces=DENSE_REPLACES[name], max_abs_err=err,
                         ms=device_ms(getattr(mod, name), args),
                         plain_ms=device_ms(getattr(mod, name + "_plain"),
                                            args),
                         bound=dense_bound(name, args), library_ms=library))
    return rows


def hand_kernels() -> dict[str, tuple[str, ...]]:
    """The ``__global__`` kernels of each source in ``_build.SOURCES``, by
    wrapper name: the names the profiler reports for them. Names are unique
    across the sources (the profiler names a kernel by its function)."""
    from consensus_tpu_torch import _build
    pattern = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    return {name: tuple(pattern.findall(
        (_build.CSRC / f"{name}.cu").read_text())) for name in _build.SOURCES}


def is_kernel(name: str, function: str) -> bool:
    """Whether the profiler's kernel ``name`` (demangled, or mangled) is
    the ``__global__`` ``function``, and not one whose name ends in it."""
    return re.search(rf"(?:^|[^A-Za-z_]){function}[(<EI]", name) is not None


# The round's code between two kernel wrappers (a gap) lies in one phase;
# none may run a PyTorch compute op on the card (only the zeroing fill_ of
# fresh tensors is allowed), and only "init", before the first round, may
# run any.
GAPS = {(None, "candidacy"): "init",
        ("candidacy", "top_active"): "P2",
        ("top_active", "delivery_edges"): "P2",
        ("delivery_edges", "delivery_edges"): "P2",
        ("delivery_edges", "elect"): "P2",
        ("elect", "top_active"): "leader mask",
        ("top_active", "slots"): "slot lifecycle",
        ("slots", "propose"): "P3a-P3b",
        ("propose", "delivery_edges"): "P3a-P3b",
        ("delivery_edges", "append_entries"): "P3c",
        ("append_entries", "delivery_edges"): "P3c-P3d",
        ("delivery_edges", "acks_commit"): "P3d-P4",
        ("acks_commit", "telemetry"): "telemetry",
        ("telemetry", "candidacy"): "between rounds",
        ("acks_commit", "candidacy"): "between rounds",
        ("telemetry", None): "after the last round",
        ("acks_commit", None): "after the last round",
        # The dense round.
        (None, "delivery"): "init",
        ("delivery", "dense_elect"): "P0-P2",
        ("dense_elect", "dense_append"): "P3a-P3c",
        ("dense_append", "dense_acks_commit"): "P3d-P4",
        ("dense_acks_commit", "delivery"): "between rounds",
        ("dense_acks_commit", None): "after the last round"}
ZEROING = ("aten::fill_", "aten::zero_")


def plain_ops_by_phase(cfg, device="cuda", telemetry=False) -> dict:
    """One eager run of ``cfg`` under torch.profiler with each kernel
    wrapper of the round in a named range: {place: {aten op: ms}} for every
    aten op that took time on the device (on the CPU: host time), where
    place is "in <wrapper>" or the phase of the round's code between two
    wrappers, found by the host order of the calls."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from consensus_tpu_torch.engines import raft
    from consensus_tpu_torch.engines import raft_sparse as rs
    from consensus_tpu_torch.network import runner
    on_cpu = torch.device(device).type == "cpu"
    # The wrappers the engine's round calls (KA's only through init).
    if runner.engine(cfg) is runner.DENSE:
        module, marked_names = raft, list(DENSE)
    else:
        module, marked_names = rs, [name for _, name in runner.KERNELS
                                    if name not in DENSE + ("random_u32",)]

    def marked(name, fn):
        def call(*args):
            with record_function(f"wrapper::{name}"):
                return fn(*args)
        return call

    def session():
        with standing_in(module, marked_names, marked), profile(
                activities=[ProfilerActivity.CPU] if on_cpu else
                [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            # The profiler records from its second step on.
            runner.run_device(cfg, device, telemetry=telemetry, graph=False)
            recorded_step(prof)
            runner.run_device(cfg, device, telemetry=telemetry, graph=False)
        return prof
    # Without device records every place would look free of compute ops.
    prof = session() if on_cpu else profiled(session, "the eager run")[0]
    events = prof.events()
    # Host ranges only: the profiler also puts each range on the device
    # timeline, where it spans the kernels' later execution.
    marks = sorted((e.time_range.start, e.time_range.end, e.name[9:])
                   for e in events if e.name.startswith("wrapper::")
                   and e.device_type == DeviceType.CPU)
    starts = [m[0] for m in marks]
    out: dict = {}
    for e in events:
        t = e.self_cpu_time_total if on_cpu else e.self_device_time_total
        if not e.name.startswith("aten::") or t <= 0:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < marks[i][1]:
            place = "in " + marks[i][2]
        else:
            key = (marks[i][2] if i >= 0 else None,
                   marks[i + 1][2] if i + 1 < len(marks) else None)
            place = GAPS.get(key, f"{key[0]} -> {key[1]}")
        ops = out.setdefault(place, {})
        ops[e.name] = ops.get(e.name, 0.0) + t / 1e3
    return out


def profile_replay(cfg) -> dict:
    """The flagship's graph replay: wall time of one replay up to the
    device's end (host clock, best of five), and one more replay under
    torch.profiler (after a warm-up step of the profiler, which misses the
    first launches of its first step): its device time by hand kernel, its
    device operations, and its busy share, device time over the same
    replay's wall. The profiler slows the host's side of a replay by a
    cost per device operation, so ``unprofiled_busy_share`` also divides
    that device time by the best unprofiled replay's wall."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from consensus_tpu_torch.network import runner
    runner.run_device(cfg)                      # the graph is captured
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        runner.run_device(cfg)
        walls.append((time.perf_counter() - t0) * 1e3)
    profiled_walls = []

    def session():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            runner.run_device(cfg)
            recorded_step(prof)
            t0 = time.perf_counter()
            runner.run_device(cfg)
            profiled_walls.append((time.perf_counter() - t0) * 1e3)
        return prof
    _, device = profiled(session, "the replay", graph=True)
    profiled_ms = profiled_walls[-1]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    hand = {k: sum(e.time_range.elapsed_us() for e in device
                   if any(is_kernel(e.name, f) for f in fns)) / 1e3
            for k, fns in hand_kernels().items()}
    return dict(replay_wall_ms=walls, profiled_wall_ms=profiled_ms,
                device_ms=busy_ms, busy_share=busy_ms / profiled_ms,
                unprofiled_busy_share=busy_ms / min(walls),
                device_launches=len(device),
                launches_per_round=len(device) / cfg.n_rounds,
                hand_kernel_ms=hand,
                hand_share=sum(hand.values()) / busy_ms)


def memory_use(run) -> dict:
    """``run()``'s result, and the device memory its first call of a config
    takes: the peak above what was allocated before (the eager warm-up
    round, the capture, the replays), and what stays allocated after it
    (the cached graph's pool: its state and outputs). The graphs cached
    before are dropped first."""
    from consensus_tpu_torch.network import runner
    runner.clear_graphs()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result = run()
    return dict(result=result,
                peak_bytes=torch.cuda.max_memory_allocated() - before,
                graph_bytes=torch.cuda.memory_allocated() - before,
                max_memory_allocated=torch.cuda.max_memory_allocated())


def check_seed_sharing(cfg, anchor: str) -> None:
    """A run of ``cfg`` with another seed replays the captured graph with
    its own seeds and equals the eager loop's run; ``cfg``'s own seed then
    gives its digest ``anchor`` again."""
    from consensus_tpu_torch.core import serialize
    from consensus_tpu_torch.network import runner, simulator
    other = dataclasses.replace(cfg, seed=cfg.seed + 1)
    captured = runner.captures
    replayed = simulator.run(other).digest
    eager = serialize.digest(simulator.decided_payload(
        other, runner.run(other, graph=False))[3])
    again = simulator.run(cfg).digest
    emit("seed_sharing", n_nodes=cfg.n_nodes, seed=other.seed,
         digest=replayed, eager_digest=eager,
         new_captures=runner.captures - captured, anchor_digest_again=again)
    require(runner.captures == captured,
            "a run with another seed captured a graph of its own")
    require(replayed == eager and replayed != anchor,
            "the replay with another seed disagrees with the eager loop")
    require(again == anchor,
            "the anchor's seed after another seed changed its digest")


# --- phase 5: telemetry --------------------------------------------------------

# The telemetry phase's anchor: the counters and flight recorder of
# raft-100k cut to N = 10 000 (the full shape is not run on a CPU), with
# telemetry and 8-round windows, made from the JAX package on the CPU by
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import json, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   res = simulator.run(Config(**chip_smoke.ANCHOR_CONFIG), warmup=False,
#                       telemetry=True)
#   print(json.dumps([res.digest, res.extras["telemetry"]["totals"],
#                     chip_smoke.flight_digest(res.extras["flight"])]))
#   EOF
ANCHOR_CONFIG = dict(protocol="raft", n_nodes=10_000, n_rounds=64,
                     n_sweeps=B, log_capacity=L, max_entries=100,
                     max_active=A, seed=6, drop_rate=0.01, churn_rate=0.001,
                     telemetry_window=WINDOW)
ANCHOR_DIGEST = \
    "0703855a0d71caeff1dd9aa885f98374ccb29cb7c9ec5011ac40659ccdca7073"
ANCHOR_TOTALS = {"leader_elections": 10, "append_accepted": 4771215,
                 "append_rejected": 222, "entries_committed": 4739189,
                 "attack_rounds": 0, "crashes": 0, "recoveries": 0,
                 "nodes_down": 0, "agg_down_rounds": 0, "stale_serves": 0,
                 "poisoned_serves": 0}
ANCHOR_FLIGHT = \
    "7d7a2d69d8455a34313b22e0423c75366a97a26ec56a3c27b15b761c10f676d8"


def flight_digest(flight) -> str:
    """SHA-256 of a flight recorder's window and latency arrays, by name,
    as little-endian int64 in the dicts' order."""
    h = hashlib.sha256()
    for part in ("windows", "latency"):
        for name, a in flight[part].items():
            h.update(name.encode())
            h.update(np.ascontiguousarray(a, dtype="<i8").tobytes())
    return h.hexdigest()


def check_telemetry(card: str, smi: str) -> int:
    """Phase 5. Returns kernel KK's launches in the telemetry run."""
    from consensus_tpu_torch.core.config import Config
    from consensus_tpu_torch.network import runner, simulator
    cfg = flagship_config(telemetry_window=WINDOW)
    for mod, name in runner.KERNELS:
        getattr(mod, name).launches = 0
    res = simulator.run(cfg, telemetry=True)
    launches = runner.launch_counts()
    tel, fl = res.extras["telemetry"], res.extras["flight"]
    per = tel["per_sweep"]
    windows_sum = all(np.array_equal(fl["windows"][k].sum(1), per[k])
                      for k in per)
    waits = np.array_equal(fl["latency"]["election_wait_rounds"].sum(1),
                           per["leader_elections"])
    # The eager loop on the same config, against the graph's replay.
    eager = runner.run_device(cfg, telemetry=True, graph=False)
    eager_stats = runner.telemetry_stats(cfg, eager)
    same = flight_digest(eager_stats["flight"]) == flight_digest(fl) and all(
        np.array_equal(eager_stats["telemetry"][k], per[k]) for k in per)
    anchor = simulator.run(Config(**ANCHOR_CONFIG), telemetry=True)
    anchor_flight = flight_digest(anchor.extras["flight"])
    anchor_totals = anchor.extras["telemetry"]["totals"]
    emit("telemetry", digest=res.digest, totals=tel["totals"],
         flight_sha256=flight_digest(fl), windows_sum_to_totals=windows_sum,
         waits_equal_elections=waits, graph_equals_eager=same,
         launches=launches, steps_per_sec=res.steps_per_sec,
         wall_s=res.wall_s, anchor_digest=anchor.digest,
         anchor_totals=anchor_totals, anchor_flight_sha256=anchor_flight,
         card=card, power=smi)
    require(res.digest == FLAGSHIP_DIGEST,
            f"telemetry changed the digest: {res.digest}")
    require(windows_sum, "the windows do not sum to the totals")
    require(waits, "election waits and leader elections disagree")
    require(same, "graph replay and eager loop disagree")
    for name, n in launches.items():
        require((n > 0) == (name not in DENSE),
                f"kernel {name}: {n} launches on the telemetry path")
    require(anchor.digest == ANCHOR_DIGEST and anchor_totals == ANCHOR_TOTALS
            and anchor_flight == ANCHOR_FLIGHT,
            "the N = 10 000 telemetry run disagrees with its JAX anchor")
    return launches["telemetry"]


def check_dense_path(card: str, smi: str) -> dict[str, int]:
    """Phase 6: the dense engine's main path, raft-5node and raft-1kx1k
    through ``simulator.run``, each replayed as one CUDA graph, with every
    launch count set to 0 just before and read just after. Their digests
    must be the committed anchors, KA and KL-KO must have launched and no
    other kernel. Then the replay under the profiler, and another seed of
    raft-1kx1k on the same graph against the eager loop. Returns the
    launches of both runs."""
    from consensus_tpu_torch.network import runner, simulator
    total = dict.fromkeys(runner.launch_counts(), 0)
    for name in DENSE_CONFIGS:
        cfg = dense_config(name)
        for mod, kernel in runner.KERNELS:
            getattr(mod, kernel).launches = 0
        memory = memory_use(lambda: simulator.run(cfg))
        res = memory.pop("result")
        launches = runner.launch_counts()
        require(res.counts.shape == (cfg.n_sweeps, cfg.n_nodes)
                and res.rec_a.shape == (cfg.n_sweeps, cfg.n_nodes, L),
                "decided logs of the wrong shape")
        emit("dense", config=name, digest=res.digest,
             digest_ok=res.digest == DENSE_DIGESTS[name],
             steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
             max_commit=int(res.counts.max()), launches=launches, **memory,
             **profile_replay(cfg), card=card, power=smi)
        require(res.digest == DENSE_DIGESTS[name],
                f"{name} digest {res.digest} != {DENSE_DIGESTS[name]}")
        for kernel, n in launches.items():
            require((n > 0) == (kernel in DENSE + ("random_u32",)),
                    f"kernel {kernel}: {n} launches on the {name} path")
            total[kernel] += n
    cfg = dense_config("raft-1kx1k")
    check_seed_sharing(cfg, DENSE_DIGESTS["raft-1kx1k"])
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # Keep CUPTI set up between profiler sessions: tearing it down and
    # setting it up again, with CUDA graphs in the process, loses device
    # records (PyTorch sets the same for its own CUDA-graph profiling).
    os.environ["TEARDOWN_CUPTI"] = "0"
    from consensus_tpu_torch import _build
    from consensus_tpu_torch.network import runner, simulator

    # 1. device
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", kind=card, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    seconds = _build.build()
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        print(f"--- nvcc {name}\n{log.read_text()}", file=sys.stderr)
    emit("build", wall_s=time.perf_counter() - t0, seconds=seconds)

    # 3. kernels
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    cfg = flagship_config()
    kernels = [check_random_u32(dev, gen), check_delivery_edges(dev, gen),
               check_top_active(dev, gen),
               *check_phases(dev, gen, flagship_config(
                   telemetry_window=WINDOW)),
               *check_dense_kernels(dev, gen)]
    torch.cuda.synchronize()
    require(sorted(k["name"] for k in kernels) == sorted(_build.SOURCES),
            "phase 3 does not check every kernel of csrc")
    for k in kernels:
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        emit("kernel", **k)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} disagrees with its plain version")

    # 4. flagship: the main path, counted from zero, replayed as a graph.
    for mod, name in runner.KERNELS:
        getattr(mod, name).launches = 0
    memory = memory_use(lambda: simulator.run(cfg))
    res = memory.pop("result")
    launches = runner.launch_counts()
    require(res.counts.shape == (B, N) and res.rec_a.shape == (B, N, L),
            "decided logs of the wrong shape")
    emit("flagship", digest=res.digest, digest_ok=res.digest == FLAGSHIP_DIGEST,
         steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
         max_commit=int(res.counts.max()), launches=launches, **memory,
         card=card, power=smi)
    require(res.digest == FLAGSHIP_DIGEST,
            f"flagship digest {res.digest} != {FLAGSHIP_DIGEST}")
    for name, n in launches.items():
        require((n > 0) == (name not in DENSE + ("telemetry",)),
                f"kernel {name}: {n} launches on the main path")
    check_seed_sharing(cfg, FLAGSHIP_DIGEST)

    # 5. telemetry and the flight recorder.
    launches["telemetry"] = check_telemetry(card, smi)

    # 6. the dense engine: BASELINE configs raft-5node and raft-1kx1k.
    dense = check_dense_path(card, smi)
    launches.update({name: dense[name] for name in DENSE})
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # 7. bench.py's shape.
    bench_cfg = flagship_config(max_entries=L - 16, seed=42)
    memory = memory_use(lambda: simulator.run(bench_cfg))
    bench = memory.pop("result")
    emit("bench", steps_per_sec=bench.steps_per_sec, wall_s=bench.wall_s,
         max_commit=int(bench.counts.max()), digest=bench.digest, **memory,
         **profile_replay(bench_cfg), card=card, power=smi)
    require(int(bench.counts.max()) > 0, "bench shape committed nothing")

    # 8. where the flagship's device time goes, and what runs in each phase
    # of an eager capped round and an eager dense round.
    prof = profile_replay(cfg)
    by_phase = plain_ops_by_phase(flagship_config(telemetry_window=WINDOW),
                                  telemetry=True)
    dense_by_phase = plain_ops_by_phase(dense_config("raft-1kx1k",
                                                     n_rounds=16))
    emit("profile", card=card, power=smi, **prof,
         plain_ops_by_phase=by_phase, dense_plain_ops_by_phase=dense_by_phase,
         profiler_sessions_redone=REDONE)
    for place, found in [*by_phase.items(), *dense_by_phase.items()]:
        require(place == "init" or set(found) <= set(ZEROING),
                f"PyTorch compute ops on the device in {place}: {found}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
