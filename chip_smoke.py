#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (consensus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   — a CUDA device is present; the card's name and power limit as
              ``nvidia-smi`` reports them.
2. build    — nvcc builds every kernel of ``consensus_tpu_torch/csrc``.
3. kernels  — each hand-written kernel (KA-KD) against its plain PyTorch
              version on the card, at the flagship shapes (B = 8 sweeps,
              N = 100 000 nodes, A = 8, L = 128) plus edge inputs. Tolerance:
              none, the results are integers and must be equal. Times are
              device time per call (torch.profiler kernel durations).
4. flagship — ``simulator.run`` of raft-100k (benchmarks/run_benchmarks.py
              CONFIGS["raft-100k"], seed 6): the decided-log digest must be
              the committed anchor, and every kernel must have launched.
5. bench    — bench.py's flagship shape (seed 42, max_entries 112):
              node-round-steps per second; something must commit.
6. profile  — one more flagship run under torch.profiler: device time by
              kernel, and the device's busy share of an unprofiled run.

Then the card's name and power limit, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Any failure, or no GPU, exits
non-zero without that last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

FLAGSHIP_DIGEST = \
    "0e9cc1ddc8b04d96240cdeb5f19877bbd3aad2b23883a585fa1e1c78a961ca5b"
B, N, A, L = 8, 100_000, 8, 128

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth, and the
# 67 TFLOP/s float32 rate outside the tensor cores, which counts a fused
# multiply-add as two operations: one 32-bit lane instruction a lane and
# clock, 33.5e12 a second, is the ceiling taken for 32-bit integer
# operations (each add, xor, shift or multiply one operation).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12
THREEFRY_OPS = 119     # 20 x (add, 3-op rotate, xor) + key schedule
EDGE_OPS = 23          # one mixer absorb (11) + fmix (8) + 4 tests an edge


class SmokeError(RuntimeError):
    pass


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def device_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of one call of ``fn``: the summed durations of the
    kernels it launched, from torch.profiler. (CUDA events around calls
    this short would time the host's launch cost, not the device.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    require(us > 0, "the profiler saw no device activity")
    return us / 1e3 / reps


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
    cases = [(rng.STREAM_TIMEOUT, term, 0, idx),        # _draw_timeout
             (rng.STREAM_VALUE, 63, 0, idx),            # P3a values
             (rng.STREAM_VALUE, 0xFFFFFFFF, 7, term),
             (rng.STREAM_CHURN, 5, 0, 0)]               # P0 churn
    err = max_abs_err((rng.random_u32(seeds, *c), rng.random_u32_plain(
        seeds, *c)) for c in cases)
    call = cases[0]
    nbytes = 4 * B + 4 * B * N + 4 * N + 8 * B * N
    return dict(
        name="random_u32", route="cuda",
        source="consensus_tpu_torch/csrc/random_u32.cu",
        replaces="consensus_tpu/core/rng.py:232 random_u32_jnp",
        max_abs_err=err,
        ms=device_ms(lambda: rng.random_u32(seeds, *call)),
        plain_ms=device_ms(lambda: rng.random_u32_plain(seeds, *call)),
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
        ms=device_ms(lambda: adversary.delivery_edges(*call)),
        plain_ms=device_ms(lambda: adversary.delivery_edges_plain(*call)),
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
        ms=device_ms(lambda: rs.top_active(sparse, term, A)),
        plain_ms=device_ms(lambda: rs.top_active_plain(sparse, term, A)),
        bound=bound(B * N * 5 + 4 * B * A, 4 * B * N),
        library_ms=device_ms(lambda: torch.topk(key, A, dim=1, largest=False)))


def check_append_entries(dev, gen):
    from consensus_tpu_torch.engines import raft_sparse as rs

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    # Terms from a small alphabet, so that log-match checks pass often.
    log_term, log_val = ri(0, 3, (B, N, L)), ri(-2**31, 2**31 - 1, (B, N, L))
    log_len, commit = ri(0, L + 1, (B, N)), ri(0, 20, (B, N))
    kstar, has_l = ri(0, A, (B, N)), ri(0, 2, (B, N)).bool()
    s_next = ri(1, L + 2, (B, A, N), torch.uint8)
    s_len, s_commit = ri(0, L + 1, (B, A)), ri(0, L + 1, (B, A))
    s_logt, s_logv = ri(0, 3, (B, A, L)), ri(-2**31, 2**31 - 1, (B, A, L))
    s_next[:, 0, :1000] = 1                      # prev = 0
    s_len[:, 0] = L                              # full-log copies
    s_next[:, 1, :1000] = 255                    # prev past any log
    inputs = (log_len, commit, kstar, has_l, s_next, s_len, s_commit,
              s_logt, s_logv)
    kt, kv = log_term.clone(), log_val.clone()
    pt, pv = log_term.clone(), log_val.clone()
    got = rs.append_entries(kt, kv, *inputs)
    want = rs.append_entries_plain(pt, pv, *inputs)
    err = max_abs_err(list(zip(got, want)) + [(kt, pt), (kv, pv)])
    # Bytes this input needs: per follower its slot, flag, length and commit
    # and three outputs; per reached follower one next byte and one own log
    # word; the leader tables once; 8 bytes per copied (term, value) pair.
    applied = want[0]
    k = kstar.to(torch.int64)
    prev = s_next.gather(1, k[:, None, :])[:, 0].to(torch.int64) - 1
    l_len = s_len.gather(1, k).to(torch.int64)
    copied = torch.where(applied, (l_len - prev.clamp(min=0)).clamp(min=0),
                         0).sum()
    nbytes = (B * N * 22 + int(has_l.sum()) * 5 + B * A * (L * 8 + 8)
              + 8 * int(copied))
    return dict(
        name="append_entries", route="cuda",
        source="consensus_tpu_torch/csrc/append_entries.cu",
        replaces="consensus_tpu/engines/raft_sparse.py:415 raft_sparse_round "
                 "P3c",
        max_abs_err=err,
        ms=device_ms(lambda: rs.append_entries(kt, kv, *inputs)),
        plain_ms=device_ms(lambda: rs.append_entries_plain(pt, pv, *inputs)),
        bound=bound(nbytes, 30 * B * N), library_ms=None)


# Kernel names of the hand-written kernels, as the profiler reports them.
HAND_KERNELS = {"random_u32": ("random_u32_kernel",),
                "delivery_edges": ("edges_src_kernel", "edges_dst_kernel"),
                "top_active": ("top_partial_kernel", "top_merge_kernel"),
                "append_entries": ("append_entries_kernel",)}


def profile_run(cfg) -> dict:
    """Device time of one flagship run, from torch.profiler: by hand kernel,
    by the PyTorch op that launched the rest, and as a share of the wall
    time of the same run unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from consensus_tpu_torch.network import runner
    t0 = time.perf_counter()
    runner.run_device(cfg)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.run_device(cfg)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    require(device, "the profiler saw no device activity")
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    hand = {k: sum(e.time_range.elapsed_us() for e in device
                   if any(p in e.name for p in pats)) / 1e3
            for k, pats in HAND_KERNELS.items()}
    ops = sorted(((e.self_device_time_total / 1e3, e.key)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_device_time_total > 0), reverse=True)
    return dict(wall_ms=wall_ms, device_ms=busy_ms,
                busy_share=busy_ms / wall_ms, device_launches=len(device),
                hand_kernel_ms=hand,
                plain_op_ms=sum(t for t, _ in ops),
                plain_op_top=[[k, t] for t, k in ops[:10]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from consensus_tpu_torch import _build
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.core.config import Config
    from consensus_tpu_torch.engines import raft_sparse as rs
    from consensus_tpu_torch.network import simulator
    from consensus_tpu_torch.ops import adversary

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
    wrappers = {"random_u32": rng.random_u32,
                "delivery_edges": adversary.delivery_edges,
                "top_active": rs.top_active,
                "append_entries": rs.append_entries}
    kernels = [check_random_u32(dev, gen), check_delivery_edges(dev, gen),
               check_top_active(dev, gen), check_append_entries(dev, gen)]
    torch.cuda.synchronize()
    for k in kernels:
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        emit("kernel", **k)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} disagrees with its plain version")

    # 4. flagship: the main path, counted from zero.
    cfg = Config(protocol="raft", n_nodes=N, n_rounds=64, n_sweeps=B,
                 log_capacity=L, max_entries=100, max_active=A, seed=6,
                 drop_rate=0.01, churn_rate=0.001)
    for w in wrappers.values():
        w.launches = 0
    res = simulator.run(cfg)
    launches = {name: w.launches for name, w in wrappers.items()}
    require(res.counts.shape == (B, N) and res.rec_a.shape == (B, N, L),
            "decided logs of the wrong shape")
    emit("flagship", digest=res.digest, digest_ok=res.digest == FLAGSHIP_DIGEST,
         steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
         max_commit=int(res.counts.max()), launches=launches, card=card,
         power=smi)
    require(res.digest == FLAGSHIP_DIGEST,
            f"flagship digest {res.digest} != {FLAGSHIP_DIGEST}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # 5. bench.py's shape.
    bench = simulator.run(Config(
        protocol="raft", n_nodes=N, n_rounds=64, n_sweeps=B, log_capacity=L,
        max_entries=L - 16, max_active=A, seed=42, drop_rate=0.01,
        churn_rate=0.001))
    emit("bench", steps_per_sec=bench.steps_per_sec, wall_s=bench.wall_s,
         max_commit=int(bench.counts.max()), digest=bench.digest, card=card,
         power=smi)
    require(int(bench.counts.max()) > 0, "bench shape committed nothing")

    # 6. where the flagship's device time goes.
    emit("profile", card=card, power=smi, **profile_run(cfg))

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
