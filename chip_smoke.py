#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (consensus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   — a CUDA device is present; the card's name and power limit as
              ``nvidia-smi`` reports them.
2. build    — nvcc builds every kernel of ``consensus_tpu_torch/csrc``.
3. kernels  — each hand-written kernel (KA-KH) against its plain PyTorch
              version on the card, at the flagship shapes (B = 8 sweeps,
              N = 100 000 nodes, A = 8, L = 128) plus edge inputs; the round's
              phase kernels KE-KH also on the flagship's own inputs of round
              20. Tolerance: none, the results are integers and must be
              equal. Times are device time per call (torch.profiler kernel
              durations).
4. flagship — ``simulator.run`` of raft-100k (benchmarks/run_benchmarks.py
              CONFIGS["raft-100k"], seed 6): the decided-log digest must be
              the committed anchor, and every kernel must have launched.
5. bench    — bench.py's flagship shape (seed 42, max_entries 112):
              node-round-steps per second; something must commit.
6. profile  — one more flagship run under torch.profiler: device time by
              kernel, launches a round, the PyTorch ops still on the round's
              device timeline, and the device's busy share of an unprofiled
              run.

Then the card's name and power limit, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Any failure, or no GPU, exits
non-zero without that last line.
"""
from __future__ import annotations

import contextlib
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


# --- phase 3, continued: the round's phase kernels KE-KH ----------------------

PHASES = ("candidacy", "elect", "slots", "acks_commit")


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
def standing_in(names, make):
    """Replace each wrapper ``names`` of the round's module by
    ``make(name, wrapper)`` while the block runs. A wrapper counts its
    launches on the module attribute it is called by, so each stand-in
    carries a ``launches`` of its own."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    originals = {name: getattr(rs, name) for name in names}
    try:
        for name, fn in originals.items():
            stand_in = make(name, fn)
            stand_in.launches = 0
            setattr(rs, name, stand_in)
        yield
    finally:
        for name, fn in originals.items():
            setattr(rs, name, fn)


def capture_phase_inputs(cfg, r: int, device="cuda") -> dict:
    """The arguments each phase wrapper (KE-KH) receives in round ``r`` of
    ``cfg``'s run on ``device``, cloned as they arrive."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    from consensus_tpu_torch.network import runner
    st = runner.advance(cfg, runner.init(cfg, runner.make_seeds(cfg),
                                         device), 0, r)
    got = {}

    def recorder(name, fn):
        def record(*args):
            got[name] = clone_args(args)
            return fn(*args)
        return record
    with standing_in(PHASES, recorder):
        rs.raft_sparse_round(cfg, st, r)
    require(set(got) == set(PHASES), f"round {r} skipped a phase")
    return got


def run_pair(name: str, args) -> list:
    """The kernel and its plain version on separate clones of ``args``:
    pairs of their results and of every tensor argument afterwards, which
    covers the in-place updates and that nothing else was written."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    ka, pa = clone_args(args), clone_args(args)
    got = getattr(rs, name)(*ka)
    want = getattr(rs, name + "_plain")(*pa)
    pairs = list(zip(got or (), want or ()))
    return pairs + [(k, p) for k, p in zip(ka, pa)
                    if isinstance(k, torch.Tensor)]


def edge_phase_inputs(dev, gen) -> dict:
    """Built inputs on which the phases' rare paths fire: {name: [args]}."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.engines import raft_sparse as rs
    from consensus_tpu_torch.ops import adversary

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def coin(p, shape):
        return torch.rand(shape, generator=gen, device=dev) < p

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
    kh = (seeds, lead_id, coin(0.9, (B, A)) & (lead_id >= 0),
          coin(0.9, (B, N, A)),
          coin(0.8, (B, N)), kstar, coin(0.7, (B, N)), ri(0, L + 1, (B, N)),
          log_term, term, role, ri(-1, N, (B, N)), ri(1, 9, (B, N)), commit,
          lead_match, lead_next)
    kh[2][0, [0, 2]] = True
    for max_entries in (100, L):
        out["acks_commit"].append((flagship_config(max_entries=max_entries),
                                   *kh))
    return out


def acks_work(args) -> tuple[int, int]:
    """(processing slots, acks they take) of KH's arguments ``args``: the
    rows of [N] match bytes it must read, and the (slot, node) pairs whose
    next byte it must read and whose two bytes it must write."""
    (_, _, lead_id, was_lead_k, del_jl, has_l, kstar, _, _, _, term, role,
     *_rest) = args
    n = term.shape[1]
    lid = lead_id.clamp(0, n - 1).to(torch.int64)
    ackm = (torch.where(has_l, kstar, A)[:, :, None]
            == torch.arange(A, device=term.device)) & del_jl
    t_in3 = torch.where(ackm, term[:, :, None], 0).amax(1)
    proc = was_lead_k & (role.gather(1, lid) == 2) \
        & ~(t_in3 > term.gather(1, lid))
    return int(proc.sum()), int((ackm & proc[:, None, :]).sum())


def check_phases(dev, gen, cfg) -> list[dict]:
    """KE-KH against their plain versions on round 20 of the flagship and
    on the built edge inputs; times on the flagship's inputs."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    real = capture_phase_inputs(cfg, 20)
    edges = edge_phase_inputs(dev, gen)
    rows = []
    for name in PHASES:
        err = max(max_abs_err(run_pair(name, args))
                  for args in [real[name], *edges[name]])
        args = real[name]
        ka, pa = clone_args(args), clone_args(args)
        fn, plain = getattr(rs, name), getattr(rs, name + "_plain")
        row = dict(name=name, route="cuda",
                   source=f"consensus_tpu_torch/csrc/{name}.cu",
                   max_abs_err=err,
                   ms=device_ms(lambda: fn(*ka)),
                   plain_ms=device_ms(lambda: plain(*pa)), library_ms=None)
        nodes = B * N
        if name == "candidacy":
            moved = int(rs.candidacy_plain(*args)[5].sum())
            row.update(replaces="consensus_tpu/engines/raft_sparse.py:236 "
                                "raft_sparse_round P0-P1",
                       bound=bound(54 * nodes, 20 * nodes
                                   + THREEFRY_OPS * moved))
        elif name == "elect":
            row.update(replaces="consensus_tpu/engines/raft_sparse.py:255 "
                                "raft_sparse_round P2",
                       bound=bound((66 + 2 * (A - 8)) * nodes,
                                   12 * A * nodes))
        elif name == "slots":
            new_ids, lead_id = args[1], args[2]
            carried = int(((new_ids[:, :, None] == lead_id[:, None, :])
                           & (new_ids >= 0)[:, :, None]).any(2).sum())
            row.update(replaces="consensus_tpu/engines/raft_sparse.py:354 "
                                "raft_sparse_round slot lifecycle",
                       bound=bound(2 * B * A * N + 2 * carried * N,
                                   4 * B * A * N))
        else:
            rows_, acks = acks_work(args)
            lead_match = args[15]
            rank = N - (N // 2 + 1) + 1
            row.update(replaces="consensus_tpu/engines/raft_sparse.py:441 "
                                "raft_sparse_round P3d-P3e",
                       bound=bound(15 * nodes + rows_ * N + 3 * acks,
                                   6 * nodes + 8 * rows_ * N),
                       library_ms=device_ms(lambda: torch.kthvalue(
                           lead_match, rank, dim=2)))
        rows.append(row)
    return rows


# Kernel names of the hand-written kernels, as the profiler reports them.
HAND_KERNELS = {"random_u32": ("random_u32_kernel",),
                "delivery_edges": ("edges_src_kernel", "edges_dst_kernel"),
                "top_active": ("top_partial_kernel", "top_merge_kernel"),
                "append_entries": ("append_entries_kernel",),
                "candidacy": ("candidacy_kernel",),
                "elect": ("elect_nodes_kernel", "elect_winners_kernel"),
                "slots": ("slots_kernel",),
                "acks_commit": ("ack_term_kernel", "slot_bump_kernel",
                                "match_next_kernel", "commit_kernel")}


# The kernel wrappers the round calls. The round's code between two of them
# (a gap) lies in one phase; the plain-torch glue lives only in the phases
# marked "glue".
MARKED = ("candidacy", "top_active", "delivery_edges", "elect", "slots",
          "append_entries", "acks_commit")
GAPS = {(None, "candidacy"): "init",
        ("candidacy", "top_active"): "P2",
        ("top_active", "delivery_edges"): "P2",
        ("delivery_edges", "delivery_edges"): "P2",
        ("delivery_edges", "elect"): "P2",
        ("elect", "top_active"): "leader mask (glue)",
        ("top_active", "slots"): "slot lifecycle",
        ("slots", "delivery_edges"): "P3a-P3b (glue)",
        ("delivery_edges", "append_entries"): "P3c (glue)",
        ("append_entries", "delivery_edges"): "P3c-P3d",
        ("delivery_edges", "acks_commit"): "P3d-P3e",
        ("acks_commit", "candidacy"): "P4 (glue)",
        ("acks_commit", None): "P4 (glue)"}
# Phases that must run no plain PyTorch op on the card.
KERNEL_ONLY = ("P2", "slot lifecycle", "P3c-P3d", "P3d-P3e")


def plain_ops_by_phase(cfg, device="cuda") -> dict:
    """One run of ``cfg`` under torch.profiler with each kernel wrapper of
    the round in a named range: {place: {aten op: ms}} for every aten op
    that took time on the device (on the CPU: host time), where place is
    "in <wrapper>" or the phase of the round's code between two wrappers,
    found by the host order of the calls."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from consensus_tpu_torch.network import runner
    on_cpu = torch.device(device).type == "cpu"

    def marked(name, fn):
        def call(*args):
            with record_function(f"wrapper::{name}"):
                return fn(*args)
        return call
    with standing_in(MARKED, marked), profile(
            activities=[ProfilerActivity.CPU] if on_cpu else
            [ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.run_device(cfg, device)
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
    hand_ms = sum(hand.values())
    return dict(wall_ms=wall_ms, device_ms=busy_ms,
                busy_share=busy_ms / wall_ms, device_launches=len(device),
                launches_per_round=len(device) / cfg.n_rounds,
                hand_kernel_ms=hand, hand_share=hand_ms / busy_ms,
                plain_op_ms=sum(t for t, _ in ops),
                plain_ops=[[k, t] for t, k in ops],
                plain_ops_by_phase=plain_ops_by_phase(cfg))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from consensus_tpu_torch import _build
    from consensus_tpu_torch.core import rng
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
                "append_entries": rs.append_entries,
                **{name: getattr(rs, name) for name in PHASES}}
    cfg = flagship_config()
    kernels = [check_random_u32(dev, gen), check_delivery_edges(dev, gen),
               check_top_active(dev, gen), check_append_entries(dev, gen),
               *check_phases(dev, gen, cfg)]
    torch.cuda.synchronize()
    for k in kernels:
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        emit("kernel", **k)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} disagrees with its plain version")

    # 4. flagship: the main path, counted from zero.
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
    bench = simulator.run(flagship_config(max_entries=L - 16, seed=42))
    emit("bench", steps_per_sec=bench.steps_per_sec, wall_s=bench.wall_s,
         max_commit=int(bench.counts.max()), digest=bench.digest, card=card,
         power=smi)
    require(int(bench.counts.max()) > 0, "bench shape committed nothing")

    # 6. where the flagship's device time goes.
    prof = profile_run(cfg)
    emit("profile", card=card, power=smi, **prof)
    for place, found in prof["plain_ops_by_phase"].items():
        require(not (place.startswith("in ") or place in KERNEL_ONLY),
                f"plain PyTorch ops on the device in {place}: {found}")

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
