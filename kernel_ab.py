#!/usr/bin/env python3
"""Time kernels KO and KW, and the replays they run in, of two checkouts of
this repository on one CUDA card, in turns.

    python3 kernel_ab.py --parent DIR [--out FILE]

DIR is a checkout of the commit to compare with (unpacked with ``git
archive``); the other side is the checkout this script lies in. Each turn is
a process of its own that imports its checkout's ``consensus_tpu_torch`` and
``chip_smoke.py`` and builds that checkout's kernels (cached in its own
``build/`` after its first turn). The turns run parent, change, change,
parent, and each prints one JSON line:

* KO (``dense_acks_commit``) on raft-1kx1k's round-20 inputs and KW
  (``dpos_schedule``) on dpos-100k's init, phase 3's timed inputs: device
  ms a call (``chip_smoke.device_ms``: torch.profiler, 20 calls rotating
  over clones past the 50 MB L2), and the same calls' device ms by device
  operation (each ``__global__`` and memset);
* the replays raft-1kx1k (flat), raft-1kx1k/knobs (phase 24's batch),
  raft-1kx1k/switch (phase 25's batch) and dpos-100k
  (``chip_smoke.profile_replay``): wall ms of five replays, device ms, and
  KO's and KW's device ms and device operations in the profiled one.

A change turn first holds both kernels to their plain versions on phase 3's
real and edge inputs, exactly, and fails if one differs. The last line is
the JSON list of the four turns; ``--out`` also writes it to FILE. The
card's name and power limit, as ``nvidia-smi`` gives them, lead each turn.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
KO, KW = "dense_acks_commit", "dpos_schedule"


def by_operation(cs, fn, args, reps: int = 20) -> dict:
    """Device ms a call of ``fn(*args)`` by device operation name: one
    profiled session of ``reps`` calls, as ``chip_smoke.device_ms`` runs
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    size = sum(a.nbytes for a in args if isinstance(a, torch.Tensor))
    copies = [cs.clone_args(args)
              for _ in range(min(16, max(2, -(-2 * cs.L2_BYTES // size))))]
    for i in range(3):
        fn(*copies[i % len(copies)])
    torch.cuda.synchronize()

    def session():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn(*copies[-1])
            torch.cuda.synchronize()
            with cs.recorded_step(prof):
                for i in range(reps):
                    fn(*copies[i % len(copies)])
                torch.cuda.synchronize()
        return prof
    _, device, _ = cs.profiled(session, fn.__name__, lost=cs.MAX_LOST)
    out: dict = {}
    for e in device:
        out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {name: ms / reps for name, ms in sorted(out.items())}


def held(cs, name: str, inputs) -> float:
    """The largest difference of kernel ``name`` from its plain version
    over ``inputs`` (each a tuple of arguments)."""
    return max(cs.max_abs_err(cs.run_pair(name, args)) for args in inputs)


def turn(root: pathlib.Path, check: bool) -> dict:
    sys.path.insert(0, str(root))
    os.environ["TEARDOWN_CUPTI"] = "0"      # as chip_smoke.py's main sets
    import torch

    import chip_smoke as cs
    from consensus_tpu_torch import _build
    from consensus_tpu_torch.engines import dpos, raft
    from consensus_tpu_torch.network import runner
    require = cs.require
    require(pathlib.Path(raft.__file__).is_relative_to(root),
            f"imported {raft.__file__}, not {root}'s package")
    _build.build()
    dev = torch.device("cuda")
    ko_args = cs.capture_dense_inputs(cs.dense_config("raft-1kx1k"),
                                      (20,))[20][KO]
    dcfg = cs.protocol_config(cs.DPOS_FLAGSHIP)
    kw_args = cs.schedule_args(dcfg, dev)
    out = dict(root=str(root), card=torch.cuda.get_device_name(0),
               power=cs.nvidia_smi())
    if check:
        gen = torch.Generator(device=dev)
        gen.manual_seed(6)
        real = [got[KO] for name, rounds in cs.DENSE_ROUNDS.items()
                for got in cs.capture_dense_inputs(cs.dense_config(name),
                                                   rounds).values()]
        out["ko_max_abs_err"] = held(
            cs, KO, real + cs.dense_edge_inputs(dev, gen)[KO])
        out["kw_max_abs_err"] = held(
            cs, KW, [kw_args] + cs.dpos_edge_inputs(dev, gen)[KW])
        require(out["ko_max_abs_err"] == out["kw_max_abs_err"] == 0.0,
                "a kernel differs from its plain version")
        out["nvcc"] = {k: _build.library_path(k).with_suffix(".log")
                       .read_text() for k in (KO, KW)}
    for key, fn, args in (("ko", raft.dense_acks_commit, ko_args),
                          ("kw", dpos.dpos_schedule, kw_args)):
        out[key + "_ms"] = cs.device_ms(fn, args)
        out[key + "_by_operation"] = by_operation(cs, fn, args)
    replays = {"raft-1kx1k": (cs.dense_config("raft-1kx1k"), None),
               "dpos-100k": (dcfg, None)}
    for key, make in (("raft-1kx1k/knobs", cs.knob_count_batch),
                      ("raft-1kx1k/switch", cs.knob_capped_batch)):
        base, _, seeds, kmat = make(key)
        replays[key] = (base, (lambda b=base, s=seeds, k=kmat:
                               runner.knob_batch_device(b, s, k)))
    out["replays"] = {}
    functions = set(cs.hand_kernels()[KO] + cs.hand_kernels()[KW])
    for key, (cfg, run) in replays.items():
        prof = cs.profile_replay(cfg, run=run)
        out["replays"][key] = dict(
            replay_wall_ms=prof["replay_wall_ms"],
            device_ms=prof["device_ms"],
            device_launches=prof["device_launches"],
            kernel_ms={k: prof["hand_kernel_ms"][k] for k in (KO, KW)},
            kernel_functions={f: v for f, v in
                              prof["hand_function_ms"].items()
                              if f in functions},
            other_ops=prof["other_ops"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--turn", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if a.turn is not None:
        print(json.dumps(turn(a.turn.resolve(), a.check)), flush=True)
        return 0
    if a.parent is None:
        ap.error("--parent is required")
    turns = []
    for root, check in ((a.parent, False), (HERE, True), (HERE, False),
                        (a.parent, False)):
        done = subprocess.run(
            [sys.executable, str(HERE / "kernel_ab.py"), "--turn",
             str(root.resolve()), *(["--check"] if check else [])],
            capture_output=True, text=True, cwd=root)
        sys.stderr.write(done.stderr[-4000:])
        if done.returncode != 0:
            print(done.stdout[-4000:], file=sys.stderr)
            return done.returncode
        turns.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(turns, indent=1))
    print(json.dumps(turns), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
