#!/usr/bin/env python3
"""Time hand kernels, and the replays they run in, of two checkouts of this
repository on one CUDA card, in turns.

    python3 kernel_ab.py --parent DIR [--kernels KZ,KV] [--quick] [--out FILE]

DIR is a checkout of the commit to compare with (unpacked with ``git
archive``); the other side is the checkout this script lies in. Each turn is
a process of its own that imports its checkout's ``consensus_tpu_torch`` and
``chip_smoke.py`` and builds that checkout's kernels (cached in its own
``build/`` after its first turn). The turns run parent, change, change,
parent, and each prints one JSON line. ``--kernels`` names the kernels to
compare (KERNELS: KZ and KV by default, KO and KW selectable), each on
phase 3's timed inputs:

* KZ (``paxos_accept_learn``) on paxos-10kx10k's round-15 inputs, with
  ``scatter_reduce(amax)`` (phase 4's segment maximum on KY's inputs) as
  its library yardstick, and the round's proceeding proposers by slot;
* KV (``bcast_decide``) on pbft-100k-bcast's round-20 inputs, with
  ``torch.amin`` over the deciders' ids, and the round's deciders;
* KO (``dense_acks_commit``) on raft-1kx1k's round-20 inputs, with
  ``torch.kthvalue``; KW (``dpos_schedule``) on dpos-100k's init, with a
  stable ``argsort``.

For each: device ms a call (``chip_smoke.device_ms``: torch.profiler, 20
calls rotating over clones past the 50 MB L2), the same calls' device ms
by device operation (each ``__global__`` and memset) and device operations
a call, and the library call's device ms; then the replays the kernel runs
in (``chip_smoke.profile_replay``): wall ms of five replays, device ms, and
the kernel's device ms and device operations in the profiled one. KZ's:
paxos-10kx10k flat, its knob batch (phase 24, two lanes) and its switch
batch (phase 25); KV's: pbft-100k-bcast flat and its knob batch (phase 23);
KO's: raft-1kx1k flat, /knobs and /switch; KW's: dpos-100k (``--quick``
leaves the replays out). A turn uses only helpers that the parent's
``chip_smoke.py`` has too.

A change turn first holds each kernel to its plain version on phase 3's
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
# Letter: (wrapper, the module of consensus_tpu_torch.engines that holds it).
KERNELS = {"KO": ("dense_acks_commit", "raft"),
           "KW": ("dpos_schedule", "dpos"),
           "KZ": ("paxos_accept_learn", "paxos"),
           "KV": ("bcast_decide", "pbft_bcast")}


def by_operation(cs, fn, args, reps: int = 20) -> tuple[dict, float]:
    """Device ms a call of ``fn(*args)`` by device operation name, and the
    device operations a call: one profiled session of ``reps`` calls, as
    ``chip_smoke.device_ms`` runs it."""
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
    _, device, launched = cs.profiled(session, fn.__name__, lost=cs.MAX_LOST)
    out: dict = {}
    for e in device:
        out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {name: ms / reps for name, ms in sorted(out.items())}, \
        launched / reps


def held(cs, name: str, inputs) -> float:
    """The largest difference of kernel ``name`` from its plain version
    over ``inputs`` (each a tuple of arguments)."""
    return max(cs.max_abs_err(cs.run_pair(name, args)) for args in inputs)


def paxos_case(cs, dev, gen, check: bool) -> dict:
    """KZ's timed arguments, yardstick, checked inputs, round statistics
    and replays."""
    import torch

    from consensus_tpu_torch.engines import paxos
    from consensus_tpu_torch.network import runner
    name = KERNELS["KZ"][0]
    cfg = cs.protocol_config(cs.PAXOS_FLAGSHIP)
    rounds = cs.capture_round_inputs(
        cfg, cs.PAXOS_ROUNDS if check else (15,), cs.PAXOS, dev)
    args = rounds[15][name]
    _, seed, r, _, _, new_promised, n_prom = args[:7]
    n, s = new_promised.shape[1:]
    is_prop, slot_p, _, _ = paxos.proposals(cfg, seed, r, n, s)
    proceed = is_prop & (n_prom >= n // 2 + 1)
    sizes = torch.bincount(slot_p[proceed], minlength=s)
    stats = dict(proceeding=int(proceed.sum()),
                 slots_by_bucket_size={int(k): int((sizes == k).sum())
                                       for k in sizes.unique()})
    inputs = []
    if check:
        edges = cs.paxos_edge_inputs(dev, gen)[name]
        inputs = [got[name] for got in rounds.values()] + edges + \
            cs.flagged(name, edges)
    replays = {"paxos-10kx10k": (cfg, None)}
    for key, make in (("paxos-10kx10k/knobs", cs.knob_count_batch),
                      ("paxos-10kx10k/switch", cs.knob_capped_batch)):
        base, _, seeds, kmat = make(key)
        replays[key] = (base, (lambda b=base, sd=seeds, k=kmat:
                               runner.knob_batch_device(b, sd, k)))
    return dict(args=args, library=cs.segment_max_yardstick(
        rounds[15]["paxos_promise"]), inputs=inputs, stats=stats,
        replays=replays)


def bcast_case(cs, dev, gen, check: bool) -> dict:
    """KV's timed arguments, yardstick, checked inputs, round statistics
    and replays."""
    from consensus_tpu_torch.engines import pbft_bcast as pb
    from consensus_tpu_torch.network import runner
    name = KERNELS["KV"][0]
    cfg = cs.bcast_config()
    rounds = cs.capture_bcast_inputs(cfg, cs.BCAST_ROUNDS)
    args = rounds[20][name]
    bits, committed = args[:2]
    n = bits.shape[1]
    hb, side = pb.hb_side(bits)
    ids = [(hb & (side == k))[:, :, None] & committed for k in (0, 1)]
    first = [d.int().argmax(1) for d in ids]
    stats = dict(pairs=2 * committed.shape[0] * committed.shape[2],
                 with_decider=sum(int(d.any(1).sum()) for d in ids),
                 last_decider=max(int(f[d.any(1)].max()) if d.any() else -1
                                  for f, d in zip(first, ids)), nodes=n)
    inputs = []
    if check:
        wide = cs.capture_bcast_inputs(cs.wide_config(), cs.BCAST_ROUNDS,
                                       cs.WIDE_RUNGS)
        inputs = [got[name] for got in (*rounds.values(), *wide.values())] \
            + cs.bcast_edge_inputs(dev, gen)[name]
    base, _, seeds, kmat = cs.knob_batch("pbft-100k-bcast/knobs")
    replays = {"pbft-100k-bcast": (cfg, None),
               "pbft-100k-bcast/knobs": (base, (
                   lambda: runner.knob_batch_device(base, seeds, kmat)))}
    return dict(args=args, library=cs.bcast_yardsticks(
        rounds[20]["bcast_view_preprepare"], args)[1], inputs=inputs,
        stats=stats, replays=replays)


def raft_case(cs, dev, gen, check: bool) -> dict:
    """KO's timed arguments, yardstick, checked inputs and replays."""
    import torch

    from consensus_tpu_torch.network import runner
    name = KERNELS["KO"][0]
    args = cs.capture_dense_inputs(cs.dense_config("raft-1kx1k"),
                                   (20,))[20][name]
    inputs = []
    if check:
        inputs = [got[name] for key, rounds in cs.DENSE_ROUNDS.items()
                  for got in cs.capture_dense_inputs(
                      cs.dense_config(key), rounds).values()] \
            + cs.dense_edge_inputs(dev, gen)[name]
    replays = {"raft-1kx1k": (cs.dense_config("raft-1kx1k"), None)}
    for key, make in (("raft-1kx1k/knobs", cs.knob_count_batch),
                      ("raft-1kx1k/switch", cs.knob_capped_batch)):
        base, _, seeds, kmat = make(key)
        replays[key] = (base, (lambda b=base, sd=seeds, k=kmat:
                               runner.knob_batch_device(b, sd, k)))
    # One torch.kthvalue over the processing leaders' match rows, as phase 3.
    match, n = args[13], args[8].shape[1]
    library = ((lambda m: torch.kthvalue(m, n - (n // 2 + 1) + 1, dim=1)),
               (match[cs.dense_ack_work(args)["proc"]],))
    return dict(args=args, library=library, inputs=inputs, stats={},
                replays=replays)


def dpos_case(cs, dev, gen, check: bool) -> dict:
    """KW's timed arguments, yardstick, checked inputs and replays."""
    import torch

    from consensus_tpu_torch.engines import dpos
    cfg = cs.protocol_config(cs.DPOS_FLAGSHIP)
    args = cs.schedule_args(cfg, dev)
    tallies = dpos.dpos_schedule_plain(*args)[1]
    inputs = []
    if check:
        inputs = [args] + cs.dpos_edge_inputs(dev, gen)[KERNELS["KW"][0]]
    return dict(args=args, library=(
        lambda t: torch.argsort(t, dim=2, stable=True), (tallies,)),
        inputs=inputs, stats={}, replays={"dpos-100k": (cfg, None)})


CASES = {"KZ": paxos_case, "KV": bcast_case, "KO": raft_case,
         "KW": dpos_case}


def turn(root: pathlib.Path, check: bool, letters, replays: bool) -> dict:
    sys.path.insert(0, str(root))
    os.environ["TEARDOWN_CUPTI"] = "0"      # as chip_smoke.py's main sets
    import importlib

    import torch

    import chip_smoke as cs
    from consensus_tpu_torch import _build
    require = cs.require
    out = dict(root=str(root), card=torch.cuda.get_device_name(0),
               power=cs.nvidia_smi())
    _build.build()
    dev = torch.device("cuda")
    functions = cs.hand_kernels()
    for letter in letters:
        name, module = KERNELS[letter]
        mod = importlib.import_module(f"consensus_tpu_torch.engines.{module}")
        require(pathlib.Path(mod.__file__).is_relative_to(root),
                f"imported {mod.__file__}, not {root}'s package")
        gen = torch.Generator(device=dev)
        gen.manual_seed(6)
        case = CASES[letter](cs, dev, gen, check)
        got = out[letter] = dict(name=name, stats=case["stats"])
        if check:
            got["max_abs_err"] = held(cs, name, case["inputs"])
            require(got["max_abs_err"] == 0.0,
                    f"{letter} differs from its plain version")
            got["nvcc"] = _build.library_path(name).with_suffix(
                ".log").read_text()
        del case["inputs"]
        fn = getattr(mod, name)
        got["ms"] = cs.device_ms(fn, case["args"])
        got["by_operation"], got["operations"] = by_operation(
            cs, fn, case["args"])
        got["library_ms"] = cs.device_ms(*case["library"])
        got["replays"] = {}
        for key, (cfg, run) in (case["replays"] if replays else {}).items():
            prof = cs.profile_replay(cfg, run=run)
            got["replays"][key] = dict(
                replay_wall_ms=prof["replay_wall_ms"],
                device_ms=prof["device_ms"],
                device_launches=prof["device_launches"],
                kernel_ms=prof["hand_kernel_ms"][name],
                kernel_functions={f: v for f, v in
                                  prof["hand_function_ms"].items()
                                  if f in functions[name]},
                other_ops=prof["other_ops"])
            torch.cuda.empty_cache()
        del case
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--kernels", default="KZ,KV",
                    help="comma-separated letters of KERNELS")
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--quick", action="store_true",
                    help="the kernels' times only, no replays")
    ap.add_argument("--turn", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    letters = a.kernels.split(",")
    unknown = set(letters) - set(KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}; known: {list(KERNELS)}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if a.turn is not None:
        print(json.dumps(turn(a.turn.resolve(), a.check, letters,
                              not a.quick)), flush=True)
        return 0
    if a.parent is None:
        ap.error("--parent is required")
    turns = []
    for root, check in ((a.parent, False), (HERE, True), (HERE, False),
                        (a.parent, False)):
        done = subprocess.run(
            [sys.executable, str(HERE / "kernel_ab.py"), "--turn",
             str(root.resolve()), "--kernels", a.kernels,
             *(["--check"] if check else []),
             *(["--quick"] if a.quick else [])],
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
