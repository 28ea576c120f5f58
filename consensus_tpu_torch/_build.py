"""Build the hand-written CUDA kernels of ``csrc/`` and call them via ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface: one ``ctt_<name>`` entry point
that launches its kernels in order on the stream it is given (zeroing its
scratch there first, where it has any) and returns ``cudaGetLastError()``.
No PyTorch header is included, so a build takes seconds. Libraries are built
at first use, all sources at once, into ``build/torch_kernels/`` at the root
of the checkout; the file name carries a hash of the sources and flags, so
an edit rebuilds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

SOURCES = ("random_u32", "delivery_edges", "top_active", "append_entries",
           "candidacy", "elect", "slots", "acks_commit", "propose",
           "telemetry", "delivery", "dense_elect", "dense_append",
           "dense_acks_commit", "dense_telemetry", "pbft_view_preprepare",
           "pbft_tally", "pbft_decide", "bcast_view_preprepare",
           "bcast_tally", "bcast_decide", "dpos_schedule", "dpos_round",
           "paxos_promise", "paxos_accept_learn", "pbft_telemetry",
           "dpos_telemetry", "paxos_telemetry", "hotstuff_propose",
           "hotstuff_vote", "hotstuff_learn", "hotstuff_extract",
           "crash_transition", "freeze_down", "hotstuff_prologue",
           "bcast_equiv_support", "agg_round", "switch_combine",
           "switch_receive")

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / \
    "torch_kernels"

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _U, _I, _L = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, \
    ctypes.c_longlong

# The trailing arguments of KM's, KY's and KZ's SWITCH instances
# (ops/aggregate.py switch_args): KAL's uplinks and table, K, drop_cut,
# part_cut, max_delay (null, null, 0, 0, 0, 0 but on a switch round).
_SW = (_P, _P, _I, _U, _U, _U)

# Argument types of each ctt_<name>, without the trailing stream pointer.
SIGNATURES = {
    # seed, round, §6c flags (null without a crash); tab, q, up outputs; t,
    # w accumulators (null without telemetry; w null without the
    # recorder); B, N, K, phases; fail_cut, stale_cut, max_stale,
    # poison_cut (0: §9b off), agg_byz; drop_cut, part_cut, max_delay; C,
    # col, window, n_windows; the poisonable phases, the §6b uplink, n_real
    # (null but on a PBFT round)
    # and last the knob table (null but in a knob batch)
    "agg_round": (_P, _U) + (_P,) * 6 + (_I,) * 4 + (_U,) * 4 + (_I,)
    + (_U,) * 3 + (_I,) * 4 + (_I, _I, _P, _P),
    # seed, round, n_real, the phase's flags, pp_val (null in the decide
    # phase), KAL's uplinks; the tot (or least-id) and value (null in the
    # decide phase) tables outputs, scratch; the uplinks' rows a lane, the
    # phase's row, B, N, S, K, decide, n_byzantine, equivocation; the §9b
    # lie cutoff (0 without lies); and last the knob table (null but in a
    # knob batch)
    "switch_combine": (_P, _U) + (_P,) * 7 + (_I,) * 9 + (_U, _P),
    # seed, round, n_real, f, KAL's table, KAM's two tables, flags, values,
    # KAL's uplinks, their rows a lane, the phase's row; base, dval in and
    # out, out, committed at round entry, timer, reset, timer out, the
    # §6c flag word (null but where a down receiver takes nothing), the
    # downlink-mask scratch; B, N, S, K, phase, n_byzantine, equivocation,
    # §9b poison; drop_cut, part_cut, max_delay; and last the knob table
    # (null but in a knob batch)
    "switch_receive": (_P, _U) + (_P,) * 8 + (_I, _I) + (_P,) * 10
    + (_I,) * 8 + (_U,) * 3 + (_P,),
    # seed, stream, (ctx, c0, c1) x (ptr, scalar, batch stride), out, B, M
    "random_u32": (_P, _U, _P, _U, _L, _P, _U, _L, _P, _U, _L, _P, _I, _L),
    # seed, round, ids, out, B, A, N, drop_cut, part_cut, ids_are_src,
    # max_delay, §6c flags (null on the flat path); §A.3 attack word (null
    # but under an attack) and the jammed receiver (-1: every edge); §9
    # phase-0 uplinks, aggregator table, K, the uplinks' lane stride (null,
    # null, 0, 0 but on a switch round); and last the knob table (null but
    # in a knob batch)
    "delivery_edges": (_P, _U, _P, _P, _I, _I, _I, _U, _U, _I, _U, _P, _P,
                       _I, _P, _P, _I, _L, _P),
    # mask, term, partial scratch, out, B, N, A, blocks per sweep
    "top_active": (_P, _P, _P, _P, _I, _I, _I, _I),
    # seed, t_min, t_span; del_lj, lead_id, s_term, term, role, voted_for,
    # timer, timeout, reset, log_term, log_val (in place), log_len, commit,
    # s_next, s_len, s_commit, s_logt, s_logv; term, role, voted_for,
    # timer, timeout, reset, kstar, has_l, apply, log_len, commit outputs;
    # B, N, A, L
    "append_entries": (_P, _I, _U) + (_P,) * 29 + (_I,) * 4,
    # seed, round, churn_cut, t_min, t_span; term, role, voted_for, timer,
    # timeout, log_term, log_len; term, role, voted_for, timer, timeout,
    # reset, own_lterm, cand_mask outputs; §6c flags (null on the flat
    # path); B, N, L; §3c byz mode, n_byzantine (0, 0 on the flat path);
    # §A.3 attack mode, attack_cut, target, attack word output (0, 0, 0,
    # null on the flat path); and last the knob table (null but in a knob
    # batch)
    "candidacy": (_P, _U, _U, _I, _U) + (_P,) * 16 + (_I,) * 5
    + (_I, _U, _I, _P, _P),
    # seed, t_min, t_span; cand_ids, del_cj, del_jc, term, role, voted_for,
    # timer, timeout, reset, log_len, own_lterm; term, role, voted_for,
    # timer, timeout, reset, lead, win outputs, votes scratch; §6c flags
    # (null on the flat path); B, N, A; byz mode, n_byzantine
    "elect": (_P, _I, _U) + (_P,) * 21 + (_I,) * 5,
    # new_ids, lead_id, lead_match, lead_next, role, log_len, lead_match
    # and lead_next outputs; B, N, A, E
    "slots": (_P,) * 8 + (_I, _I, _I, _I),
    # seed, t_min, t_span; lead_id, was_lead_k, del_jl, has_l, kstar,
    # apply, log_len, log_term; term, role, voted_for, timeout, commit,
    # lead_match, lead_next, timer (in place), reset; t_in3, proc, hist
    # scratch; §6c flags (null on the flat path); B, N, A, L, E; byz mode,
    # n_byzantine
    "acks_commit": (_P, _I, _U) + (_P,) * 21 + (_I,) * 7,
    # seed, round, lead, term, log_term, log_val (in place), log_len,
    # commit, lead_id; log_len, was_lead_k, hb_ids, s_term, s_len,
    # s_commit, s_logt, s_logv outputs; B, N, A, L, E; byz mode,
    # n_byzantine
    "propose": (_P, _U) + (_P,) * 15 + (_I,) * 7,
    # cand_ids, win, timer at round entry, has_l, apply, commit at round
    # entry, commit, role, log_len, down; t, w, lat accumulators (w and
    # lat null with the recorder off); B, N, A, K, window, n_windows; §A.3
    # attack word (null but under an attack)
    "telemetry": (_P,) * 13 + (_I,) * 6 + (_P,),
    # seed, round, out, side scratch, B, N, drop_cut, part_cut, max_delay,
    # §6c flags (null on the flat path); §A.3 sticky: role at round entry
    # (null but under the sticky attack), target, attack_cut; and last the
    # knob table (null but in a knob batch)
    "delivery": (_P, _U, _P, _P, _I, _I, _U, _U, _U, _P, _P, _I, _U, _P),
    # seed, round, churn_cut, t_min, t_span; deliver, term, role,
    # voted_for, timer, timeout, log_term, log_len, match_idx and next_idx
    # (in place); term, role, voted_for, timer, timeout, reset outputs,
    # winner flags (null without telemetry), scratch; §6c flags (null on
    # the flat path); B, N, L; byz mode, n_byzantine; §A.3 attack mode,
    # attack_cut, target, attack word output (0, 0, 0, null on the flat
    # path)
    # §9 switch (ops/aggregate.py switch_args) and the sticky target (-1
    # but on a switch round under the sticky attack); and last the knob
    # table (null but in a knob batch)
    "dense_elect": (_P, _U, _U, _I, _U) + (_P,) * 19 + (_I,) * 5
    + (_I, _U, _I, _P) + _SW + (_I, _P),
    # seed, round, t_min, t_span; deliver, term, role, voted_for, timer,
    # timeout, reset, log_term, log_val (in place), log_len, commit,
    # match_idx (in place), next_idx; term, role, voted_for, timer,
    # timeout, reset, log_len, commit, was_leader, ack_to, ack_ok,
    # ack_match outputs; scratch, row scratch; §6c flags (null on the flat
    # path); B, N, L, E; byz mode, n_byzantine
    "dense_append": (_P, _U, _I, _U) + (_P,) * 28 + (_I,) * 6,
    # seed, t_min, t_span; deliver, was_leader, ack_to, ack_ok, ack_match,
    # log_term; term, role, voted_for, timeout, commit, match_idx,
    # next_idx, timer (in place), reset; scratch; §6c flags (null on the
    # flat path); B, N, L, E; byz mode, n_byzantine
    "dense_acks_commit": (_P, _I, _U) + (_P,) * 17 + (_I,) * 6,
    # win, timer at round entry, ack_to, ack_ok, commit at round entry,
    # commit, role, log_len, down; t, w, lat accumulators (w and lat null
    # with the recorder off); B, N, K, window, n_windows; §A.3 attack word
    # (null but under an attack)
    "dense_telemetry": (_P,) * 12 + (_I,) * 5 + (_P,),
    # seed, round, churn_cut, view_timeout, vmax, desync_cut, max_skew
    # (§B; desync_cut 0 off); deliver, n_real, f, view, timer, pp_seen,
    # pp_view, pp_val, prepared, committed; view, timer, reset, pp_seen,
    # pp_view, pp_val outputs, catch-up flags (null without telemetry),
    # order scratch; §6c flags (null on the flat path); B, N, S; byz mode,
    # n_byzantine; and last the knob table (null but in a knob batch)
    "pbft_view_preprepare": (_P, _U, _U, _I, _I, _U, _U) + (_P,) * 19
    + (_I,) * 5 + (_P,),
    # deliver, n_real, f, pp_seen, pp_val, prepared, committed, dval;
    # prepared, committed, dval outputs; B, N, S; byz mode, n_byzantine,
    # then under equivocation seed, round and the extra-count scratch (null,
    # 0, null otherwise)
    "pbft_tally": (_P,) * 11 + (_I,) * 5 + (_P, _U, _P),
    # deliver, n_real, committed, dval, committed at round entry, timer,
    # reset; committed, dval, timer outputs; B, N, S; byz mode, n_byzantine
    "pbft_decide": (_P,) * 10 + (_I,) * 5,
    # seed, round, churn_cut, drop_cut, part_cut, max_delay, view_timeout,
    # vmax, desync_cut, max_skew (§B; desync_cut 0 off); n_real, f, view,
    # timer, pp_seen, pp_view, pp_val, prepared, committed; view, timer,
    # reset, pp_seen, pp_view, pp_val, node bits outputs, histogram and
    # first-unseen-slot scratch, catch-up flags (null without telemetry);
    # §6c flags (null on the flat path); B, N, S; byz mode, n_byzantine
    # and last the knob table (null but in a knob batch)
    "bcast_view_preprepare": (_P, _U, _U, _U, _U, _U, _I, _I, _U, _U)
    + (_P,) * 20 + (_I,) * 5 + (_P,),
    # n_real, f, node bits, pp_seen, pp_val, prepared, committed, dval;
    # prepared, committed, dval outputs, scratch; scratch words; m, B, N,
    # S, §6c (bit 2 of the node bits read); byz mode, n_byzantine, the
    # equivocating support (null but under equivocation)
    "bcast_tally": (_P,) * 12 + (_L,) + (_I,) * 7 + (_P,),
    # node bits, committed, dval, committed at round entry, timer, reset;
    # committed, dval, timer outputs, minima scratch; B, N, S, §6c (bit 2
    # of the node bits read); n_real (null on the flat path), n_byzantine
    "bcast_decide": (_P,) * 10 + (_I,) * 4 + (_P, _I),
    # seeds; producers, tallies outputs; partials scratch (null: the RANKS
    # instance); B, E, V, C, K, partials a lane
    "dpos_schedule": (_P,) * 4 + (_I,) * 6,
    # seed, round, producers; chain_r, chain_p, chain_len (in place),
    # append counts (null without telemetry); chain_r and chain_p element
    # sizes, the round's producer index within a lane's list and the
    # list's length (E * K), drop_cut, part_cut, churn_cut, max_delay;
    # §6c flags (null on the flat path); B, V, L; §A.1 miss_cut, §A.4
    # suppress_cut and suppress_window (0, 0 and any window on the flat
    # path); and last the knob table (null but in a knob batch)
    "dpos_round": (_P, _U) + (_P,) * 5 + (_I,) * 4 + (_U,) * 4 + (_P,)
    + (_I,) * 3 + (_U,) * 3 + (_P,),
    # seed, round; deliver, promised, acc_bal; new_promised, n_prom,
    # best_bal, best_a, prep_del outputs, pair counts (null without
    # telemetry), proposal and key scratch; §6c flags (null on the flat
    # path); P, churn_cut, B, N, S; §9 switch (ops/aggregate.py
    # switch_args); and last the knob table (null but in a knob batch)
    "paxos_promise": (_P, _U) + (_P,) * 12 + (_I, _U, _I, _I, _I) + _SW
    + (_P,),
    # seed, round; deliver, prep_del, new_promised, n_prom, best_bal,
    # best_a, acc_bal, acc_val, learned_val, learned_mask; promised,
    # acc_bal, acc_val, learned_val, learned_mask outputs, proposal, count
    # and bit scratch; P, churn_cut, B, N, S; §9 switch (ops/aggregate.py
    # switch_args); and last the knob table (null but in a knob batch)
    "paxos_accept_learn": (_P, _U) + (_P,) * 18 + (_I, _U, _I, _I, _I)
    + _SW + (_P,),
    # n_real; view and timer at round entry, view, catch-up flags, down;
    # pp_seen, prepared at entry, prepared, committed at entry, committed
    # after the tally, committed; t, w, lat accumulators (w and lat null
    # with the recorder off), span scratch; round, B, N, S, K, window,
    # n_windows
    # n_windows, §6c mode (engines/pbft.py CRASH_VIEWS, CRASH_COMMITS);
    # byz mode, n_byzantine; pp_val, dval at entry, dval (null but under
    # equivocation)
    "pbft_telemetry": (_P,) * 16 + (_I,) * 10 + (_P,) * 3,
    # seed, round; producers, chain_len, KX's append counts; t, w, lat
    # accumulators (w and lat null with the recorder off), span scratch;
    # the round's and the round before's producer indexes, the list's
    # length, churn_cut; B, V, K, window, n_windows; §A.1 miss_cut, §A.4
    # suppress_cut and suppress_window (as KX's); and last the knob table
    # (null but in a knob batch)
    "dpos_telemetry": (_P, _U) + (_P,) * 7 + (_I,) * 3 + (_U,) + (_I,) * 5
    + (_U,) * 3 + (_P,),
    # n_prom, n_pair, n_acc, decided; learned_mask at entry and after; t,
    # w, lat accumulators (w and lat null with the recorder off); decided's
    # lane stride; round, B, N, S, K, window, n_windows
    "paxos_telemetry": (_P,) * 9 + (_L,) + (_I,) * 7,
    # seed, round; view, b1_h, lane words (in place); view after P1,
    # catch-up flags outputs; §6c flags (null on the flat path); drop_cut,
    # part_cut, churn_cut, max_delay; the lane word of P1's key; B, N, S;
    # byz mode, n_byzantine
    # and last the knob table (null but in a knob batch)
    "hotstuff_propose": (_P, _U) + (_P,) * 6 + (_U,) * 4 + (_I,) * 6
    + (_P,),
    # seed, round; view after P1, lane words (in place), b1_v, b1_h, b2_v,
    # b2_h, b3_v, b3_h, gcommit, chain_v (in place); delivery flags, [7, B]
    # registers outputs; §6c flags (null on the flat path); drop_cut,
    # part_cut, max_delay; Q, B, N, S; byz mode, n_byzantine; chain_vid,
    # ftab_v, ftab_h, fnum (in place), deceived output (null but under
    # equivocation); §9 switch: KAL's uplinks and table, K (null, null, 0
    # but on a switch round; ops/aggregate.py switch_tables), and the §9b
    # uplink-lie cutoff (0 without lies)
    # and last the knob table (null but in a knob batch)
    "hotstuff_vote": (_P, _U) + (_P,) * 13 + (_U,) * 3 + (_I,) * 6
    + (_P,) * 5 + (_P, _P, _I, _U, _P),
    # view after P1, delivery flags, catch-up flags, timer, clen, lane
    # words (in place), gcommit at round entry, b1_h and gcommit after P4;
    # [3, B, N] view, timer, clen output; t, w, lat accumulators (null
    # without telemetry; w and lat null without the recorder); §6c flags,
    # view and timer at round entry (null on the flat path); Q,
    # view_timeout, B, N, window, n_windows; byz mode, n_byzantine;
    # deceived, fvec (in place), ftab_h, fnum (null but under equivocation)
    "hotstuff_learn": (_P,) * 16 + (_I,) * 8 + (_P,) * 4,
    # seed, chain_v, chain_vid, clen, fvec, ftab_v, ftab_h, fnum; committed,
    # dval outputs; B, N, S
    "hotstuff_extract": (_P,) * 10 + (_I,) * 3,
    # seed, round, down; down and flags outputs; crash_cut, recover_cut,
    # max_crashed; t, w accumulators (null without telemetry; w null
    # without the recorder); tile-count scratch (null without a cap); B,
    # N, K, the crash tail's column, window, n_windows
    # and last the knob table (null but in a knob batch)
    "crash_transition": (_P, _U, _P, _P, _P, _U, _U, _I, _P, _P, _P)
    + (_I,) * 6 + (_P,),
    # flags; eight (dst, src) leaf pointers (null past the last leaf);
    # eight row sizes in bytes; the reset-where-recovered bits; B, N
    "freeze_down": (_P,) * 17 + (_I,) * 8 + (_U, _I, _I),
    # seed, round; view, timer, §6c flags (null without a crash), lane
    # words (in place); [2, B, N] view and timer output; t, w accumulators
    # (null without telemetry; w null without the recorder); desync_cut,
    # max_skew; view_timeout, B, N, K, view_changes' column, window,
    # n_windows, n_byzantine
    # and last the knob table (null but in a knob batch)
    "hotstuff_prologue": (_P, _U) + (_P,) * 7 + (_U, _U) + (_I,) * 8
    + (_P,),
    # seed, round, n_real, node bits; support output; n_byzantine, B, N
    "bcast_equiv_support": (_P, _U, _P, _P, _P, _I, _I, _I),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns the seconds each
    build took (0.0 when it was already built) and raises with the
    compiler's output if any build fails. Each compiler log is kept next
    to its library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        seconds[name] = 0.0
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


@functools.cache
def _entry(name: str):
    build()  # all sources at once: the first launch builds them in parallel
    fn = getattr(ctypes.CDLL(str(library_path(name))), f"ctt_{name}")
    fn.argtypes = [*SIGNATURES[name], _P]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, *args) -> None:
    """Launch ``ctt_<name>`` on the current CUDA stream; raise on the error
    ``cudaGetLastError()`` reports right after the launch."""
    err = _entry(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError_t {err})")


def check(t: torch.Tensor, dtype: torch.dtype, device: torch.device,
          shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on the CUDA
    ``device`` (of ``shape`` when given) — what a kernel's pointer
    arithmetic assumes."""
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"expected a tensor on {device}, got {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
