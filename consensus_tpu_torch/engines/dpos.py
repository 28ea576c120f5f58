"""DPoS in PyTorch: SPEC §7, a stake-weighted producer schedule and one
block a round.

The port of ``consensus_tpu/engines/dpos.py`` on its flat path and under
its gates: the SPEC §A.2 delayed retransmission on the producer's edges,
the SPEC §6c crash-recover adversary, the SPEC §A.1 slot miss and the SPEC
§A.4 window-keyed producer suppression, with its telemetry and flight
recorder.
Each epoch's producers are the top K candidates of a stake-weighted vote
tally over every validator, computed once from the seed at init; round
r's producer is entry ``(r mod epoch_len) mod K`` of epoch
``r // epoch_len``'s list, and every validator that its block reaches
appends (r, producer) to its chain. No [V, V] mask exists: a round draws
the producer's V edges only. Sweeps (lanes) are a leading batch axis B on
every tensor.

Three functions are wrappers of hand-written CUDA kernels, each beside
its plain PyTorch version (``<name>_plain``), which CPU tensors run:

* :func:`dpos_schedule` — kernel KW (``csrc/dpos_schedule.cu``): stakes,
  votes, the [B, E, C] tallies and the [B, E, K] producers, at init;
* :func:`dpos_round` — kernel KX (``csrc/dpos_round.cu``): one round's
  delivery from the producer and the chain appends (and, for the
  telemetry, their count);
* :func:`dpos_telemetry` — kernel KAB (``csrc/dpos_telemetry.cu``): the
  round's DPOS_TELEMETRY counters and DPOS_LATENCY histogram.

On the card a run is KW once and KX once a round (and KAB once a round
with telemetry), and nothing else; with ``crash_prob > 0`` kernel KAH
(``ops/adversary.py`` ``crash_transition``) comes first in each round,
and KX's CRASH instance appends nothing at a down validator and nothing
at all in a round whose producer is down (``consensus_tpu/engines/
dpos.py:171-172``). With ``miss_rate`` or ``suppress_rate`` set, KX's
and KAB's GATES instances run: no validator appends in a round whose
producer misses its slot or is suppressed in the round's window, and KAB
counts the raw draws. DPoS has no volatile state: no reset, no freeze. The
chains are updated in place, where the JAX round returns new arrays: a
round's state replaces its input state. They are stored as the JAX
package stores them, ``chain_r`` in the narrowest unsigned type that holds
``n_rounds - 1`` and ``chain_p`` in the narrowest that holds
``n_candidates - 1`` (uint8, uint16 or int32).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import knobs, rng
from ..core.config import Config
from ..ops.adversary import (CRASH_DOWN, CRASH_TELEMETRY, bitcast_i32,
                             crash_step, open_drop_plain, slot_missed,
                             suppressed)
from ..ops.flight import (add_plain, bucket_counts_plain, check_recorder,
                          window_of)
from .raft import check_all

# The engine's name, as the JAX package's EngineDef names it.
NAME = "dpos"

# The DPoS engine's telemetry counters, in order: a copy of
# consensus_tpu/engines/dpos.py DPOS_TELEMETRY (lines 100-106): the
# round's chain extensions, the validators not extended, whether the
# producer changed from the round before, whether churn skipped the slot,
# the §A.1 and §A.4 draws of the round's producer and the crash tail.
DPOS_TELEMETRY = ("blocks_appended", "missed_appends", "producer_rotations",
                  "churn_slots", "missed_slots", "suppressed_slots") \
    + CRASH_TELEMETRY
# The flight recorder's latency histogram (engines/dpos.py DPOS_LATENCY,
# line 114): one observation a round, max(chain_len) - min(chain_len).
DPOS_LATENCY = ("chain_lag_rounds",)


class DposState(NamedTuple):
    seed: torch.Tensor       # [B] uint32
    producers: torch.Tensor  # [B, E, K] i32: each epoch's producer list
    chain_r: torch.Tensor    # [B, V, L] store_dtype(n_rounds - 1): rounds
    chain_p: torch.Tensor    # [B, V, L] store_dtype(n_candidates - 1)
    chain_len: torch.Tensor  # [B, V] i32
    down: torch.Tensor       # [B, V] bool (SPEC §6c: down at round end)


def store_dtype(vmax: int) -> torch.dtype:
    """The narrowest unsigned storage of values in [0, vmax], as
    ``consensus_tpu/engines/raft.py`` ``_store_dtype`` picks it (int32
    past uint16)."""
    if vmax <= 0xFF:
        return torch.uint8
    return torch.uint16 if vmax <= 0xFFFF else torch.int32


def n_epochs(cfg: Config) -> int:
    """E = ceil(n_rounds / epoch_len): the epochs a run reaches."""
    return -(-cfg.n_rounds // cfg.epoch_len)


# --- KW: the epoch schedule --------------------------------------------------

# The most candidates whose keys kernel KW ranks in its clusters' shared
# memory (csrc/dpos_schedule.cu KEYS_MAX_C); past it the RANKS instance.
KEYS_MAX_C = 16_384


def dpos_schedule_plain(cfg: Config, seeds) -> tuple:
    """Plain version of KW, SPEC §7's schedule for each seed of ``seeds``
    ([B] uint32). Validator v's stake is ``draw(STAKE, 0, 0, v) mod 1000 +
    1``; in epoch e it votes for candidate ``draw(VOTE, e, 0, v) mod C``;
    ``tallies[b, e, c]`` is the int32 (wrapping) sum of the stakes voting
    for c, and ``producers[b, e]`` the first K candidates of a stable
    ascending sort of the wrapped negated tallies: most stake first, ties
    to the lower id. Returns (producers [B, E, K], tallies [B, E, C]),
    int32."""
    V, C, K, E = cfg.n_nodes, cfg.n_candidates, cfg.n_producers, \
        n_epochs(cfg)
    B, dev = seeds.shape[0], seeds.device
    v = torch.arange(V, dtype=torch.int64, device=dev)
    stake = rng.random_u32_plain(seeds, rng.STREAM_STAKE, 0, 0, v) % 1000 + 1
    e = torch.arange(E, dtype=torch.int64, device=dev)
    k0 = (rng.as_u32(seeds) ^ rng.STREAM_VOTE)[:, None, None]
    shape = (B, E, V)
    vote = rng.threefry2x32_plain(k0.expand(shape), e[None, :, None].expand(
        shape), torch.zeros(shape, dtype=torch.int64, device=dev),
        v.expand(shape)) % C
    tallies = torch.zeros((B, E, C), dtype=torch.int64, device=dev)
    tallies.scatter_add_(2, vote, stake[:, None, :].expand(shape))
    tallies = bitcast_i32(rng.as_u32(tallies))
    return top_producers_plain(tallies, K), tallies


def top_producers_plain(tallies, K: int) -> torch.Tensor:
    """The first K candidates of a stable ascending sort of each epoch's
    wrapped negated int32 ``tallies`` ([..., C]), as the JAX package's
    ``jnp.argsort(-tally, stable=True)[:K]``: most stake first, ties to
    the lower id. [..., K] int32."""
    order = torch.argsort(bitcast_i32(rng.as_u32(-tallies.to(torch.int64))),
                          dim=-1, stable=True)
    return order[..., :K].to(torch.int32).contiguous()


def dpos_schedule(cfg: Config, seeds) -> tuple:
    """Kernel KW: same arguments and result as :func:`dpos_schedule_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/dpos_schedule.cu``: G blocks a lane (G the card's SMs over the
    lanes, at most one a 256 validators) draw each validator's stake and
    votes once, into an [E, C] histogram in shared memory stored as the
    lane's partial g; then a thread block cluster a (lane, epoch) sums the
    partials in slices of candidates, packs each tally as a u64 key (the
    negated tally's order word high, the id low), ranks the keys by
    counting within each slice and then, for the first min(K, slice) of
    every slice, within their union in the first block, and writes the
    first K ids at their ranks. Two launches, no memset, no global atomic:
    ascending keys are the plain version's stable order, and modular sums
    and distinct keys make the result independent of order. Past C =
    KEYS_MAX_C its RANKS instance
    runs (global atomics into the zeroed tallies, then a thread per
    candidate counts the candidates ranked before it)."""
    if seeds.device.type == "cpu":
        return dpos_schedule_plain(cfg, seeds)
    from .. import _build
    B, dev = seeds.shape[0], seeds.device
    V, C, K, E = cfg.n_nodes, cfg.n_candidates, cfg.n_producers, \
        n_epochs(cfg)
    _build.check(seeds, torch.uint32, dev, (B,))
    producers = torch.empty((B, E, K), dtype=torch.int32, device=dev)
    tallies = torch.empty((B, E, C), dtype=torch.int32, device=dev)
    G, partials = 0, None
    if C <= KEYS_MAX_C:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        G = max(1, min(-(-V // 256), -(-sms // max(B, 1))))
        partials = torch.empty((B, G, E, C), dtype=torch.int32, device=dev)
    _build.launch("dpos_schedule", seeds.data_ptr(), producers.data_ptr(),
                  tallies.data_ptr(),
                  None if partials is None else partials.data_ptr(),
                  B, E, V, C, K, G)
    dpos_schedule.launches += 1
    return producers, tallies


dpos_schedule.launches = 0


# --- KX: the round -----------------------------------------------------------

def producer_index(cfg: Config, r: int) -> int:
    """Round r's entry in a lane's [E * K] producer list: entry
    ``(r mod epoch_len) mod K`` of epoch ``r // epoch_len``'s list."""
    e, t = divmod(int(r), cfg.epoch_len)
    return e * cfg.n_producers + t % cfg.n_producers


def round_producer(cfg: Config, producers, r: int) -> torch.Tensor:
    """[B] int32: round r's producer of each lane (:func:`producer_index`;
    read on the device)."""
    return producers.reshape(producers.shape[0], -1)[
        :, producer_index(cfg, r)]


def gated(cfg: Config) -> bool:
    """Whether the round runs the SPEC §A.1 or §A.4 gate: KX's and KAB's
    GATES instances."""
    return cfg.miss_on or cfg.suppress_on


def gate_draws(cfg: Config, seed, r: int, producers) -> tuple:
    """The SPEC §A.1 and §A.4 draws of round r's producer in each lane, as
    ``consensus_tpu/engines/dpos.py:139-163`` draws them: ([B] bool slot
    missed, [B] bool suppressed in the round's window); a gate that is off
    never fires (its cutoff is 0)."""
    p = round_producer(cfg, producers, r)
    u32 = rng.random_u32_plain
    return (slot_missed(seed, r, p, cfg.miss_cutoff, u32),
            suppressed(seed, r, cfg.suppress_window, p, cfg.suppress_cutoff,
                       u32))


def dpos_round_plain(cfg: Config, seed, r: int, producers, chain_r, chain_p,
                     chain_len, count: bool = False, flags=None):
    """Plain version of KX, one SPEC §7 round at every validator v of each
    lane, in place. The round's producer p (:func:`round_producer`) sends
    its block: it reaches v != p when the delivery mixer's draw of the edge
    p -> v is not below the drop cutoff, or a block lost on that edge in one
    of the last ``max_delay_rounds`` rounds arrives now (SPEC §A.2, the
    JAX ``_producer_delivery``), and, in a round whose partition is
    active, v drew p's side; p itself always has it. Unless the round's
    churn event fires, a reached validator whose chain is not full writes
    (r, p) at index ``chain_len[v]`` and counts it. Returns (chain_r,
    chain_p, chain_len), the tensors it was given, and with ``count`` the
    [B] int32 number of the round's appends in each lane. With the round's
    SPEC §6c ``flags`` ([B, V] uint8, KAH), a validator down at the
    round's end appends nothing, nor does any in a round whose producer is
    down. With ``cfg.miss_on`` or ``cfg.suppress_on`` none appends in a
    round whose producer misses its slot (SPEC §A.1) or is suppressed in
    the round's window (SPEC §A.4; :func:`gate_draws`)."""
    V, L = chain_len.shape[1], chain_r.shape[2]
    dev = chain_len.device
    useed = rng.as_u32(seed)[:, None]
    v = torch.arange(V, dtype=torch.int64, device=dev)[None, :]
    p = round_producer(cfg, producers, r).to(torch.int64)[:, None]   # [B, 1]
    open_drop = open_drop_plain(useed, r, p, v, cfg.drop_cutoff,
                                cfg.max_delay_rounds)
    part_active = rng.random_u32_plain(seed, rng.STREAM_PARTITION, r, 0, 0) \
        < cfg.partition_cutoff                                       # [B, 1]
    side_v = rng.threefry2x32_plain(useed ^ rng.STREAM_PARTITION, r, 1,
                                    v.expand(useed.shape[0], V)) & 1
    side_p = rng.threefry2x32_plain(useed ^ rng.STREAM_PARTITION, r, 1,
                                    p) & 1
    ok = open_drop & ((side_v == side_p) | ~part_active) & (v != p)
    churn = rng.random_u32_plain(seed, rng.STREAM_CHURN, r, 0, 0) \
        < cfg.churn_cutoff                                           # [B, 1]
    append = (ok | (v == p)) & ~churn & (chain_len < L)
    if gated(cfg):
        miss, supp = gate_draws(cfg, seed, r, producers)
        append = append & ~(miss | supp)[:, None]
    if flags is not None:
        down = (flags & CRASH_DOWN) != 0
        append = append & ~down & ~down.gather(1, p)
    hot = (torch.arange(L, dtype=torch.int32, device=dev)
           == chain_len[:, :, None]) & append[:, :, None]
    chain_r.copy_(torch.where(hot, int(r), chain_r.to(torch.int32)))
    chain_p.copy_(torch.where(hot, p[:, :, None].to(torch.int32),
                              chain_p.to(torch.int32)))
    chain_len.add_(append.to(torch.int32))
    if count:
        return chain_r, chain_p, chain_len, append.sum(1, dtype=torch.int32)
    return chain_r, chain_p, chain_len


def dpos_round(cfg: Config, seed, r: int, producers, chain_r, chain_p,
               chain_len, count: bool = False, flags=None):
    """Kernel KX: same arguments and result as :func:`dpos_round_plain`,
    which it runs for CPU tensors; for CUDA tensors it launches
    ``csrc/dpos_round.cu`` (a thread per (lane, validator) reads its
    lane's producer, draws the edge, and appends in place; with ``count``
    a ballot a warp and an atomic a block and lane count the appends; its
    CRASH instance with ``flags``, its GATES instance with a §A.1 or §A.4
    cutoff; its KNOBS instances with a knob batch's view, whose lanes read
    their drop, partition, churn, miss and suppress cutoffs from the view's
    table, ``core/knobs.py``)."""
    if chain_len.device.type == "cpu":
        return dpos_round_plain(cfg, seed, r, producers, chain_r, chain_p,
                                chain_len, count, flags)
    from .. import _build
    B, V, L = chain_r.shape
    if not 0 <= int(r) < cfg.n_rounds:
        raise ValueError(f"round {r} is outside the run's rounds 0.."
                         f"{cfg.n_rounds - 1}")
    check_all(chain_len.device, (seed, torch.uint32, (B,)),
              (producers, torch.int32, (B, n_epochs(cfg), cfg.n_producers)),
              (chain_r, store_dtype(cfg.n_rounds - 1), (B, V, L)),
              (chain_p, store_dtype(cfg.n_candidates - 1), (B, V, L)),
              (chain_len, torch.int32, (B, V)),
              *(() if flags is None else ((flags, torch.uint8, (B, V)),)))
    n_app = torch.empty(B, dtype=torch.int32, device=chain_len.device) \
        if count else None
    base = knobs.static(cfg)
    table = knobs.table_ptr(cfg, chain_len.device, B)
    _build.launch("dpos_round", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  producers.data_ptr(), chain_r.data_ptr(),
                  chain_p.data_ptr(), chain_len.data_ptr(),
                  None if n_app is None else n_app.data_ptr(),
                  chain_r.element_size(), chain_p.element_size(),
                  producer_index(cfg, r), n_epochs(cfg) * cfg.n_producers,
                  base.drop_cutoff, base.partition_cutoff, base.churn_cutoff,
                  cfg.max_delay_rounds,
                  None if flags is None else flags.data_ptr(), B, V, L,
                  base.miss_cutoff, base.suppress_cutoff, cfg.suppress_window,
                  table)
    dpos_round.launches += 1
    dpos_round.knob_launches += table is not None
    if count:
        return chain_r, chain_p, chain_len, n_app
    return chain_r, chain_p, chain_len


dpos_round.launches = 0
# Launches of its KNOBS instances (a knob batch), also counted in
# ``launches``.
dpos_round.knob_launches = 0


# --- KAB: the telemetry tail --------------------------------------------------

def dpos_telemetry_plain(cfg: Config, r: int, seed, producers, chain_len,
                         n_app, t, w=None, lat=None) -> None:
    """Plain version of KAB: the round's DPOS_TELEMETRY counters, per lane,
    added into the [B, K] int32 accumulator ``t`` and, with the flight
    recorder (``w`` [B, n_windows, K] and ``lat`` [B, 1, N_BUCKETS], both
    or neither), into window ``r // cfg.telemetry_window`` of ``w``, and
    the round's DPOS_LATENCY observation into ``lat``, as
    ``consensus_tpu/engines/dpos.py`` dpos_round's tail (lines 183-198)
    on its flat path: ``n_app`` ([B] int32, KX's count) appends, V minus
    them missed, a rotation where round r > 0's producer is not round r -
    1's, the round's churn event, the §A.1 and §A.4 draws of the round's
    producer (:func:`gate_draws`, whether or not its slot had anything
    left to skip; 0 with the gates off), 0 for the crash tail (KAH adds
    it); the lag max - min of ``chain_len`` after the append. Updates
    ``t``, ``w`` and ``lat`` in place."""
    check_recorder(cfg, w, lat)
    V = chain_len.shape[1]
    rotated = (round_producer(cfg, producers, r)
               != round_producer(cfg, producers, max(int(r) - 1, 0))) \
        & (int(r) > 0)
    churn = (rng.random_u32_plain(seed, rng.STREAM_CHURN, r, 0, 0)
             < cfg.churn_cutoff)[:, 0]
    vec = torch.zeros_like(t)
    vec[:, :4] = torch.stack([n_app, V - n_app, rotated.to(torch.int32),
                              churn.to(torch.int32)], 1)
    if gated(cfg):
        vec[:, 4:6] = torch.stack(gate_draws(cfg, seed, r, producers),
                                  1).to(torch.int32)
    hists = ()
    if w is not None:
        lag = (chain_len.amax(1) - chain_len.amin(1))[:, None]
        hists = (bucket_counts_plain(lag, torch.ones_like(lag, dtype=bool)),)
    add_plain(cfg, r, vec, t, w, lat, hists)


def dpos_telemetry(cfg: Config, r: int, seed, producers, chain_len, n_app,
                   t, w=None, lat=None) -> None:
    """Kernel KAB: same arguments and in-place updates as
    :func:`dpos_telemetry_plain`, which it runs for CPU tensors; for CUDA
    tensors it launches ``csrc/dpos_telemetry.cu`` (a block per 1 024
    validators of a lane takes its lengths' max and min; the lane's last
    block adds the counters and the bucket; its GATES instance with a §A.1
    or §A.4 cutoff)."""
    check_recorder(cfg, w, lat)
    if t.device.type == "cpu":
        return dpos_telemetry_plain(cfg, r, seed, producers, chain_len, n_app,
                                    t, w, lat)
    from .. import _build
    B, V = chain_len.shape
    dev = t.device
    check_all(dev, (seed, torch.uint32, (B,)),
              (producers, torch.int32, (B, n_epochs(cfg), cfg.n_producers)),
              (chain_len, torch.int32, (B, V)), (n_app, torch.int32, (B,)),
              (t, torch.int32, (B, len(DPOS_TELEMETRY))))
    window, n_windows = window_of(cfg, r, t, w, lat, len(DPOS_LATENCY))
    span = torch.empty((B, 4), dtype=torch.int32, device=dev)
    base, table = knobs.static(cfg), knobs.table_ptr(cfg, dev, B)
    _build.launch("dpos_telemetry", seed.data_ptr(), int(r) & 0xFFFFFFFF,
                  *(x.data_ptr() for x in (producers, chain_len, n_app, t)),
                  *(None if x is None else x.data_ptr() for x in (w, lat)),
                  span.data_ptr(), producer_index(cfg, r),
                  producer_index(cfg, max(int(r) - 1, 0)),
                  n_epochs(cfg) * cfg.n_producers, base.churn_cutoff, B, V,
                  t.shape[1], window, n_windows, base.miss_cutoff,
                  base.suppress_cutoff, cfg.suppress_window, table)
    dpos_telemetry.launches += 1
    dpos_telemetry.knob_launches += table is not None


dpos_telemetry.launches = 0
# Launches of its KNOBS instances (a knob batch), also counted in
# ``launches``.
dpos_telemetry.knob_launches = 0


# --- the engine --------------------------------------------------------------

def dpos_init(cfg: Config, seeds: torch.Tensor) -> DposState:
    """Fresh state for each sweep seed in ``seeds`` ([B] uint32): the
    epoch schedule (KW, ``dpos_make_carry``'s ``dpos_schedule``) and empty
    chains."""
    V, L = cfg.n_nodes, cfg.log_capacity
    B, dev = seeds.shape[0], seeds.device
    producers, _ = dpos_schedule(cfg, seeds)
    return DposState(
        seed=seeds, producers=producers,
        chain_r=torch.zeros((B, V, L), dtype=store_dtype(cfg.n_rounds - 1),
                            device=dev),
        chain_p=torch.zeros((B, V, L),
                            dtype=store_dtype(cfg.n_candidates - 1),
                            device=dev),
        chain_len=torch.zeros((B, V), dtype=torch.int32, device=dev),
        down=torch.zeros((B, V), dtype=torch.bool, device=dev))


def dpos_step(cfg: Config, st: DposState, r: int, *, telem=None,
              flight=None) -> DposState:
    """One SPEC §7 round, as ``consensus_tpu/engines/dpos.py``
    ``dpos_round``: one launch of KX, which updates the chains in place,
    after KAH with ``cfg.crash_on`` (SPEC §6c); KX and KAB run their GATES
    instances under the SPEC §A.1 and §A.4 gates.

    ``telem`` ([B, K] i32, the run's counter totals) switches on the
    round's telemetry and ``flight`` (the window ring and latency buckets,
    a pair of [B, n_windows, K] and [B, 1, N_BUCKETS] i32) its flight
    recorder, as the JAX round's ``telem=True`` and ``flight=True``: KX
    then also counts the round's appends, and kernel KAB adds the round's
    counters into the accumulators in place."""
    if flight is not None and telem is None:
        raise ValueError("the flight recorder rides the telemetry "
                         "accumulator: pass telem with flight")
    on = () if telem is None else (True,)
    down = st.down
    if cfg.crash_on:
        # SPEC §6c crash transition (KAH), read by KX's CRASH instance.
        down, flags = crash_step(cfg, st.seed, r, st.down, DPOS_TELEMETRY,
                                 telem, flight)
        on = (telem is not None, flags)
    chain_r, chain_p, chain_len, *n_app = dpos_round(
        cfg, st.seed, r, st.producers, st.chain_r, st.chain_p, st.chain_len,
        *on)
    if telem is not None:
        dpos_telemetry(cfg, r, st.seed, st.producers, chain_len, n_app[0],
                       telem, *(flight if flight is not None
                                else (None, None)))
    return st._replace(chain_r=chain_r, chain_p=chain_p, chain_len=chain_len,
                       down=down)


def extract(st: DposState) -> dict[str, torch.Tensor]:
    """The leaves the decided-log digest and the tests read (the JAX
    package's ``_dpos_extract``): the chains as int32."""
    return {"chain_r": st.chain_r.to(torch.int32),
            "chain_p": st.chain_p.to(torch.int32),
            "chain_len": st.chain_len}


def lib_index(chain_p, chain_len, n_candidates: int, n_producers: int):
    """SPEC §7 last-irreversible block, on the host: a copy of
    ``consensus_tpu/engines/dpos.py`` ``lib_index``. The largest local
    index k such that the blocks after k were produced by at least T =
    floor(2K/3) + 1 distinct candidates (-1 if none), vectorised over
    leading batch axes: chain_p [..., L], chain_len [...] -> lib [...]
    int64. Closed form: (the T-th largest of each candidate's last
    occurrence index) - 1, clamped to -1."""
    chain_p = np.asarray(chain_p)
    chain_len = np.asarray(chain_len)
    T = (2 * n_producers) // 3 + 1
    lead = chain_p.shape[:-1]
    L = chain_p.shape[-1]
    if T > n_candidates:
        return np.full(lead, -1, np.int64)
    # A stable argsort groups each candidate's occurrences into a run with
    # k ascending, so the end of each run is its last occurrence; slots
    # past chain_len sort into a sentinel run after every candidate.
    B = int(np.prod(lead, dtype=np.int64)) if lead else 1
    k_idx = np.arange(L, dtype=np.int64)
    valid = k_idx < chain_len.reshape(B, 1)
    p = np.where(valid, chain_p.reshape(B, L), n_candidates)
    order = np.argsort(p, axis=-1, kind="stable")
    p_sorted = np.take_along_axis(p, order, axis=-1)
    run_end = np.ones((B, L), dtype=bool)
    run_end[:, :-1] = p_sorted[:, 1:] != p_sorted[:, :-1]
    rows, ends = np.nonzero(run_end)
    lo = np.full((B, n_candidates + 1), -1, np.int64)
    lo[rows, p_sorted[rows, ends]] = order[rows, ends]
    last_occ = lo[:, :n_candidates].reshape(lead + (n_candidates,))
    lt = np.partition(last_occ, n_candidates - T,
                      axis=-1)[..., n_candidates - T]
    return np.maximum(lt - 1, -1)


def dpos_run(cfg: Config, device=None, **kw) -> dict[str, np.ndarray]:
    """``network/runner.py`` :func:`run` of a DPoS config, plus ``lib``,
    the SPEC §7 last-irreversible index of every chain (host numpy,
    leading sweep axis)."""
    from ..network import runner
    out = runner.run(cfg, device, **kw)
    out["lib"] = lib_index(out["chain_p"], out["chain_len"],
                           cfg.n_candidates, cfg.n_producers)
    return out
