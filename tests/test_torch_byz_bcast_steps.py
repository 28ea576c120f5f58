"""The port's SPEC §3c/§7c byzantine nodes on the §6b broadcast PBFT engine
and its f-ladders against the JAX package, on the CPU: ladders, a composed
run, single rounds and KAK.

Beside the whole runs of ``tests/test_torch_byz_bcast.py``, tolerance 0:
the ladders rung by rung against the JAX ladder and the oracle's
standalone rungs (the BCAST half of ``tests/test_pbft_sweep.py:102-112``,
one silent node, and ``:115-135``'s f = 8 ladder under the bcast fault
model), and their refusals; a run with byzantine nodes, a crash, a delay
and a desync against JAX and the oracle; one round from a converted JAX
carry in each mode, partitions on and off; KAK's plain version against a
transcription of the JAX sum (standalone and padded).
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.core import rng as jrng  # noqa: E402
from consensus_tpu.engines import pbft_sweep as jsweep  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu.ops.adversary import draw as jdraw  # noqa: E402
from consensus_tpu_torch.engines import pbft_bcast as tb  # noqa: E402
from consensus_tpu_torch.engines import pbft_sweep  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_pbft_bcast import _cfg  # noqa: E402
from test_pbft_sweep import BCAST as LADDER_BASE  # noqa: E402
from torch_byz_helpers import (  # noqa: E402
    one_round_from_jax, port, run_and_hold)

# The BCAST half of tests/test_pbft_sweep.py:102-112 (one equivocator,
# churn 0.2, rungs 1 and 2), the same with one silent node, and
# :115-135's f = 8 ladder with 8 equivocators under the bcast fault model.
LADDERS = {
    "equivocate-1-2": (dict(n_byzantine=1, byz_mode="equivocate",
                            churn_rate=0.2), (1, 2)),
    "silent-1-2": (dict(n_byzantine=1, churn_rate=0.2), (1, 2)),
    "equivocate-8-16": (dict(f=8, n_nodes=25, n_byzantine=8,
                             byz_mode="equivocate", churn_rate=0.1,
                             view_timeout=4, n_rounds=32), (8, 16)),
}


@pytest.mark.parametrize("name", list(LADDERS))
def test_ladder_rung_by_rung_matches_jax(name):
    """Each rung equals the JAX ladder's rung and the oracle's standalone
    run of the rung (f = fs[k], seed + k): the honest ids and the stances
    are absolute, and the table is the widest rung's."""
    kw, fs = LADDERS[name]
    jbase = dataclasses.replace(LADDER_BASE, **kw)
    got = pbft_sweep.rung_payloads(pbft_sweep.pbft_fsweep_run(
        port(jbase), fs, device="cpu"))
    assert got == jsweep.rung_payloads(jsweep.pbft_fsweep_run(jbase, fs))
    for k, f in enumerate(fs):
        rung = dataclasses.replace(jbase, f=f, n_nodes=3 * f + 1,
                                   seed=jbase.seed + k, engine="cpu")
        assert got[k] == jsim.run(rung, warmup=False).payload


def test_ladders_refuse_what_jax_refuses():
    """A bcast ladder with more byzantine nodes than its smallest rung
    tolerates, or with a crash, raises with the JAX package's message."""
    for kw in (dict(f=2, n_nodes=7, n_byzantine=2),
               dict(n_byzantine=1, byz_mode="equivocate", crash_prob=0.1)):
        jbase = dataclasses.replace(LADDER_BASE, **kw)
        with pytest.raises(ValueError) as want:
            jsweep.pbft_fsweep_run(jbase, (1, 2))
        with pytest.raises(ValueError) as got:
            pbft_sweep.pbft_fsweep_run(port(jbase), (1, 2), device="cpu")
        assert str(got.value) == str(want.value)


# Byzantine nodes, a crash, a delay and a desync together.
COMPOSED = dict(protocol="pbft", fault_model="bcast", f=4, n_nodes=13,
                n_rounds=40, log_capacity=16, n_sweeps=2, seed=67,
                n_byzantine=4, byz_mode="equivocate", drop_rate=0.2,
                partition_rate=0.2, crash_prob=0.1, recover_prob=0.3,
                max_delay_rounds=2, desync_rate=0.15, max_skew_rounds=3,
                view_timeout=4)


def test_composed_run_matches_jax_and_the_oracle():
    run_and_hold(JConfig(**COMPOSED), "composed")


# One round from a converted JAX carry: each mode, partitions on and off.
STEPS = {f"{mode}-{'part' if p else 'nopart'}": _cfg(
    f=3, n_byzantine=3, byz_mode=mode, partition_rate=p, drop_rate=0.2,
    view_timeout=4, n_rounds=24, seed=43)
    for mode in ("silent", "equivocate") for p in (0.3, 0.0)}


@pytest.mark.parametrize("name", list(STEPS))
def test_one_round_from_jax_state(name):
    one_round_from_jax(STEPS[name], 17, name)


# --- KAK: each receiver's equivocating support --------------------------------

def _jax_extra(seed, r, bc, side, active, n_real, nb, padded):
    """``pbft_bcast.py:425-433`` (``padded``: ``pbft_sweep.py:335-350``, the
    [N, N] grid masked to the byzantine rows) for one lane, as JAX computes
    it."""
    N = bc.shape[0]
    ur = jnp.uint32(r)
    idx = jnp.arange(N, dtype=jnp.int32)
    uidx = idx.astype(jnp.uint32)
    bcast, side = jnp.asarray(bc), jnp.asarray(side)
    if padded:
        byz = (idx < n_real) & ~(idx < n_real - nb)
        supg = (jdraw(jnp.uint32(seed), jrng.STREAM_EQUIV, ur, uidx[:, None],
                      uidx[None, :]) & jnp.uint32(1)).astype(bool)
        sendg = supg & (byz & bcast)[:, None] & (idx[:, None] != idx[None, :])
        sendg &= ~active | (side[:, None] == side[None, :])
    else:
        bids = uidx[N - nb:]
        supg = (jdraw(jnp.uint32(seed), jrng.STREAM_EQUIV, ur, bids[:, None],
                      uidx[None, :]) & jnp.uint32(1)).astype(bool)
        sendg = supg & bcast[N - nb:, None] & (bids[:, None] != uidx[None, :])
        sendg &= ~active | (side[N - nb:, None] == side[None, :])
    return np.asarray(jnp.sum(sendg.astype(jnp.int32), axis=0))


@pytest.mark.parametrize("padded", [False, True])
def test_equiv_support_matches_jax(padded, monkeypatch):
    """KAK's plain version against the JAX sum on random node bytes, rounds
    0, 1 and 200, partitions active and not, every lane's byzantine tail
    (standalone: n_real = N; padded: n_real < N, whose padded receivers
    count 0), in blocks of a few draws."""
    monkeypatch.setattr(tb, "SUPPORT_BLOCK", 64)
    g = np.random.default_rng(5 + padded)
    B, N, nb = 4, 31, 5
    n_real = np.array([31, 22, 13, 16] if padded else [N] * B, np.int32)
    seeds = g.integers(0, 2**32, B).astype(np.uint32)
    for r in (0, 1, 200):
        bc = (g.random((B, N)) < 0.7) & (np.arange(N) < n_real[:, None])
        side = (g.random((B, N)) < 0.5).astype(np.int32)
        active = np.array([True, False, True, True])
        own = np.where(active[:, None], side, 0)
        bits = torch.from_numpy((bc | (own << 1)).astype(np.uint8))
        got = tb.bcast_equiv_support(torch.from_numpy(seeds), r,
                                     torch.from_numpy(n_real), nb, bits)
        assert got.dtype == torch.int32 and got.shape == (B, N)
        for b in range(B):
            n = int(n_real[b])
            want = _jax_extra(seeds[b], r, bc[b], side[b], active[b], n, nb,
                              padded)
            assert np.array_equal(got[b, :n].numpy(), want[:n]), (r, b)
            assert not got[b, n:].any()
