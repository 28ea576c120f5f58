"""The port's SPEC §3c/§6 byzantine nodes on dense PBFT and its f-ladder
against the JAX package, on the CPU.

The ids from n_real - n_byzantine up of a lane are byzantine. In both modes
only honest senders count in P1's view catch-up, the prepare and commit
tallies and the decide gossip, and only an honest primary pre-prepares;
"equivocate" adds, for each receiver, the byzantine senders delivered to it
whose STREAM_EQUIV stance toward it is set (``extra``, claiming its value at
every slot), and lets a byzantine primary pre-prepare every slot with a
value drawn from the receiver's view and its stance. The same seeds go
through ``consensus_tpu`` and through the port's plain versions of kernels
KQ-KS and KAA; everything must be equal, tolerance 0: whole runs at the JAX
package's own byzantine cases (``tests/test_pbft.py`` CFGS) against the JAX
package and the C++ oracle; the dense ladder rung by rung
(``tests/test_pbft_sweep.py``) against the JAX ladder and the oracle's
standalone rungs; a run with byzantine nodes, a crash, a delay and a
desync; the telemetry with 4-round windows; one round from a converted JAX
carry in each mode; and the ladder's check of n_byzantine against its
smallest rung.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.engines import pbft_sweep as jsweep  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch.engines import pbft_sweep  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_pbft import CFGS as PBFT_CFGS  # noqa: E402
from test_pbft_sweep import BASE as LADDER_BASE  # noqa: E402
from torch_byz_helpers import (  # noqa: E402
    one_round_from_jax, port, run_and_hold, telemetry_holds)

# tests/test_pbft.py:22-47's byzantine cases, both modes.
PBFT_BYZ = [c for c in PBFT_CFGS if c.n_byzantine > 0]


@pytest.mark.parametrize("k", range(len(PBFT_BYZ)))
def test_run_matches_jax_and_the_oracle(k):
    run_and_hold(PBFT_BYZ[k], f"pbft case {k}")


# The dense half of tests/test_pbft_sweep.py:107 (BASE, equivocating, churn
# 0.2, rungs 1 and 2) and :120 (f = 8, 8 equivocators, rungs 8 and 16),
# and BASE with one silent node.
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
    are absolute, so padding leaves them unchanged."""
    kw, fs = LADDERS[name]
    jbase = dataclasses.replace(LADDER_BASE, **kw)
    got = pbft_sweep.rung_payloads(pbft_sweep.pbft_fsweep_run(
        port(jbase), fs, device="cpu"))
    assert got == jsweep.rung_payloads(jsweep.pbft_fsweep_run(jbase, fs))
    for k, f in enumerate(fs):
        rung = dataclasses.replace(jbase, f=f, n_nodes=3 * f + 1,
                                   seed=jbase.seed + k, engine="cpu")
        assert got[k] == jsim.run(rung, warmup=False).payload


def test_ladder_caps_the_byzantine_count_at_its_smallest_rung():
    """The JAX package's check and message: every rung must hold
    n_byzantine <= f."""
    cfg = port(dataclasses.replace(LADDER_BASE, f=2, n_nodes=7,
                                   n_byzantine=2))
    with pytest.raises(ValueError, match="exceeds the smallest rung f=1"):
        pbft_sweep.pbft_fsweep_run(cfg, (1, 2), device="cpu")
    with pytest.raises(ValueError, match="exceeds the smallest rung f=1"):
        jsweep.pbft_fsweep_run(dataclasses.replace(LADDER_BASE, f=2,
                                                   n_nodes=7, n_byzantine=2),
                               (1, 2))


# Byzantine nodes, a crash, a delay and a desync together.
COMPOSED = dict(protocol="pbft", f=3, n_nodes=10, n_rounds=48,
                log_capacity=16, n_sweeps=2, seed=61, n_byzantine=3,
                byz_mode="equivocate", drop_rate=0.2, crash_prob=0.1,
                recover_prob=0.3, max_delay_rounds=2, desync_rate=0.15,
                max_skew_rounds=3, view_timeout=4)


def test_composed_run_matches_jax_and_the_oracle():
    run_and_hold(JConfig(**COMPOSED), "composed")


# Telemetry with 4-round windows. Under PBFT's 2f + 1 quorums and at most f
# byzantine nodes no run forks a slot, so the safety tail stays 0 here; it
# is held on built states in tests/test_torch_byz.py.
TELEMETRY = {
    "equivocate": {**COMPOSED, "n_rounds": 24},
    "silent": dict(dataclasses.asdict(PBFT_BYZ[3]), n_rounds=24),
}


@pytest.mark.parametrize("name", list(TELEMETRY))
def test_telemetry_matches_jax(name):
    telemetry_holds(TELEMETRY[name], name)


@pytest.mark.parametrize("k", [3, 6])
def test_one_round_from_jax_state(k):
    one_round_from_jax(PBFT_BYZ[k], 21, f"pbft case {k}")
