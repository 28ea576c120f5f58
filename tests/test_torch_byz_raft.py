"""The port's SPEC §3c byzantine Raft nodes against the JAX package, on the
CPU: whole runs.

The ids from N - n_byzantine up are byzantine: "silent" ones withhold every
send (candidacy requests, vote responses, heartbeats, acks), "equivocate"
ones answer every candidate whose request they got (the double grant).
The same seeds go through ``consensus_tpu`` and through the port's plain
versions of kernels KC-KI (capped) and KL-KO (dense); everything must be
equal, tolerance 0: whole runs at the JAX package's own byzantine configs
(``tests/test_raft_byz.py`` CONFIGS, dense and capped, both modes) against
the JAX package and the C++ oracle, every extract leaf. One round from a
JAX carry, the composed runs, the telemetry and the runs without
byzantine nodes are in ``tests/test_torch_byz_raft_steps.py``.
"""
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_raft_byz import CONFIGS  # noqa: E402
from torch_byz_helpers import run_and_hold  # noqa: E402


@pytest.mark.parametrize("tag,jcfg", CONFIGS, ids=[t for t, _ in CONFIGS])
def test_whole_run_matches_jax_and_the_oracle(tag, jcfg):
    run_and_hold(jcfg, tag)
