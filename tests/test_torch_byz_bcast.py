"""The port's SPEC §3c/§7c byzantine nodes on the §6b broadcast PBFT engine
and its f-ladders against the JAX package, on the CPU: whole runs.

The ids from n_real - n_byzantine up of a lane are byzantine. In both modes
only honest senders count in P1's view catch-up, the prepare and commit
tallies and the decide gossip, only an honest primary pre-prepares, and a
node's own vote counts only where it is honest; "equivocate" adds to each
receiver's counts its ``extra`` (the byzantine senders whose broadcast
reaches it and whose STREAM_EQUIV stance toward it is set: kernel KAK),
lets a byzantine primary pre-prepare every slot with a value drawn from
the receiver's view and its stance, and widens the tallies' tables to the
JAX package's ``_table_width`` (up to 4). The same seeds go through
``consensus_tpu`` and through the port's plain versions of kernels KT, KU,
KV and KAK; everything must be equal, tolerance 0: whole runs at the JAX
package's own §6b byzantine cases (``tests/test_pbft_bcast.py``) against
the JAX package and the C++ oracle. The ladders, a composed run, single
rounds and KAK are in ``tests/test_torch_byz_bcast_steps.py``; the
telemetry, the safety tail, the tallies with ``extra`` and the table
widths in ``tests/test_torch_byz_bcast_tallies.py``.
"""
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_pbft_bcast import CONFIGS, DIET_CONFIGS, _cfg  # noqa: E402
from torch_byz_helpers import run_and_hold  # noqa: E402

# tests/test_pbft_bcast.py's §6b byzantine cases: CONFIGS (lines 30-32 and
# 39-41), the agreement test's (line 73) and DIET_CONFIGS' (lines 125-128
# and 135-141).
RUNS = {tag: cfg for tag, cfg in CONFIGS + DIET_CONFIGS
        if cfg.n_byzantine > 0}
RUNS["f3-agreement"] = _cfg(f=3, n_byzantine=3, byz_mode="equivocate",
                            n_rounds=64, drop_rate=0.2, churn_rate=0.05,
                            seed=21)


def test_the_cases_cover_both_modes_and_every_gate():
    assert set(RUNS) == {"f2-byz-silent", "f2-byz-equiv", "f8-byz-equiv",
                         "f3-nopart-hostile", "N64-byz-silent",
                         "N64-byz-equiv", "N2047-equiv-crash-part",
                         "f3-agreement"}
    assert {c.byz_mode for c in RUNS.values()} == {"silent", "equivocate"}
    assert any(c.crash_prob > 0 and c.partition_rate > 0
               for c in RUNS.values())


@pytest.mark.parametrize("tag", list(RUNS))
def test_run_matches_jax_and_the_oracle(tag):
    run_and_hold(RUNS[tag], tag)
