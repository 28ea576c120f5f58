"""State carried across by consensus_tpu_torch/convert.py.

The JAX carry after k rounds becomes the port's state; both implementations
then step one round, and every leaf must be equal (tolerance 0).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.engines.raft_sparse import RaftSparseState as JState  # noqa: E402,E501
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.engines import raft_sparse as trs  # noqa: E402

KW = dict(protocol="raft", n_nodes=300, n_rounds=40, n_sweeps=2,
          log_capacity=32, max_entries=24, max_active=6, seed=21, t_min=2,
          t_max=5, drop_rate=0.15, partition_rate=0.2, churn_rate=0.05)
CHUNK = 10
STEPS = (10, 20, 30)


def _leaves(carry) -> dict:
    return {k: np.array(v) for k, v in carry._asdict().items()}


@pytest.fixture(scope="module")
def jax_steps():
    """{k: (leaves after k rounds, leaves after k + 1 rounds)} from JAX."""
    jcfg = JConfig(**KW)
    eng = jsim.engine_def(jcfg)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    out = {}
    for k in STEPS:
        carry = jrunner._chunk_jit(jcfg, eng, CHUNK, carry,
                                   jnp.int32(k - CHUNK))
        before = _leaves(carry)
        out[k] = (before, _leaves(jrunner._chunk_jit(
            jcfg, eng, 1, carry, jnp.int32(k))))
        # The step donated ``carry``: rebuild it from its copy.
        carry = JState(**{n: jnp.asarray(a) for n, a in before.items()})
    return out


@pytest.mark.parametrize("k", STEPS)
def test_one_round_from_jax_state(jax_steps, k):
    before, after = jax_steps[k]
    st = convert.state_from_numpy(before)
    got = convert.state_to_numpy(trs.raft_sparse_round(Config(**KW), st, k))
    assert set(got) == set(after)
    for name in after:
        assert got[name].dtype == after[name].dtype, name
        assert np.array_equal(got[name], after[name]), name


def test_roundtrip_keeps_every_dtype(jax_steps):
    before, _ = jax_steps[STEPS[0]]
    st = convert.state_from_numpy(before)
    assert st.seed.dtype == torch.uint32
    assert st.lead_match.dtype == torch.uint8 and st.down.dtype == torch.bool
    back = convert.state_to_numpy(st)
    for name, a in before.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a)


def test_from_numpy_rejects_a_wrong_dtype(jax_steps):
    before, _ = jax_steps[STEPS[0]]
    with pytest.raises(TypeError):
        convert.state_from_numpy({**before,
                                  "term": before["term"].astype(np.int64)})
