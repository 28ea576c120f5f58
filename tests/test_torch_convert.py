"""State carried across by consensus_tpu_torch/convert.py.

The JAX carry after k rounds becomes the port's state; both implementations
then step one round, and every leaf must be equal (tolerance 0). DPoS and
Paxos states round-trip with the JAX package's dtypes, the DPoS chains in
each of their uint8, uint16 and int32 storages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (bounds torch's CPU threads)

import jax.numpy as jnp  # noqa: E402

from consensus_tpu import Config as JConfig  # noqa: E402
from consensus_tpu.engines.raft_sparse import RaftSparseState as JState  # noqa: E402,E501
from consensus_tpu.network import runner as jrunner  # noqa: E402
from consensus_tpu.network import simulator as jsim  # noqa: E402
from consensus_tpu_torch import Config  # noqa: E402
from consensus_tpu_torch import convert  # noqa: E402
from consensus_tpu_torch.engines import raft_sparse as trs  # noqa: E402
from consensus_tpu_torch.engines.dpos import DposState  # noqa: E402
from consensus_tpu_torch.engines.paxos import PaxosState  # noqa: E402

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


# A config on which the phase kernels' rarer paths fire: more than A
# candidates (the cap binds), and two leaders tracked at once, so that the
# slot lifecycle carries a row from another slot index (max_entries 8:
# full logs leave a lagging candidate up to date, and it can win while the
# old leader still leads).
EDGE_CASES = {
    "edge-paths": dict(protocol="raft", n_nodes=256, n_rounds=40,
                       n_sweeps=2, log_capacity=32, max_entries=8,
                       max_active=4, seed=21, t_min=3, t_max=8,
                       drop_rate=0.2, churn_rate=0.02),
}


def _jax_every_round(kw) -> list:
    """Leaves of the JAX carry before round 0 and after every round."""
    jcfg = JConfig(**kw)
    eng = jsim.engine_def(jcfg)
    carry = jrunner._init_jit(jcfg, eng, jnp.asarray(jrunner.make_seeds(jcfg)))
    out = [_leaves(carry)]
    for k in range(kw["n_rounds"]):
        carry = jrunner._chunk_jit(jcfg, eng, 1, carry, jnp.int32(k))
        out.append(_leaves(carry))
    return out


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_every_round_from_jax_state_on_edge_paths(case, monkeypatch):
    kw = EDGE_CASES[case]
    cfg, A = Config(**kw), kw["max_active"]
    seen = {"cap": 0, "carried_other": 0, "bump3": 0}
    candidacy, slots, acks_commit = trs.candidacy, trs.slots, trs.acks_commit

    def count_candidates(*args):
        out = candidacy(*args)
        seen["cap"] += int((out[7].sum(1) > A).sum())
        return out

    def count_carried(*args):
        new_ids, lead_id = args[1], args[2]
        same = (new_ids[:, :, None] == lead_id[:, None, :]) \
            & (new_ids >= 0)[:, :, None] & ~torch.eye(A, dtype=torch.bool)
        seen["carried_other"] += int(same.sum())
        return slots(*args)

    def count_bump3(*args):
        (_, _, lead_id, was_lead_k, del_jl, has_l, kstar, _, _, _, term,
         role, *_rest) = args
        lid = lead_id.clamp(0, term.shape[1] - 1).to(torch.int64)
        ackm = (torch.where(has_l, kstar, A)[:, :, None]
                == torch.arange(A)) & del_jl
        t_in3 = torch.where(ackm, term[:, :, None], 0).amax(1)
        seen["bump3"] += int((was_lead_k & (role.gather(1, lid) == 2)
                              & (t_in3 > term.gather(1, lid))).sum())
        return acks_commit(*args)

    monkeypatch.setattr(trs, "candidacy", count_candidates)
    monkeypatch.setattr(trs, "slots", count_carried)
    monkeypatch.setattr(trs, "acks_commit", count_bump3)
    states = _jax_every_round(kw)
    for k in range(kw["n_rounds"]):
        got = convert.state_to_numpy(trs.raft_sparse_round(
            cfg, convert.state_from_numpy(states[k]), k))
        for name, want in states[k + 1].items():
            assert got[name].dtype == want.dtype, (k, name)
            assert np.array_equal(got[name], want), (k, name)
    assert states[-1]["commit"].max() > 0
    assert seen["cap"] > 0 and seen["carried_other"] > 0
    # A follower acks only the slot whose snapshot term equals its own, and
    # a leader's term only rises after its snapshot, so on this flat path
    # no acked term exceeds the leader's: bump3 stays dark (kernel KH's
    # bump is held to its plain version on built inputs instead).
    assert seen["bump3"] == 0


# --- DPoS and Paxos carries --------------------------------------------------

@pytest.mark.parametrize("rdt,pdt", [(np.uint8, np.uint8),
                                     (np.uint16, np.uint16),
                                     (np.uint8, np.int32)])
def test_chain_dtypes_roundtrip(rdt, pdt):
    g = np.random.default_rng(0)
    leaves = {"seed": np.arange(2, dtype=np.uint32),
              "producers": g.integers(0, 9, (2, 3, 4)).astype(np.int32),
              "chain_r": g.integers(0, 200, (2, 5, 6)).astype(rdt),
              "chain_p": g.integers(0, 200, (2, 5, 6)).astype(pdt),
              "chain_len": g.integers(0, 7, (2, 5)).astype(np.int32),
              "down": np.zeros((2, 5), bool)}
    back = convert.state_to_numpy(convert.state_from_numpy(leaves))
    for name, a in leaves.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a)
    st = convert.state_from_numpy(leaves)
    assert isinstance(st, DposState)
    producers, rest = convert.dpos_carry(back)
    assert np.array_equal(producers, leaves["producers"])
    assert set(rest) == set(leaves) - {"producers"}


def test_paxos_state_roundtrips_with_jax_dtypes():
    from consensus_tpu.engines.paxos import paxos_init
    jst = paxos_init(JConfig(protocol="paxos", n_nodes=6, log_capacity=4),
                     np.uint32(3))
    leaves = {k: np.stack([np.asarray(v)] * 2) for k, v in
              jst._asdict().items()}
    leaves["acc_val"] = leaves["acc_val"] - 7
    leaves["learned_mask"][0, 1, 2] = True
    st = convert.state_from_numpy(leaves)
    assert isinstance(st, PaxosState)
    assert st.learned_mask.dtype == torch.bool
    assert st.seed.dtype == torch.uint32
    back = convert.state_to_numpy(st)
    for name, a in leaves.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a)
    with pytest.raises(TypeError):
        convert.state_from_numpy(
            {**leaves,
             "learned_mask": leaves["learned_mask"].astype(np.uint8)})


def test_hotstuff_state_roundtrips_with_jax_dtypes():
    """A JAX HotStuff carry (the fork carry: fork table, value-ids and
    fork bits set) converts to the port's state, with its [B] registers
    and the ``lane`` words made from the views, and back with every leaf
    and dtype of the JAX carry and nothing else."""
    import pathlib

    from consensus_tpu.engines.hotstuff import HotstuffState as JHotstuff
    from consensus_tpu_torch.engines import hotstuff
    data = np.load(pathlib.Path(__file__).resolve().parent
                   / "hotstuff_fork_carry.npz")
    leaves = {k: data[k] for k in JHotstuff._fields}
    st = convert.state_from_numpy(leaves)
    assert isinstance(st, hotstuff.HotstuffState)
    assert st.seed.dtype == torch.uint32 and st.down.dtype == torch.bool
    assert st.b1_v.shape == st.gcommit.shape == st.fnum.shape == (2,)
    assert torch.equal(st.lane, hotstuff.lane_at_rest(st.view))
    back = convert.state_to_numpy(st)
    assert list(back) == list(JHotstuff._fields)
    for name, a in leaves.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a)
    with pytest.raises(TypeError):
        convert.state_from_numpy({**leaves,
                                  "clen": leaves["clen"].astype(np.int64)})
