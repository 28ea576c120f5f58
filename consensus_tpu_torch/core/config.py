"""The run configuration of the port: ``Config`` for all seven engines of
the JAX package, on their flat paths.

A slim copy of ``consensus_tpu/core/config.py``: the same field names,
defaults and u32 cutoffs for what the Raft, PBFT, Paxos, DPoS and HotStuff
engines read. As
in the JAX package, a raft config with ``max_active = 0`` selects the dense
engine (``engines/raft.py``) and ``max_active > 0`` the §3b capped one
(``engines/raft_sparse.py``); ``protocol="pbft"`` selects the dense SPEC §6
engine (``engines/pbft.py``), or with ``fault_model="bcast"`` the SPEC §6b
broadcast engine (``engines/pbft_bcast.py``), whose population is
``n_nodes = 3f + 1``; ``protocol="paxos"`` the SPEC §5 multi-decree Paxos
engine (``engines/paxos.py``), ``protocol="dpos"`` the SPEC §7 DPoS
engine (``engines/dpos.py``) and ``protocol="hotstuff"`` the SPEC §7b
chained HotStuff engine (``engines/hotstuff.py``), whose population is
``n_nodes = 3f + 1`` too.
The SPEC §A.2 delayed retransmission (``max_delay_rounds`` in [0, 16])
runs on every engine and both f-ladders. The SPEC §6c crash-recover
adversary (``crash_prob``, ``recover_prob``, ``max_crashed`` in [0,
n_nodes]) runs on every engine; a PBFT f-ladder with ``crash_prob > 0``
raises in ``pbft_sweep.pbft_fsweep_run`` as in the JAX package. The SPEC
§B view desync (``desync_rate``, ``max_skew_rounds`` in [1, 8]) runs on
both PBFT engines, both f-ladders and HotStuff, and raises with the JAX
package's message on the other protocols. The SPEC §3c/§7c byzantine nodes
(``n_byzantine`` in [0, n_nodes], at most f on pbft and hotstuff, the ids
from N - n_byzantine up; ``byz_mode`` "silent" or "equivocate") run on both
Raft engines, both PBFT engines (``fault_model`` "edge" and "bcast"), their
f-ladders and HotStuff, with the JAX package's checks and messages. The
SPEC §A.1 slot miss (``miss_rate``) and §A.4 producer suppression
(``suppress_rate``, ``suppress_window``) run on DPoS, the SPEC §A.3
targeted attacks (``attack`` "elect" or "sticky", ``attack_rate``,
``attack_target``) on both Raft engines, each with the JAX package's checks
and messages on the other protocols. The SPEC §9 switch (``net_model``
"switch" with ``n_aggregators`` K in [1, n_nodes], ``agg_fail_rate``,
``agg_stale_rate``, ``agg_max_stale`` in [1, 8]) runs on both Raft engines,
Paxos, HotStuff and both PBFT engines (``fault_model`` "edge" and "bcast")
and their f-ladders, and its SPEC §9b knobs (``agg_byz``,
``agg_poison_rate``, ``byz_uplink_rate``) on HotStuff and PBFT, with the
JAX package's checks and messages. The other knobs
of the JAX package that this port does not implement yet are fields too,
and setting one off its default raises ``ValueError``, also beside a
delay, a crash, a desync or byzantine nodes; the port never ignores a
setting silently.
"""
from __future__ import annotations

from dataclasses import dataclass

from .rng import prob_threshold_u32

# Knobs of consensus_tpu's Config that the port does not implement yet,
# with the default each must keep.
UNSUPPORTED = {
    "scan_chunk": 0, "sweep_chunk": 0,
    "mesh_shape": (),
}

# The SPEC §6c crash-recover knobs and their defaults: supported on every
# engine.
CRASH_KNOBS = {"crash_prob": 0.0, "recover_prob": 0.0, "max_crashed": 0}

# The protocols the port runs: every protocol of the JAX package.
PROTOCOLS = ("raft", "pbft", "paxos", "dpos", "hotstuff")

# SPEC §A.2: the most rounds a dropped flight may be retransmitted late
# (consensus_tpu/core/config.py:224-227).
MAX_DELAY_ROUNDS = 16

# SPEC §3c/§7c byzantine modes as the kernels take them (``Config.byz``):
# none, silent (withhold every send), equivocate.
BYZ_NONE, BYZ_SILENT, BYZ_EQUIV = 0, 1, 2

# SPEC §A.3 targeted Raft attacks as the kernels take them
# (``Config.attack_mode``): none, elect (election traffic jammed in an
# attacked round with a live new candidacy), sticky (the target's inbound
# traffic jammed while it leads at the round's start).
ATTACKS = ("none", "elect", "sticky")
ATTACK_NONE, ATTACK_ELECT, ATTACK_STICKY = 0, 1, 2

# Raft only. The top-A kernel keeps a sorted list of A keys per thread in
# registers.
MAX_ACTIVE = 16
# Raft only. The replication bookkeeping (the capped engine's lead_match /
# lead_next, the dense engine's match_idx / next_idx) is uint8 (L + 1 <=
# 255), as the JAX package stores it at these capacities; PyTorch has no
# uint16 arithmetic for the wider ones. The state of PBFT, Paxos and
# HotStuff is int32 and bool, and DPoS stores its chains as the JAX package does; they take
# any slot count.
MAX_LOG_CAPACITY = 254


@dataclass(frozen=True)
class Config:
    protocol: str = "raft"

    n_nodes: int = 5
    n_rounds: int = 64
    n_sweeps: int = 1
    seed: int = 0

    log_capacity: int = 128
    max_entries: int = 100

    t_min: int = 3
    t_max: int = 8
    max_active: int = 0

    # PBFT and HotStuff.
    f: int = 1                   # byzantine tolerance; n_nodes = 3f+1
    view_timeout: int = 8        # rounds without progress before view change
    fault_model: str = "edge"    # "edge" (SPEC §6) | "bcast" (§6b)

    # Paxos.
    n_proposers: int = 0         # 0 ⇒ all nodes propose

    # DPoS.
    n_candidates: int = 16
    n_producers: int = 4         # K active producers per epoch
    epoch_len: int = 16          # rounds per epoch

    drop_rate: float = 0.0
    partition_rate: float = 0.0
    churn_rate: float = 0.0

    crash_prob: float = 0.0
    recover_prob: float = 0.0
    max_crashed: int = 0
    max_delay_rounds: int = 0
    attack: str = "none"
    attack_rate: float = 1.0
    attack_target: int = 0
    # SPEC §9 switch delivery and its §9b byzantine axes
    # (consensus_tpu/core/config.py:90-118).
    net_model: str = "flat"
    n_aggregators: int = 0
    agg_fail_rate: float = 0.0
    agg_stale_rate: float = 0.0
    agg_max_stale: int = 1
    agg_byz: int = 0
    agg_poison_rate: float = 0.0
    byz_uplink_rate: float = 0.0
    n_byzantine: int = 0
    byz_mode: str = "silent"
    desync_rate: float = 0.0
    max_skew_rounds: int = 1
    miss_rate: float = 0.0
    suppress_rate: float = 0.0
    suppress_window: int = 16
    telemetry_window: int = 0
    scan_chunk: int = 0
    sweep_chunk: int = 0
    mesh_shape: tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.protocol not in PROTOCOLS:
            raise ValueError(f"protocol {self.protocol!r} is not ported yet "
                             f"(the port runs {', '.join(PROTOCOLS)})")
        if min(self.n_nodes, self.n_rounds, self.n_sweeps,
               self.log_capacity) < 1:
            raise ValueError("n_nodes, n_rounds, n_sweeps, log_capacity "
                             "must be >= 1")
        if self.protocol in ("pbft", "hotstuff"):
            expect = 3 * self.f + 1
            if self.n_nodes != expect:
                raise ValueError(
                    f"{self.protocol} requires n_nodes == 3f+1 == "
                    f"{expect}, got {self.n_nodes}")
            if self.n_byzantine > self.f:
                raise ValueError("n_byzantine must be <= f")
        # The JAX package's SPEC §3c/§7c checks and messages
        # (consensus_tpu/core/config.py:193-209).
        if self.n_byzantine < 0 or self.n_byzantine > self.n_nodes:
            raise ValueError("n_byzantine must be in [0, n_nodes]")
        if self.n_byzantine > 0 and self.protocol not in ("pbft", "raft",
                                                          "hotstuff"):
            raise ValueError(
                f"n_byzantine is a pbft/raft/hotstuff adversary "
                f"(SPEC §6/§3c/§7b); {self.protocol} would silently "
                "ignore it")
        if self.byz_mode not in ("silent", "equivocate"):
            raise ValueError(f"unknown byz_mode {self.byz_mode!r}")
        if self.fault_model not in ("edge", "bcast"):
            raise ValueError(f"unknown fault_model {self.fault_model!r}")
        if self.fault_model == "bcast" and self.protocol != "pbft":
            raise ValueError(
                "fault_model='bcast' (SPEC §6b) is a pbft model; other "
                "protocols would silently ignore it")
        if self.t_max <= self.t_min:
            raise ValueError("t_max must exceed t_min")
        if not 0 <= self.max_active <= self.n_nodes:
            raise ValueError("max_active must be in [0, n_nodes] (0 = dense "
                             "engine)")
        if self.protocol == "raft":
            if self.max_active > MAX_ACTIVE:
                raise ValueError(f"max_active must be 0 (the dense engine) "
                                 f"or in [1, min({MAX_ACTIVE}, n_nodes)]")
            if self.log_capacity > MAX_LOG_CAPACITY:
                raise ValueError(f"log_capacity must be <= "
                                 f"{MAX_LOG_CAPACITY} (uint8 replication "
                                 "bookkeeping)")
        if self.telemetry_window < 0:
            raise ValueError("telemetry_window must be >= 0 (0 = flight "
                             "recorder off)")
        if self.protocol == "dpos":
            # The JAX package's check and message: candidates are a subset
            # of the validators and producers a subset of the candidates.
            if not (1 <= self.n_producers <= self.n_candidates
                    <= self.n_nodes):
                raise ValueError(
                    "dpos requires 1 <= n_producers <= n_candidates "
                    f"<= n_nodes, got K={self.n_producers} "
                    f"C={self.n_candidates} V={self.n_nodes}")
            if self.epoch_len < 1:
                raise ValueError("epoch_len must be >= 1")
        if not 0 <= self.max_delay_rounds <= MAX_DELAY_ROUNDS:
            raise ValueError(
                "max_delay_rounds must be in [0, 16] (SPEC §A.2: the "
                "delayed-open check is a D-deep static loop per edge; "
                "0 = off)")
        if self.n_nodes >= 2**31 - 1:
            raise ValueError("n_nodes must fit int32 ids")
        # The JAX package's check and message
        # (consensus_tpu/core/config.py:216-218).
        if self.max_crashed < 0 or self.max_crashed > self.n_nodes:
            raise ValueError("max_crashed must be in [0, n_nodes] "
                             "(0 = no cap on simultaneous crashes)")
        # The JAX package's SPEC §B checks and messages
        # (consensus_tpu/core/config.py:315-328).
        if self.desync_rate > 0 and self.protocol not in ("pbft",
                                                          "hotstuff"):
            raise ValueError(
                "desync_rate is the SPEC §B view-synchronizer timer-skew "
                f"adversary of the per-node BFT pacemakers; {self.protocol} "
                "has no per-node view timer and would silently ignore it")
        if not (1 <= self.max_skew_rounds <= 8):
            raise ValueError("max_skew_rounds must be in [1, 8] (SPEC §B: "
                             "the skew depth is a bounded jump, like the "
                             "§9 stale horizon)")
        if self.max_skew_rounds != 1 and self.desync_rate == 0:
            raise ValueError(
                "max_skew_rounds requires desync_rate > 0 (SPEC §B) "
                "— it would be silently ignored")
        # The JAX package's SPEC §A.1, §A.3 and §A.4 checks and messages
        # (consensus_tpu/core/config.py:219-223, 229-253, 329-340; its
        # engine == "cpu" check has no counterpart: the port has no
        # engine field).
        if self.miss_rate > 0 and self.protocol != "dpos":
            raise ValueError(
                "miss_rate is the SPEC §A.1 per-producer DPoS slot-fault "
                f"adversary; {self.protocol} has no producer schedule and "
                "would silently ignore it")
        if self.attack not in ATTACKS:
            raise ValueError(f"unknown attack {self.attack!r} (SPEC §A.3: "
                             "none | elect | sticky)")
        if self.attack != "none":
            if self.protocol != "raft":
                raise ValueError(
                    "attack != 'none' is a SPEC §A.3 Raft-targeted "
                    f"adversary; {self.protocol} would silently ignore it")
            if self.attack == "elect" and self.attack_target != 0:
                raise ValueError(
                    "attack_target is read only by attack='sticky' (SPEC "
                    "§A.3 leader-stickiness); 'elect' jams election "
                    "traffic population-wide and would silently ignore it")
            if not (0 <= self.attack_target < self.n_nodes):
                raise ValueError("attack_target must be in [0, n_nodes)")
        elif self.attack_rate != 1.0 or self.attack_target != 0:
            raise ValueError(
                "attack_rate/attack_target require attack != 'none' "
                "(SPEC §A.3) — they would be silently ignored")
        if self.suppress_rate > 0 and self.protocol != "dpos":
            raise ValueError(
                "suppress_rate is the SPEC §A.4 correlated DPoS "
                f"producer-suppression adversary; {self.protocol} has no "
                "producer schedule and would silently ignore it")
        if self.suppress_window < 1:
            raise ValueError("suppress_window must be >= 1")
        if self.suppress_window != 16 and self.suppress_rate == 0:
            raise ValueError(
                "suppress_window requires suppress_rate > 0 (SPEC §A.4) "
                "— it would be silently ignored")
        self._check_switch()
        off = [k for k, d in UNSUPPORTED.items() if getattr(self, k) != d]
        if off:
            raise ValueError(f"{', '.join(off)}: not supported by the port "
                             "yet; it would be silently ignored")

    def _check_switch(self) -> None:
        """The JAX package's SPEC §9/§9b checks and messages
        (consensus_tpu/core/config.py:254-315)."""
        if self.net_model not in ("flat", "switch"):
            raise ValueError(f"unknown net_model {self.net_model!r} "
                             "(SPEC §9: flat | switch)")
        if self.net_model == "switch":
            if self.protocol == "dpos":
                raise ValueError(
                    "net_model='switch' aggregates vote/quorum responses "
                    "(SPEC §9); dpos's producer row doesn't vote — there "
                    "is nothing to aggregate, so the model would be a "
                    "silent no-op")
            if not (1 <= self.n_aggregators <= self.n_nodes):
                raise ValueError(
                    "net_model='switch' requires 1 <= n_aggregators <= "
                    f"n_nodes, got K={self.n_aggregators} N={self.n_nodes}")
            if not (0 <= self.agg_byz <= self.n_aggregators):
                raise ValueError(
                    "agg_byz must be in [0, n_aggregators] (SPEC §9b: "
                    "the byzantine aggregators are the last agg_byz "
                    f"vertex ids), got {self.agg_byz} with "
                    f"K={self.n_aggregators}")
            if self.agg_poison_rate > 0:
                if self.agg_byz == 0:
                    raise ValueError(
                        "agg_poison_rate > 0 requires agg_byz > 0 (SPEC "
                        "§9b: only a byzantine aggregator serves forged "
                        "combines) — it would be silently ignored")
                if self.protocol not in ("pbft", "hotstuff"):
                    raise ValueError(
                        "agg_poison_rate is the SPEC §9b forged-combine "
                        "axis of the BFT vote engines (pbft, hotstuff); "
                        f"{self.protocol} would silently ignore it")
            if self.byz_uplink_rate > 0:
                if self.protocol not in ("pbft", "hotstuff"):
                    raise ValueError(
                        "byz_uplink_rate is the SPEC §9b byzantine-"
                        "uplink axis of the BFT vote engines (pbft, "
                        f"hotstuff); {self.protocol} would silently "
                        "ignore it")
                if self.n_byzantine == 0:
                    raise ValueError(
                        "byz_uplink_rate > 0 requires n_byzantine > 0 "
                        "(SPEC §9b: only a byzantine replica lies to "
                        "its switch vertex) — it would be silently "
                        "ignored")
        else:
            bad = [n for n, v, d in (
                ("n_aggregators", self.n_aggregators, 0),
                ("agg_fail_rate", self.agg_fail_rate, 0.0),
                ("agg_stale_rate", self.agg_stale_rate, 0.0),
                ("agg_max_stale", self.agg_max_stale, 1),
                ("agg_byz", self.agg_byz, 0),
                ("agg_poison_rate", self.agg_poison_rate, 0.0),
                ("byz_uplink_rate", self.byz_uplink_rate, 0.0)) if v != d]
            if bad:
                raise ValueError(
                    f"{', '.join(bad)} require net_model='switch' "
                    "(SPEC §9) — they would be silently ignored")
        if not (1 <= self.agg_max_stale <= 8):
            raise ValueError("agg_max_stale must be in [1, 8] (SPEC §9: "
                             "the stale re-draw is a bounded shift, like "
                             "the §A.2 delay horizon)")

    @property
    def switch_on(self) -> bool:
        """SPEC §9 gate: the flat round runs unless ``net_model`` is
        "switch" (consensus_tpu/core/config.py:443-447)."""
        return self.net_model == "switch"

    @property
    def agg_fail_cutoff(self) -> int:
        return prob_threshold_u32(self.agg_fail_rate)

    @property
    def agg_stale_cutoff(self) -> int:
        return prob_threshold_u32(self.agg_stale_rate)

    @property
    def agg_poison_cutoff(self) -> int:
        return prob_threshold_u32(self.agg_poison_rate)

    @property
    def byz_uplink_cutoff(self) -> int:
        return prob_threshold_u32(self.byz_uplink_rate)

    @property
    def agg_fail_on(self) -> bool:
        return self.agg_fail_cutoff > 0

    @property
    def agg_stale_on(self) -> bool:
        return self.agg_stale_cutoff > 0

    @property
    def agg_poison_on(self) -> bool:
        """SPEC §9b forged combines can fire
        (consensus_tpu/core/config.py:455-459)."""
        return self.agg_byz > 0 and self.agg_poison_cutoff > 0

    @property
    def uplink_lies_on(self) -> bool:
        return self.n_byzantine > 0 and self.byz_uplink_cutoff > 0

    @property
    def drop_cutoff(self) -> int:
        return prob_threshold_u32(self.drop_rate)

    @property
    def partition_cutoff(self) -> int:
        return prob_threshold_u32(self.partition_rate)

    @property
    def churn_cutoff(self) -> int:
        return prob_threshold_u32(self.churn_rate)

    @property
    def crash_cutoff(self) -> int:
        return prob_threshold_u32(self.crash_prob)

    @property
    def recover_cutoff(self) -> int:
        return prob_threshold_u32(self.recover_prob)

    @property
    def crash_on(self) -> bool:
        """SPEC §6c runs only where a crash can fire: with ``crash_prob =
        0`` the round is the flat one, whatever ``recover_prob`` and
        ``max_crashed`` say (consensus_tpu/core/config.py:433-434)."""
        return self.crash_cutoff > 0

    @property
    def desync_cutoff(self) -> int:
        return prob_threshold_u32(self.desync_rate)

    @property
    def desync_on(self) -> bool:
        """SPEC §B runs only where a skew can fire: with ``desync_rate = 0``
        the round is the flat one (consensus_tpu/core/config.py:473-476)."""
        return self.desync_cutoff > 0

    @property
    def miss_cutoff(self) -> int:
        return prob_threshold_u32(self.miss_rate)

    @property
    def miss_on(self) -> bool:
        """SPEC §A.1 runs only where a slot miss can fire
        (consensus_tpu/core/config.py:437-439)."""
        return self.miss_cutoff > 0

    @property
    def suppress_cutoff(self) -> int:
        return prob_threshold_u32(self.suppress_rate)

    @property
    def suppress_on(self) -> bool:
        """SPEC §A.4 runs only where a suppression can fire
        (consensus_tpu/core/config.py:467-469)."""
        return self.suppress_cutoff > 0

    @property
    def attack_cutoff(self) -> int:
        return prob_threshold_u32(self.attack_rate)

    @property
    def attack_mode(self) -> int:
        """The SPEC §A.3 attack the kernels take: ATTACK_NONE, ATTACK_ELECT
        or ATTACK_STICKY. As in the JAX package, the gate is the attack's
        name (``cfg.attack == "elect"``), not its rate: an attack at rate 0
        runs the attack's round, whose draw never fires."""
        return ATTACKS.index(self.attack)

    @property
    def byz(self) -> int:
        """The SPEC §3c/§7c mode the kernels take: BYZ_NONE without
        byzantine nodes (whatever ``byz_mode`` says: the round is the flat
        one), else BYZ_SILENT or BYZ_EQUIV."""
        if self.n_byzantine == 0:
            return BYZ_NONE
        return BYZ_SILENT if self.byz_mode == "silent" else BYZ_EQUIV

    @property
    def n_honest(self) -> int:
        """The honest nodes: ids below N - n_byzantine."""
        return self.n_nodes - self.n_byzantine

    @property
    def no_partition(self) -> bool:
        """No round's partition can be active: the §6b engine's tallies
        then need one aggregate a slot, not one a side."""
        return self.partition_cutoff == 0
