#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (consensus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device    — a CUDA device is present; the card's name and power limit as
               ``nvidia-smi`` reports them.
2. build     — nvcc builds every kernel of ``consensus_tpu_torch/csrc``.
3. kernels   — each hand-written kernel against its plain PyTorch version
               on the card. KA-KK (the capped engine) at the flagship shapes
               (B = 8 sweeps, N = 100 000 nodes, A = 8, L = 128) on random
               and built edge inputs, the round's phase kernels (KD-KK) also
               on the flagship's own inputs of round 20. KL-KO (the dense
               engine) on rounds 3 (the first election) and 20 or 100 (a
               leader in every sweep) of raft-1kx1k and raft-5node, on
               rounds of hostile runs, on random states and on built ones
               (a re-grant, two leaders of different terms in one P3c; KO
               at E = 0 and E = L, its CRASH and silent BYZ instances, and
               one sweep of N = 29 100 for its GLOBAL instance); KP
               (its telemetry) on raft-1kx1k's rounds 3 and 20 and on edge
               inputs. KQ-KS (dense PBFT) on rounds 3 and 20 of the
               fs = 1..128 ladder (B = 128 lanes of 385 nodes, 32 slots)
               and of standalone pbft-f128, on a hostile ladder's rounds,
               random states and built ones (a primary taking its own
               fresh slot, an adoption another receiver must not read).
               KT-KV (the §6b broadcast PBFT round) on rounds 3 and 20 of
               pbft-100k-bcast (B = 8, N = 100 000, S = 16) and of the
               full-width bcast ladder, on rounds of a partitioned hostile
               bcast ladder and run and of the config-3 bcast ladder, on
               random states (views past P1's range, f = 1 lanes: m = 2),
               on tallies whose quorums sit at the threshold on either
               side, and at N = 1. KW-KX (DPoS) on dpos-100k's init and
               rounds 0, 31, 32 (an epoch change) and 200 (chains near
               full), on the hostile DPoS run's seeds and rounds (uint16
               chains, full from round 128), on zero tallies tied across
               candidates, one candidate, C = 70 000, 72 000 (lane,
               epoch) pairs, all-equal tallies, V = C = K = 2 000 and
               V = 4 099, and random states with int32 chain_p and
               full chains. KY-KZ (Paxos) on
               paxos-10kx10k's rounds 0, 1 and 15, on the hostile Paxos
               run's rounds, on random states whose accepted ballots tie
               across acceptors on slots every proposer contends for, and
               at S = 60 000 (more slots than a row block's shared memory
               holds), and on 70 000 lanes at N = 7, S = 16. KAA-KAC (the
               telemetry of dense and §6b PBFT, DPoS and Paxos) on rounds
               3 and 20 of pbft-f128, pbft-100k-bcast and dpos-100k (and
               its round 200), rounds 1 and 15 of paxos-10kx10k and rounds
               of the hostile dense PBFT, DPoS and Paxos runs, all with
               telemetry and 8-round windows, and on random states (views
               that differ across nodes, some past P1's range, catch-ups,
               down nodes and an all-down lane, lanes with n_real < N,
               strided and misaligned inputs), with and without the
               recorder; KQ, KT, KX, KY and KZ also with their optional
               outputs set, on those rounds and on their edge inputs.
               KAD-KAF (the HotStuff round) on rounds 0, 3 and 20 of
               hotstuff-100k (B = 8, N = 100 000, S = 64; round 20 also
               with telemetry and 8-round windows), of hotstuff-1k and of
               the hostile HotStuff run (with telemetry; a full chain from
               about round 40), and on random states (ties on the highest
               view, several proposers at different views, views on and
               above V*, a full chain, no proposer, timers at the timeout,
               int32 view extremes, N = 7 and 3 001), KAF without
               telemetry, with the counters and with the recorder, with
               strided and misaligned inputs; KAG on hotstuff-100k's and
               the hostile run's end states, on an equivocating JAX carry
               with forks (tests/hotstuff_fork_carry.npz), random fork
               tables and S = 5 000.
               Tolerance: none, the results are integers and must be
               equal. Times are device time per call (torch.profiler
               kernel durations).
4. flagship  — ``simulator.run`` of raft-100k (benchmarks/run_benchmarks.py
               CONFIGS["raft-100k"], seed 6), replayed as one CUDA graph: the
               decided-log digest must be the committed anchor, and every
               kernel of the capped path must have launched (KK must not:
               telemetry is off; nor KL-KS). Seed 7 then replays the same
               graph (no new capture) and must equal the eager loop; seed 6
               again the anchor.
5. telemetry — raft-100k with telemetry and a flight recorder of 8-round
               windows: the same digest, KA-KK launched, windows that sum
               to the totals, one election wait a leader election, graph
               replay and eager loop equal; and the same run at
               N = 10 000, whose counters and recorder must equal an anchor
               made by the JAX package.
6. dense     — ``simulator.run`` of BASELINE configs raft-5node and
               raft-1kx1k (CONFIGS["raft-5node"], ["raft-1kx1k"]), each
               replayed as one CUDA graph: the committed digests, KA and
               KL-KO launched and no other kernel, steps per second, busy
               share and graph memory; seed 3 of raft-1kx1k replays the
               same graph and must equal the eager loop. Then both with
               telemetry and 8-round windows: the same digests, KA and
               KL-KP launched, windows that sum to the totals,
               raft-5node's counters and recorder equal to an anchor made
               by the JAX package, raft-1kx1k's replay equal to its eager
               loop.
7. bench     — bench.py's flagship shape (seed 42, max_entries 112):
               node-round-steps per second; something must commit.
8. profile   — the flagship's graph replay under torch.profiler: device busy
               share, launches a round, device time by kernel, graph memory;
               and an eager capped run, an eager dense run with telemetry
               and an eager fs = 1..128 ladder, an eager
               pbft-100k-bcast run, an eager dpos-100k run and an eager
               paxos-10kx10k run cut to 4 rounds and an eager
               hotstuff-100k run, and the same five (and pbft-f128) with
               telemetry and 8-round windows, with each
               kernel wrapper in a named range, which must show no PyTorch
               compute op in any phase of the round.
9. pbft      — ``simulator.run`` of BASELINE config 3's standalone rows
               pbft-f1 ... pbft-f128 and the fs = 1..128 ladder in one run
               (``engines/pbft_sweep.py`` pbft_fsweep_timed), each replayed
               as one CUDA graph: the oracle digests of
               benchmarks/RESULTS.json and the ladder's
               ``a1148caa…c0f3fa``, KL and KQ-KS launched in each run
               (counted from 0) and no other kernel; the ladder's real node-round-steps per second,
               busy share, device operations a round and graph memory; a
               ladder with every lane's seed shifted replays the same graph
               and must equal the eager loop, and the base seeds then give
               the anchor again.
10. bcast    — ``simulator.run`` of pbft-100k-bcast (CONFIGS
               ["pbft-100k-bcast"], seed 7), BASELINE config 3's fs = 1..128
               ladder with ``fault_model="bcast"`` and the full-width bcast
               ladder fs = (8333, 16666, 33333) at pbft-100k-bcast's knobs,
               each replayed as one CUDA graph, and a partitioned hostile
               bcast ladder fs = 1..32 (whose digest the dense round does
               not give): the anchor ``6c6395aa…f6a47b`` and the ladders'
               JAX-made anchors, KT-KV launched in each run (counted from
               0) and no other kernel; steps per second, busy share, device
               operations a round and graph memory; another seed on the
               flagship's graph and a shifted ladder against the eager
               loop; each full-width rung against its standalone run.
11. dpos     — ``simulator.run`` of dpos-100k (CONFIGS["dpos-100k"], BASELINE
               config 5) and of a hostile DPoS run (V = 20 000, C = 300,
               K = 21, 300 rounds, 128-slot chains, drop 0.2, partition
               0.1, churn 0.05, 3 sweeps), each replayed as one CUDA graph:
               the anchor ``bc791cf4…6fd1a5`` and the hostile run's
               JAX-made one, ``extras["lib"]`` equal to the JAX package's
               (a SHA-256 of its bytes), KW and KX launched in each run
               (counted from 0) and no other kernel; steps per second,
               busy share, device operations a round and graph memory;
               another seed on the graph against the eager loop.
12. paxos    — ``simulator.run`` of paxos-10kx10k (CONFIGS["paxos-10kx10k"],
               BASELINE config 4) and of a hostile Paxos run (N = S =
               1 000, 300 proposers, drop 0.1, partition 0.2, churn 0.05,
               32 rounds, 2 sweeps), each replayed as one CUDA graph: the
               anchor ``4d64c217…2b41fa`` and the hostile run's JAX-made
               one, KL, KY and KZ launched in each run (counted from 0) and
               no other kernel; steps per second, busy share, device
               operations a round, the graph's peak and kept memory;
               another seed on the graph against the eager loop.
13. telemetry_bft — ``simulator.run`` with telemetry and 8-round windows of
               pbft-f128, pbft-100k-bcast, dpos-100k and paxos-10kx10k at
               full shape and of the hostile dense PBFT, DPoS and Paxos
               runs, each replayed as one CUDA graph: the telemetry-off
               digests, counter totals and flight recorders equal to
               JAX-made anchors, windows that sum to the totals, replay
               equal to the eager loop, the engine's kernels and its
               telemetry kernel (KAA-KAC) launched (counted from 0) and no
               other; the same for hotstuff-100k and the hostile HotStuff
               run (KAD-KAF, whose KAF adds the telemetry, and KAG); each
               flagship's replay profiled without and with telemetry; the
               counters prepare_missed, commit_missed, commits_adopted,
               view_changes, nacks, churn_slots and missed_appends each
               counted by some run, and view_spread_max, desync_rounds and
               sync_msgs_delivered by some HotStuff run.
14. hotstuff — ``simulator.run`` of hotstuff-100k (CONFIGS["hotstuff-100k"]),
               hotstuff-1k (tools/hlocheck/registry.py HOTSTUFF_1K) and a
               hostile HotStuff run (N = 301, drop 0.15, partition 0.1,
               churn 0.05, view timeout 4, a 32-height chain that fills),
               each replayed as one CUDA graph: the anchors on which the
               JAX package and the C++ oracle agree, the eager loop's
               digest equal, KAD-KAF launched once a round and KAG once
               (counted from 0) and no other kernel; steps per second,
               replay wall, busy share and graph memory; three device
               operations a round of hotstuff-100k's replay, telemetry
               off and on; another seed on its graph against the eager
               loop.
15. delay    — SPEC §A.2 delayed retransmission (``max_delay_rounds``).
               KB, KL, KT, KX, KAD and KAE (each with ctt::delayed_open
               inline) against their plain versions with delays of 1, 8
               and 16 rounds on rounds 0, 3, 7 and 20 of the storm runs
               below at full width (KL also on the storm ladder's and
               paxos-10kx10k's rounds, KT on the full-width storm
               ladder's), on runs of N = 1 and 7, at drop 0.55 and 0.99,
               and KB and KL on random inputs; each one's time and bound
               on its storm run's round 20 (D = 8) and on the same inputs
               at D = 0. Then ``simulator.run`` of raft-100k, raft-1kx1k,
               pbft-f128, pbft-100k-bcast, dpos-100k, paxos-10kx10k and
               hotstuff-100k with delay-storm's overrides (drop 0.55,
               D = 8), raft-100k at its drop 0.01 with D = 16, and the
               fs = 1..128 and full-width bcast ladders with the same
               overrides, each replayed as one CUDA graph: their JAX-made
               anchors (the C++ oracle agrees on the standalone ones) from
               the replay and the eager loop, dpos-100k's LIB, only the
               engine's kernels launched (counted from 0), steps per
               second, replay wall and busy share; and pbft-f128,
               pbft-100k-bcast, dpos-100k and hotstuff-100k's storm runs
               with telemetry and 8-round windows against JAX-made
               counter and recorder anchors.
16. crash    — SPEC §6c crash-recover on the six engines that run it.
               KAH (``csrc/crash_transition.cu``, the round's transition
               and crash tail) against its plain version on random down
               masks at N = 1, 7 and 100 000 (B = 8), max_crashed 0, 1, 3
               and N, cutoffs (0.12, 0.35) and (0.99, 0.99), rounds 0, 3
               and 20, with the totals and window ring; then every kernel
               call of round 20 (paxos-10kx10k: 15) of each flagship's
               crash run (raft-100k, raft-1kx1k, pbft-f128,
               pbft-100k-bcast, paxos-10kx10k, dpos-100k; uncapped with
               telemetry and 8-round windows, and capped) against its plain
               version, KAI (``csrc/freeze_down.cu``, the PBFT freeze) on
               its leaves; each kernel's time on the uncapped round, the
               CRASH instances also through their flat instance on the
               same inputs, its plain version's time and its bound. Then
               ``simulator.run`` of each flagship under
               crash-churn-under-partition's overrides (crash 0.12,
               recover 0.35, max_crashed 2, partition 0.25, churn 0.05,
               drop 0.05: the cap binds) and under tests/test_crash.py's
               CRASH (crash 0.15, recover 0.3, no cap), and raft-100k with
               that crash and max_delay_rounds = 6, each replayed as one
               CUDA graph: the JAX-made anchors from the replay and the
               eager loop, the engine's kernels, KAH and (PBFT) KAI
               launched and no other (counted from 0), steps per second,
               replay wall, busy share and KAH's share; and the uncapped
               runs of raft-100k, pbft-100k-bcast, paxos-10kx10k and
               dpos-100k with telemetry and 8-round windows against
               JAX-made counter (crash tail included) and recorder
               anchors, replay against eager loop.
17. desync   — SPEC §B view desync on dense and §6b PBFT, both ladders and
               HotStuff, and SPEC §6c on HotStuff. Every kernel call of
               rounds 3 and 20 of hotstuff-100k, pbft-f128 and
               pbft-100k-bcast under view-desync-storm's overrides
               (desync 0.15, depth 4, drop 0.25, view timeout 4),
               hotstuff-100k under phase 16's capped and uncapped crash
               and "composed" (the crash, the desync and D = 2), and
               pbft-f128 composed (the crash and the desync), with
               telemetry and 8-round windows on three of them; KQ on the
               desync fs = 1..128 ladder's rounds and KT on the desync
               full-width ladder's; every call of a round from built
               HotStuff states at N = 13 and 100 000 (the highest view
               down, every node down, a recovered node tied at view 0,
               down nodes skewed one short of the timeout): each against
               its plain version, exact (KAJ ``csrc/hotstuff_prologue.cu``;
               the DESYNC instances of KQ and KT; the CRASH instances of
               KAD-KAF; the skew ``ctt::desync_skew`` through their
               timers). KAJ's and each instance's time on round 20, its
               plain version's and its bound, each instance also through
               its flat instance on the same inputs. Then ``simulator.run``
               of those seven runs and ``pbft_fsweep_timed`` of both
               ladders under the desync, each replayed as one CUDA graph:
               JAX-made anchors (the C++ oracle agrees on the standalone
               ones; HotStuff's final views too) from the replay and the
               eager loop, the path's kernels launched and no other
               (counted from 0), node-round-steps per second, replay wall,
               busy share and device operations a round; and three runs
               with telemetry and 8-round windows against JAX-made
               counter and recorder anchors.
18. byzantine — SPEC §3c/§7c byzantine nodes, silent and equivocating, on
               both Raft engines, dense PBFT and its ladder and HotStuff.
               Every kernel call of rounds 3 and 20 of raft-100k and
               raft-1kx1k at n_byzantine = 2N/5, pbft-f128 at f,
               hotstuff-100k at 10 000 (silent) and f (equivocating),
               pbft-f128 and hotstuff-100k equivocating with phase 16's
               CRASH and phase 17's desync ("composed"), and hotstuff-1k
               over 1 024 rounds and heights at f (its byzantine leaders
               certify variant-1 blocks), with telemetry and 8-round
               windows on the equivocating pbft-f128 and hotstuff-100k;
               KQ-KS on both byzantine fs = 1..128 ladders' rounds (one
               byzantine node a lane); KAE and KAF on built equivocating
               HotStuff lanes (forked and variant-1 QCs, a full fork
               table, conflicting commits) and KAA on built equivocating
               PBFT rounds (forked and conflicting slots, with and
               without down nodes): each against its plain version,
               exact (the BYZ instances of KE, KF, KI, KH, KM-KO, KQ-KS,
               KAA, KAD-KAF and KAJ's honest key). Each instance's time
               on round 20, its plain version's and its bound, and its
               flat instance's time and bound on the same inputs. Then
               ``simulator.run`` of those eleven runs and
               ``pbft_fsweep_timed`` of both ladders, each replayed as one
               CUDA graph: JAX-made anchors (the C++ oracle agrees on the
               standalone ones; HotStuff's final views and variant-1
               heights too) from the replay and the eager loop, the
               path's kernels launched and no other (counted from 0),
               node-round-steps per second, replay wall, busy share and
               device operations a round (3 on a HotStuff round without a
               crash or a desync); and the two telemetry runs against
               JAX-made counter (the safety tail among them) and recorder
               anchors.
19. byzantine_bcast — SPEC §3c/§7c byzantine nodes, silent and
               equivocating, on the §6b engine and its bcast ladders.
               Every kernel call of rounds 3 and 20 of pbft-100k-bcast at
               n_byzantine = f = 33 333 (silent at its 8 sweeps,
               equivocating at one, with telemetry and 8-round windows),
               of its equivocating run with phase 16's CRASH and phase
               17's desync ("composed"), and KT, KU, KV and KAK on rounds
               3 and 20 of the fs = 1..128 bcast ladder (one byzantine
               node a lane), the full-width ladder (n_byzantine = 8 333)
               and the partitioned hostile ladder fs = 1..32 (one
               equivocator a lane: byzantine primaries, tables of four);
               KAA on built equivocating rounds under §6b's crash mode;
               KU's BYZ instances on tallies at the threshold at table
               widths 1-4 (four distinct values a slot at f = 1), KT on
               random states with byzantine primaries, KV, and KAK
               (``csrc/bcast_equiv_support.cu``, each receiver's
               equivocating support) on random node bytes: each against
               its plain version, exact. Each BYZ instance's time on round
               20, its plain version's and its bound, and its flat
               instance's time and bound on the same inputs; KAK's time
               against its bound (operations). Then ``simulator.run`` of
               the three runs and ``pbft_fsweep_timed`` of the five
               ladders (both modes of the fs = 1..128 and full-width ones,
               the hostile equivocating one), each replayed as one CUDA
               graph: JAX-made anchors (and the runs' final views) from
               the replay and the eager loop, the path's kernels launched
               and no other (counted from 0; KAK once a round under
               equivocation only), node-round-steps per second, replay
               wall, busy share, device operations a round and KAK's
               share of the device time; and the equivocating run with
               telemetry and 8-round windows against JAX-made counter and
               recorder anchors.
20. gates    — SPEC §A.1 slot miss and §A.4 producer suppression on
               dpos-100k (rolling-producer-outage's overrides; the
               adversary knobs of tests/test_aggregate.py's SUPPRESS_BASE)
               and SPEC §A.3 attacks on raft-100k and raft-1kx1k (elect at
               repeated-election-disruption's overrides; sticky at rate 1
               on the first leader of the flat run's sweep 0), each with
               telemetry and 8-round windows: every kernel call of rounds
               3 and 20 of the six runs against its plain version, exact,
               and the gate instances (KB, KE, KK, KL, KM, KP, KX, KAB) on
               built inputs: an old candidacy alone, a down node's new
               candidacy alone, a live one, a sticky target leading in a
               churn round, attack words in every other lane, a producer
               both missed and suppressed. Each instance's time on round
               20, its plain version's and its bound, and its flat
               instance's time and bound on the same inputs. Then
               ``simulator.run`` of the six runs, each replayed as one
               CUDA graph: JAX-made anchors (digest, counters, recorder;
               the C++ oracle's digest on DPoS) from the replay and the
               eager loop, the gate's counter above 0, the path's kernels
               launched and no other (counted from 0), node-round-steps
               per second, replay wall, busy share and device operations
               a round.
21. switch   — SPEC §9 switch delivery (K = 8, fail and stale 0.01,
               depth 4) on raft-100k, raft-1kx1k, raft-100k under the
               parity grid's composed adversary, paxos-10kx10k and
               hotstuff-100k, §9b on hotstuff-100k (n_byzantine = f,
               discovered-silent-qc-fork's knobs) and that scenario at its
               tuned shape at seeds 11, 23 and 37, each with telemetry:
               every kernel call of rounds 3 and 20 (paxos-10kx10k: 15) of
               the nine runs against its plain version, exact (KAL and the
               SWITCH instances of KB, KM, KY, KZ and KAE among them), and
               of round 20 of six built runs: K = 1, K = N, an empty
               trailing aggregator, every aggregator stale at depth
               agg_max_stale, poisoned aggregators that are dead, lying
               byzantine nodes that are down. KAL's and each instance's
               time on round 20, its plain version's and its bound, and the
               flat instance's time and bound on the same inputs. Then
               ``simulator.run`` of the nine runs, each replayed as one
               CUDA graph: JAX-made anchors (digest, counters, recorder;
               the C++ oracle's digest) from the replay and the eager loop,
               the path's kernels launched and no other and each SWITCH
               instance launched (counted from 0), node-round-steps per
               second, replay wall, busy share and device operations a
               round; the scenario's runs fork QCs, commit conflicting
               values, flag safety violations and keep availability 0.7.
22. pbft_switch — SPEC §9 switch tallies and §9b on PBFT (dense, §6b and
               both f-ladders): every kernel call of rounds 3 and 20 of the
               runs, the ladders and built runs against the plain versions
               (KAL's PBFT modes, KAM ``csrc/switch_combine.cu`` and KAN
               ``csrc/switch_receive.cu`` among them), the switch round
               timed against the flat round's tallies on the same inputs,
               then the runs against JAX-made anchors.
23. knobs    — the knob batch (K23, ``runner.run_knob_batch``): a
               generation of adversary-search candidates as the lanes of
               one CUDA graph, each lane reading its own row of cutoffs.
               Every kernel call of rounds 3 and 20 of generation 0 of
               hotstuff-forked-qc-1k, of a HotStuff batch at
               hotstuff-100k's shape (partitions and the §B desync on, 8
               rows, one the base's, one with the partition zeroed) and of
               a pbft-100k-bcast batch under phase 16's capped crash (8
               rows), and of round 20 of each with every row the base's,
               against the plain versions, exact (the KNOBS instances of
               KAJ, KAD, KAE flat and SWITCH, KAL, KAH and KT among them;
               with every row the base's each KNOBS instance also equals its
               flat instance). Each instance's time on round 20, its plain
               version's and its bound, and on the all-base round its time
               and its flat instance's time and bound. Then three
               generations each of hotstuff-forked-qc-1k and
               pbft-quorum-1k (population 16, 96 rounds, 4-round windows;
               seeds and rows from the search, written in below): every
               lane's digest of its extract and flight recorder equal to
               the JAX package's ``run_knob_batch``, one capture for the
               three, the path's kernels and each KNOBS instance on it
               launched (counted from 0), two lanes of each generation
               equal to production runs of their own configs; and the two
               full-width batches as one replay each: their lanes' JAX
               anchors, the path's kernels and KNOBS instances launched,
               node-round-steps per second, replay wall, busy share and
               device operations a round.
24. knobs_count — the knob batch (K23) on the count engines: dense PBFT
               (flat, and under the §9 switch with §9b), §6b PBFT under
               the switch, dense Raft (flat and under the §A.3 sticky
               attack), Paxos and DPoS. Every kernel call of rounds 3 and
               20 (paxos-10kx10k: 15) of generation 0 of the six advsearch
               spaces on these engines (dpos-delivery, raft-elections,
               pbft-quorum, paxos-slots, pbft-cert-poison,
               raft-attack-elect) and of seven full-width batches
               (raft-1kx1k with raft-elections' gates and under the
               sticky attack with per-lane targets, N + 3 and 0xFFFFFFFD
               among them; pbft-f128 with pbft-quorum's gates and under
               the switch with pbft-cert-poison's §9b; pbft-quorum-1k's
               shape under the switch with §9b; paxos-10kx10k at 2 lanes;
               dpos-100k with dpos-delivery's gates), and of that round
               with every row the base's, against the plain versions,
               exact (the KNOBS instances of KL, KQ, KAM, KAN, KM, KY,
               KZ, KX and KAB among them; with every row the base's each
               KNOBS call also equals its flat instance). Each instance's
               time on round 20, its plain version's and its bound, and on
               the all-base round its time and its flat instance's time
               and bound. Then three generations of each space
               (population 16, 96 rounds, 4-round windows; seeds and rows
               from the search, written in below): every lane's digest
               equal to the JAX package's ``run_knob_batch``, one capture
               for the three, the path's kernels and each KNOBS instance
               on it launched (counted from 0), two lanes of each
               generation equal to production runs of their configs; and
               the seven batches as one replay each: their lanes' JAX
               anchors, the path's kernels and KNOBS instances launched,
               node-round-steps per second, replay wall, busy share and
               device operations a round.
25. knobs_capped — the knob batch (K23) on capped Raft, and on dense
               Raft and Paxos under the §9 switch. Every kernel call of
               rounds 3 and 20 (paxos-10kx10k: 15) of six batches (8
               lanes; paxos 2): raft-100k as it stands (every row the
               base's), with raft-elections' gates (8 rows), under the
               §A.3 sticky attack with per-lane targets (3, 0, N - 1, and
               N + 3, 0xFFFFFFFD and 0xFFFFFFFF out of range) and under
               the switch (K = 8) with partitions and the elect attack;
               raft-1kx1k under the switch and the sticky attack (128
               rounds); paxos-10kx10k under the switch with
               raft-elections' gates; and of that round with every row
               the base's, against the plain versions, exact (the KNOBS
               instances of KE ``csrc/candidacy.cu`` and KB
               ``csrc/delivery_edges.cu`` and of the SWITCH instances of
               KM, KY and KZ among them; with every row the base's each
               KNOBS call also equals its flat instance). Each instance's
               time on the later round, its plain version's and its bound,
               and on the all-base round its time and its flat instance's
               time and bound. Then the six batches as one replay each:
               the first's decided logs on the flagship's digest, the
               others' lanes on JAX anchors, the path's kernels and KNOBS
               instances launched (counted from 0), node-round-steps per
               second, replay wall, busy share and device operations a
               round.

Every line carries ``elapsed_s``, the seconds since the script's start.
Then the card's name and power limit, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. The kernels line takes each
kernel's launches from one path's own run, counted from 0: KA-KJ from
raft-100k's, KK from raft-100k's with telemetry, KL-KO from raft-1kx1k's,
KP from raft-1kx1k's with telemetry, KQ-KS from the dense ladder's, KT-KV
from pbft-100k-bcast's, KW-KX from dpos-100k's, KY-KZ from
paxos-10kx10k's, KAA, KAB and KAC from pbft-100k-bcast's, dpos-100k's and
paxos-10kx10k's with telemetry, KAD-KAG from hotstuff-100k's, KAH and
KAI from raft-100k's and pbft-100k-bcast's uncapped crash runs, KAJ
from hotstuff-100k's composed run, KAK from pbft-100k-bcast's
equivocating run, KAL from hotstuff-100k's §9b run, and each SWITCH
instance (a row of its own: KB's, KM's, KY's, KZ's, KAE's and KAE's under
§9b) from its phase-21 run, KAM and KAN from pbft-100k-bcast's switch run,
and each KNOBS instance (a row of its own: KAJ's, KAD's and KAE's from the
HotStuff 100k batch, KAE's SWITCH instance and KAL's from the three
generations of hotstuff-forked-qc-1k, KAH's and KT's from the
pbft-100k-bcast batch) from its phase-23 run, and each of phase 24 (KL's
and KM's from the raft-1kx1k batch, their STICKY and ATTACK instances'
from the sticky batch, KQ's from the pbft-f128 batch, KAM's and KAN's
from its switch batch, KY's and KZ's from the paxos-10kx10k batch, KX's
and KAB's from the dpos-100k batch) from its phase-24 batch, and each of
phase 25 (KE's four and KB's five from the raft-100k batches, KM's from
the raft-1kx1k batch, KY's and KZ's from the paxos-10kx10k batch) from
its phase-25 batch, counting its KNOBS launches; the other runs' counts
are in their phases' lines. Any
failure, or no GPU, exits non-zero without that last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

FLAGSHIP_DIGEST = \
    "0e9cc1ddc8b04d96240cdeb5f19877bbd3aad2b23883a585fa1e1c78a961ca5b"
B, N, A, L = 8, 100_000, 8, 128
WINDOW = 8                      # the telemetry phase's flight-recorder window

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth, and the
# 67 TFLOP/s float32 rate outside the tensor cores, which counts a fused
# multiply-add as two operations: one 32-bit lane instruction a lane and
# clock, 33.5e12 a second, is the ceiling taken for 32-bit integer
# operations (each add, xor, shift or multiply one operation).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12
L2_BYTES = 50 * 2**20
# One Threefry-2x32 draw of its first word: 20 rounds of an add, a rotate
# (one funnel shift) and an xor, less the last round's rotate and xor of the
# word no caller reads, 9 key-injection adds and 3 for the initial adds and
# the parity key. (119, which counted a rotate as three operations, is above
# what kernel KAK was measured to take.)
THREEFRY_OPS = 70
EDGE_OPS = 23          # one mixer absorb (11) + fmix (8) + 4 tests an edge


class SmokeError(RuntimeError):
    pass


def emit(phase: str, **kw) -> None:
    """One JSON line of ``phase``, with its ``elapsed_s``: the seconds since
    the script's start."""
    kw.setdefault("elapsed_s", time.perf_counter() - T0)
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def device_ms(fn, args, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of one call of ``fn(*args)``: the summed durations
    of the kernels it launched, from torch.profiler. (CUDA events around
    calls this short would time the host's launch cost, not the device.)
    The calls rotate over clones of ``args`` that together exceed the L2
    cache twice over, so that no call finds its inputs left in L2 by the
    call before it. The profiler records from its second step on: it can
    miss the first launches of its first.

    A wrapper that updates its inputs in place (KAD-KAF) is timed by
    :func:`graph_ms` instead, each call on a clone of its own. A session
    may lack MAX_LOST of the
    device operations it launched (on the H100 late in a run of this
    script, single launches of KAD or KAE went unrecorded in every
    session, one of 20 each time, while the same sessions in a process of
    their own recorded all 20; in another run one of KS's 20, in all eight
    sessions); its recorded time is then scaled by the operations launched
    over those recorded. Where every session lacks more (3 of KAE's 20 in
    all eight sessions of one run), the call is timed by CUDA events
    instead: :func:`graph_ms` for a kernel wrapper, :func:`event_ms` for
    anything else, named in REDONE."""
    from torch.profiler import ProfilerActivity, profile, schedule
    size = sum(a.nbytes for a in args if isinstance(a, torch.Tensor))
    n_copies = min(16, max(2, -(-2 * L2_BYTES // size)))
    copies = [clone_args(args) for _ in range(n_copies)]
    for i in range(warm):
        fn(*copies[i % len(copies)])
    torch.cuda.synchronize()

    def session():
        calls = copies
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn(*calls[-1])
            torch.cuda.synchronize()
            with recorded_step(prof):
                for i in range(reps):
                    fn(*calls[i % len(calls)])
                torch.cuda.synchronize()
        return prof
    name = getattr(fn, "__name__", "a kernel")
    try:
        _, device, launched = profiled(session, name, lost=MAX_LOST)
    except SmokeError as err:
        # Every session lacked more records than MAX_LOST: CUDA events.
        from consensus_tpu_torch import _build
        wrapper = name in _build.SOURCES
        REDONE.append(f"{name}: timed by CUDA events "
                      f"({'graph' if wrapper else 'eager'}) after: {err}")
        print(f"chip_smoke: {REDONE[-1]}", file=sys.stderr, flush=True)
        return graph_ms(fn, args, reps) if wrapper else event_ms(fn, args)
    return sum(e.time_range.elapsed_us() for e in device) / 1e3 \
        * launched / len(device) / reps


# The calls a plain version's time is taken over (event_ms, host launches
# included): a plain version's time is written down beside its kernel's,
# never judged, so it takes no profiled sessions.
PLAIN_REPS = 3


def plain_time(fn, args) -> float:
    """A plain version's time a call on ``args`` (:func:`event_ms`)."""
    return event_ms(fn, args, PLAIN_REPS)


def graph_ms(fn, args, reps: int = 20) -> float:
    """Device time of one call of ``fn(*args)``: CUDA events around one
    replay of a CUDA graph of ``reps`` calls, each on a clone of its own
    that is restored from ``args`` before each replay (KX, KAD and KAE
    update inputs in place) and then pushed out of L2; best of three.
    Phase 15 times its kernels so, and :func:`device_ms` where the
    profiler fails: late in this script it lost 14 of a session's 80
    records of KT, in every session, and 4-5 of 20 single launches of KX,
    KAD and KAE. A call's time includes the graph's gaps between its
    launches (about a microsecond each)."""
    originals = [clone_args(args) for _ in range(reps)]
    calls = [clone_args(a) for a in originals]
    fn(*clone_args(args))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in calls:
            fn(*a)
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.int32, device=next(
        a.device for a in args if isinstance(a, torch.Tensor)))
    best = float("inf")
    for _ in range(3):
        for a, o in zip(calls, originals):
            for t, u in zip(tensors_of(a), tensors_of(o)):
                t.copy_(u)
        flush.fill_(0)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def event_ms(fn, args, reps: int = 5) -> float:
    """Time of one call of ``fn(*args)`` launched eagerly, each on a clone
    of its own: CUDA events around ``reps`` calls, their host launches
    included (the plain versions' time in phase 15, and :func:`device_ms`'s
    where the profiler fails on a function that is not a kernel
    wrapper)."""
    calls = [clone_args(args) for _ in range(reps + 1)]
    fn(*calls.pop())
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for a in calls:
        fn(*a)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# The device operations whose records a session of device_ms may lack.
MAX_LOST = 2
PROFILER_SESSIONS = 8
REDONE: list[str] = []          # the profiled work whose session was redone
# The profiler can drop the first device operations of its recorded step:
# on the H100 the first of 20 torch.kthvalue launches (4 us each) went
# missing in 8 sessions of 8 with no wait after the step, and with a 10 ms
# and then a 100 ms wait the first one or two kernels of a session (up to
# 2.1 ms each) still went missing in every session of later runs, whatever
# the wait. So each recorded step starts with a lead-in: a wait, a spin
# kernel of its own, a synchronize and a wait, before the range MEASURED
# opens; the runtime calls that start inside that range are counted, and
# the step's device operations but the spin kernel are counted and timed
# (device_events).
STEP_SETTLE_S = 0.01
LEAD_IN_CYCLES = 50_000_000     # about 25 ms of spinning at 1.98 GHz
MEASURED = "chip_smoke::measured"


@contextlib.contextmanager
def recorded_step(prof, lead_in: bool = True):
    """Step ``prof`` into its recorded step, run the lead-in (on the card),
    and run the block inside the range MEASURED, whose work is what
    :func:`device_events` and :func:`profiled` count."""
    from torch.profiler import record_function
    prof.step()
    time.sleep(STEP_SETTLE_S)
    if lead_in:
        torch.cuda._sleep(LEAD_IN_CYCLES)
        torch.cuda.synchronize()
        time.sleep(STEP_SETTLE_S)
    with record_function(MEASURED):
        yield


def profiled(session, what: str, graph: bool = False,
             lost: int = 0) -> tuple:
    """``session()``'s profiler, its device operations and the runtime
    calls that launched device operations in it. CUPTI now and
    then delivers a session's device records only in part, or not at all,
    so a session counts only when it is complete: when it holds a device
    operation for each kernel launch, memset and copy that the host made in
    it (or for all but ``lost`` of them, where the caller averages over the
    records it got); for a graph replay, which the host launches as one
    call, when it holds as many device operations as the session before.
    Otherwise the session is run again, up to PROFILER_SESSIONS times, and
    then this fails."""
    from torch.autograd import DeviceType
    counts = []
    for _ in range(PROFILER_SESSIONS):
        prof = session()
        device = device_events(prof)
        mark = measured_start(prof)
        calls = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CPU
                    and e.time_range.start >= mark
                    and any(c in e.name for c in RUNTIME_CALLS))
        counts.append((len(device), calls))
        if graph:
            complete = len(counts) > 1 and counts[-1][0] == counts[-2][0] > 0
        else:
            complete = 0 < len(device) <= calls <= len(device) + lost
        if complete:
            if len(device) < calls:
                REDONE.append(f"{what}: {calls - len(device)} of {calls} "
                              "launches unrecorded")
            if len(counts) > 1 + graph:
                REDONE.append(what)
                print(f"chip_smoke: profiling {what}: (device operations, "
                      f"runtime calls) by session: {counts}",
                      file=sys.stderr, flush=True)
            return prof, device, calls
    raise SmokeError(f"the profiler recorded the device operations of "
                     f"{what} in part only: (device operations, runtime "
                     f"calls) by session {counts}")


# The CUDA runtime calls that put one operation each on the device.
RUNTIME_CALLS = ("Launch", "Memset", "Memcpy")


def measured_start(prof) -> float:
    """The start of the range MEASURED (:func:`recorded_step`) on the
    profiler's host clock."""
    from torch.autograd import DeviceType
    starts = [e.time_range.start for e in prof.events()
              if e.name == MEASURED and e.device_type == DeviceType.CPU]
    require(len(starts) == 1, "a profiled session without one measured "
            "range")
    return starts[0]


# The lead-in's spin kernel (torch.cuda._sleep), as the profiler names it.
SPIN_KERNEL = "spin_kernel"


def device_events(prof) -> list:
    """The profiled device operations (kernels, memsets, copies) of the
    recorded step but the lead-in's spin kernel, without the ranges that
    the profiler's steps and the script's named ranges also put on the
    device timeline. Every recorded step synchronizes before it and
    starts with the lead-in (:func:`recorded_step`), so its device
    operations are the lead-in's and the measured work's, told apart by
    name and not by time: the profiler maps device times onto the host
    clock, and on the H100 that mapping moved by up to 4 ms within a
    session (20 launches made inside the range MEASURED were mapped
    before it), so that a time mark dropped records of work that was
    done."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and SPIN_KERNEL not in e.name
            and not e.name.startswith(("ProfilerStep", "wrapper::",
                                       "chip_smoke::"))]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(pairs) -> float:
    err = 0.0
    for got, want in pairs:
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"shape/dtype {tuple(got.shape)} {got.dtype} != "
                f"{tuple(want.shape)} {want.dtype}")
        d = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --- phase 3: each kernel against its plain version --------------------------

def check_random_u32(dev, gen):
    from consensus_tpu_torch.core import rng
    seeds = torch.tensor([0, 0xFFFFFFFF, 6, 7, 8, 9, 10, 0x80000000],
                         dtype=torch.uint32, device=dev)
    term = torch.randint(0, 40, (B, N), generator=gen, device=dev,
                         dtype=torch.int32)
    term[0, :4] = torch.tensor([-1, 0, 2**31 - 1, -2**31], dtype=torch.int32)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    cases = [(rng.STREAM_TIMEOUT, 0, 0, idx),           # init's timeouts
             (rng.STREAM_TIMEOUT, term, 0, idx),        # _draw_timeout
             (rng.STREAM_VALUE, 63, 0, idx),
             (rng.STREAM_VALUE, 0xFFFFFFFF, 7, term),
             (rng.STREAM_CHURN, 5, 0, 0)]
    err = max_abs_err((rng.random_u32(seeds, *c), rng.random_u32_plain(
        seeds, *c)) for c in cases)
    call = cases[0]                     # the one call on the main path
    nbytes = 4 * B + 4 * N + 8 * B * N
    return dict(
        name="random_u32", route="cuda",
        source="consensus_tpu_torch/csrc/random_u32.cu",
        replaces="consensus_tpu/core/rng.py:232 random_u32_jnp",
        max_abs_err=err,
        ms=device_ms(rng.random_u32, (seeds, *call)),
        plain_ms=plain_time(rng.random_u32_plain, (seeds, *call)),
        bound=bound(nbytes, THREEFRY_OPS * B * N), library_ms=None)


def check_delivery_edges(dev, gen):
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.ops import adversary
    seeds = torch.tensor([0, 0xFFFFFFFF, 6, 7, 8, 9, 10, 11],
                         dtype=torch.uint32, device=dev)
    ids = torch.randint(-1, N, (B, A), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[0, :3] = torch.tensor([-1, N - 1, 0], dtype=torch.int32)
    ids[1] = -1
    drop = rng.prob_threshold_u32(0.01)
    pairs = []
    for r, part in ((17, 0), (0xFFFFFFFF, 0),
                    (3, rng.prob_threshold_u32(1.0)),
                    (4, rng.prob_threshold_u32(0.5))):
        for src in (True, False):
            args = (seeds, r, ids, N, drop, part, src)
            pairs.append((adversary.delivery_edges(*args),
                          adversary.delivery_edges_plain(*args)))
    err = max_abs_err(pairs)
    call = (seeds, 17, ids, N, drop, 0, True)
    return dict(
        name="delivery_edges", route="cuda",
        source="consensus_tpu_torch/csrc/delivery_edges.cu",
        replaces="consensus_tpu/ops/adversary.py:178 delivery_edges",
        max_abs_err=err,
        ms=device_ms(adversary.delivery_edges, call),
        plain_ms=plain_time(adversary.delivery_edges_plain, call),
        bound=bound(B * A * N + 4 * B * A + 4 * B, EDGE_OPS * B * A * N),
        library_ms=None)


def check_top_active(dev, gen):
    from consensus_tpu_torch.engines import raft_sparse as rs
    term = torch.randint(0, 30, (B, N), generator=gen, device=dev,
                         dtype=torch.int32)
    sparse = torch.rand((B, N), generator=gen, device=dev) < 2e-4
    masks = [sparse,
             torch.rand((B, N), generator=gen, device=dev) < 0.5,
             torch.ones((B, N), dtype=torch.bool, device=dev),
             torch.zeros((B, N), dtype=torch.bool, device=dev)]
    masks[0][0, N - 5:] = True                  # ties in term, high ids
    pairs = [(rs.top_active(m, term, a), rs.top_active_plain(m, term, a))
             for m in masks for a in (1, A, 16)]
    err = max_abs_err(pairs)
    # The yardstick: one torch.topk over the same (term desc, id asc) keys.
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    key = torch.where(sparse, ((2**31 - 1) - term.to(torch.int64)) * 2**31
                      + idx, 2**63 - 1)
    return dict(
        name="top_active", route="cuda",
        source="consensus_tpu_torch/csrc/top_active.cu",
        replaces="consensus_tpu/engines/raft_sparse.py:144 _top_active",
        max_abs_err=err,
        ms=device_ms(rs.top_active, (sparse, term, A)),
        plain_ms=plain_time(rs.top_active_plain, (sparse, term, A)),
        bound=bound(B * N * 5 + 4 * B * A, 4 * B * N),
        library_ms=device_ms(
            lambda k: torch.topk(k, A, dim=1, largest=False), (key,)))




# --- phase 3, continued: the round's phase kernels KD-KK ---------------------

PHASES = ("candidacy", "elect", "slots", "propose", "append_entries",
          "acks_commit", "telemetry")
REPLACES = {"candidacy": "consensus_tpu/engines/raft_sparse.py:236 "
                        "raft_sparse_round P0-P1",
           "elect": "consensus_tpu/engines/raft_sparse.py:255 "
                    "raft_sparse_round P2",
           "slots": "consensus_tpu/engines/raft_sparse.py:354 "
                    "raft_sparse_round slot lifecycle",
           "propose": "consensus_tpu/engines/raft_sparse.py:377 "
                      "raft_sparse_round P3a-P3b",
           "append_entries": "consensus_tpu/engines/raft_sparse.py:398 "
                             "raft_sparse_round P3c",
           "acks_commit": "consensus_tpu/engines/raft_sparse.py:441 "
                          "raft_sparse_round P3d-P4",
           "telemetry": "consensus_tpu/engines/raft_sparse.py:503 "
                        "raft_sparse_round telemetry and flight tail, "
                        "consensus_tpu/ops/flight.py:29 bucket_counts"}


def flagship_config(**kw):
    from consensus_tpu_torch.core.config import Config
    return Config(**{**dict(protocol="raft", n_nodes=N, n_rounds=64,
                            n_sweeps=B, log_capacity=L, max_entries=100,
                            max_active=A, seed=6, drop_rate=0.01,
                            churn_rate=0.001), **kw})


def clone_args(args):
    """``args`` with every tensor cloned, also inside lists and tuples (KAI
    takes its leaves as a list of (dst, src, reset) tuples)."""
    def clone(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        if type(a) in (list, tuple):
            return type(a)(clone(x) for x in a)
        return a
    return tuple(clone(a) for a in args)


def tensors_of(args):
    """The tensors of ``args``, also inside lists and tuples, in order."""
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif type(a) in (list, tuple):
            yield from tensors_of(a)


@contextlib.contextmanager
def standing_in(module, names, make):
    """Replace each wrapper ``names`` of the round's ``module`` by
    ``make(name, wrapper)`` while the block runs. A wrapper counts its
    launches on the module attribute it is called by, so each stand-in
    carries a ``launches`` (and ``switch_launches`` and ``knob_launches``)
    of its own."""
    originals = {name: getattr(module, name) for name in names}
    try:
        for name, fn in originals.items():
            stand_in = make(name, fn)
            stand_in.launches = stand_in.switch_launches = 0
            stand_in.knob_launches = 0
            setattr(module, name, stand_in)
        yield
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def recording(got: dict):
    """A ``make`` for :func:`standing_in` whose stand-ins put a clone of
    their arguments into ``got`` by wrapper name and call the wrapper."""
    def recorder(name, fn):
        def record(*args):
            got[name] = clone_args(args)
            return fn(*args)
        return record
    return recorder


def capture_phase_inputs(cfg, r: int, device="cuda") -> dict:
    """The arguments each phase wrapper (KD-KK) receives in round ``r`` of
    ``cfg``'s run on ``device`` (with its telemetry on), cloned as they
    arrive."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    from consensus_tpu_torch.network import runner
    telem, flight = runner.accumulators(cfg, device)
    st = runner.advance(cfg, runner.init(cfg, runner.make_seeds(cfg),
                                         device), 0, r, telem=telem,
                        flight=flight)
    got = {}
    with standing_in(rs, PHASES, recording(got)):
        rs.raft_sparse_round(cfg, st, r, telem=telem, flight=flight)
    require(set(got) == set(PHASES), f"round {r} skipped a phase")
    return got


def kernel_module(name: str):
    """The module that defines wrapper ``name`` and its plain version."""
    from consensus_tpu_torch.network import runner
    return {n: mod for mod, n in runner.KERNELS}[name]


def run_pair(name: str, args) -> list:
    """The kernel and its plain version on separate clones of ``args``:
    pairs of their results and of every tensor argument afterwards, which
    covers the in-place updates and that nothing else was written."""
    mod = kernel_module(name)
    ka, pa = clone_args(args), clone_args(args)
    got = getattr(mod, name)(*ka)
    want = getattr(mod, name + "_plain")(*pa)
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    pairs = list(zip(got or (), want or ()))
    return pairs + list(zip(tensors_of(ka), tensors_of(pa)))


def edge_phase_inputs(dev, gen) -> dict:
    """Random and built inputs on which the phases' rare paths fire:
    {name: [args]}."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.engines import raft_sparse as rs
    from consensus_tpu_torch.network import runner
    from consensus_tpu_torch.ops import adversary

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def coin(p, shape):
        return torch.rand(shape, generator=gen, device=dev) < p

    def distinct_ids(n, empty):
        ids = torch.stack([torch.randperm(n, generator=gen, device=dev)[:A]
                           for _ in range(B)]).to(torch.int32)
        ids[coin(empty, (B, A))] = -1
        return ids

    seeds = torch.arange(11, 11 + B, dtype=torch.int64,
                         device=dev).to(torch.uint32)
    out = {name: [] for name in PHASES}

    # KE: every node timed out (so far more than A candidates), churn at
    # 0.5 so that some sweeps step their leaders down, terms at the i32
    # edge, empty and full logs.
    cfg = flagship_config(churn_rate=0.5, t_min=1, t_max=3)
    term, role = ri(0, 50, (B, N)), ri(0, 3, (B, N))
    term[0, :4] = torch.tensor([2**31 - 1, 0, -1, 5], dtype=torch.int32)
    log_len = ri(0, L + 1, (B, N))
    log_len[:, :100], log_len[:, 100:200] = 0, L
    ke = (cfg, seeds, 20, term, role, ri(-1, N, (B, N)), ri(3, 10, (B, N)),
          ri(1, 3, (B, N)), ri(0, 50, (B, N, L)), log_len)
    out["candidacy"].append(ke)

    # KF on KE's result: more than A candidates compete.
    (term, role, vf, timer, timeout, reset, own_lterm,
     cand) = rs.candidacy_plain(*ke)
    require(int(cand.sum(1).min()) > A, "edge inputs: too few candidates")
    cand_ids = rs.top_active_plain(cand, term, A)
    del_cj, del_jc = (adversary.delivery_edges_plain(
        seeds, 20, cand_ids, N, rng.prob_threshold_u32(0.01), 0, src)
        for src in (True, False))
    out["elect"].append((cfg, seeds, cand_ids, del_cj, del_jc, term, role,
                         vf, timer, timeout, reset, log_len, own_lterm))

    # KF at the majority: candidate 5 gets the grants of every node but
    # its rival 9; K of them are delivered, so that 1 + K is the majority
    # in even sweeps and one short of it in odd ones. N even and odd.
    for n in (N, N - 1):
        cfg_n = flagship_config(n_nodes=n)
        maj = n // 2 + 1
        cand_ids = torch.full((B, A), -1, dtype=torch.int32, device=dev)
        cand_ids[:, 0], cand_ids[:, 1] = 5, 9
        role = torch.zeros((B, n), dtype=torch.int32, device=dev)
        role[:, 5] = role[:, 9] = 1
        vf = torch.full((B, n), -1, dtype=torch.int32, device=dev)
        vf[:, 5], vf[:, 9] = 5, 9
        del_cj = torch.zeros((B, A, n), dtype=torch.bool, device=dev)
        del_cj[:, 0] = True
        del_cj[:, 0, 5] = False
        del_jc = torch.zeros((B, n, A), dtype=torch.bool, device=dev)
        for b in range(B):
            k = maj - 1 if b % 2 == 0 else maj - 2
            del_jc[b, 10:10 + k, 0] = True
        z = torch.zeros((B, n), dtype=torch.int32, device=dev)
        out["elect"].append((cfg_n, seeds, cand_ids, del_cj, del_jc,
                             z + 7, role, vf, z.clone(), z + 1,
                             torch.zeros((B, n), dtype=torch.bool,
                                         device=dev), z.clone(), z.clone()))

    # KG: old and new tracked ids drawn from a small pool, so that slots
    # are carried from other slot indices, dropped and started; empty
    # slots; leaders at log length E (no self-match) and below.
    cfg = flagship_config()
    E = min(cfg.max_entries, L)
    old = torch.stack([torch.randperm(16, generator=gen, device=dev)[:A]
                       for _ in range(2 * B)]).to(torch.int32)
    lead_id, new_ids = old[:B].clone(), old[B:].clone()
    lead_id[coin(0.25, (B, A))] = -1
    new_ids[coin(0.25, (B, A))] = -1
    role, log_len = ri(0, 2, (B, N)), ri(0, L + 1, (B, N))
    role[:, :16] = 2
    log_len[:, :4], log_len[:, 4:8] = E, E - 1
    out["slots"].append((cfg, new_ids, lead_id, ri(0, 256, (B, A, N),
                                                   torch.uint8),
                         ri(0, 256, (B, A, N), torch.uint8), role, log_len))

    # KI: a third of the nodes lead; leaders at log length E (no append)
    # and at L - 1 (the last slot, when E = L), tracked among others that
    # do not lead; empty slots. E = 100 and E = L.
    lead = coin(0.3, (B, N))
    lead[:, :200] = True
    for max_entries in (100, L):
        cfg = flagship_config(max_entries=max_entries)
        log_len = ri(0, L + 1, (B, N))
        log_len[:, :100] = min(max_entries, L)
        log_len[:, 100:200] = L - 1
        lead_id = distinct_ids(400, 0.2)
        out["propose"].append((cfg, seeds, 20, lead, ri(0, 50, (B, N)),
                               ri(0, 50, (B, N, L)),
                               ri(-2**31, 2**31 - 1, (B, N, L)), log_len,
                               ri(0, 50, (B, N)), lead_id))

    # KD: heartbeats from half the slots, snapshot terms and follower terms
    # from a small alphabet, so that bumps, ties between slots, candidates
    # stepping down with and without a bump all fire; log terms from a
    # small alphabet, so that log-match checks pass often; prev = 0,
    # full-log copies, prev past any log.
    cfg = flagship_config()
    lead_id = distinct_ids(N, 0.1)
    s_term, term = ri(0, 4, (B, A)), ri(0, 4, (B, N))
    role = ri(0, 3, (B, N))
    s_next = ri(1, L + 2, (B, A, N), torch.uint8)
    s_len = ri(0, L + 1, (B, A))
    s_next[:, 0, :1000] = 1                      # prev = 0
    s_len[:, 0] = L                              # full-log copies
    s_next[:, 1, :1000] = 255                    # prev past any log
    kd = (cfg, seeds, coin(0.5, (B, A, N)), lead_id, s_term, term, role,
          ri(-1, N, (B, N)), ri(0, 9, (B, N)), ri(3, 10, (B, N)),
          coin(0.3, (B, N)), ri(0, 3, (B, N, L)),
          ri(-2**31, 2**31 - 1, (B, N, L)), ri(0, L + 1, (B, N)),
          ri(0, 20, (B, N)), s_next, s_len, ri(0, L + 1, (B, A)),
          ri(0, 3, (B, A, L)), ri(-2**31, 2**31 - 1, (B, A, L)))
    got = rs.append_entries_plain(*clone_args(kd))
    both = (role == 1) & (got[0] > term) & got[7]
    require(int(both.sum()) > 0 and int(((role == 1) & (got[0] == term)
                                         & got[7]).sum()) > 0,
            "edge inputs: no candidate stepped down with and without a bump")
    out["append_entries"].append(kd)

    # KH: tiny terms so that acked terms bump leaders (bump3); a third of
    # the leaders' log entries of their own term; match rows with values
    # above E; next at 0 and 1 under failed acks. Sweep 0 acks no slot 0
    # or 2, whose rows sit exactly at the majority (60) and one short.
    lead_id = torch.stack([torch.randperm(N, generator=gen, device=dev)[:A]
                           for _ in range(B)]).to(torch.int32)
    lead_id[1:][coin(0.1, (B - 1, A))] = -1
    role = ri(0, 3, (B, N))
    role.scatter_(1, lead_id.clamp(min=0).to(torch.int64),
                  torch.full((B, A), 2, dtype=torch.int32, device=dev))
    kstar = ri(0, A, (B, N))
    kstar[0] = torch.where(coin(0.5, (N,)), 1, 3)
    lead_match = ri(0, 256, (B, A, N), torch.uint8)
    lead_match[1:, :4] = ri(90, 140, (B - 1, 4, N), torch.uint8)
    maj = N // 2 + 1
    lead_match[0, 0], lead_match[0, 2] = 59, 59
    lead_match[0, 0, :maj] = lead_match[0, 2, :maj - 1] = 60
    lead_next = ri(0, 256, (B, A, N), torch.uint8)
    lead_next[:, 4:] = ri(0, 3, (B, A - 4, N), torch.uint8)
    term, log_term = ri(0, 4, (B, N)), ri(0, 4, (B, N, L))
    lid = lead_id.clamp(min=0).to(torch.int64)
    log_term[0, lid[0, 0], 59] = term[0, lid[0, 0]]
    log_term[0, lid[0, 2], 58:60] = term[0, lid[0, 2]]
    commit = ri(0, 50, (B, N))
    commit[0, lid[0, 0]] = commit[0, lid[0, 2]] = 0
    timer = ri(-3, 2**31 - 1, (B, N))
    timer[:, :10] = 2**31 - 1                   # P4's add wraps
    kh = (seeds, lead_id, coin(0.9, (B, A)) & (lead_id >= 0),
          coin(0.9, (B, N, A)),
          coin(0.8, (B, N)), kstar, coin(0.7, (B, N)), ri(0, L + 1, (B, N)),
          log_term, term, role, ri(-1, N, (B, N)), ri(1, 9, (B, N)), commit,
          lead_match, lead_next, timer, coin(0.5, (B, N)))
    kh[2][0, [0, 2]] = True
    for max_entries in (100, L):
        out["acks_commit"].append((flagship_config(max_entries=max_entries),
                                   *kh))

    # KK: 20 rounds in windows of 6, so that round 19 adds into the
    # ragged last window; winners whose wait is <= 0, at 2^14 - 1, 2^14
    # and past it (and one that wraps); leaders whose lag is <= 0 or
    # >= 2^14; down nodes. Accumulators start nonzero. Round 0, and the
    # recorder off.
    cfg = flagship_config(n_rounds=20, telemetry_window=6)
    cand_ids = distinct_ids(64, 0.2)
    win = coin(0.6, (B, A))
    timer_in = ri(-5, 40, (B, N))
    timer_in[:, :8] = torch.tensor([-6, -1, 0, 2**14 - 2, 2**14 - 1, 2**14,
                                    2**20, 2**31 - 1], dtype=torch.int32)
    cand_ids[:, :3] = torch.randint(0, 8, (B, 3), generator=gen, device=dev,
                                    dtype=torch.int32)
    log_len = ri(0, 2**16, (B, N))
    commit_in = ri(0, 100, (B, N))
    t, (w, lat) = runner.accumulators(cfg, dev)
    t += ri(0, 1000, t.shape)
    w += ri(0, 1000, w.shape)
    lat += ri(0, 1000, lat.shape)
    kk = (cand_ids, win, timer_in, coin(0.5, (B, N)), coin(0.5, (B, N)),
          commit_in, commit_in + ri(0, 3, (B, N)), ri(0, 3, (B, N)),
          log_len, coin(0.1, (B, N)))
    for r, acc in ((19, (t, w, lat)), (0, (t, w, lat)), (19, (t,))):
        out["telemetry"].append((cfg, r, *kk, *acc))
    return out


def acks_work(args) -> dict:
    """What KH must touch on its arguments ``args``: ``has_l`` and
    ``delivered``, the nodes that ack a slot and those whose ack was
    delivered (P3d reads their slot and the mask byte, and the term of the
    delivered); ``rows``, the processing slots, whose [N] match bytes it
    reads; ``acks`` and ``applied``, the delivered acks to a processing slot
    and those of them applied (each reads its apply flag, an applied one
    the new log length and writes match and next, another reads and
    writes next); ``leaders`` and ``counting``, after the bump, the leaders
    (P4 writes their timer) and the other nodes whose timer counts up (P4
    reads and writes it)."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    (_, _, lead_id, was_lead_k, del_jl, has_l, kstar, apply_, _, _, term,
     role, *_rest) = args
    reset = args[18]
    n = term.shape[1]
    lid = lead_id.clamp(0, n - 1).to(torch.int64)
    ackm = (torch.where(has_l, kstar, A)[:, :, None]
            == torch.arange(A, device=term.device)) & del_jl
    t_in3 = torch.where(ackm, term[:, :, None], 0).amax(1)
    proc = was_lead_k & (role.gather(1, lid) == 2) \
        & ~(t_in3 > term.gather(1, lid))
    acks = ackm & proc[:, None, :]
    after = clone_args(args)
    rs.acks_commit_plain(*after)
    lead = after[11] == 2
    return dict(has_l=int(has_l.sum()), delivered=int(ackm.sum()),
                rows=int(proc.sum()), acks=int(acks.sum()),
                applied=int((acks & apply_[:, :, None]).sum()),
                leaders=int(lead.sum()), counting=int((~lead & ~reset).sum()))


def phase_bound(name: str, args) -> tuple[float, str]:
    """The least time of phase ``name``'s work on ``args`` (flagship
    shapes): the bytes it must move and the 32-bit operations it must do
    for these inputs."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    nodes = B * N
    if name == "candidacy":
        moved = int(rs.candidacy_plain(*clone_args(args))[5].sum())
        return bound(54 * nodes, 20 * nodes + THREEFRY_OPS * moved)
    if name == "elect":
        return bound((67 + 2 * (A - 8)) * nodes, 12 * A * nodes)
    if name == "slots":
        new_ids, lead_id = args[1], args[2]
        carried = int(((new_ids[:, :, None] == lead_id[:, None, :])
                       & (new_ids >= 0)[:, :, None]).any(2).sum())
        return bound(2 * B * A * N + 2 * carried * N, 4 * B * A * N)
    if name == "propose":
        cfg, lead, log_len = args[0], args[3], args[7]
        app = int((lead & (log_len < min(cfg.max_entries, L))).sum())
        return bound(9 * nodes + 12 * app + B * A * (16 * L + 20),
                     4 * nodes + THREEFRY_OPS * app)
    if name == "append_entries":
        term = args[5]
        got = rs.append_entries_plain(*clone_args(args))
        new_term, kstar, has_l, applied = got[0], got[6], got[7], got[8]
        s_next, s_len = args[15], args[16]
        k = kstar.to(torch.int64)
        prev = s_next.gather(1, k[:, None, :])[:, 0].to(torch.int64) - 1
        l_len = s_len.gather(1, k).to(torch.int64)
        copied = torch.where(applied, (l_len - prev.clamp(min=0))
                             .clamp(min=0), 0).sum()
        bumped = int((new_term > term).sum())
        return bound(nodes * (A + 29 + 35) + 5 * int(has_l.sum())
                     + B * A * (8 * L + 12) + 8 * int(copied),
                     (4 * A + 30) * nodes + THREEFRY_OPS * bumped)
    if name == "acks_commit":
        # P3d-P3e as acks_work counts them; P4 reads every role, the reset
        # flag of each node that does not lead, and the timers it changes.
        k = acks_work(args)
        followers = nodes - k["leaders"]
        p3 = (nodes + 5 * k["has_l"] + 4 * k["delivered"] + k["rows"] * N
              + 3 * k["acks"] + 4 * k["applied"])
        p4 = 4 * nodes + followers + 8 * k["counting"] + 4 * k["leaders"]
        return bound(p3 + p4, 9 * nodes + 8 * k["rows"] * N)
    # KK reads every apply flag and both commits, has_l where not applied,
    # the winner flags; with the recorder also every role, the down flag
    # of each leader and the log length of each live one, and each
    # winner's id and round-entry timer.
    (_, _, _, win, _, _, apply_, _, _, role, _, down) = args[:12]
    n_apply = int(apply_.sum())
    nbytes = 9 * nodes + (nodes - n_apply) + B * A
    if len(args) == 15:                         # w and lat given
        lead = role == 2
        nbytes += (4 * nodes + int(lead.sum()) + 4 * int((lead & ~down).sum())
                   + 8 * int(win.sum()))
    return bound(nbytes, 10 * nodes)


def check_phases(dev, gen, cfg) -> list[dict]:
    """KD-KK against their plain versions on round 20 of the flagship (with
    its telemetry on) and on the random and built edge inputs; times and
    bounds on the flagship's inputs."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    real = capture_phase_inputs(cfg, 20)
    edges = edge_phase_inputs(dev, gen)
    rows = []
    for name in PHASES:
        err = max(max_abs_err(run_pair(name, args))
                  for args in [real[name], *edges[name]])
        args = real[name]
        fn, plain = getattr(rs, name), getattr(rs, name + "_plain")
        library = None
        if name == "acks_commit":
            rank = N - (N // 2 + 1) + 1
            library = device_ms(lambda m: torch.kthvalue(m, rank, dim=2),
                                (args[15],))
        rows.append(dict(name=name, route="cuda",
                         source=f"consensus_tpu_torch/csrc/{name}.cu",
                         replaces=REPLACES[name], max_abs_err=err,
                         ms=device_ms(fn, args),
                         plain_ms=plain_time(plain, args),
                         bound=phase_bound(name, args), library_ms=library))
    return rows


# --- phase 3, continued: the dense round's kernels KL-KO ---------------------

DENSE = ("delivery", "dense_elect", "dense_append", "dense_acks_commit")
DENSE_REPLACES = {
    "delivery": "consensus_tpu/ops/adversary.py:61 delivery",
    "dense_elect": "consensus_tpu/engines/raft.py:301 raft_round P0-P2",
    "dense_append": "consensus_tpu/engines/raft.py:422 raft_round P3a-P3c",
    "dense_acks_commit": "consensus_tpu/engines/raft.py:480 raft_round "
                         "P3d-P4"}
# BASELINE configs 1 and 2 (benchmarks/run_benchmarks.py CONFIGS) and
# their committed digests (benchmarks/parts/<name>.json).
DENSE_CONFIGS = {
    "raft-5node": dict(n_nodes=5, n_rounds=160, n_sweeps=512, seed=1),
    "raft-1kx1k": dict(n_nodes=1024, n_rounds=1024, n_sweeps=8, seed=2)}
DENSE_DIGESTS = {
    "raft-5node":
        "51007288213f9b78e1e4fd2f3601105ff97f12210a2a0a3382a059e2b703940b",
    "raft-1kx1k":
        "8748ac4fce3ad51b006d1d6542aa853f6d2f25839915ead9327bf7ca948f3308"}
# The rounds phase 3 records of each: the first election (every sweep's
# nodes of timeout 3 stand at once), and a round with a leader in every
# sweep. The kernels are timed on raft-1kx1k's second.
DENSE_ROUNDS = {"raft-5node": (3, 100), "raft-1kx1k": (3, 20)}


def dense_config(name: str, **kw):
    from consensus_tpu_torch.core.config import Config
    return Config(**{**dict(protocol="raft", log_capacity=L, max_entries=100,
                            drop_rate=0.01, churn_rate=0.001),
                     **DENSE_CONFIGS[name], **kw})


# The gate runs of phases 15, 16, 18, 20 and 21 on raft-1kx1k's shape run
# 256 of its 1 024 rounds (cut to keep the full run within its wall
# budget; PERF.md §4), with JAX anchors made at that depth.
GATE_1KX1K_ROUNDS = 256


def gate_1kx1k(**kw):
    """raft-1kx1k's shape as the gate runs take it: GATE_1KX1K_ROUNDS
    rounds, changed by ``kw``."""
    return dense_config("raft-1kx1k", **{"n_rounds": GATE_1KX1K_ROUNDS,
                                         **kw})


def capture_dense_inputs(cfg, rounds, device="cuda") -> dict:
    """{r: {wrapper: arguments}}: what each wrapper of the dense round
    (KL-KO) receives in each round r of ``rounds`` of ``cfg``'s eager run
    on ``device``, cloned as it arrives."""
    from consensus_tpu_torch.engines import raft
    from consensus_tpu_torch.network import runner
    st = runner.init(cfg, runner.make_seeds(cfg), device)
    out, r0 = {}, 0
    for r in sorted(rounds):
        st = runner.advance(cfg, st, r0, r - r0)
        got = out[r] = {}
        with standing_in(raft, DENSE, recording(got)):
            st = raft.raft_round(cfg, st, r)
        require(set(got) == set(DENSE), f"round {r} skipped a phase")
        r0 = r + 1
    return out


def dense_edge_inputs(dev, gen) -> dict:
    """Inputs on which the dense kernels' rare paths fire: {name: [args]}.
    KL: seeds and rounds at the u32 edges, partitions never, always and in
    some sweeps, N = 1024, 1000, 5, 3 and 1. KM-KO: the rounds of hostile
    runs (drops 0.3, partitions 0.4, churn 0.1, timeouts 1-3) at N = 64
    and 999, and random states over small alphabets, with two built
    sweeps: a re-grant in KM, and in KN two leaders of different terms,
    the older one bumped by the newer while a follower of its own term
    copies its row."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.engines import raft
    out = {name: [] for name in DENSE}

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def coin(p, shape):
        return torch.rand(shape, generator=gen, device=dev) < p

    seeds = torch.tensor([0, 0xFFFFFFFF, 1, 2, 3, 4, 5, 0x80000000],
                         dtype=torch.uint32, device=dev)
    half = rng.prob_threshold_u32(0.5)
    active = rng.random_u32_plain(seeds, rng.STREAM_PARTITION, 7, 0, 0) < half
    require(0 < int(active.sum()) < B, "edge inputs: no sweep whose "
            "partition is active and one whose is not")
    for n in (1024, 1000, 5, 3, 1):
        for r, drop, part in ((0, 0.01, 0.0), (0xFFFFFFFF, 0.3, 1.0),
                              (7, 0.3, 0.5), (7, 0.0, 0.5)):
            out["delivery"].append((seeds, r, n, rng.prob_threshold_u32(drop),
                                    rng.prob_threshold_u32(part)))

    for n in (64, 999):
        cfg = dense_config("raft-1kx1k", n_nodes=n, n_sweeps=B, seed=5,
                           t_min=1, t_max=4, drop_rate=0.3,
                           partition_rate=0.4, churn_rate=0.1)
        for got in capture_dense_inputs(cfg, (2, 5, 9, 17, 30),
                                        dev).values():
            for name in DENSE[1:]:
                out[name].append(got[name])

    n = 1024
    cfg = dense_config("raft-1kx1k")
    seeds = torch.arange(11, 11 + B, dtype=torch.int64,
                         device=dev).to(torch.uint32)
    logt, logv = ri(0, 4, (B, n, L)), ri(-2**31, 2**31 - 1, (B, n, L))
    term, role, vf = ri(0, 4, (B, n)), ri(0, 3, (B, n)), ri(-1, n, (B, n))
    timer, timeout = ri(0, 9, (B, n)), ri(1, 9, (B, n))
    log_len, commit = ri(0, L + 1, (B, n)), ri(0, 50, (B, n))
    match, nxt = ri(0, 256, (B, n, n), torch.uint8), \
        ri(0, 256, (B, n, n), torch.uint8)
    deliver, reset = coin(0.5, (B, n, n)), coin(0.3, (B, n))

    # KM. Sweep 0: node 10 voted for candidate 7 and hears it and the
    # lower candidate 3, both eligible: it grants 7 again.
    t0 = (term, role, vf, timer, timeout)
    term, role, vf, timer, timeout = (t.clone() for t in t0)
    deliver_m = deliver.clone()
    for node, (tm, rl, v) in {3: (5, 1, 3), 7: (5, 1, 7),
                              10: (5, 0, 7)}.items():
        term[0, node], role[0, node], vf[0, node] = tm, rl, v
        timer[0, node], timeout[0, node] = 0, 9
    log_len[0, (3, 7)], log_len[0, 10] = L, 0
    deliver_m[0, :, 10] = False
    deliver_m[0, (3, 7), 10] = True
    km = (cfg, seeds, 20, deliver_m, term, role, vf, timer, timeout, logt,
          log_len, match, nxt)
    got = raft.dense_elect_plain(*clone_args(km))
    require(int(got[2][0, 10]) == 7, "edge inputs: no re-grant")
    out["dense_elect"].append(km)
    term, role, vf, timer, timeout = t0

    # KN. Sweep 0: leader 5 (term 3) hears leader 9 (term 4), bumps and
    # copies its log from 0; follower 20 (term 3) hears only leader 5 and
    # copies 5's log from 0: as it was after P3a, not as 9 left it.
    term, role = term.clone(), role.clone()
    log_len, nxt, deliver_n = log_len.clone(), nxt.clone(), deliver.clone()
    role[0][role[0] == 2] = 0
    term[0, (5, 9, 20)] = torch.tensor([3, 4, 3], dtype=torch.int32,
                                       device=dev)
    role[0, (5, 9, 20)] = torch.tensor([2, 2, 0], dtype=torch.int32,
                                       device=dev)
    log_len[0, (5, 9)] = 60
    nxt[0, 9, 5], nxt[0, 5, 20] = 1, 1
    deliver_n[0, :, (5, 20)] = False
    deliver_n[0, 9, 5], deliver_n[0, 5, 20] = True, True
    kn = (cfg, seeds, 20, deliver_n, term, role, vf, timer, timeout, reset,
          logt, logv, log_len, commit, match, nxt)
    after = clone_args(kn)
    got = raft.dense_append_plain(*after)
    require(int(got[9][0, 5]) == 9 and int(got[9][0, 20]) == 5
            and bool(got[10][0, 5]) and bool(got[10][0, 20])
            and torch.equal(after[10][0, 20, :60], logt[0, 5, :60])
            and int(after[10][0, 20, 60]) == 3
            and not torch.equal(after[10][0, 5, :60], logt[0, 5, :60]),
            "edge inputs: no two leaders of different terms in one P3c")
    require(int(((got[9] >= 0) & ~got[10]).sum()) > 0,
            "edge inputs: no P3c reject")
    out["dense_append"].append(kn)

    # KO on random acks: bump3, decrements, matches above E, several
    # processing leaders in a sweep.
    ko = (cfg, seeds, deliver, coin(0.3, (B, n)), ri(-1, n, (B, n)),
          coin(0.5, (B, n)), ri(0, L + 1, (B, n)), logt, term, role, vf,
          timeout, commit, match, nxt, timer, reset)
    after = clone_args(ko)
    raft.dense_acks_commit_plain(*after)
    require(int((after[14] < nxt).sum()) > 0, "edge inputs: no decrement")
    require(int((ko[3] & (role == 2) & (after[9] == 0)).sum()) > 0,
            "edge inputs: no bump3")
    require(int(dense_ack_work(ko)["proc"].sum(1).max()) >= 2,
            "edge inputs: no sweep with several processing leaders")
    out["dense_acks_commit"].append(ko)
    # The same state at E = 0 and E = L, under its CRASH instance (down
    # nodes keep their timers) and under its BYZ instance (the acks of
    # nodes 924 and up withheld).
    for kw in (dict(max_entries=0), dict(max_entries=L),
               dict(n_byzantine=100, byz_mode="silent")):
        out["dense_acks_commit"].append(
            (dense_config("raft-1kx1k", **kw), *ko[1:]))
    out["dense_acks_commit"].append(
        (*ko, ri(0, 8, (B, n), torch.uint8)))
    out["dense_acks_commit"].append(global_ko_state(dev, gen))
    return out


def global_ko_state(dev, gen):
    """KO's arguments for one sweep of N = 29 100 nodes, whose ack-term
    maxima, flags and list (4 (2N + 1) bytes) exceed a block's shared
    memory and so select its GLOBAL instance: 40 leaders of terms 1-3,
    most nodes acking one of them, match rows over 0..255."""
    from consensus_tpu_torch.engines import raft
    n = 29_100
    cfg = dense_config("raft-1kx1k", n_nodes=n, n_sweeps=1)

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)
    leaders = torch.randperm(n, generator=gen, device=dev)[:40]
    ack_to = leaders[ri(0, 40, (1, n)).to(torch.int64)].to(torch.int32)
    ack_to[ri(0, 5, (1, n)) == 0] = -1
    term, role = ri(1, 4, (1, n)), ri(0, 2, (1, n))
    was_leader = torch.zeros((1, n), dtype=torch.bool, device=dev)
    role[0, leaders], was_leader[0, leaders] = 2, True
    deliver = torch.rand((1, n, n), generator=gen, device=dev) < 0.9
    ko = (cfg, torch.tensor([77], dtype=torch.uint32, device=dev), deliver,
          was_leader, ack_to, ri(0, 4, (1, n)) > 0, ri(0, L + 1, (1, n)),
          ri(1, 4, (1, n, L)), term, role, ri(-1, n, (1, n)),
          ri(1, 9, (1, n)), ri(0, 50, (1, n)),
          ri(0, 256, (1, n, n), torch.uint8),
          ri(0, 256, (1, n, n), torch.uint8), ri(0, 9, (1, n)),
          ri(0, 3, (1, n)) == 0)
    proc = dense_ack_work(ko)["proc"]
    require(4 * (2 * n + 1) > 232_448 and 2 <= int(proc.sum()) < 40,
            "edge inputs: no GLOBAL state with several processing and "
            "bumped leaders")
    after = clone_args(ko)
    raft.dense_acks_commit_plain(*after)
    require(bool((after[12] != ko[12]).any()), "edge inputs: the GLOBAL "
            "state advances no commit")
    return ko


def dense_ack_work(args) -> dict:
    """What KO must touch on its arguments: ``acks`` (nodes that ack),
    ``delivered`` (their delivered acks), the processing leaders
    ``proc`` ([B, N] bool), the delivered acks ``proc_acks`` to a
    processing leader, and ``bumped``, the leaders an acked term bumps."""
    (_, _, deliver, was_leader, ack_to, _, _, _, term, role, *_rest) = args
    n = term.shape[1]
    idx = torch.arange(n, device=term.device)
    ackm = (ack_to[:, :, None] == idx) & deliver                # [B, j, l]
    t_in3 = torch.where(ackm, term[:, :, None], 0).amax(1)
    still = was_leader & (role == 2)
    bumped = still & (t_in3 > term)
    proc = still & ~bumped
    return dict(acks=int((ack_to >= 0).sum()), delivered=int(ackm.sum()),
                proc=proc, proc_acks=int((ackm & proc[:, None, :]).sum()),
                bumped=int(bumped.sum()))


def dense_bound(name: str, args) -> tuple[float, str]:
    """The least time of dense kernel ``name``'s work on ``args``: the
    bytes it must move and the 32-bit operations it must do for these
    inputs (see each source's note)."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.engines import raft
    if name == "delivery":
        seed, r, n, _, part = args[:5]
        b = seed.shape[0]
        active = int((rng.random_u32_plain(seed, rng.STREAM_PARTITION, r, 0,
                                           0) < part).sum())
        draws = b + active * n if part else 0
        return bound(b * n * n + 4 * b,
                     EDGE_OPS * b * n * n + THREEFRY_OPS * draws)
    if name == "dense_elect":
        (_, _, _, _, term, role, vf, timer, timeout, *_rest) = args
        b, n = term.shape
        got = raft.dense_elect_plain(*clone_args(args))
        new = (role != 2) & (timer >= timeout)
        cand = (role == 1) | new
        pairs = int(cand.sum()) * n             # request bytes
        idx = torch.arange(n, device=term.device)
        granted = int(((got[2] >= 0) & (got[2] != idx) & got[5]).sum())
        won = int((cand & (got[1] == 2)).sum())
        bumped = int((got[0] > term + new.to(torch.int32)).sum())
        return bound(49 * b * n + pairs + granted + 2 * n * won,
                     20 * b * n + 10 * pairs
                     + THREEFRY_OPS * (int(new.sum()) + bumped))
    if name == "dense_append":
        (cfg, _, _, _, term, role, _, _, _, _, _, _, log_len, _, _,
         nxt) = args
        b, n = term.shape
        got = raft.dense_append_plain(*clone_args(args))
        lead = role == 2
        app = int((lead & (log_len < min(cfg.max_entries, L))).sum())
        pairs = int(lead.sum()) * n             # heartbeat bytes
        has_l, applied = got[9] >= 0, got[10]
        ls = got[9].clamp(min=0).to(torch.int64)
        prev = nxt.gather(1, ls[:, None, :])[:, 0].to(torch.int64) - 1
        copied = int(torch.where(applied, (got[6] - prev.clamp(min=0))
                                 .clamp(min=0), 0).sum())
        bumped = int((got[0] > term).sum())
        return bound(70 * b * n + pairs + 9 * int(has_l.sum()) + 9 * app
                     + 16 * copied,
                     30 * b * n + 8 * pairs + THREEFRY_OPS * (app + bumped))
    work = dense_ack_work(args)
    b, n = args[8].shape
    rows = int(work["proc"].sum())
    return bound(18 * b * n + work["delivered"] + 7 * work["proc_acks"]
                 + n * rows,
                 10 * b * n + 8 * n * rows + THREEFRY_OPS * work["bumped"])


def check_dense_kernels(dev, gen) -> list[dict]:
    """KL-KO against their plain versions on the rounds DENSE_ROUNDS of
    raft-1kx1k and raft-5node and on the edge inputs; times and bounds on
    raft-1kx1k's round with a leader in every sweep."""
    from consensus_tpu_torch.engines import raft
    real = {}
    for name, rounds in DENSE_ROUNDS.items():
        for r, got in capture_dense_inputs(dense_config(name),
                                           rounds).items():
            real[name, r] = got
    for name, (first, later) in DENSE_ROUNDS.items():
        won = raft.dense_elect_plain(*clone_args(
            real[name, first]["dense_elect"]))[1] == 2
        require(bool(won.any()), f"{name} round {first}: no election")
        lead = real[name, later]["dense_append"][5] == 2
        require(bool(lead.any(1).all()),
                f"{name} round {later}: a sweep without a leader")
    edges = dense_edge_inputs(dev, gen)
    timed = real["raft-1kx1k", DENSE_ROUNDS["raft-1kx1k"][1]]
    rows = []
    for name in DENSE:
        err = max(max_abs_err(run_pair(name, args)) for args in
                  [got[name] for got in real.values()] + edges[name])
        args, mod = timed[name], kernel_module(name)
        library = None
        if name == "dense_acks_commit":
            # One torch.kthvalue over the processing leaders' match rows.
            match, n = args[13], args[8].shape[1]
            leader_rows = match[dense_ack_work(args)["proc"]]
            library = device_ms(
                lambda m: torch.kthvalue(m, n - (n // 2 + 1) + 1, dim=1),
                (leader_rows,))
        rows.append(dict(name=name, route="cuda",
                         source=f"consensus_tpu_torch/csrc/{name}.cu",
                         replaces=DENSE_REPLACES[name], max_abs_err=err,
                         ms=device_ms(getattr(mod, name), args),
                         plain_ms=plain_time(getattr(mod, name + "_plain"),
                                             args),
                         bound=dense_bound(name, args), library_ms=library))
    return rows


# --- phase 3, continued: the dense PBFT round's kernels KQ-KS, and KP --------

PBFT = ("pbft_view_preprepare", "pbft_tally", "pbft_decide")
# The kernels that no flat run of the capped engine launches (KAH runs only
# under SPEC §6c, KAI only in a PBFT round under it, KAJ only in a HotStuff
# round under §6c or §B, KAL only under the §9 switch, KAM and KAN only in
# a PBFT round under it).
NOT_CAPPED = DENSE + ("dense_telemetry",) + PBFT + (
    "bcast_view_preprepare", "bcast_tally", "bcast_decide", "dpos_schedule",
    "dpos_round", "paxos_promise", "paxos_accept_learn", "pbft_telemetry",
    "dpos_telemetry", "paxos_telemetry", "hotstuff_propose", "hotstuff_vote",
    "hotstuff_learn", "hotstuff_extract", "crash_transition", "freeze_down",
    "hotstuff_prologue", "bcast_equiv_support", "agg_round",
    "switch_combine", "switch_receive")
PBFT_REPLACES = {
    "pbft_view_preprepare": "consensus_tpu/engines/pbft.py:209 pbft_round "
                            "P0-P3, consensus_tpu/engines/pbft.py:72 "
                            "_vth_select, consensus_tpu/engines/"
                            "pbft_sweep.py:184 pbft_round_padded P0-P3",
    "pbft_tally": "consensus_tpu/engines/pbft.py:308 pbft_round P4-P5, "
                  "consensus_tpu/engines/pbft_sweep.py:251 "
                  "pbft_round_padded P4-P5",
    "pbft_decide": "consensus_tpu/engines/pbft.py:344 pbft_round P6-P7, "
                   "consensus_tpu/engines/pbft_sweep.py:270 "
                   "pbft_round_padded P6-P7",
    "dense_telemetry": "consensus_tpu/engines/raft.py:539 raft_round "
                       "telemetry and flight tail"}
# BASELINE config 3 (benchmarks/run_benchmarks.py bench_pbft_fsweep and
# bench_pbft_oracle_ladder): 32 rounds, 32 slots, seed 3, drop 0.01, churn
# 0.001. The standalone rows' digests are benchmarks/RESULTS.json rows
# pbft-f1 ... pbft-f128 (the C++ oracle), the ladder's its row
# pbft-fsweep-one-program (fs = 1..128 in one program).
PBFT_ADV = dict(protocol="pbft", n_rounds=32, log_capacity=32, seed=3,
                drop_rate=0.01, churn_rate=0.001)
PBFT_DIGESTS = {
    1: "6574526de45414f6c577319247c8118850dd686b193f4b4725ebca27e3b1e1e1",
    2: "11f8b5c1cce786e7e28b96184c9fa3ecd0cb62c37cf94a5840daccb3da053474",
    4: "2419aad15ed59da3b203f37ad0e89d4e57aba647169296bfd22f29ef0ea7e559",
    8: "59faa4a6a2dda220984f47cfb077154ae170089b648ef9c12d39f4bfefb932f3",
    16: "2f6a05d573c85e6673c6adc8d2f207959dcb7ba985689579200c4963cf402a37",
    32: "17039179044a8d613082551e69436d1651e7cdefbe55968be11d963cabb0be76",
    64: "344b221526d80a31460524750da2009ab52bc36618bd13b6fd97b95265fae73c",
    128: "6c763cb1ffab1cbdd82f763bc73732ed00db7b03d523824de7d1f46d1cd3a252"}
LADDER = tuple(range(1, 129))
LADDER_DIGEST = \
    "a1148caa9408b84f05c0728251c9bb95dd7ceaee59f5700db7a39c3aa6c0f3fa"
# The rounds phase 3 records: an early one and one in the steady state.
# The kernels are timed on the ladder's second.
PBFT_ROUNDS = (3, 20)
# tests/test_pbft_sweep.py BASE's knobs (with its 24 rounds, 8 slots and
# seed 7): drops, partitions, churn and, once the slots are all committed,
# timeouts.
HOSTILE = dict(drop_rate=0.15, partition_rate=0.05, churn_rate=0.05)


def pbft_config(f: int, **kw):
    from consensus_tpu_torch.core.config import Config
    return Config(**{**PBFT_ADV, "f": f, "n_nodes": 3 * f + 1, **kw})


def ladder_config(fs=None, **kw):
    """The padded config of the f-ladder ``fs`` (default LADDER) on
    BASELINE config 3's knobs (changed by ``kw``)."""
    from consensus_tpu_torch.engines import pbft_sweep
    return pbft_sweep._fsweep_static(pbft_config(1, **kw),
                                     LADDER if fs is None else fs)[1]


def capture_pbft_inputs(cfg, rounds, rungs=None, device="cuda") -> dict:
    """{r: {wrapper: arguments}}: what each wrapper of the PBFT round
    (KQ-KS) receives in each round r of ``rounds`` of ``cfg``'s eager run
    (a ladder with ``rungs``) on ``device``, cloned as it arrives."""
    from consensus_tpu_torch.engines import pbft
    from consensus_tpu_torch.network import runner
    lanes = runner.device_lanes(cfg, rungs, device)
    st = pbft.pbft_init(cfg, lanes.pop("seed"))
    out, r0 = {}, 0
    for r in sorted(rounds):
        st = runner.advance(cfg, st, r0, r - r0, lanes=lanes)
        got = out[r] = {}
        with standing_in(pbft, PBFT, recording(got)):
            st = pbft.pbft_round(cfg, st, r, **lanes)
        require(set(got) == set(PBFT), f"round {r} skipped a phase")
        r0 = r + 1
    return out


def catch_ups(plain, args, view, timer) -> int:
    """The nodes that P1 moves when ``plain`` (KQ's or KT's plain version)
    runs on ``args``, whose round's views and timers are ``view`` and
    ``timer``: their view passed the churn step with their timer short of
    the timeout (P2 moves a view only from a timer at the timeout)."""
    from consensus_tpu_torch.engines import pbft
    cfg, seed, r = args[:3]
    ch = pbft.churn(seed, r, cfg.churn_cutoff)[:, None]
    out = plain(*clone_args(args))
    return int(((out[0] > view + ch.to(torch.int32))
                & (torch.where(ch, 0, timer) < cfg.view_timeout)).sum())


def pbft_edge_inputs(dev, gen) -> dict:
    """Inputs on which KQ-KS's rare paths fire: {name: [args]}. The
    rounds of a hostile ladder (fs = 1..32, BASE's drops, partitions and
    churn; its views stay equal, as in the JAX package, whose view-sync
    counters read 0 on such runs); random states over small alphabets on
    lanes of 49 padded nodes and 40 slots (two slot tiles, a ragged one),
    where views differ and catch-ups fire, and re-proposals meet prepared
    slots; and two
    built states: a primary that takes its own fresh slot while the
    others read its row, and a slot that node 1 adopts from node 5 while
    node 4, to which 1 (and not 5) is delivered, must not adopt from 1."""
    from consensus_tpu_torch.engines import pbft
    from consensus_tpu_torch.network import runner
    out = {name: [] for name in PBFT}

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def coin(p, shape):
        return torch.rand(shape, generator=gen, device=dev) < p

    fs = tuple(range(1, 33))
    cfg = ladder_config(fs, n_rounds=24, log_capacity=8, seed=7, **HOSTILE)
    for got in capture_pbft_inputs(cfg, (2, 5, 9, 17, 23), fs,
                                   dev).values():
        for name in PBFT:
            out[name].append(got[name])

    # Random states: lanes of 4..49 real nodes, views and values from
    # small alphabets.
    B, N, S = 16, 49, 40
    cfg = pbft_config(16, log_capacity=S, view_timeout=4, drop_rate=0.3,
                      partition_rate=0.3)
    seeds = torch.arange(21, 21 + B, dtype=torch.int64,
                         device=dev).to(torch.uint32)
    f = ri(1, 17, (B,))
    n_real = 3 * f + 1
    view = ri(0, 6, (B, N))
    pp_seen = coin(0.6, (B, N, S))
    pp_view = torch.where(pp_seen, torch.minimum(ri(0, 6, (B, N, S)),
                                                 view[:, :, None]), 0)
    pp_val = ri(0, 3, (B, N, S))
    prepared = pp_seen & coin(0.5, (B, N, S))
    committed = prepared & coin(0.4, (B, N, S))
    dval = torch.where(committed, pp_val, ri(0, 3, (B, N, S)))
    deliver = pbft.delivery(seeds, 7, N, cfg.drop_cutoff,
                            cfg.partition_cutoff)
    kq = (cfg, seeds, 7, deliver, n_real, f, view, ri(0, 9, (B, N)),
          pp_seen, pp_view, pp_val, prepared, committed)
    free = pbft.pbft_view_preprepare_plain(
        *kq[:11], torch.zeros_like(prepared), committed)
    got = pbft.pbft_view_preprepare_plain(*clone_args(kq))
    require(int((free[5] != got[5]).sum()) > 0,
            "edge inputs: no re-proposal refused for a prepared slot")
    require(catch_ups(pbft.pbft_view_preprepare_plain, kq, kq[6], kq[7]) > 0,
            "edge inputs: no catch-up")
    out["pbft_view_preprepare"].append(kq)
    out["pbft_tally"].append((deliver, n_real, f, got[3], got[5], prepared,
                              committed, dval))
    out["pbft_decide"].append((deliver, n_real, committed, dval,
                               committed & coin(0.5, (B, N, S)),
                               ri(0, 9, (B, N)), coin(0.3, (B, N))))

    # Built: primary 3 of view 3 has seen slots 0 and 1; every receiver,
    # itself included, takes 0, 1 and its fresh slot 2, and none slot 3.
    B, N, S = 2, 7, 8
    cfg = pbft_config(2, log_capacity=S, view_timeout=50, drop_rate=0.0,
                      churn_rate=0.0)
    z = torch.zeros((B, N, S), dtype=torch.int32, device=dev)
    seen = torch.zeros((B, N, S), dtype=torch.bool, device=dev)
    seen[:, 3, :2] = True
    deliver = ~torch.eye(N, dtype=torch.bool, device=dev).expand(B, N, N)
    lanes = torch.full((B,), N, dtype=torch.int32, device=dev)
    kq = (cfg, seeds[:B], 5, deliver.contiguous(), lanes, lanes * 0 + 2,
          torch.full((B, N), 3, dtype=torch.int32, device=dev),
          torch.zeros((B, N), dtype=torch.int32, device=dev), seen, z,
          ri(0, 3, (B, N, S)), torch.zeros_like(seen), torch.zeros_like(seen))
    got = pbft.pbft_view_preprepare_plain(*clone_args(kq))
    require(bool(got[3][:, :, :3].all()) and not bool(got[3][:, :, 3:].any()),
            "edge inputs: the primary's fresh slot was not slot 2 for all")
    out["pbft_view_preprepare"].append(kq)

    # Built: node 5 committed every slot and is delivered to node 1 only;
    # node 1 is delivered to node 4. Node 1 adopts; node 4 does not.
    deliver = torch.zeros((B, N, N), dtype=torch.bool, device=dev)
    deliver[:, 5, 1] = deliver[:, 1, 4] = True
    committed = torch.zeros((B, N, S), dtype=torch.bool, device=dev)
    committed[:, 5] = True
    dval = ri(-2**31, 2**31 - 1, (B, N, S))
    ks = (deliver, lanes, committed, dval, torch.zeros_like(committed),
          ri(0, 9, (B, N)), coin(0.5, (B, N)))
    got = pbft.pbft_decide_plain(*clone_args(ks))
    require(bool(got[0][:, 1].all()) and not bool(got[0][:, 4].any())
            and torch.equal(got[1][:, 1], dval[:, 5]),
            "edge inputs: no adoption, or an adoption read the same round")
    out["pbft_decide"].append(ks)
    return out


def capture_dense_telemetry_inputs(cfg, rounds, device="cuda") -> list:
    """The arguments KP receives in each round of ``rounds`` of ``cfg``'s
    eager run with telemetry and its flight recorder, cloned."""
    from consensus_tpu_torch.engines import raft
    from consensus_tpu_torch.network import runner
    telem, flight = runner.accumulators(cfg, device)
    st = runner.init(cfg, runner.make_seeds(cfg), device)
    out, r0 = [], 0
    for r in sorted(rounds):
        st = runner.advance(cfg, st, r0, r - r0, telem=telem, flight=flight)
        got = {}
        with standing_in(raft, ("dense_telemetry",), recording(got)):
            st = raft.raft_round(cfg, st, r, telem=telem, flight=flight)
        out.append(got["dense_telemetry"])
        r0 = r + 1
    return out


def dense_telemetry_edge_inputs(dev, gen) -> list:
    """KP on random flags, winners whose wait is <= 0, at the bucket
    edges and past them (and one that wraps), leaders whose lag is <= 0
    or >= 2^14, down nodes; accumulators that start nonzero; rounds 19
    (the ragged last window of 6) and 0, and the recorder off."""
    from consensus_tpu_torch.network import runner
    n = 1000
    cfg = dense_config("raft-1kx1k", n_nodes=n, n_rounds=20,
                       telemetry_window=6)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def coin(p, shape):
        return torch.rand(shape, generator=gen, device=dev) < p

    timer_in = ri(-5, 40, (B, n))
    timer_in[:, :8] = torch.tensor([-6, -1, 0, 2**14 - 2, 2**14 - 1, 2**14,
                                    2**20, 2**31 - 1], dtype=torch.int32)
    win = coin(0.05, (B, n))
    win[:, :8] = True
    commit_in = ri(0, 100, (B, n))
    t, (w, lat) = runner.accumulators(cfg, dev)
    t += ri(0, 1000, t.shape)
    w += ri(0, 1000, w.shape)
    lat += ri(0, 1000, lat.shape)
    kp = (win, timer_in, ri(-1, n, (B, n)), coin(0.5, (B, n)), commit_in,
          commit_in + ri(0, 3, (B, n)), ri(0, 3, (B, n)), ri(0, 2**16, (B, n)),
          coin(0.1, (B, n)))
    return [(cfg, r, *kp, *acc) for r, acc in ((19, (t, w, lat)),
                                               (0, (t, w, lat)), (19, (t,)))]


def order_walk(args) -> torch.Tensor:
    """[B, N]: how many senders KQ's P1 walks for each receiver on its
    arguments: in order of the post-P0 views (descending, ties by id) up
    to the (f+1)-th that counts (itself, or a real sender delivered to
    it), or all N."""
    from consensus_tpu_torch.engines import pbft
    (cfg, seed, r, deliver, n_real, f, view, *_rest) = args
    b, n = view.shape
    ch = pbft.churn(seed, r, cfg.churn_cutoff)[:, None]
    order = torch.sort(view + ch.to(torch.int32), dim=1, descending=True,
                       stable=True).indices
    eye = torch.eye(n, dtype=torch.bool, device=view.device)
    counted = (pbft.real_delivery(deliver, n_real) | eye).gather(
        1, order[:, :, None].expand(b, n, n))
    below = (counted.cumsum(1) < (f + 1)[:, None, None]).sum(1)
    return (below + 1).clamp(max=n)


def pbft_bound(name: str, args) -> tuple[float, str]:
    """The least time of kernel ``name``'s work (KP-KS) on ``args``: the
    bytes it must move and the 32-bit operations it must do for these
    inputs (see each source's note)."""
    from consensus_tpu_torch.engines import pbft, raft
    if name == "dense_telemetry":
        (_, _, win, _, _, ack_ok, _, _, role, _, down, *acc) = args
        nodes = win.numel()
        nbytes = 10 * nodes + 4 * (nodes - int(ack_ok.sum()))
        if len(acc) == 3:                       # w and lat given
            lead = role == raft.ROLE_L
            nbytes += (4 * nodes + int(lead.sum())
                       + 4 * int((lead & ~down).sum()) + 4 * int(win.sum()))
        return bound(nbytes, 10 * nodes)
    if name == "pbft_view_preprepare":
        pp_seen = args[8]
        nodes, pairs = pp_seen.shape[0] * pp_seen.shape[1], pp_seen.numel()
        walked = int(order_walk(args).sum())
        got = pbft.pbft_view_preprepare_plain(*clone_args(args))
        draws = int((got[3] & ~pp_seen).any(2).sum())
        return bound(17 * nodes + walked + 19 * pairs,
                     4 * walked + 10 * pairs + THREEFRY_OPS * draws)
    if name == "pbft_tally":
        (deliver, n_real, f, pp_seen, pp_val, prepared, committed,
         dval) = args
        b, n, s = pp_seen.shape
        prep4 = pbft.pbft_tally_plain(*clone_args(args))[0]
        real = pbft.real_nodes(n_real, n)[:, :, None]
        waiting = ((pp_seen & ~prepared & real).sum((1, 2))
                   + (prep4 & ~committed & real).sum((1, 2)))
        triples = int((waiting.to(torch.int64)
                       * n_real.to(torch.int64)).sum())
        edges = int((n_real.to(torch.int64) ** 2).sum())
        return bound(edges + 17 * pp_seen.numel(), 3 * triples)
    (deliver, n_real, committed, dval, committed_start, timer, reset) = args
    b, n, s = committed.shape
    # The senders each undecided (receiver, slot) walks: to its decider,
    # or all real senders.
    sent = (pbft.real_delivery(deliver, n_real)[..., None]
            & committed[:, :, None, :]).to(torch.uint8)   # [B, i, j, s]
    found = sent.amax(1).bool()
    first = sent.argmax(1)
    real = pbft.real_nodes(n_real, n)[:, :, None]
    search = real & ~committed
    walked = torch.where(found, first + 1,
                         n_real.to(torch.int64)[:, None, None])
    walked = torch.where(search, walked, 0)
    # Bytes: every tensor once. The walks re-read committed and dval,
    # already counted, and a receiver's delivery column down to its
    # farthest walk, each byte once.
    cols = int(walked.amax(2).sum())
    return bound(11 * committed.numel() + 9 * b * n + cols,
                 2 * int(walked.sum()))


def kthvalue_yardstick(args):
    """P1's statistic for KQ's arguments as one ``torch.kthvalue`` call:
    the [B, N, N] view matrix (delivered real senders' views, -1 else, own
    view on the diagonal) with f_max - f[b] rows of INT32_MAX appended to
    lane b, whose N-th smallest entry of each column is then the
    (f[b]+1)-th largest of the matrix's. Returns (fn, its input)."""
    from consensus_tpu_torch.engines import pbft
    (_, _, _, deliver, n_real, f, view, *_rest) = args
    b, n = view.shape
    eye = torch.eye(n, dtype=torch.bool, device=view.device)
    w = torch.where(pbft.real_delivery(deliver, n_real), view[:, :, None],
                    -1)
    w = torch.where(eye, view[:, None, :], w)
    f_max = int(f.max())
    pad = torch.arange(f_max, device=view.device)[None, :] \
        >= (f_max - f)[:, None]                 # [B, f_max]
    top = torch.where(pad, -1, 2**31 - 1).to(torch.int32)
    w = torch.cat([w, top[:, :, None].expand(b, f_max, n)], 1)
    return (lambda m: torch.kthvalue(m, n, dim=1)), (w.contiguous(),)


def check_pbft_kernels(dev, gen) -> list[dict]:
    """KQ-KS against their plain versions on rounds PBFT_ROUNDS of the
    fs = 1..128 ladder and of standalone pbft-f128 and on the edge inputs;
    KP on raft-1kx1k's rounds 3 and 20 with telemetry and on its edge
    inputs. Times and bounds on the ladder's round 20 and raft-1kx1k's
    round 20."""
    from consensus_tpu_torch.engines import pbft, raft
    real = list(capture_pbft_inputs(ladder_config(), PBFT_ROUNDS,
                                    LADDER).values())
    timed = real[-1]
    real += capture_pbft_inputs(pbft_config(128), PBFT_ROUNDS).values()
    edges = pbft_edge_inputs(dev, gen)
    rows = []
    for name in PBFT:
        err = max(max_abs_err(run_pair(name, args)) for args in
                  [got[name] for got in real] + edges[name]
                  + flagged(name, edges[name]))
        args = timed[name]
        library = None
        if name == "pbft_view_preprepare":
            library = device_ms(*kthvalue_yardstick(args))
        rows.append(dict(name=name, route="cuda",
                         source=f"consensus_tpu_torch/csrc/{name}.cu",
                         replaces=PBFT_REPLACES[name], max_abs_err=err,
                         ms=device_ms(getattr(pbft, name), args),
                         plain_ms=plain_time(getattr(pbft, name + "_plain"),
                                             args),
                         bound=pbft_bound(name, args), library_ms=library))
    kp = capture_dense_telemetry_inputs(
        dense_config("raft-1kx1k", telemetry_window=WINDOW),
        DENSE_ROUNDS["raft-1kx1k"])
    err = max(max_abs_err(run_pair("dense_telemetry", args))
              for args in kp + dense_telemetry_edge_inputs(dev, gen))
    rows.append(dict(name="dense_telemetry", route="cuda",
                     source="consensus_tpu_torch/csrc/dense_telemetry.cu",
                     replaces=PBFT_REPLACES["dense_telemetry"],
                     max_abs_err=err,
                     ms=device_ms(raft.dense_telemetry, kp[-1]),
                     plain_ms=plain_time(raft.dense_telemetry_plain, kp[-1]),
                     bound=pbft_bound("dense_telemetry", kp[-1]),
                     library_ms=None))
    return rows


# --- phase 3, continued: the §6b broadcast PBFT round's kernels KT-KV --------

BCAST = ("bcast_view_preprepare", "bcast_tally", "bcast_decide")
BCAST_REPLACES = {
    "bcast_view_preprepare": "consensus_tpu/engines/pbft_bcast.py:360 "
                             "pbft_bcast_round P0-P3, consensus_tpu/engines/"
                             "pbft_bcast.py:108 _kth_largest, consensus_tpu/"
                             "engines/pbft_sweep.py:289 "
                             "pbft_bcast_round_padded P0-P3",
    "bcast_tally": "consensus_tpu/engines/pbft_bcast.py:233 "
                   "_aggregate_tallies (:147 _SortedRuns, :197 _top_runs, "
                   ":221 _table_count), consensus_tpu/engines/"
                   "pbft_sweep.py:452 pbft_bcast_round_padded P4-P5",
    "bcast_decide": "consensus_tpu/engines/pbft_bcast.py:630 "
                    "pbft_bcast_round P6-P7, consensus_tpu/engines/"
                    "pbft_sweep.py:460 pbft_bcast_round_padded P6-P7"}
# pbft-100k-bcast (benchmarks/run_benchmarks.py CONFIGS): N = 100 000, f =
# 33 333, 64 rounds, 8 sweeps, 16 slots, seed 7, drop 0.01, churn 0.001.
# Its anchor is the benchmarks/RESULTS.json row (the JAX package and the
# C++ oracle).
BCAST_FLAGSHIP = dict(protocol="pbft", fault_model="bcast", f=33_333,
                      n_nodes=100_000, n_rounds=64, n_sweeps=8,
                      log_capacity=16, seed=7, drop_rate=0.01,
                      churn_rate=0.001)
BCAST_DIGEST = \
    "6c6395aa5c0d35c528edbab6912298e8f44fcf5457e4b712b8cad8702bf6a47b"
# The three bcast ladders' anchors, made by the JAX package on the CPU:
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   from consensus_tpu import Config
#   from consensus_tpu.core import serialize
#   from consensus_tpu.engines import pbft_sweep
#   adv = dict(protocol="pbft", fault_model="bcast", f=1, n_nodes=4)
#   calm = dict(drop_rate=0.01, churn_rate=0.001)
#   hostile = dict(drop_rate=0.15, partition_rate=0.05, churn_rate=0.05)
#   for kw, fs in ((dict(n_rounds=32, log_capacity=32, seed=3, **calm),
#                   range(1, 129)),
#                  (dict(n_rounds=64, log_capacity=16, seed=7, **calm),
#                   (8333, 16666, 33333)),
#                  (dict(n_rounds=24, log_capacity=8, seed=7, **hostile),
#                   range(1, 33))):
#       out = pbft_sweep.pbft_fsweep_run(Config(**adv, **kw), fs)
#       print(serialize.digest(pbft_sweep.fsweep_payload(out)),
#             [serialize.digest(p) for p in pbft_sweep.rung_payloads(out)])
#   EOF
#
# tests/test_torch_pbft_bcast.py test_bcast_ladder_anchor_is_jax makes the
# first and the third again with the JAX package and holds them to these.
# BASELINE config 3's knobs under fault_model="bcast", fs = 1..128. At
# these calm knobs the dense round gives the same digest (LADDER_DIGEST):
# under both fault models every rung commits every slot with the same
# values, so this anchor tells the §6b round from no round that commits
# everything.
BCAST_LADDER_DIGEST = \
    "a1148caa9408b84f05c0728251c9bb95dd7ceaee59f5700db7a39c3aa6c0f3fa"
# The partitioned hostile bcast ladder (tests/test_pbft_sweep.py BASE's
# knobs under fault_model="bcast"), fs = 1..32, whose digest tells the §6b
# round from the dense one (which gives 304de041…e81aa9d there).
HOSTILE_BCAST_FS = tuple(range(1, 33))
HOSTILE_BCAST_DIGEST = \
    "a45946363daae5d61503e5309ceacc09495787725ed70bf54bbf220b231a23d2"
# The full-width ladder (tools/hlocheck/registry.py FSWEEP_BCAST_FS: N_pad
# = 100 000, 16 slots, 64 rounds, seed 7, one sweep a rung) and its rungs.
WIDE_RUNGS = (8333, 16666, 33333)
WIDE_DIGEST = \
    "ddbc5fe6c5827da2bdf8d47ce2fc3816d981fb52bb69980cae26e9176085d313"
WIDE_RUNG_DIGESTS = (
    "6a8da635f939ef0f5a2cc5b149f82d7aad01f45461206f29ae60dfc41e19f6e0",
    "2e2af0cf255368f89d8c7cf1c8c5d2be9719a4645aaa55ec3e214d392d6a1752",
    "181f27e424739806cefc92b80a8d96130df2ac96e45ab50895c0fdd36d82956f")
# The rounds phase 3 records: an early one and one in the steady state.
# The kernels are timed on the flagship's second.
BCAST_ROUNDS = (3, 20)


def bcast_config(**kw):
    """pbft-100k-bcast, changed by ``kw``."""
    from consensus_tpu_torch.core.config import Config
    return Config(**{**BCAST_FLAGSHIP, **kw})


def wide_base(**kw):
    """The full-width ladder's base config: pbft-100k-bcast's knobs, one
    sweep a rung (``f`` and ``n_nodes`` are the ladder's)."""
    return bcast_config(**{"f": 1, "n_nodes": 4, "n_sweeps": 1, **kw})


def wide_config():
    """The padded config of the full-width ladder WIDE_RUNGS."""
    from consensus_tpu_torch.engines import pbft_sweep
    return pbft_sweep._fsweep_static(wide_base(), WIDE_RUNGS)[1]


def capture_bcast_inputs(cfg, rounds, rungs=None, device="cuda") -> dict:
    """{r: {wrapper: arguments}}: what each wrapper of the §6b round
    (KT-KV) receives in each round r of ``rounds`` of ``cfg``'s eager run
    (a ladder with ``rungs``) on ``device``, cloned as it arrives."""
    from consensus_tpu_torch.engines import pbft
    from consensus_tpu_torch.engines import pbft_bcast as pb
    from consensus_tpu_torch.network import runner
    lanes = runner.device_lanes(cfg, rungs, device)
    st = pbft.pbft_init(cfg, lanes.pop("seed"))
    m = pb.table_cap(cfg, rungs)
    out, r0 = {}, 0
    for r in sorted(rounds):
        st = runner.advance(cfg, st, r0, r - r0, lanes=lanes, rungs=rungs)
        got = out[r] = {}
        with standing_in(pb, BCAST, recording(got)):
            st = pb.pbft_bcast_round(cfg, st, r, m=m, **lanes)
        require(set(got) == set(BCAST), f"round {r} skipped a phase")
        r0 = r + 1
    return out


def bcast_edge_inputs(dev, gen) -> dict:
    """Inputs on which KT-KV's rare paths fire: {name: [args]}. The
    rounds of a partitioned hostile bcast ladder (fs = 1..32, BASE's
    drops, partitions and churn) and of a standalone hostile run at f = 1;
    the rounds of BASELINE config 3's bcast ladder; random states on
    lanes of up to 97 padded nodes and 40 slots (a ragged last warp),
    f = 1 lanes among them (m = 2), views past the search's top and below
    0, where catch-ups fire; tally inputs where one value of each (lane,
    slot) has 2f - 1 to 2f + 1 senders of a side, the sides unbalanced so
    that either side can reach a quorum; and N = 1 (f = 0); and KV's
    inputs over four of its search tiles (the last ragged) with sparse
    commits, slots no node committed, a side whose only decider is its
    last honest node, S = 16 and 24, CRASH and BYZ; and S = 6 160, past
    the shared memory of its adopt launch."""
    from consensus_tpu_torch.engines import pbft_bcast as pb
    out = {name: [] for name in BCAST}

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def coin(p, shape):
        return torch.rand(shape, generator=gen, device=dev) < p

    fs = tuple(range(1, 33))
    sides = 0
    for cfg, rungs, rounds in (
            (ladder_config(fs, fault_model="bcast", n_rounds=24,
                           log_capacity=8, seed=7, **HOSTILE), fs,
             (2, 5, 9, 17, 23)),
            (pbft_config(1, fault_model="bcast", n_rounds=24,
                         log_capacity=8, seed=7, n_sweeps=8, **HOSTILE),
             None, (2, 9, 17, 23)),
            (ladder_config(fault_model="bcast"), LADDER, BCAST_ROUNDS)):
        for got in capture_bcast_inputs(cfg, rounds, rungs, dev).values():
            sides += int((got["bcast_tally"][3] & 2).bool().sum())
            for name in BCAST:
                out[name].append(got[name])
    require(sides > 0, "edge inputs: no partition was active")

    # Random states: lanes of 1..97 real nodes (f = 0..32, f = 1 on two).
    B, N, S = 16, 97, 40
    cfg = pbft_config(32, fault_model="bcast", log_capacity=S,
                      view_timeout=4, drop_rate=0.2, partition_rate=0.6)
    vmax = 2 * cfg.n_rounds + 2
    seeds = torch.arange(21, 21 + B, dtype=torch.int64,
                         device=dev).to(torch.uint32)
    f = ri(0, 33, (B,))
    f[:2] = 1
    n_real = 3 * f + 1
    view = ri(-2, vmax + 9, (B, N))
    view[:, : N // 2] = ri(0, 4, (B, N // 2))
    pp_seen = coin(0.6, (B, N, S))
    pp_view = torch.where(pp_seen, torch.minimum(ri(-1, vmax, (B, N, S)),
                                                 view[:, :, None]), 0)
    pp_val = ri(0, 3, (B, N, S))
    prepared = (pp_seen | coin(0.05, (B, N, S))) & coin(0.5, (B, N, S))
    committed = prepared & coin(0.4, (B, N, S))
    dval = torch.where(committed, pp_val, ri(0, 3, (B, N, S)))
    kt = (cfg, seeds, 7, n_real, f, view, ri(0, 9, (B, N)), pp_seen,
          pp_view, pp_val, prepared, committed)
    require(catch_ups(pb.bcast_view_preprepare_plain, kt, kt[5], kt[6]) > 0,
            "edge inputs: no catch-up")
    got = pb.bcast_view_preprepare_plain(*clone_args(kt))
    out["bcast_view_preprepare"].append(kt)
    out["bcast_tally"].append((2, n_real, f, got[6], got[3], got[5],
                               prepared, committed, dval))
    out["bcast_decide"].append((got[6], committed, dval,
                                committed & coin(0.5, (B, N, S)),
                                ri(0, 9, (B, N)), coin(0.3, (B, N))))

    # Tallies at the threshold: lanes of f = 1..8 whose senders lie 95:5
    # on side 0 or on side 1 by lane; in each (lane, slot) value 7 for
    # exactly 2f - 1, 2f or 2f + 1 senders of the larger side and value 7
    # or 8 for every other node; every real node has seen every slot.
    f = ri(1, 9, (B,))
    f[:2] = 1
    n_real = 3 * f + 1
    idx = torch.arange(N, device=dev)
    real = idx[None, :] < n_real[:, None]
    hb = real & coin(0.95, (B, N))
    big = (torch.arange(B, device=dev) % 2).bool()            # its side
    side = coin(0.95, (B, N)) == big[:, None]
    bits = (hb.to(torch.uint8) | (side.to(torch.uint8) << 1)).contiguous()
    counted = (hb & (side == big[:, None]))[:, :, None].expand(B, N, S)
    rank = torch.rand((B, N, S), generator=gen, device=dev).masked_fill(
        ~counted, 2.0).argsort(1).argsort(1)
    k = (2 * f - 1)[:, None] + ri(0, 3, (B, S))               # [B, S]
    pp_val = torch.where(counted, torch.where(rank < k[:, None, :], 7, 8),
                         7 + ri(0, 2, (B, N, S))).to(torch.int32)
    pp_seen = real[:, :, None].expand(B, N, S).contiguous()
    prepared = pp_seen & coin(0.3, (B, N, S))
    committed = prepared & coin(0.2, (B, N, S))
    ku = (2, n_real, f, bits, pp_seen, pp_val, prepared, committed,
          ri(0, 9, (B, N, S)))
    hit = pb.bcast_tally_plain(*clone_args(ku))[0] & ~prepared
    missed = pp_seen & ~prepared & ~hit & (pp_val == 7)
    require(bool(hit.any()) and bool(missed.any()),
            "edge inputs: no prepare at the threshold, or no miss")
    out["bcast_tally"].append(ku)

    # N = 1: f = 0, the single node is its own quorum.
    cfg1 = pbft_config(0, fault_model="bcast", log_capacity=8)
    z = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    one = torch.ones((4,), dtype=torch.int32, device=dev)
    seen1 = coin(0.5, (4, 1, 8))
    kt1 = (cfg1, seeds[:4], 3, one, one * 0, ri(0, 5, (4, 1)), z, seen1,
           torch.zeros((4, 1, 8), dtype=torch.int32, device=dev),
           ri(0, 3, (4, 1, 8)), seen1 & coin(0.5, (4, 1, 8)),
           torch.zeros((4, 1, 8), dtype=torch.bool, device=dev))
    out["bcast_view_preprepare"].append(kt1)
    got = pb.bcast_view_preprepare_plain(*clone_args(kt1))
    out["bcast_tally"].append((1, one, one * 0, got[6], got[3], got[5],
                               kt1[10], kt1[11], ri(0, 3, (4, 1, 8))))

    # P6-P7 (KV) over four of its search tiles, the last ragged: sparse
    # commits (deciders deep in a lane), slots no node committed, lane 0's
    # side 1 with one broadcasting node, its last honest one, that commits
    # every slot; S = 16 and 24 (not a multiple of 16), flat, CRASH (bit
    # 2) and BYZ (per-lane n_real, 5 byzantine nodes).
    n2 = 3 * pb.DECIDE_TILE + 5
    for s2, crash, nb in ((16, False, 0), (24, True, 0), (16, True, 5),
                          (24, False, 5)):
        last = n2 - 1 - nb
        bits = (coin(0.7, (4, n2)).to(torch.uint8)
                | (coin(0.4, (4, n2)).to(torch.uint8) << 1)
                | (coin(0.2, (4, n2)).to(torch.uint8) << 2))
        side1 = (bits[0] & 2) != 0
        bits[0] = torch.where(side1, bits[0] & 0xFE, bits[0])
        bits[0, last] = 3
        committed = coin(0.002, (4, n2, s2))
        committed[:, :, s2 // 2:] = False
        committed[0, last] = True
        n_real = ri(n2 // 2, n2 + 1, (4,))
        n_real[0] = n2
        kv = (bits, committed, ri(-5, 5, (4, n2, s2)),
              committed & coin(0.7, (4, n2, s2)),
              ri(-2**31, 2**31 - 1, (4, n2)), coin(0.3, (4, n2)), crash,
              (n_real, nb) if nb else None)
        got = pb.bcast_decide_plain(*clone_args(kv))
        takes = side1 & ~(crash & ((bits[0] & 4) != 0))
        require(bool(got[0][0][takes].all()) and bool(
            (got[1][0][takes & ~committed[0, :, 0]][:, 0]
             == kv[2][0, last, 0]).all()),
                "edge inputs: lane 0's side 1 did not adopt its last node's")
        require(not bool(got[0][:, :, s2 // 2:].all()),
                "edge inputs: every slot found a decider")
        out["bcast_decide"].append(kv)
    # S = 6 160: the lane minima no longer fit launch 2's shared memory and
    # are read from the tiles' table at each use (BYZ, 16-byte rows).
    n3, s3 = 40, 6_160
    committed = coin(0.3, (2, n3, s3))
    out["bcast_decide"].append((
        (coin(0.8, (2, n3)).to(torch.uint8)
         | (coin(0.5, (2, n3)).to(torch.uint8) << 1)), committed,
        ri(-5, 5, (2, n3, s3)), committed & coin(0.5, (2, n3, s3)),
        ri(0, 9, (2, n3)), coin(0.3, (2, n3)), False,
        (torch.tensor([n3, 31], dtype=torch.int32, device=dev), 3)))
    return out


def bcast_bound(name: str, args) -> tuple[float, str]:
    """The least time of kernel ``name``'s work (KT-KV) on ``args``: the
    bytes it must move and the 32-bit operations it must do for these
    inputs (see each source's note)."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.engines import pbft_bcast as pb
    if name == "bcast_view_preprepare":
        (cfg, seed, r, n_real, f, view, timer, pp_seen, pp_view, pp_val,
         prepared, committed) = args
        b, n, s = pp_seen.shape
        got = pb.bcast_view_preprepare_plain(*clone_args(args))
        prim = got[0].remainder(n_real[:, None]).to(torch.int64)
        rows = sum(int(torch.unique(p).numel()) for p in prim)
        accept = (got[3] != pp_seen) | (got[4] != pp_view) | \
            (got[5] != pp_val)
        seen_prim = pp_seen.gather(1, prim[:, :, None].expand(b, n, s))
        draws = int((accept & ~seen_prim).sum())
        active = int((rng.random_u32_plain(seed, rng.STREAM_PARTITION, r, 0,
                                           0) < cfg.partition_cutoff).sum())
        return bound(18 * b * n + 19 * b * n * s + rows * s,
                     EDGE_OPS * b * n + THREEFRY_OPS * (active * n + draws))
    if name == "bcast_tally":
        bits, pp_seen = args[3], args[4]
        return bound(bits.numel() + 17 * pp_seen.numel(), 0)
    bits, committed = args[0], args[1]
    return bound(10 * bits.numel() + 11 * committed.numel(), 0)


def bcast_yardsticks(args_kt, args_kv):
    """One PyTorch call a kernel where one computes the same function, on
    the timed inputs: ``torch.kthvalue`` for KT's statistic (the (f+1)-th
    largest sender view + 1 of each lane and side: the (N - f)-th smallest
    of a [B, 2, N] matrix of them, 0 for the rest), and ``torch.amin`` for
    KV's decider rows (the least id of each (lane, side, slot), over a [B,
    2, N, S] matrix of committed senders' ids, N for the rest). Returns
    ((fn, args), (fn, args))."""
    from consensus_tpu_torch.engines import pbft_bcast as pb
    (cfg, seed, r, n_real, f, view, *_rest) = args_kt
    b, n = view.shape
    require(bool((f == f[0]).all()), "the yardstick takes one f a run")
    bits = pb.node_bits(cfg, seed, r, n_real)
    hb, side = pb.hb_side(bits)
    ch = pb.churn(seed, r, cfg.churn_cutoff)[:, None].to(torch.int32)
    w = torch.stack([torch.where(hb & (side == k), view + ch + 1, 0)
                     for k in (0, 1)], 1).contiguous()
    kth = (lambda m: torch.kthvalue(m, n - int(f[0]), dim=2)), (w,)
    (bits, committed, *_rest) = args_kv
    hb, side = pb.hb_side(bits)
    idx = torch.arange(n, dtype=torch.int32, device=view.device)
    src = torch.stack([torch.where(
        (hb & (side == k))[:, :, None] & committed, idx[:, None], n)
        for k in (0, 1)], 1).contiguous()
    amin = (lambda m: torch.amin(m, dim=2)), (src,)
    return kth, amin


def check_bcast_kernels(dev, gen) -> list[dict]:
    """KT-KV against their plain versions on rounds BCAST_ROUNDS of
    pbft-100k-bcast and of the full-width ladder, and on the edge inputs.
    Times and bounds on the flagship's round 20."""
    from consensus_tpu_torch.engines import pbft_bcast as pb
    real = list(capture_bcast_inputs(bcast_config(), BCAST_ROUNDS).values())
    timed = real[-1]
    real += capture_bcast_inputs(wide_config(), BCAST_ROUNDS,
                                 WIDE_RUNGS).values()
    edges = bcast_edge_inputs(dev, gen)
    kth, amin = bcast_yardsticks(timed["bcast_view_preprepare"],
                                 timed["bcast_decide"])
    library = {"bcast_view_preprepare": kth, "bcast_decide": amin}
    rows = []
    for name in BCAST:
        err = max(max_abs_err(run_pair(name, args)) for args in
                  [got[name] for got in real] + edges[name]
                  + flagged(name, edges[name]))
        args = timed[name]
        lib = library.get(name)
        rows.append(dict(name=name, route="cuda",
                         source=f"consensus_tpu_torch/csrc/{name}.cu",
                         replaces=BCAST_REPLACES[name], max_abs_err=err,
                         ms=device_ms(getattr(pb, name), args),
                         plain_ms=plain_time(getattr(pb, name + "_plain"),
                                             args),
                         bound=bcast_bound(name, args),
                         library_ms=None if lib is None else device_ms(*lib)))
    return rows


# --- phase 3, continued: the DPoS and Paxos rounds' kernels KW-KZ ------------

DPOS = ("dpos_schedule", "dpos_round")
PAXOS = ("paxos_promise", "paxos_accept_learn")
# dpos-100k and paxos-10kx10k (benchmarks/run_benchmarks.py CONFIGS, BASELINE
# configs 5 and 4), and their anchors: the benchmarks/RESULTS.json rows, on
# which the JAX package and the C++ oracle agree.
DPOS_FLAGSHIP = dict(protocol="dpos", n_nodes=100_000, n_rounds=256,
                     n_sweeps=1, log_capacity=256, n_candidates=1024,
                     n_producers=21, epoch_len=32, seed=5, drop_rate=0.01,
                     churn_rate=0.001)
DPOS_DIGEST = \
    "bc791cf44cc16bfab72ab7f013847dcc0073519d35e4f685a2ad6885946fd1a5"
PAXOS_FLAGSHIP = dict(protocol="paxos", n_nodes=10_000, n_rounds=16,
                      n_sweeps=1, log_capacity=10_000, seed=4,
                      drop_rate=0.01, churn_rate=0.001)
PAXOS_DIGEST = \
    "4d64c2179c317a36b5330e5da3fe95842afbdde0a7af25714aedc6f27a2b41fa"
# The hostile runs and their anchors, made by the JAX package on the CPU:
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   for kw in (DPOS_HOSTILE, PAXOS_HOSTILE):   # as below
#       print(simulator.run(Config(**kw), warmup=False).digest)
#   EOF
#
# tests/test_torch_dpos.py and tests/test_torch_paxos.py make them again.
# The DPoS run crosses into uint16 on both chain fields (300 rounds, 300
# candidates), fills every chain (128 slots) and partitions.
DPOS_HOSTILE = dict(protocol="dpos", n_nodes=20_000, n_candidates=300,
                    n_producers=21, epoch_len=16, n_rounds=300,
                    log_capacity=128, drop_rate=0.2, partition_rate=0.1,
                    churn_rate=0.05, n_sweeps=3, seed=5)
DPOS_HOSTILE_DIGEST = \
    "48f252feabb55aaa46ae894c881f8368a4cd4196e4be5409e31c977f29a9eb36"
PAXOS_HOSTILE = dict(protocol="paxos", n_nodes=1000, log_capacity=1000,
                     n_proposers=300, drop_rate=0.1, partition_rate=0.2,
                     churn_rate=0.05, n_rounds=32, n_sweeps=2, seed=4)
PAXOS_HOSTILE_DIGEST = \
    "8da7243eedc331d9c79dcf3873a46e901c7e700e03b53c170c87d29e3e07293a"


# LIB of dpos-100k's chains (simulator.run's extras["lib"], [1, 100 000]
# int64): the SHA-256 of its little-endian bytes as the JAX package gives
# it on the CPU (min 228, max 240, sum 23 744 989):
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import hashlib, numpy as np
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   res = simulator.run(Config(**DPOS_FLAGSHIP), warmup=False)  # as above
#   lib = np.asarray(res.extras["lib"], "<i8")
#   print(hashlib.sha256(lib.tobytes()).hexdigest())
#   EOF
DPOS_LIB_SHA256 = \
    "5b53a3780e65512aa99fa0b04ed51193756ed4248f4436824ad5a6a686a17c07"
DPOS_REPLACES = {
    "dpos_schedule": "consensus_tpu/engines/dpos.py:53 dpos_schedule",
    "dpos_round": "consensus_tpu/engines/dpos.py:117 dpos_round, "
                  "consensus_tpu/engines/dpos.py:73 _producer_delivery"}
PAXOS_REPLACES = {
    "paxos_promise": "consensus_tpu/engines/paxos.py:93 paxos_round "
                     "phases 1-2 (lines 93-180)",
    "paxos_accept_learn": "consensus_tpu/engines/paxos.py:93 paxos_round "
                          "phases 3-6 (lines 182-250)"}
# The rounds phase 3 records: dpos-100k's first, the last of its first
# epoch, the first of the second, and one whose chains are near full (the
# kernels are timed on it); paxos-10kx10k's first two and its last (timed).
DPOS_ROUNDS = (0, 31, 32, 200)
PAXOS_ROUNDS = (0, 1, 15)


def protocol_config(base: dict, **kw):
    """The config ``base`` (a dict of Config fields), changed by ``kw``."""
    from consensus_tpu_torch.core.config import Config
    return Config(**{**base, **kw})


def capture_round_inputs(cfg, rounds, names, device="cuda") -> dict:
    """{r: {wrapper: arguments}}: what each wrapper ``names`` of ``cfg``'s
    engine round receives in each round r of ``rounds`` of its eager run on
    ``device``, cloned as it arrives."""
    from consensus_tpu_torch.network import runner
    eng = runner.engine(cfg)
    module = kernel_module(names[0])
    st = eng.init(cfg, runner.device_lanes(cfg, None, device)["seed"])
    out, r0 = {}, 0
    for r in sorted(rounds):
        st = runner.advance(cfg, st, r0, r - r0)
        got = out[r] = {}
        with standing_in(module, names, recording(got)):
            st = eng.round(cfg, st, r)
        require(set(got) == set(names), f"round {r} skipped a phase")
        r0 = r + 1
    return out


def schedule_args(cfg, device="cuda"):
    from consensus_tpu_torch.network import runner
    return (cfg, runner.device_lanes(cfg, None, device)["seed"])


# A DPoS shape whose lane 1 has two epochs (1 and 7) of all-equal
# tallies, 1 053 each: ties to the lower id (found by search over seeds).
DPOS_EQUAL = dict(n_nodes=4, n_candidates=2, n_producers=2, epoch_len=1,
                  n_rounds=8, n_sweeps=2, seed=24)


def dpos_edge_inputs(dev, gen) -> dict:
    """Inputs on which KW's and KX's rare paths fire: {name: [args]}. KW
    on the hostile run's seeds (3 lanes, V = 20 000), on V = C = 20 with
    K = C (candidates without a vote, zero tallies tied; one block a
    lane), on one candidate, on C = 70 000 (K = 5; past the clusters'
    shared memory: the RANKS instance), on 9 000 lanes of 8 epochs each
    (72 000 (lane, epoch) pairs, past the 65 535 blocks of a grid's y or
    z), on DPOS_EQUAL (all-equal tallies), on V = C = K = 2 000 (C not a
    multiple of 32, C = K: every key in the union), and on V = 4 099
    (chunks that do not divide V), C = 45; KX on rounds of the hostile
    run (partitions, churn,
    uint16 chains, every chain full from round 128 on) and on random
    states of int32 chain_p (C = 70 000), a third of the chains full."""
    from consensus_tpu_torch.engines import dpos
    hostile = protocol_config(DPOS_HOSTILE)
    wide = protocol_config(DPOS_FLAGSHIP, n_nodes=70_000,
                           n_candidates=70_000, n_producers=5, n_rounds=40,
                           log_capacity=8, partition_rate=0.5, n_sweeps=2)
    out = {"dpos_schedule": [schedule_args(c, dev) for c in (
        hostile, wide,
        protocol_config(DPOS_HOSTILE, n_nodes=20, n_candidates=20,
                        n_producers=20),
        protocol_config(DPOS_HOSTILE, n_nodes=1, n_candidates=1,
                        n_producers=1),
        protocol_config(DPOS_HOSTILE, n_nodes=6, n_candidates=4,
                        n_producers=2, epoch_len=1, n_rounds=8,
                        n_sweeps=9_000),
        protocol_config(DPOS_HOSTILE, **DPOS_EQUAL),
        protocol_config(DPOS_HOSTILE, n_nodes=2_000, n_candidates=2_000,
                        n_producers=2_000),
        protocol_config(DPOS_HOSTILE, n_nodes=4_099, n_candidates=45,
                        n_producers=21))]}
    zero = dpos.dpos_schedule_plain(*out["dpos_schedule"][2])[1]
    require(bool((zero == 0).sum(2).ge(2).any()),
            "edge inputs: no zero tallies tied")
    equal = dpos.dpos_schedule_plain(*out["dpos_schedule"][5])[1]
    require(bool(((equal == equal[..., :1]) & (equal > 0)).all(2).any()),
            "edge inputs: no epoch whose tallies are all equal")
    kx = [got["dpos_round"] for got in capture_round_inputs(
        hostile, (5, 150, 299), ("dpos_round",), dev).values()]
    require(bool((kx[-1][6] == hostile.log_capacity).all()),
            "edge inputs: the hostile run's chains are not full")
    B, V, L = wide.n_sweeps, wide.n_nodes, wide.log_capacity
    producers, _ = dpos.dpos_schedule_plain(*schedule_args(wide, dev))
    chain_len = torch.randint(0, L + 1, (B, V), generator=gen, device=dev,
                              dtype=torch.int32)
    chain_len[:, ::3] = L
    for r in (0, 21, 39):
        kx.append((wide, torch.arange(9, 9 + B, device=dev).to(torch.uint32),
                   r, producers,
                   torch.randint(0, 40, (B, V, L), generator=gen,
                                 device=dev).to(torch.uint8),
                   torch.randint(0, V, (B, V, L), generator=gen, device=dev,
                                 dtype=torch.int32), chain_len.clone()))
    out["dpos_round"] = kx
    return out


def paxos_state(gen, dev, B, N, S, r, hi=None):
    """A random batched PaxosState on ``dev``: accepted ballots from a small
    set (ties across acceptors), promises around round r's ballots (below
    ``hi``, by default the round's last ballot + 1: some outbid them), half
    the slots learned."""
    from consensus_tpu_torch.engines import paxos

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    hi = (r + 1) * N + 1 if hi is None else hi
    pick = torch.tensor([0, 3, 5, hi], dtype=torch.int32, device=dev)
    return paxos.PaxosState(
        torch.arange(70, 70 + B, device=dev).to(torch.uint32),
        ri(0, hi, (B, N, S)), pick[ri(0, 4, (B, N, S)).long()],
        ri(-3, 3, (B, N, S)), ri(-9, 9, (B, N, S)),
        torch.rand((B, N, S), generator=gen, device=dev) < 0.5,
        torch.zeros((B, N), dtype=torch.bool, device=dev))


def paxos_round_args(cfg, st, r) -> dict:
    """The arguments KY and KZ receive in round r from state ``st`` (KZ's
    from KY's plain version)."""
    from consensus_tpu_torch.engines import paxos
    from consensus_tpu_torch.ops import adversary
    deliver = adversary.delivery_plain(st.seed, r, cfg.n_nodes,
                                       cfg.drop_cutoff, cfg.partition_cutoff)
    ky = (cfg, st.seed, r, deliver, st.promised, st.acc_bal)
    np_, n_prom, best_bal, best_a, prep = paxos.paxos_promise_plain(
        *clone_args(ky))
    return {"paxos_promise": ky, "paxos_accept_learn": (
        cfg, st.seed, r, deliver, prep, np_, n_prom, best_bal, best_a,
        st.acc_bal, st.acc_val, st.learned_val, st.learned_mask)}


def paxos_edge_inputs(dev, gen) -> dict:
    """Inputs on which KY's and KZ's rare paths fire: {name: [args]}.
    Rounds of the hostile run (n_proposers 300 of 1 000, drops, partitions,
    churn); random states whose accepted ballots tie across acceptors, on
    two or three slots that every proposer contends for; and rounds of a
    run with S = 60 000 slots, more than a row block's shared memory holds
    (its per-slot values then live in its output rows; KZ's bucket starts
    in device memory); and random states of 70 000 lanes at N = 7, S = 16,
    past the 65 535 blocks of a grid's y or z. For KZ also: a full-width
    round (N = S = 10 000) at r = (2^31 - 1) // N, whose ballots pass 2^31
    within the round; KZ inputs of one slot (N = 2 000, and N = 301 with
    100 proposers) whose promise counts are raised to a majority at
    random, so that one bucket holds every proceeding proposer, each
    row's walk the whole of it; and N = 40 976, past KZ's shared memory."""
    out = {name: [] for name in PAXOS}
    for cfg, rounds in ((protocol_config(PAXOS_HOSTILE), (2, 17, 31)),
                        (protocol_config(PAXOS_FLAGSHIP, n_nodes=48,
                                         log_capacity=60_000, drop_rate=0.1,
                                         n_rounds=8, n_sweeps=2), (0, 3, 7))):
        for got in capture_round_inputs(cfg, rounds, PAXOS, dev).values():
            for name in PAXOS:
                out[name].append(got[name])
    ties = 0
    for kw in (dict(n_nodes=300, log_capacity=3, drop_rate=0.1),
               dict(n_nodes=257, log_capacity=2, n_proposers=100,
                    partition_rate=0.5, churn_rate=0.0)):
        cfg = protocol_config(PAXOS_FLAGSHIP, **kw)
        for r in (0, 4):
            args = paxos_round_args(cfg, paxos_state(
                gen, dev, 2, cfg.n_nodes, cfg.log_capacity, r), r)
            ties += int((args["paxos_accept_learn"][7] > 0).sum())
            for name in PAXOS:
                out[name].append(args[name])
    require(ties > 0, "edge inputs: no promise carried an accepted ballot")
    lanes = protocol_config(PAXOS_FLAGSHIP, n_nodes=7, log_capacity=16,
                            drop_rate=0.1, n_sweeps=70_000)
    for r in (0, 3):
        args = paxos_round_args(lanes, paxos_state(
            gen, dev, lanes.n_sweeps, lanes.n_nodes, lanes.log_capacity, r), r)
        for name in PAXOS:
            out[name].append(args[name])
    kz = "paxos_accept_learn"
    wide = protocol_config(PAXOS_FLAGSHIP)
    n = wide.n_nodes
    r = (2**31 - 1) // n
    out[kz].append(paxos_round_args(wide, paxos_state(
        gen, dev, 1, n, wide.log_capacity, r, hi=r * n), r)[kz])
    require(int(out[kz][-1][6].ge(n // 2 + 1).sum()) > 0,
            "edge inputs: no proposer proceeds at the wrapping round")
    for kw in (dict(n_nodes=2_000, log_capacity=1),
               dict(n_nodes=301, log_capacity=1, n_proposers=100,
                    drop_rate=0.2)):
        cfg = protocol_config(PAXOS_FLAGSHIP, **kw)
        args = list(paxos_round_args(cfg, paxos_state(
            gen, dev, 2, cfg.n_nodes, 1, 5), 5)[kz])
        args[6] = torch.where(
            torch.rand(args[6].shape, generator=gen, device=dev) < 0.6,
            cfg.n_nodes // 2 + 1, args[6])
        out[kz].append(tuple(args))
    # N = 40 976: a row's mask bytes and the list's counts no longer fit in
    # KZ's shared memory, so its launches read the rows and count in device
    # memory. Made directly (KY's plain version would need [N, N] ints):
    # 0.5% of the proposers hold a majority of promises.
    big = protocol_config(PAXOS_FLAGSHIP, n_nodes=40_976, log_capacity=4)
    n = big.n_nodes
    deliver = torch.randint(0, 10, (1, n, n), generator=gen, device=dev,
                            dtype=torch.uint8) < 9
    st = paxos_state(gen, dev, 1, n, 4, 5)
    n_prom = torch.where(
        torch.rand((1, n), generator=gen, device=dev) < 0.005, n // 2 + 1,
        0).to(torch.int32)
    pick = torch.randint(0, n, (1, n), generator=gen, device=dev,
                         dtype=torch.int32)
    out[kz].append((big, st.seed, 5, deliver,
                    deliver.transpose(1, 2).contiguous(), st.promised,
                    n_prom, pick % 3, pick, st.acc_bal, st.acc_val,
                    st.learned_val, st.learned_mask))
    return out


def dpos_bound(name: str, args) -> tuple[float, str]:
    """The least time of kernel ``name``'s work (KW, KX) on ``args``: the
    bytes it must move and the 32-bit operations it must do for these
    inputs (see each source's note)."""
    import math

    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.engines import dpos
    if name == "dpos_schedule":
        cfg, seeds = args
        b, e = seeds.shape[0], dpos.n_epochs(cfg)
        c = cfg.n_candidates
        # A draw for each validator's stake, a draw and an add for each
        # (epoch, validator)'s vote, and the sort's comparisons.
        return bound(4 * b + 4 * b * e * (c + cfg.n_producers),
                     b * cfg.n_nodes * THREEFRY_OPS
                     + b * e * cfg.n_nodes * (THREEFRY_OPS + 1)
                     + b * e * c * max(1, math.ceil(math.log2(c))))
    cfg, seed, r, producers, chain_r, chain_p, chain_len = args
    b, v = chain_len.shape
    appended = int((dpos.dpos_round_plain(*clone_args(args))[2]
                    - chain_len).sum())
    active = int((rng.random_u32_plain(seed, rng.STREAM_PARTITION, r, 0, 0)
                  < cfg.partition_cutoff).sum())
    return bound(8 * b * v + appended * (chain_r.element_size()
                                         + chain_p.element_size()),
                 EDGE_OPS * b * v + THREEFRY_OPS * (2 * b + active * (v + 1)))


def paxos_bound(name: str, args) -> tuple[float, str]:
    """The least time of kernel ``name``'s work (KY, KZ) on ``args``: the
    bytes each tensor must move once (see each source's note) and about
    eight 32-bit operations an (acceptor, proposer) pair."""
    if name == "paxos_promise":
        deliver, promised = args[3], args[4]
        b, n, s = promised.shape
        return bound(2 * deliver.numel() + 12 * b * n * s + 12 * b * n,
                     8 * deliver.numel() + 2 * THREEFRY_OPS * b * n)
    deliver, new_promised = args[3], args[5]
    b, n, s = new_promised.shape
    return bound(2 * deliver.numel() + 34 * b * n * s + 12 * b * n,
                 8 * deliver.numel() + 2 * THREEFRY_OPS * b * n)


def segment_max_yardstick(args):
    """One PyTorch call of the segment maximum KY's phase 1 and KZ's phase
    4 take: ``torch.scatter_reduce(amax)`` of a [B, N, P] matrix of
    delivered proposers' ballots by their slots into [B, N, S]. Returns
    (fn, args)."""
    from consensus_tpu_torch.engines import paxos
    cfg, seed, r, deliver, promised, _ = args
    b, n, s = promised.shape
    is_prop, slot_p, ballot, _ = paxos.proposals(cfg, seed, r, n, s)
    vals = torch.where(is_prop[:, None, :] & deliver.transpose(1, 2),
                       ballot[:, None, :], 0).contiguous()
    idx = slot_p[:, None, :].expand(b, n, n).contiguous()
    out = torch.zeros((b, n, s), dtype=torch.int32, device=promised.device)
    return (lambda o, i, v: o.scatter_reduce(2, i, v, "amax",
                                             include_self=True)), \
        (out, idx, vals)


def check_dpos_paxos_kernels(dev, gen) -> list[dict]:
    """KW-KZ against their plain versions on dpos-100k's init and rounds
    DPOS_ROUNDS, on paxos-10kx10k's rounds PAXOS_ROUNDS, and on the edge
    inputs. Times and bounds on dpos-100k's init and round 200 and on
    paxos-10kx10k's round 15."""
    from consensus_tpu_torch.engines import dpos, paxos
    dcfg = protocol_config(DPOS_FLAGSHIP)
    init = schedule_args(dcfg, dev)
    drounds = capture_round_inputs(dcfg, DPOS_ROUNDS, ("dpos_round",), dev)
    real = {"dpos_schedule": [init],
            "dpos_round": [got["dpos_round"] for got in drounds.values()]}
    timed = {"dpos_schedule": init, "dpos_round": drounds[200]["dpos_round"]}
    prounds = capture_round_inputs(protocol_config(PAXOS_FLAGSHIP),
                                   PAXOS_ROUNDS, PAXOS, dev)
    for name in PAXOS:
        real[name] = [got[name] for got in prounds.values()]
        timed[name] = prounds[15][name]
    edges = {**dpos_edge_inputs(dev, gen), **paxos_edge_inputs(dev, gen)}
    tallies = dpos.dpos_schedule_plain(*init)[1]
    argsort = device_ms(lambda t: torch.argsort(t, dim=2, stable=True),
                        (tallies,))
    segmax = device_ms(*segment_max_yardstick(timed["paxos_promise"]))
    rows = []
    for name in DPOS + PAXOS:
        mod = dpos if name in DPOS else paxos
        err = max(max_abs_err(run_pair(name, args))
                  for args in real[name] + edges[name]
                  + flagged(name, edges[name]))
        args = timed[name]
        rows.append(dict(
            name=name, route="cuda",
            source=f"consensus_tpu_torch/csrc/{name}.cu",
            replaces={**DPOS_REPLACES, **PAXOS_REPLACES}[name],
            max_abs_err=err, ms=device_ms(getattr(mod, name), args),
            plain_ms=plain_time(getattr(mod, name + "_plain"), args),
            bound=(dpos_bound if name in DPOS else paxos_bound)(name, args),
            library_ms={"dpos_schedule": argsort, "dpos_round": None}.get(
                name, segmax)))
    return rows


# --- phase 3, continued: the telemetry kernels KAA-KAC -----------------------

TELEMETRY = ("pbft_telemetry", "dpos_telemetry", "paxos_telemetry")
TELEMETRY_REPLACES = {
    "pbft_telemetry": "consensus_tpu/engines/pbft.py:377 pbft_round "
                      "telemetry and flight tail, consensus_tpu/engines/"
                      "pbft_bcast.py:687 pbft_bcast_round telemetry and "
                      "flight tail, consensus_tpu/ops/viewsync.py:56 "
                      "sync_counts",
    "dpos_telemetry": "consensus_tpu/engines/dpos.py:183 dpos_round "
                      "telemetry and flight tail",
    "paxos_telemetry": "consensus_tpu/engines/paxos.py:253 paxos_round "
                       "telemetry and flight tail"}
# What phase 3 records in a round with telemetry, by engine name: its
# telemetry kernel, and the kernels whose optional outputs it reads (KQ's
# and KT's catch-up flags, KX's append count, KY's pair count, KZ's
# accepted responses and decided flags).
TELEMETRY_RECORDS = {
    "pbft": ("pbft_view_preprepare", "pbft_telemetry"),
    "pbft-bcast": ("bcast_view_preprepare", "pbft_telemetry"),
    "dpos": ("dpos_round", "dpos_telemetry"),
    "paxos": ("paxos_promise", "paxos_accept_learn", "paxos_telemetry")}
# The wrappers whose optional outputs the telemetry asks for, and the
# place of the flag argument that asks (their last positional one).
FLAGGED = {"pbft_view_preprepare": 13, "bcast_view_preprepare": 12,
           "dpos_round": 7, "paxos_promise": 6, "paxos_accept_learn": 13}
# The hostile dense PBFT run (tests/test_pbft_sweep.py BASE's knobs at f =
# 8, four sweeps): quorums missed, adoptions and timeouts.
PBFT_HOSTILE = dict(PBFT_ADV, f=8, n_nodes=25, n_rounds=24, log_capacity=8,
                    seed=7, n_sweeps=4, **HOSTILE)


def capture_telemetry_inputs(cfg, rounds, device="cuda") -> dict:
    """{r: {wrapper: arguments}}: what the wrappers TELEMETRY_RECORDS of
    ``cfg``'s engine receive in each round r of ``rounds`` of its eager
    run with telemetry and the flight recorder on ``device``, cloned as
    they arrive (the accumulators as they stood before the round)."""
    from consensus_tpu_torch.network import runner
    eng = runner.engine(cfg)
    names = TELEMETRY_RECORDS[eng.name]
    lanes = runner.device_lanes(cfg, None, device)
    st = eng.init(cfg, lanes.pop("seed"))
    telem, flight = runner.accumulators(cfg, device)
    statics = eng.statics(cfg, None) if eng.statics else {}
    out, r0 = {}, 0
    for r in sorted(rounds):
        st = runner.advance(cfg, st, r0, r - r0, telem=telem, flight=flight,
                            lanes=lanes)
        got = out[r] = {}
        with contextlib.ExitStack() as stack:
            for name in names:
                stack.enter_context(standing_in(kernel_module(name), (name,),
                                                recording(got)))
            st = eng.round(cfg, st, r, telem=telem, flight=flight, **lanes,
                           **statics)
        require(set(got) == set(names), f"round {r} skipped a phase")
        r0 = r + 1
    return out


def telemetry_edge_inputs(dev, gen) -> dict:
    """Random inputs of KAA-KAC, with and without the flight recorder:
    {name: [args]}. KAA on views that differ across nodes, some far past
    P1's range and two at the ends of int32, catch-up flags, down nodes
    (one lane all down: an empty mask), lanes with n_real < N, entry
    timers past the last bucket, rounds whose slot ages reach it, and N
    from 1 to 1 000 (one to four blocks a lane); KAB on random chain
    lengths, append counts and producer lists at rounds 0, 5 and 11 with
    churn in some lanes, V = 3 000; KAC on random counts, a decided row
    that is a strided view, and masks whose lane size is not a multiple
    of 16 bytes, is one, and lies one byte off 16-byte alignment."""
    from consensus_tpu_torch.core.config import Config
    from consensus_tpu_torch.engines import dpos, paxos, pbft

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def flags(p, shape):
        return torch.rand(shape, generator=gen, device=dev) < p

    def accumulators(B, K, n_windows, n_hists):
        return (ints(0, 99, (B, K)), ints(0, 99, (B, n_windows, K)),
                ints(0, 99, (B, n_hists, 16)))

    out = {name: [] for name in TELEMETRY}
    for B, N, S, r, vhi in ((5, 300, 16, 20, 8), (3, 1000, 32, 20_000, 2**20),
                            (2, 1, 4, 3, 5)):
        cfg = pbft_config(1, telemetry_window=WINDOW)
        n_real = ints(1, N + 1, (B,))
        n_real[0] = N
        view = ints(0, vhi, (B, N))
        if N > 1:
            view[1, :2] = torch.tensor([-2**31, 2**31 - 1], device=dev)
        down = flags(0.2, (B, N))
        down[-1] = True
        t, w, lat = accumulators(B, len(pbft.PBFT_TELEMETRY),
                                 r // WINDOW + 2, 2)
        args = (cfg, r, n_real, ints(0, vhi, (B, N)), ints(0, 2**15, (B, N)),
                view, flags(0.3, (B, N)), down,
                *(flags(0.5, (B, N, S)) for _ in range(6)), t)
        out["pbft_telemetry"] += [args, (*args, w, lat)]
    V = 3000
    cfg = Config(protocol="dpos", n_nodes=V, n_candidates=50, n_producers=5,
                 epoch_len=4, n_rounds=12, churn_rate=0.5,
                 telemetry_window=WINDOW)
    for B, r in ((4, 0), (4, 5), (6, 11)):
        seed = torch.from_numpy(np.arange(9, 9 + B, dtype=np.uint32)).to(dev)
        t, w, lat = accumulators(B, len(dpos.DPOS_TELEMETRY), 2, 1)
        args = (cfg, r, seed, ints(0, 50, (B, dpos.n_epochs(cfg), 5)),
                ints(0, 257, (B, V)), ints(0, V + 1, (B,)), t)
        out["dpos_telemetry"] += [args, (*args, w, lat)]
    for B, N, S, offset in ((3, 70, 33, 0), (2, 64, 64, 0), (2, 64, 64, 1)):
        cfg = Config(protocol="paxos", n_nodes=N, log_capacity=S,
                     n_rounds=40, telemetry_window=WINDOW)
        n_prom = ints(0, N, (B, N))
        masks = [flags(0.5, (B * N * S + offset,))[offset:].view(B, N, S)
                 for _ in range(2)]
        t, w, lat = accumulators(B, len(paxos.PAXOS_TELEMETRY), 6, 1)
        args = (cfg, 37, n_prom, n_prom + ints(0, 5, (B, N)),
                ints(0, N, (B, N)), ints(0, 2, (B, 4, N))[:, 2], *masks, t)
        out["paxos_telemetry"] += [args, (*args, w, lat)]
    return out


def flagged(name: str, edges) -> list:
    """Wrapper ``name``'s edge inputs ``edges`` again with the flag that
    asks for its optional outputs, where it has one (FLAGGED), else
    none."""
    if name not in FLAGGED:
        return []
    return [(*args[:FLAGGED[name]], True) for args in edges]


def telemetry_bound(name: str, args) -> tuple[float, str]:
    """The least time of kernel ``name``'s work (KAA-KAC) on ``args``: the
    bytes it must read once (see each source's note) and about one 32-bit
    operation a byte."""
    if name == "pbft_telemetry":
        b, n, s = args[8].shape
        nbytes = 6 * b * n * s + 14 * b * n + 4 * b
    elif name == "dpos_telemetry":
        b, v = args[4].shape
        nbytes = 4 * b * v + 8 * b
    else:
        b, n, s = args[7].shape
        nbytes = 2 * b * n * s + 16 * b * n
    return bound(nbytes, nbytes)


def check_telemetry_kernels(dev, gen) -> tuple[list[dict], dict]:
    """KAA-KAC against their plain versions on rounds 3 and 20 of
    pbft-f128, pbft-100k-bcast and dpos-100k (and its round 200),
    rounds 1 and 15 of paxos-10kx10k, rounds of the hostile dense PBFT,
    DPoS and Paxos runs, all with telemetry and the flight recorder, and
    on the edge inputs; KQ, KT, KX, KY and KZ on the same rounds (their
    optional outputs set) and on their own edge inputs with the flag that
    sets them. Times and bounds of KAA on pbft-100k-bcast's round 20, KAB
    on dpos-100k's round 200, KAC on paxos-10kx10k's round 15. Returns
    the rows and {flagged wrapper: max_abs_err} of those rounds (the
    flagged edge inputs are in the wrappers' own rows)."""
    from consensus_tpu_torch.engines import dpos, paxos, pbft
    # (config, rounds, the round whose telemetry kernel is timed)
    runs = [(pbft_config(128, telemetry_window=WINDOW), (3, 20), None),
            (bcast_config(telemetry_window=WINDOW), (3, 20), 20),
            (protocol_config(DPOS_FLAGSHIP, telemetry_window=WINDOW),
             (3, 20, 200), 200),
            (protocol_config(PAXOS_FLAGSHIP, telemetry_window=WINDOW),
             (1, 15), 15),
            (protocol_config(PBFT_HOSTILE, telemetry_window=WINDOW), (5, 17),
             None),
            (protocol_config(DPOS_HOSTILE, telemetry_window=WINDOW),
             (31, 250), None),
            (protocol_config(PAXOS_HOSTILE, telemetry_window=WINDOW),
             (2, 20), None)]
    flag_err = dict.fromkeys(FLAGGED, 0.0)
    real: dict = {name: [] for name in TELEMETRY}
    timed = {}
    for cfg, rounds, timed_round in runs:
        got = capture_telemetry_inputs(cfg, rounds, dev)
        for r, calls in got.items():
            for name, args in calls.items():
                if name in FLAGGED:
                    flag_err[name] = max(flag_err[name],
                                         max_abs_err(run_pair(name, args)))
                    continue
                real[name].append(args)
                if r == timed_round:
                    timed[name] = args
        del got
    edges = telemetry_edge_inputs(dev, gen)
    mods = {"pbft_telemetry": pbft, "dpos_telemetry": dpos,
            "paxos_telemetry": paxos}
    rows = []
    for name in TELEMETRY:
        err = max(max_abs_err(run_pair(name, args))
                  for args in real[name] + edges[name])
        args = timed[name]
        rows.append(dict(
            name=name, route="cuda",
            source=f"consensus_tpu_torch/csrc/{name}.cu",
            replaces=TELEMETRY_REPLACES[name], max_abs_err=err,
            ms=device_ms(getattr(mods[name], name), args),
            plain_ms=plain_time(getattr(mods[name], name + "_plain"), args),
            bound=telemetry_bound(name, args), library_ms=None))
    return rows, flag_err


# --- phase 3, continued: the HotStuff round's kernels KAD-KAG ----------------

HOTSTUFF = ("hotstuff_propose", "hotstuff_vote", "hotstuff_learn")
HOTSTUFF_ALL = HOTSTUFF + ("hotstuff_extract",)
# hotstuff-100k (benchmarks/run_benchmarks.py CONFIGS) and hotstuff-1k
# (tools/hlocheck/registry.py HOTSTUFF_1K), and a hostile run: N = 301, f =
# 100, drops, partitions and churn, a 4-round view timeout, and a 32-height
# chain that fills (then nobody proposes and views move by timeouts only).
# No digest of theirs was committed before; the anchors were made by the
# JAX package on the CPU and by the C++ oracle (engine="cpu"), which agree:
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   for kw in (chip_smoke.HOTSTUFF_FLAGSHIP, chip_smoke.HOTSTUFF_1K,
#              chip_smoke.HOTSTUFF_HOSTILE):
#       cfg = Config(**kw)
#       print(simulator.run(cfg, warmup=False).digest, simulator.run(
#           dataclasses.replace(cfg, engine="cpu"), warmup=False).digest)
#   EOF
#
# (about 10 s each for hotstuff-100k on a CPU). tests/test_torch_hotstuff.py
# makes the hostile anchor again.
HOTSTUFF_FLAGSHIP = dict(protocol="hotstuff", f=33_333, n_nodes=100_000,
                         n_rounds=64, n_sweeps=8, log_capacity=64, seed=8,
                         drop_rate=0.01, churn_rate=0.001)
HOTSTUFF_DIGEST = \
    "5bcc22a0d6392871185ce0fe9a3a4f8b58821aa8b36f9c19f3b02354c96eda16"
HOTSTUFF_1K = dict(protocol="hotstuff", f=341, n_nodes=1024, n_rounds=32,
                   n_sweeps=2, log_capacity=32, seed=9, drop_rate=0.01,
                   churn_rate=0.001)
HOTSTUFF_1K_DIGEST = \
    "0fe6093935dfe2ed0fe40bc844ceb67406e1288c430f2eb972be8b445f26bad2"
HOTSTUFF_HOSTILE = dict(protocol="hotstuff", f=100, n_nodes=301,
                        n_rounds=96, n_sweeps=3, log_capacity=32, seed=7,
                        drop_rate=0.15, partition_rate=0.1, churn_rate=0.05,
                        view_timeout=4)
HOTSTUFF_HOSTILE_DIGEST = \
    "1a8874ec0a9ea273c9f78d87b6c0b1c770eedbc9a9b4ab3c0cc98361305f7ec3"
HOTSTUFF_REPLACES = {
    "hotstuff_propose": "consensus_tpu/engines/hotstuff.py:195 "
                        "hotstuff_round P0-P2 (lines 232-299)",
    "hotstuff_vote": "consensus_tpu/engines/hotstuff.py:195 hotstuff_round "
                     "P2-P4 (lines 300-433)",
    "hotstuff_learn": "consensus_tpu/engines/hotstuff.py:195 hotstuff_round "
                      "P6-P7 and telemetry and flight tail (lines 456-519), "
                      "consensus_tpu/ops/viewsync.py:56 sync_counts",
    "hotstuff_extract": "consensus_tpu/engines/hotstuff.py:183 _block_val, "
                        "consensus_tpu/engines/hotstuff.py:544 _extract"}
# An equivocating JAX carry with forks (fnum 1 and 6), made by the JAX
# package (tests/test_torch_hotstuff.py reads it too), with its JAX
# extraction: committed and dval.
HOTSTUFF_FORK_CARRY = os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "tests", "hotstuff_fork_carry.npz")
# The rounds phase 3 records: early ones, one in the steady state (the
# kernels are timed on hotstuff-100k's), and the hostile run's with a full
# chain.
HOTSTUFF_ROUNDS = (0, 3, 20)
HOTSTUFF_HOSTILE_ROUNDS = (5, 40, 95)


def capture_hotstuff_inputs(cfg, rounds, telemetry, device="cuda") -> dict:
    """{r: {wrapper: arguments}}: what KAD, KAE and KAF receive in each
    round r of ``rounds`` of ``cfg``'s eager run on ``device`` (with
    ``telemetry``, the accumulators and, at ``cfg.telemetry_window > 0``,
    the recorder, as they stood before the round), cloned as they
    arrive."""
    from consensus_tpu_torch.engines import hotstuff
    from consensus_tpu_torch.network import runner
    st = hotstuff.hotstuff_init(cfg, runner.device_lanes(cfg, None,
                                                         device)["seed"])
    telem, flight = runner.accumulators(cfg, device) if telemetry \
        else (None, None)
    out, r0 = {}, 0
    for r in sorted(rounds):
        st = runner.advance(cfg, st, r0, r - r0, telem=telem, flight=flight)
        got = out[r] = {}
        with standing_in(hotstuff, HOTSTUFF, recording(got)):
            st = hotstuff.hotstuff_round(cfg, st, r, telem=telem,
                                         flight=flight)
        require(set(got) == set(HOTSTUFF), f"round {r} skipped a phase")
        r0 = r + 1
    return out


def extract_args(st) -> tuple:
    """KAG's arguments from a HotStuff state."""
    return (st.seed, st.chain_v, st.chain_vid, st.clen, st.fvec, st.ftab_v,
            st.ftab_h, st.fnum)


def hotstuff_round_args(cfg, st, r, accumulators=()) -> dict:
    """The arguments KAD, KAE and KAF receive in round r from state ``st``,
    each from the plain version of the phase before; ``accumulators`` are
    KAF's optional (t,) or (t, w, lat)."""
    from consensus_tpu_torch.engines import hotstuff
    kad = (cfg, st.seed, r, st.view, st.b1_h, st.lane)
    lane = st.lane.clone()
    view1, adv = hotstuff.hotstuff_propose_plain(*kad[:5], lane)
    regs = (st.b1_v, st.b1_h, st.b2_v, st.b2_h, st.b3_v, st.b3_h,
            st.gcommit)
    kae = (cfg, st.seed, r, view1, lane.clone(), *regs, st.chain_v)
    out = hotstuff.hotstuff_vote_plain(*clone_args(kae[:4]), lane, *regs,
                                       st.chain_v.clone())
    kaf = (cfg, r, view1, out[0], adv, st.timer, st.clen, lane, st.gcommit,
           out[2], out[7], *accumulators)
    return {"hotstuff_propose": kad, "hotstuff_vote": kae,
            "hotstuff_learn": kaf}


def hotstuff_state(gen, dev, cfg, B, r, case):
    """A random batched HotStuff state of ``cfg``'s N nodes and S heights
    on ``dev``, in round r: views in a small range, so that the highest
    view is tied, several nodes propose at different views and some views
    sit on V* and some above it; timers at view_timeout - 1 and around it;
    prefixes below, at and above the commit. ``case`` "full" sets b1_h to
    S - 1 or S (no room: nobody proposes, L = 0), "extremes" puts int32's
    ends among the views (V* + 1 wraps) and makes a lane all negative (no
    gossiper, no proposal)."""
    from consensus_tpu_torch.engines import hotstuff
    N, S = cfg.n_nodes, cfg.log_capacity

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)
    view = ints(r, r + 6, (B, N))
    view[:, ::5] = r + 5
    if case == "extremes":
        view[0, :3] = torch.tensor([2**31 - 1, -2**31, -7], device=dev)
        view[1, 1] = 2**31 - 1
        view[2] = -3 - ints(0, 4, (N,))
    b1_h = ints(-1, S - 1, (B,))
    if case == "full":
        b1_h[:] = S - 1
        b1_h[0] = S
    gcommit = (b1_h - ints(0, 4, (B,))).clamp(min=0)
    clen = torch.minimum(ints(0, S, (B, N)), gcommit[:, None] + 1)
    clen[:, ::3] = gcommit[:, None]
    s = torch.arange(S, dtype=torch.int32, device=dev)
    b1_v = ints(0, r + 3, (B,))
    timer = ints(0, cfg.view_timeout + 2, (B, N))
    timer[:, ::4] = cfg.view_timeout - 1
    none = torch.full((B, hotstuff.FORK_TABLE), -1, dtype=torch.int32,
                      device=dev)
    zeros = torch.zeros((B, N), dtype=torch.int32, device=dev)
    return hotstuff.HotstuffState(
        seed=torch.arange(50, 50 + B, device=dev).to(torch.uint32),
        b1_v=b1_v, b1_h=b1_h, b2_v=b1_v - 1, b2_h=b1_h - 1,
        b3_v=b1_v - ints(2, 4, (B,)), b3_h=b1_h - 2, gcommit=gcommit,
        chain_v=torch.where(s <= b1_h[:, None], s + r // 2, -1),
        chain_vid=torch.zeros((B, S), dtype=torch.int32, device=dev),
        fvec=zeros, ftab_v=none, ftab_h=none.clone(),
        fnum=torch.zeros((B,), dtype=torch.int32, device=dev), view=view,
        timer=timer, clen=clen, down=zeros.to(torch.bool),
        lane=hotstuff.lane_at_rest(view))


def strided(x):
    """``x`` as a strided view (every other element of a wider tensor)."""
    wide = torch.empty((*x.shape[:-1], 2 * x.shape[-1]), dtype=x.dtype,
                       device=x.device)
    wide[..., ::2] = x
    return wide[..., ::2]


def misaligned(x):
    """``x`` as a contiguous view one element past its storage's start."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def hotstuff_edge_inputs(dev, gen) -> dict:
    """Inputs on which KAD-KAG's rare paths fire: {name: [args]}. The
    hostile run's rounds (partitions, churn, views apart, a full chain
    from about round 40), with telemetry and the recorder; random states
    (hotstuff_state: ties, several proposers, the view <= V* boundary, a
    full chain, L = 0, timers at view_timeout - 1, int32 view extremes) at
    N = 7 and N = 3 001 (twelve blocks a lane), KAF with no telemetry, with
    the counters only and with the recorder, and with strided and
    misaligned inputs; KAG on the hostile run's end, the JAX equivocating
    carry with forks, random fork tables (fnum up to 9, heights repeated)
    and S = 5 000 heights (two height tiles a block)."""
    from consensus_tpu_torch import convert
    from consensus_tpu_torch.core.config import Config
    from consensus_tpu_torch.engines import hotstuff
    from consensus_tpu_torch.network import runner
    out = {name: [] for name in HOTSTUFF_ALL}
    hostile = protocol_config(HOTSTUFF_HOSTILE, telemetry_window=WINDOW)
    for got in capture_hotstuff_inputs(hostile, HOTSTUFF_HOSTILE_ROUNDS,
                                       True, dev).values():
        for name in HOTSTUFF:
            out[name].append(got[name])
    K = len(hotstuff.HOTSTUFF_TELEMETRY)
    for kw in (dict(f=2, n_nodes=7, drop_rate=0.3, partition_rate=0.5,
                    view_timeout=3),
               dict(f=1000, n_nodes=3001, drop_rate=0.05,
                    partition_rate=0.3, churn_rate=0.2)):
        cfg = Config(protocol="hotstuff", log_capacity=12, n_rounds=40,
                     telemetry_window=WINDOW, **kw)
        for r, case in ((0, "spread"), (7, "full"), (30, "extremes")):
            B = 6
            st = hotstuff_state(gen, dev, cfg, B, r, case)
            acc = (torch.randint(0, 99, (B, K), generator=gen, device=dev,
                                 dtype=torch.int32),
                   torch.randint(0, 99, (B, 6, K), generator=gen, device=dev,
                                 dtype=torch.int32),
                   torch.randint(0, 99, (B, 2, 16), generator=gen,
                                 device=dev, dtype=torch.int32))
            for tail in ((), acc[:1], acc):
                args = hotstuff_round_args(cfg, st, r, tail)
                for name in HOTSTUFF:
                    out[name].append(args[name])
            kad = list(args["hotstuff_propose"])
            kad[3] = strided(kad[3])
            out["hotstuff_propose"].append(tuple(kad))
            kaf = list(args["hotstuff_learn"])
            kaf[2], kaf[3], kaf[5] = (misaligned(kaf[2]), misaligned(kaf[3]),
                                      strided(kaf[5]))
            out["hotstuff_learn"].append(tuple(kaf))
    # KAG.
    st = runner.run_device(protocol_config(HOTSTUFF_HOSTILE), dev,
                           graph=False)
    out["hotstuff_extract"].append(extract_args(st.state))
    fork = dict(np.load(HOTSTUFF_FORK_CARRY))
    for k in ("jax_committed", "jax_dval"):
        fork.pop(k)
    out["hotstuff_extract"].append(extract_args(convert.state_from_numpy(
        fork, dev)))
    for B, N, S in ((5, 300, 40), (2, 3, 5000)):
        seed = torch.arange(60, 60 + B, device=dev).to(torch.uint32)
        chain_v = torch.randint(-1, 50, (B, S), generator=gen, device=dev,
                                dtype=torch.int32)
        chain_vid = torch.randint(0, 2, (B, S), generator=gen, device=dev,
                                  dtype=torch.int32)
        clen = torch.randint(0, S + 1, (B, N), generator=gen, device=dev,
                             dtype=torch.int32)
        fvec = torch.randint(0, 256, (B, N), generator=gen, device=dev,
                             dtype=torch.int32)
        ftab_v = torch.randint(-1, 60, (B, 8), generator=gen, device=dev,
                               dtype=torch.int32)
        ftab_h = torch.randint(-1, min(S, 12), (B, 8), generator=gen,
                               device=dev, dtype=torch.int32)
        ftab_h[:, 3] = ftab_h[:, 1]
        fnum = torch.randint(-1, 10, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
        out["hotstuff_extract"].append((seed, chain_v, chain_vid, clen,
                                        fvec, ftab_v, ftab_h, fnum))
    return out


def hotstuff_bound(name: str, args) -> tuple[float, str]:
    """The least time of kernel ``name``'s work (KAD-KAG) on ``args``: the
    bytes each tensor must move once and the 32-bit operations these
    inputs need (see each source's note): KAD's gossip draw only for the
    nodes behind the highest view, KAE's proposal and vote draws only for
    the nodes at or below V*, the partition sides only in lanes whose
    partition is active."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.engines import hotstuff
    if name == "hotstuff_extract":
        seed, chain_v, _, clen = args[:4]
        b, n = clen.shape
        s = chain_v.shape[1]
        return bound(5 * b * n * s + 4 * b * n + 8 * b * s,
                     b * n * s + THREEFRY_OPS * b * s)
    cfg = args[0]
    if name == "hotstuff_learn":
        view1 = args[2]
        b, n = view1.shape
        return bound(26 * b * n + 64 * b, 20 * b * n)
    seed, r = args[1], args[2]
    part = int((rng.random_u32_plain(seed, rng.STREAM_PARTITION, r, 0, 0)
                < cfg.partition_cutoff).sum())
    if name == "hotstuff_propose":
        view, lane = args[3], args[5]
        b, n = view.shape
        word = hotstuff.KEY if hotstuff.gated(cfg) else hotstuff.TOP
        behind = int((view < (lane[:, word] >> 32)[:, None]).sum())
        return bound(9 * b * n + 72 * b,
                     EDGE_OPS * behind + THREEFRY_OPS * (3 * b + part * n))
    view1, lane = args[3], args[4]
    b, n = view1.shape
    eligible = int((view1 <= lane[:, hotstuff.VMAX][:, None]).sum())
    return bound(5 * b * n + 100 * b,
                 2 * EDGE_OPS * eligible + THREEFRY_OPS * (2 * b + part * n))


def check_hotstuff_kernels(dev, gen) -> list[dict]:
    """KAD-KAG against their plain versions on hotstuff-100k's rounds
    HOTSTUFF_ROUNDS (telemetry off, and round 20 again with telemetry and
    the recorder), hotstuff-1k's, the hostile run's and the edge inputs,
    KAG on hotstuff-100k's end state. Times (:func:`graph_ms`: CUDA
    events over a graph of 20 calls, each on a clone of its own, which the
    profiler lost records of in every session) and bounds of KAD-KAF on
    hotstuff-100k's round 20 as its main path calls them (telemetry off;
    KAF also with the recorder, ``ms_telemetry``), KAG on its end state."""
    from consensus_tpu_torch.engines import hotstuff
    from consensus_tpu_torch.network import runner
    flag = protocol_config(HOTSTUFF_FLAGSHIP)
    rounds = capture_hotstuff_inputs(flag, HOTSTUFF_ROUNDS, False, dev)
    with_telem = capture_hotstuff_inputs(
        protocol_config(HOTSTUFF_FLAGSHIP, telemetry_window=WINDOW), (20,),
        True, dev)[20]
    small = capture_hotstuff_inputs(protocol_config(HOTSTUFF_1K), (0, 17, 31),
                                    False, dev)
    real = {name: [got[name] for got in (*rounds.values(), with_telem,
                                         *small.values())]
            for name in HOTSTUFF}
    end = runner.run_device(flag, dev, graph=False).state
    real["hotstuff_extract"] = [extract_args(end)]
    timed = {**rounds[20], "hotstuff_extract": extract_args(end)}
    edges = hotstuff_edge_inputs(dev, gen)
    rows = []
    for name in HOTSTUFF_ALL:
        err = max(max_abs_err(run_pair(name, args))
                  for args in real[name] + edges[name])
        args = timed[name]
        row = dict(
            name=name, route="cuda",
            source=f"consensus_tpu_torch/csrc/{name}.cu",
            replaces=HOTSTUFF_REPLACES[name], max_abs_err=err,
            ms=graph_ms(getattr(hotstuff, name), args),
            plain_ms=plain_time(getattr(hotstuff, name + "_plain"), args),
            bound=hotstuff_bound(name, args), library_ms=None)
        if name == "hotstuff_learn":
            row["ms_telemetry"] = graph_ms(hotstuff.hotstuff_learn,
                                           with_telem[name])
        rows.append(row)
    return rows


def hand_kernels() -> dict[str, tuple[str, ...]]:
    """The ``__global__`` kernels of each source in ``_build.SOURCES``, by
    wrapper name: the names the profiler reports for them. Names are unique
    across the sources (the profiler names a kernel by its function)."""
    from consensus_tpu_torch import _build
    pattern = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    return {name: tuple(pattern.findall(
        (_build.CSRC / f"{name}.cu").read_text())) for name in _build.SOURCES}


def is_kernel(name: str, function: str) -> bool:
    """Whether the profiler's kernel ``name`` (demangled, or mangled) is
    the ``__global__`` ``function``, and not one whose name ends in it."""
    return re.search(rf"(?:^|[^A-Za-z_]){function}[(<EI]", name) is not None


# The round's code between two kernel wrappers (a gap) lies in one phase;
# none may run a PyTorch compute op on the card (only the zeroing fill_ of
# fresh tensors is allowed), and only "init", before the first round, may
# run any.
GAPS = {(None, "candidacy"): "init",
        ("candidacy", "top_active"): "P2",
        ("top_active", "delivery_edges"): "P2",
        ("delivery_edges", "delivery_edges"): "P2",
        ("delivery_edges", "elect"): "P2",
        ("elect", "top_active"): "leader mask",
        ("top_active", "slots"): "slot lifecycle",
        ("slots", "propose"): "P3a-P3b",
        ("propose", "delivery_edges"): "P3a-P3b",
        ("delivery_edges", "append_entries"): "P3c",
        ("append_entries", "delivery_edges"): "P3c-P3d",
        ("delivery_edges", "acks_commit"): "P3d-P4",
        ("acks_commit", "telemetry"): "telemetry",
        ("telemetry", "candidacy"): "between rounds",
        ("acks_commit", "candidacy"): "between rounds",
        ("telemetry", None): "after the last round",
        ("acks_commit", None): "after the last round",
        # The dense round.
        (None, "delivery"): "init",
        ("delivery", "dense_elect"): "P0-P2",
        ("dense_elect", "dense_append"): "P3a-P3c",
        ("dense_append", "dense_acks_commit"): "P3d-P4",
        ("dense_acks_commit", "delivery"): "between rounds",
        ("dense_acks_commit", None): "after the last round",
        ("dense_acks_commit", "dense_telemetry"): "telemetry",
        ("dense_telemetry", "delivery"): "between rounds",
        ("dense_telemetry", None): "after the last round",
        # The PBFT round.
        ("delivery", "pbft_view_preprepare"): "P0-P3",
        ("pbft_view_preprepare", "pbft_tally"): "P4-P5",
        ("pbft_tally", "pbft_decide"): "P6-P7",
        ("pbft_decide", "delivery"): "between rounds",
        ("pbft_decide", None): "after the last round",
        ("pbft_decide", "pbft_telemetry"): "telemetry",
        ("pbft_telemetry", "delivery"): "between rounds",
        ("pbft_telemetry", None): "after the last round",
        # The §6b broadcast round.
        (None, "bcast_view_preprepare"): "init",
        ("bcast_view_preprepare", "bcast_tally"): "P4-P5",
        ("bcast_tally", "bcast_decide"): "P6-P7",
        ("bcast_decide", "bcast_view_preprepare"): "between rounds",
        ("bcast_decide", None): "after the last round",
        ("bcast_decide", "pbft_telemetry"): "telemetry",
        ("pbft_telemetry", "bcast_view_preprepare"): "between rounds",
        # The DPoS round (KW runs at init).
        (None, "dpos_schedule"): "init",
        ("dpos_schedule", "dpos_round"): "init",
        ("dpos_round", "dpos_round"): "between rounds",
        ("dpos_round", None): "after the last round",
        ("dpos_round", "dpos_telemetry"): "telemetry",
        ("dpos_telemetry", "dpos_round"): "between rounds",
        ("dpos_telemetry", None): "after the last round",
        # The Paxos round.
        ("delivery", "paxos_promise"): "phases 1-2",
        ("paxos_promise", "paxos_accept_learn"): "phases 3-6",
        ("paxos_accept_learn", "delivery"): "between rounds",
        ("paxos_accept_learn", None): "after the last round",
        ("paxos_accept_learn", "paxos_telemetry"): "telemetry",
        ("paxos_telemetry", "delivery"): "between rounds",
        ("paxos_telemetry", None): "after the last round",
        # The HotStuff round (telemetry rides KAF).
        (None, "hotstuff_propose"): "init",
        ("hotstuff_propose", "hotstuff_vote"): "P2-P3",
        ("hotstuff_vote", "hotstuff_learn"): "P4-P6",
        ("hotstuff_learn", "hotstuff_propose"): "between rounds",
        ("hotstuff_learn", None): "after the last round"}
ZEROING = ("aten::fill_", "aten::zero_")


def plain_ops_by_phase(cfg, device="cuda", telemetry=False,
                       rungs=None) -> dict:
    """One eager run of ``cfg`` under torch.profiler with each kernel
    wrapper of the round in a named range: {place: {aten op: ms}} for every
    aten op that took time on the device (on the CPU: host time), where
    place is "in <wrapper>" or the phase of the round's code between two
    wrappers, found by the host order of the calls."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from consensus_tpu_torch.engines import (dpos, hotstuff, paxos, pbft,
                                             raft)
    from consensus_tpu_torch.engines import pbft_bcast as pb
    from consensus_tpu_torch.engines import raft_sparse as rs
    from consensus_tpu_torch.network import runner
    on_cpu = torch.device(device).type == "cpu"
    # The wrappers the engine's round calls, by the module it calls them
    # through (KA's only through init; KW's only in DPoS's init; the §6b
    # round calls KAA through the dense PBFT engine's module).
    eng = runner.engine(cfg)
    if eng is runner.HOTSTUFF:
        marks = [(hotstuff, list(HOTSTUFF))]
    elif eng is runner.DPOS:
        marks = [(dpos, [*DPOS, "dpos_telemetry"])]
    elif eng is runner.PAXOS:
        marks = [(paxos, ["delivery", *PAXOS, "paxos_telemetry"])]
    elif eng is runner.PBFT_BCAST:
        marks = [(pb, list(BCAST)), (pbft, ["pbft_telemetry"])]
    elif eng is runner.PBFT:
        marks = [(pbft, ["delivery", *PBFT, "pbft_telemetry"])]
    elif eng is runner.DENSE:
        marks = [(raft, [*DENSE, "dense_telemetry"])]
    else:
        marks = [(rs, [name for mod, name in runner.KERNELS
                       if mod is rs or name == "delivery_edges"])]

    def marked(name, fn):
        def call(*args):
            with record_function(f"wrapper::{name}"):
                return fn(*args)
        return call

    def session():
        with contextlib.ExitStack() as stack:
            for module, names in marks:
                stack.enter_context(standing_in(module, names, marked))
            prof = stack.enter_context(profile(
                activities=[ProfilerActivity.CPU] if on_cpu else
                [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1)))
            # The profiler records from its second step on.
            runner.run_device(cfg, device, telemetry=telemetry, graph=False,
                              rungs=rungs)
            with recorded_step(prof, lead_in=not on_cpu):
                runner.run_device(cfg, device, telemetry=telemetry,
                                  graph=False, rungs=rungs)
        return prof
    # Without device records every place would look free of compute ops.
    prof = session() if on_cpu else profiled(session, "the eager run")[0]
    events = prof.events()
    # Host ranges only: the profiler also puts each range on the device
    # timeline, where it spans the kernels' later execution.
    marks = sorted((e.time_range.start, e.time_range.end, e.name[9:])
                   for e in events if e.name.startswith("wrapper::")
                   and e.device_type == DeviceType.CPU)
    starts = [m[0] for m in marks]
    out: dict = {}
    for e in events:
        t = e.self_cpu_time_total if on_cpu else e.self_device_time_total
        if not e.name.startswith("aten::") or t <= 0:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < marks[i][1]:
            place = "in " + marks[i][2]
        else:
            key = (marks[i][2] if i >= 0 else None,
                   marks[i + 1][2] if i + 1 < len(marks) else None)
            place = GAPS.get(key, f"{key[0]} -> {key[1]}")
        ops = out.setdefault(place, {})
        ops[e.name] = ops.get(e.name, 0.0) + t / 1e3
    return out


def profile_replay(cfg, rungs=None, telemetry=False, run=None) -> dict:
    """The flagship's graph replay: wall time of one replay up to the
    device's end (host clock, best of five), and one more replay under
    torch.profiler (after a warm-up step of the profiler, which misses the
    first launches of its first step): its device time by hand kernel, by
    ``__global__`` function (count, ms) and of every other device
    operation by name (count, ms), its device
    operations, and its busy share, device time over the same replay's
    wall. The profiler slows the host's side of a replay by a cost per
    device operation, so ``unprofiled_busy_share`` also divides that
    device time by the best unprofiled replay's wall. ``run``, where
    given, is the replay (a knob batch's) in place of ``cfg``'s run."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from consensus_tpu_torch.network import runner

    def replay():
        if run is not None:
            run()
        else:
            runner.run_device(cfg, rungs=rungs, telemetry=telemetry)
    replay()                                    # the graph is captured
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        replay()
        walls.append((time.perf_counter() - t0) * 1e3)
    profiled_walls = []

    def session():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            replay()
            with recorded_step(prof):
                t0 = time.perf_counter()
                replay()
                profiled_walls.append((time.perf_counter() - t0) * 1e3)
        return prof
    _, device, _ = profiled(session, "the replay", graph=True)
    profiled_ms = profiled_walls[-1]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    kernels = hand_kernels()
    hand = dict.fromkeys(kernels, 0.0)
    by_function: dict = {}
    other: dict = {}
    for e in device:
        ms = e.time_range.elapsed_us() / 1e3
        k, fn = next(((k, f) for k, fns in kernels.items() for f in fns
                      if is_kernel(e.name, f)), (None, None))
        if k is not None:
            hand[k] += ms
            n, t = by_function.get(fn, (0, 0.0))
            by_function[fn] = (n + 1, t + ms)
        else:
            n, t = other.get(e.name, (0, 0.0))
            other[e.name] = (n + 1, t + ms)
    return dict(replay_wall_ms=walls, profiled_wall_ms=profiled_ms,
                device_ms=busy_ms, busy_share=busy_ms / profiled_ms,
                unprofiled_busy_share=busy_ms / min(walls),
                device_launches=len(device),
                launches_per_round=len(device) / cfg.n_rounds,
                hand_kernel_ms=hand, hand_function_ms=by_function,
                other_ops=other, hand_share=sum(hand.values()) / busy_ms)


def memory_use(run) -> dict:
    """``run()``'s result, and the device memory its first call of a config
    takes: the peak above what was allocated before (the eager warm-up
    round, the capture, the replays), and what stays allocated after it
    (the cached graph's pool: its state and outputs). The graphs cached
    before are dropped first."""
    from consensus_tpu_torch.network import runner
    runner.clear_graphs()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result = run()
    return dict(result=result,
                peak_bytes=torch.cuda.max_memory_allocated() - before,
                graph_bytes=torch.cuda.memory_allocated() - before,
                max_memory_allocated=torch.cuda.max_memory_allocated())


def counted(run) -> tuple:
    """``run()``'s result and the launch counts of that run alone: every
    count is set to 0 just before it and read just after."""
    from consensus_tpu_torch.network import runner
    for mod, name in runner.KERNELS:
        getattr(mod, name).launches = 0
    result = run()
    return result, runner.launch_counts()


def eager_digest(cfg, res, eager=None) -> str:
    """The digest of ``cfg``'s eager loop (``graph=False``; ``eager`` is its
    extract where the caller ran it): the extract held leaf by leaf against
    ``res.extract``, the extract of the replay whose digest ``res.digest``
    is held to its anchor, and packed and hashed on the host only where a
    leaf differs. Packing a 100 000-node run's logs again took seconds a
    run (PERF.md §4)."""
    from consensus_tpu_torch.core import serialize
    from consensus_tpu_torch.network import runner, simulator
    if eager is None:
        eager = runner.run(cfg, graph=False)
    replayed = res.extract
    if set(eager) == set(replayed) and all(
            np.array_equal(eager[k], replayed[k]) for k in eager):
        return res.digest
    return serialize.digest(simulator.decided_payload(cfg, eager)[3])


def require_launched(launches: dict[str, int], kernels, path: str) -> None:
    """Fails unless exactly the kernels ``kernels`` launched on ``path``."""
    for kernel, n in launches.items():
        require((n > 0) == (kernel in kernels),
                f"kernel {kernel}: {n} launches on {path}")


def check_seed_sharing(cfg, anchor: str) -> None:
    """A run of ``cfg`` with another seed replays the captured graph with
    its own seeds and equals the eager loop's run; ``cfg``'s own seed then
    gives its digest ``anchor`` again."""
    from consensus_tpu_torch.network import runner, simulator
    other = dataclasses.replace(cfg, seed=cfg.seed + 1)
    captured = runner.captures
    res = simulator.run(other)
    replayed = res.digest
    eager = eager_digest(other, res)
    again = simulator.run(cfg).digest
    emit("seed_sharing", n_nodes=cfg.n_nodes, seed=other.seed,
         digest=replayed, eager_digest=eager,
         new_captures=runner.captures - captured, anchor_digest_again=again)
    require(runner.captures == captured,
            "a run with another seed captured a graph of its own")
    require(replayed == eager and replayed != anchor,
            "the replay with another seed disagrees with the eager loop")
    require(again == anchor,
            "the anchor's seed after another seed changed its digest")


# --- phase 5: telemetry ------------------------------------------------------

# The telemetry phase's anchor: the counters and flight recorder of
# raft-100k cut to N = 10 000 (the full shape is not run on a CPU), with
# telemetry and 8-round windows, made from the JAX package on the CPU by
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import json, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   res = simulator.run(Config(**chip_smoke.ANCHOR_CONFIG), warmup=False,
#                       telemetry=True)
#   print(json.dumps([res.digest, res.extras["telemetry"]["totals"],
#                     chip_smoke.flight_digest(res.extras["flight"])]))
#   EOF
ANCHOR_CONFIG = dict(protocol="raft", n_nodes=10_000, n_rounds=64,
                     n_sweeps=B, log_capacity=L, max_entries=100,
                     max_active=A, seed=6, drop_rate=0.01, churn_rate=0.001,
                     telemetry_window=WINDOW)
ANCHOR_DIGEST = \
    "0703855a0d71caeff1dd9aa885f98374ccb29cb7c9ec5011ac40659ccdca7073"
ANCHOR_TOTALS = {"leader_elections": 10, "append_accepted": 4771215,
                 "append_rejected": 222, "entries_committed": 4739189,
                 "attack_rounds": 0, "crashes": 0, "recoveries": 0,
                 "nodes_down": 0, "agg_down_rounds": 0, "stale_serves": 0,
                 "poisoned_serves": 0}
ANCHOR_FLIGHT = \
    "7d7a2d69d8455a34313b22e0423c75366a97a26ec56a3c27b15b761c10f676d8"


def flight_digest(flight) -> str:
    """SHA-256 of a flight recorder's window and latency arrays, by name,
    as little-endian int64 in the dicts' order."""
    h = hashlib.sha256()
    for part in ("windows", "latency"):
        for name, a in flight[part].items():
            h.update(name.encode())
            h.update(np.ascontiguousarray(a, dtype="<i8").tobytes())
    return h.hexdigest()


def check_telemetry(card: str, smi: str) -> int:
    """Phase 5. Returns kernel KK's launches in the telemetry run."""
    from consensus_tpu_torch.core.config import Config
    from consensus_tpu_torch.network import runner, simulator
    cfg = flagship_config(telemetry_window=WINDOW)
    for mod, name in runner.KERNELS:
        getattr(mod, name).launches = 0
    res = simulator.run(cfg, telemetry=True)
    launches = runner.launch_counts()
    tel, fl = res.extras["telemetry"], res.extras["flight"]
    per = tel["per_sweep"]
    windows_sum = all(np.array_equal(fl["windows"][k].sum(1), per[k])
                      for k in per)
    waits = np.array_equal(fl["latency"]["election_wait_rounds"].sum(1),
                           per["leader_elections"])
    # The eager loop on the same config, against the graph's replay.
    eager = runner.run_device(cfg, telemetry=True, graph=False)
    eager_stats = runner.telemetry_stats(cfg, eager)
    same = flight_digest(eager_stats["flight"]) == flight_digest(fl) and all(
        np.array_equal(eager_stats["telemetry"][k], per[k]) for k in per)
    anchor = simulator.run(Config(**ANCHOR_CONFIG), telemetry=True)
    anchor_flight = flight_digest(anchor.extras["flight"])
    anchor_totals = anchor.extras["telemetry"]["totals"]
    emit("telemetry", digest=res.digest, totals=tel["totals"],
         flight_sha256=flight_digest(fl), windows_sum_to_totals=windows_sum,
         waits_equal_elections=waits, graph_equals_eager=same,
         launches=launches, steps_per_sec=res.steps_per_sec,
         wall_s=res.wall_s, anchor_digest=anchor.digest,
         anchor_totals=anchor_totals, anchor_flight_sha256=anchor_flight,
         card=card, power=smi)
    require(res.digest == FLAGSHIP_DIGEST,
            f"telemetry changed the digest: {res.digest}")
    require(windows_sum, "the windows do not sum to the totals")
    require(waits, "election waits and leader elections disagree")
    require(same, "graph replay and eager loop disagree")
    for name, n in launches.items():
        require((n > 0) == (name not in NOT_CAPPED),
                f"kernel {name}: {n} launches on the telemetry path")
    require(anchor.digest == ANCHOR_DIGEST and anchor_totals == ANCHOR_TOTALS
            and anchor_flight == ANCHOR_FLIGHT,
            "the N = 10 000 telemetry run disagrees with its JAX anchor")
    return launches["telemetry"]


def check_dense_path(card: str, smi: str) -> dict[str, int]:
    """Phase 6: the dense engine's main path, raft-5node and raft-1kx1k
    through ``simulator.run``, each replayed as one CUDA graph, with every
    launch count set to 0 just before and read just after. Their digests
    must be the committed anchors, KA and KL-KO must have launched and no
    other kernel. Then the replay under the profiler, and another seed of
    raft-1kx1k on the same graph against the eager loop. Returns
    raft-1kx1k's launches."""
    from consensus_tpu_torch.network import runner, simulator
    own = {}
    for name in DENSE_CONFIGS:
        cfg = dense_config(name)
        for mod, kernel in runner.KERNELS:
            getattr(mod, kernel).launches = 0
        memory = memory_use(lambda: simulator.run(cfg))
        res = memory.pop("result")
        launches = runner.launch_counts()
        require(res.counts.shape == (cfg.n_sweeps, cfg.n_nodes)
                and res.rec_a.shape == (cfg.n_sweeps, cfg.n_nodes, L),
                "decided logs of the wrong shape")
        emit("dense", config=name, digest=res.digest,
             digest_ok=res.digest == DENSE_DIGESTS[name],
             steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
             max_commit=int(res.counts.max()), launches=launches, **memory,
             **profile_replay(cfg), card=card, power=smi)
        require(res.digest == DENSE_DIGESTS[name],
                f"{name} digest {res.digest} != {DENSE_DIGESTS[name]}")
        for kernel, n in launches.items():
            require((n > 0) == (kernel in DENSE + ("random_u32",)),
                    f"kernel {kernel}: {n} launches on the {name} path")
        own[name] = launches
    cfg = dense_config("raft-1kx1k")
    check_seed_sharing(cfg, DENSE_DIGESTS["raft-1kx1k"])
    return own["raft-1kx1k"]


# --- phase 6, continued: the dense engine's telemetry ------------------------

# raft-5node's telemetry anchor: its counters and flight recorder with
# 8-round windows, made from the JAX package on the CPU by
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import json, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   cfg = {**chip_smoke.DENSE_CONFIGS["raft-5node"], "protocol": "raft",
#          "log_capacity": 128, "max_entries": 100, "drop_rate": 0.01,
#          "churn_rate": 0.001, "telemetry_window": chip_smoke.WINDOW}
#   res = simulator.run(Config(**cfg), warmup=False, telemetry=True)
#   print(json.dumps([res.digest, res.extras["telemetry"]["totals"],
#                     chip_smoke.flight_digest(res.extras["flight"])]))
#   EOF
DENSE_TELEMETRY_TOTALS = {
    "leader_elections": 592, "append_accepted": 316184,
    "append_rejected": 2, "entries_committed": 255996, "attack_rounds": 0,
    "crashes": 0, "recoveries": 0, "nodes_down": 0, "agg_down_rounds": 0,
    "stale_serves": 0, "poisoned_serves": 0}
DENSE_TELEMETRY_FLIGHT = \
    "39b3d26f20b923bee5e9451d281877769652c11d5ec556e520f7037197157273"


def check_dense_telemetry(card: str, smi: str) -> int:
    """Phase 6, telemetry: raft-5node and raft-1kx1k with telemetry and
    8-round windows, replayed as graphs, with every launch count set to 0
    just before each and read just after it. The digests must not move, KA and
    KL-KP must have launched and no other kernel, the windows must sum to
    the totals, raft-5node's counters and recorder must equal their JAX
    anchor, and raft-1kx1k's graph replay must equal its eager loop.
    Then each config's replay under the profiler without and with
    telemetry, alternated (without, with, with, without), so that the
    cost of telemetry is read within one process. Returns KP's
    launches in raft-1kx1k's run."""
    from consensus_tpu_torch.network import runner, simulator
    res, counts = {}, {}
    for name in DENSE_CONFIGS:
        cfg = dense_config(name, telemetry_window=WINDOW)
        res[name], counts[name] = counted(
            lambda: simulator.run(cfg, telemetry=True))
    prof = {name: [profile_replay(
        dense_config(name, telemetry_window=WINDOW if on else 0),
        telemetry=on) for on in (False, True, True, False)]
        for name in DENSE_CONFIGS}
    cfg = dense_config("raft-1kx1k", telemetry_window=WINDOW)
    eager = runner.telemetry_stats(cfg, runner.run_device(
        cfg, telemetry=True, graph=False))
    fl = res["raft-1kx1k"].extras["flight"]
    per = res["raft-1kx1k"].extras["telemetry"]["per_sweep"]
    same = flight_digest(eager["flight"]) == flight_digest(fl) and all(
        np.array_equal(eager["telemetry"][k], per[k]) for k in per)
    sums = all(np.array_equal(r.extras["flight"]["windows"][k].sum(1), v)
               for r in res.values()
               for k, v in r.extras["telemetry"]["per_sweep"].items())
    anchor = res["raft-5node"].extras
    emit("dense_telemetry",
         **{name: dict(digest=r.digest, totals=r.extras["telemetry"]
                       ["totals"], flight_sha256=flight_digest(
                           r.extras["flight"]),
                       steps_per_sec=r.steps_per_sec, wall_s=r.wall_s,
                       launches=counts[name],
                       profiles_without_with_with_without=prof[name])
            for name, r in res.items()},
         windows_sum_to_totals=sums, graph_equals_eager=same,
         card=card, power=smi)
    for name, r in res.items():
        require(r.digest == DENSE_DIGESTS[name],
                f"telemetry changed {name}'s digest: {r.digest}")
    require(sums, "the windows do not sum to the totals")
    require(same, "raft-1kx1k: graph replay and eager loop disagree")
    require(anchor["telemetry"]["totals"] == DENSE_TELEMETRY_TOTALS
            and flight_digest(anchor["flight"]) == DENSE_TELEMETRY_FLIGHT,
            "raft-5node's telemetry disagrees with its JAX anchor")
    for name in DENSE_CONFIGS:
        require_launched(counts[name],
                         DENSE + ("random_u32", "dense_telemetry"),
                         f"{name}'s telemetry path")
    return counts["raft-1kx1k"]["dense_telemetry"]


# --- phase 9: dense PBFT and the f-ladder ------------------------------------

def check_pbft_path(card: str, smi: str) -> dict[str, int]:
    """Phase 9: ``simulator.run`` of the standalone rows pbft-f1 ...
    pbft-f128 and the fs = 1..128 ladder (``pbft_fsweep_timed``), each
    replayed as one CUDA graph, with every launch count set to 0 just
    before each run and read just after it: the oracle digests and the
    ladder's anchor, KL and KQ-KS launched in each run and no other
    kernel. Then the ladder's replay under the profiler, and a replay with
    every lane's seed shifted against the eager loop. Returns the
    ladder's launches."""
    from consensus_tpu_torch.core import serialize
    from consensus_tpu_torch.engines import pbft_sweep
    from consensus_tpu_torch.network import runner, simulator
    rows = {}
    for f, want in PBFT_DIGESTS.items():
        cfg = pbft_config(f)
        res, row_launches = counted(lambda: simulator.run(cfg))
        require(res.counts.shape == (1, cfg.n_nodes)
                and int(res.counts.max()) > 0,
                f"pbft-f{f}: decided logs of the wrong shape, or empty")
        rows[f"pbft-f{f}"] = dict(digest=res.digest,
                                  digest_ok=res.digest == want,
                                  steps_per_sec=res.steps_per_sec,
                                  wall_s=res.wall_s,
                                  max_committed=int(res.counts.max()),
                                  launches=row_launches)
    base = pbft_config(1)
    memory, launches = counted(lambda: memory_use(
        lambda: pbft_sweep.pbft_fsweep_timed(base, LADDER, repeats=5)))
    out, compile_s, best, real_steps = memory.pop("result")
    digest = serialize.digest(pbft_sweep.fsweep_payload(out))
    cfg_pad = ladder_config()
    padded_steps = cfg_pad.n_sweeps * cfg_pad.n_nodes * cfg_pad.n_rounds
    emit("pbft", standalone=rows, ladder=dict(
        digest=digest, digest_ok=digest == LADDER_DIGEST,
        real_steps=real_steps, padded_steps=padded_steps, wall_s=best,
        real_steps_per_sec=real_steps / best, first_run_s=compile_s,
        rungs_committed=sum(bool(o["committed"].any()) for o in out),
        **memory), launches=launches, card=card, power=smi)
    for name, row in rows.items():
        require(row["digest_ok"], f"{name} digest {row['digest']}")
        require_launched(row["launches"], ("delivery",) + PBFT, name)
    require(digest == LADDER_DIGEST, f"the ladder's digest {digest} != "
            f"{LADDER_DIGEST}")
    require_launched(launches, ("delivery",) + PBFT, "the fs = 1..128 ladder")
    prof = profile_replay(cfg_pad, rungs=LADDER)
    emit("pbft_profile", config="fs = 1..128 ladder", card=card, power=smi,
         **prof)

    # Another seed on the same graph, against the eager loop; then the
    # base seeds again.
    captured = runner.captures
    other = dataclasses.replace(base, seed=base.seed + len(LADDER))
    replayed = serialize.digest(pbft_sweep.fsweep_payload(
        pbft_sweep.pbft_fsweep_run(other, LADDER)))
    eager = serialize.digest(pbft_sweep.fsweep_payload(
        pbft_sweep.pbft_fsweep_run(other, LADDER, graph=False)))
    again = serialize.digest(pbft_sweep.fsweep_payload(
        pbft_sweep.pbft_fsweep_run(base, LADDER)))
    emit("seed_sharing", config="fs = 1..128 ladder", seed=other.seed,
         digest=replayed, eager_digest=eager,
         new_captures=runner.captures - captured, anchor_digest_again=again)
    require(runner.captures == captured,
            "a ladder with another seed captured a graph of its own")
    require(replayed == eager and replayed != LADDER_DIGEST,
            "the ladder's replay with another seed disagrees with the "
            "eager loop")
    require(again == LADDER_DIGEST,
            "the ladder's base seeds after another seed changed its digest")
    return launches


# --- phase 10: the §6b broadcast engine and its ladders ----------------------

def check_bcast_path(card: str, smi: str) -> dict[str, int]:
    """Phase 10: ``simulator.run`` of pbft-100k-bcast, BASELINE config 3's
    fs = 1..128 ladder under the bcast fault model
    (``pbft_fsweep_timed``), the full-width ladder WIDE_RUNGS
    (``pbft_fsweep_timed``) and the hostile ladder HOSTILE_BCAST_FS
    (``pbft_fsweep_run``), each replayed as one CUDA graph, with every
    launch count set to 0 just before each run and read just after it:
    their anchors, KT-KV launched in each run and no other kernel. Then
    the flagship's replay under the profiler and another seed on its graph
    against the eager loop; each full-width rung against the standalone
    run of its f and seed; and the config-3 ladder with every lane's seed
    shifted against the eager loop. Returns pbft-100k-bcast's launches."""
    from consensus_tpu_torch.core import serialize
    from consensus_tpu_torch.engines import pbft_sweep
    from consensus_tpu_torch.network import runner, simulator
    cfg = bcast_config()
    memory, launches = counted(lambda: memory_use(
        lambda: simulator.run(cfg)))
    res = memory.pop("result")
    require(res.counts.shape == (cfg.n_sweeps, cfg.n_nodes)
            and int(res.counts.max()) > 0,
            "pbft-100k-bcast: decided logs of the wrong shape, or empty")
    base = pbft_config(1, fault_model="bcast")
    ladder_memory, ladder_launches = counted(lambda: memory_use(
        lambda: pbft_sweep.pbft_fsweep_timed(base, LADDER, repeats=5)))
    out, compile_s, best, real_steps = ladder_memory.pop("result")
    ladder_digest = serialize.digest(pbft_sweep.fsweep_payload(out))
    wide_memory, wide_launches = counted(lambda: memory_use(
        lambda: pbft_sweep.pbft_fsweep_timed(wide_base(), WIDE_RUNGS,
                                             repeats=3)))
    wide, wide_first_s, wide_best, wide_steps = wide_memory.pop("result")
    hostile_base = pbft_config(1, fault_model="bcast", n_rounds=24,
                               log_capacity=8, seed=7, **HOSTILE)
    hostile, hostile_launches = counted(lambda: pbft_sweep.pbft_fsweep_run(
        hostile_base, HOSTILE_BCAST_FS))
    hostile_digest = serialize.digest(pbft_sweep.fsweep_payload(hostile))
    wide_digest = serialize.digest(pbft_sweep.fsweep_payload(wide))
    wide_rungs = [serialize.digest(p)
                  for p in pbft_sweep.rung_payloads(wide)]
    emit("bcast", digest=res.digest, digest_ok=res.digest == BCAST_DIGEST,
         steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
         max_committed=int(res.counts.max()), **memory,
         ladder=dict(digest=ladder_digest,
                     digest_ok=ladder_digest == BCAST_LADDER_DIGEST,
                     real_steps=real_steps, wall_s=best,
                     real_steps_per_sec=real_steps / best,
                     first_run_s=compile_s, launches=ladder_launches,
                     **ladder_memory),
         wide_ladder=dict(digest=wide_digest,
                          digest_ok=wide_digest == WIDE_DIGEST,
                          rung_digests=wide_rungs, real_steps=wide_steps,
                          wall_s=wide_best,
                          real_steps_per_sec=wide_steps / wide_best,
                          first_run_s=wide_first_s,
                          launches=wide_launches, **wide_memory),
         hostile_ladder=dict(digest=hostile_digest,
                             digest_ok=hostile_digest == HOSTILE_BCAST_DIGEST,
                             launches=hostile_launches),
         launches=launches, card=card, power=smi)
    require(res.digest == BCAST_DIGEST,
            f"pbft-100k-bcast digest {res.digest} != {BCAST_DIGEST}")
    require(ladder_digest == BCAST_LADDER_DIGEST,
            f"the bcast ladder's digest {ladder_digest} != "
            f"{BCAST_LADDER_DIGEST}")
    require(wide_digest == WIDE_DIGEST
            and tuple(wide_rungs) == WIDE_RUNG_DIGESTS,
            f"the full-width ladder's digests {wide_digest} {wide_rungs}")
    require(hostile_digest == HOSTILE_BCAST_DIGEST,
            f"the hostile bcast ladder's digest {hostile_digest} != "
            f"{HOSTILE_BCAST_DIGEST}")
    require_launched(launches, BCAST, "pbft-100k-bcast")
    require_launched(ladder_launches, BCAST, "the config-3 bcast ladder")
    require_launched(wide_launches, BCAST, "the full-width bcast ladder")
    require_launched(hostile_launches, BCAST, "the hostile bcast ladder")
    emit("bcast_profile", config="pbft-100k-bcast", card=card, power=smi,
         **profile_replay(cfg))
    check_seed_sharing(cfg, BCAST_DIGEST)

    # Each full-width rung against its standalone run (f = fs[k], seed
    # 7 + k, one sweep).
    for k, f in enumerate(WIDE_RUNGS):
        alone = simulator.run(wide_base(f=f, n_nodes=3 * f + 1,
                                        seed=7 + k))
        emit("wide_rung", f=f, digest=alone.digest,
             rung_digest=wide_rungs[k], steps_per_sec=alone.steps_per_sec)
        require(alone.payload == pbft_sweep.rung_payloads(wide)[k],
                f"the full-width rung f = {f} differs from its standalone "
                "run")

    # The config-3 bcast ladder with every lane's seed shifted, on the same
    # graph (captured again: the cache keeps the latest), against the
    # eager loop; then the base seeds again.
    pbft_sweep.pbft_fsweep_run(base, LADDER)
    captured = runner.captures
    other = dataclasses.replace(base, seed=base.seed + len(LADDER))
    replayed = serialize.digest(pbft_sweep.fsweep_payload(
        pbft_sweep.pbft_fsweep_run(other, LADDER)))
    eager = serialize.digest(pbft_sweep.fsweep_payload(
        pbft_sweep.pbft_fsweep_run(other, LADDER, graph=False)))
    again = serialize.digest(pbft_sweep.fsweep_payload(
        pbft_sweep.pbft_fsweep_run(base, LADDER)))
    emit("seed_sharing", config="fs = 1..128 bcast ladder", seed=other.seed,
         digest=replayed, eager_digest=eager,
         new_captures=runner.captures - captured, anchor_digest_again=again)
    require(runner.captures == captured,
            "a bcast ladder with another seed captured a graph of its own")
    require(replayed == eager and replayed != BCAST_LADDER_DIGEST,
            "the bcast ladder's replay with another seed disagrees with the "
            "eager loop")
    require(again == BCAST_LADDER_DIGEST,
            "the bcast ladder's base seeds after another seed changed its "
            "digest")
    return launches


# --- phase 11: DPoS ----------------------------------------------------------

def check_dpos_path(card: str, smi: str) -> dict[str, int]:
    """Phase 11: ``simulator.run`` of dpos-100k (BASELINE config 5) and of
    the hostile run DPOS_HOSTILE, each replayed as one CUDA graph, with
    every launch count set to 0 just before each run and read just after
    it: their anchors, dpos-100k's last-irreversible indices against the
    JAX package's, KW and KX launched in each run and no other kernel. Then
    dpos-100k's replay under the profiler, and another seed on its graph
    against the eager loop. Returns dpos-100k's launches."""
    from consensus_tpu_torch.network import simulator
    cfg = protocol_config(DPOS_FLAGSHIP)
    memory, launches = counted(lambda: memory_use(
        lambda: simulator.run(cfg)))
    res = memory.pop("result")
    lib = res.extras["lib"]
    lib_sha = hashlib.sha256(
        np.ascontiguousarray(lib, dtype="<i8").tobytes()).hexdigest()
    hostile_cfg = protocol_config(DPOS_HOSTILE)
    hostile, hostile_launches = counted(lambda: simulator.run(hostile_cfg))
    emit("dpos", digest=res.digest, digest_ok=res.digest == DPOS_DIGEST,
         steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
         max_chain=int(res.counts.max()), min_chain=int(res.counts.min()),
         lib_sha256=lib_sha, lib_ok=lib_sha == DPOS_LIB_SHA256,
         lib_min=int(lib.min()), lib_max=int(lib.max()), **memory,
         hostile=dict(digest=hostile.digest,
                      digest_ok=hostile.digest == DPOS_HOSTILE_DIGEST,
                      steps_per_sec=hostile.steps_per_sec,
                      wall_s=hostile.wall_s, launches=hostile_launches),
         launches=launches, card=card, power=smi)
    require(res.counts.shape == (1, cfg.n_nodes)
            and res.rec_a.shape == (1, cfg.n_nodes, cfg.log_capacity)
            and int(res.counts.min()) > 0,
            "dpos-100k: chains of the wrong shape, or empty")
    require(res.digest == DPOS_DIGEST,
            f"dpos-100k digest {res.digest} != {DPOS_DIGEST}")
    require(lib_sha == DPOS_LIB_SHA256,
            f"dpos-100k's lib {lib_sha} != the JAX package's "
            f"{DPOS_LIB_SHA256}")
    require(hostile.digest == DPOS_HOSTILE_DIGEST,
            f"the hostile DPoS run's digest {hostile.digest} != "
            f"{DPOS_HOSTILE_DIGEST}")
    require_launched(launches, DPOS, "dpos-100k")
    require_launched(hostile_launches, DPOS, "the hostile DPoS run")
    emit("dpos_profile", config="dpos-100k", card=card, power=smi,
         **profile_replay(cfg))
    check_seed_sharing(cfg, DPOS_DIGEST)
    return launches


# --- phase 12: Paxos ---------------------------------------------------------

def check_paxos_path(card: str, smi: str) -> dict[str, int]:
    """Phase 12: ``simulator.run`` of paxos-10kx10k (BASELINE config 4) and
    of the hostile run PAXOS_HOSTILE, each replayed as one CUDA graph, with
    every launch count set to 0 just before each run and read just after
    it: their anchors, KL, KY and KZ launched in each run and no other
    kernel, the graph's peak and kept memory. Then paxos-10kx10k's replay
    under the profiler, and another seed on its graph against the eager
    loop. Returns paxos-10kx10k's launches."""
    from consensus_tpu_torch.network import simulator
    cfg = protocol_config(PAXOS_FLAGSHIP)
    memory, launches = counted(lambda: memory_use(
        lambda: simulator.run(cfg)))
    res = memory.pop("result")
    hostile_cfg = protocol_config(PAXOS_HOSTILE)
    hostile, hostile_launches = counted(lambda: simulator.run(hostile_cfg))
    # The carry: four int32 grids and a bool one, the down flags, the seed.
    state_bytes = cfg.n_sweeps * (cfg.n_nodes * (17 * cfg.log_capacity + 1)
                                  + 4)
    emit("paxos", digest=res.digest, digest_ok=res.digest == PAXOS_DIGEST,
         steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
         max_learned=int(res.counts.max()), min_learned=int(res.counts.min()),
         state_bytes=state_bytes, **memory,
         hostile=dict(digest=hostile.digest,
                      digest_ok=hostile.digest == PAXOS_HOSTILE_DIGEST,
                      steps_per_sec=hostile.steps_per_sec,
                      wall_s=hostile.wall_s, launches=hostile_launches),
         launches=launches, card=card, power=smi)
    require(res.counts.shape == (1, cfg.n_nodes) and int(res.counts.max()) > 0,
            "paxos-10kx10k: learned logs of the wrong shape, or empty")
    require(res.digest == PAXOS_DIGEST,
            f"paxos-10kx10k digest {res.digest} != {PAXOS_DIGEST}")
    require(hostile.digest == PAXOS_HOSTILE_DIGEST,
            f"the hostile Paxos run's digest {hostile.digest} != "
            f"{PAXOS_HOSTILE_DIGEST}")
    require_launched(launches, ("delivery",) + PAXOS, "paxos-10kx10k")
    require_launched(hostile_launches, ("delivery",) + PAXOS,
                     "the hostile Paxos run")
    emit("paxos_profile", config="paxos-10kx10k", card=card, power=smi,
         **profile_replay(cfg))
    check_seed_sharing(cfg, PAXOS_DIGEST)
    return launches


# --- phase 13: telemetry on dense and §6b PBFT, DPoS and Paxos --------------

# Phase 13's runs, each with telemetry and 8-round windows: (config, the
# digest it must keep, its nonzero counter totals, the SHA-256 of its
# flight recorder (flight_digest)). The flagships are BASELINE config 3's
# largest standalone row and configs pbft-100k-bcast, 5 and 4 at full
# shape; then the hostile runs. Their digests are the telemetry-off
# anchors above (the hostile dense PBFT run's is JAX-made); every counter
# not listed is 0. The totals and recorders were made from the JAX
# package on the CPU (pbft-100k-bcast took 172 s, paxos-10kx10k 207 s on
# eight cores) by
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   for name, (kw, *_) in chip_smoke.BFT_TELEMETRY.items():
#       res = simulator.run(Config(**kw, telemetry_window=chip_smoke.WINDOW),
#                           warmup=False, telemetry=True)
#       print(name, res.digest, {k: v for k, v in
#                                res.extras["telemetry"]["totals"].items()
#                                if v}, chip_smoke.flight_digest(
#                                    res.extras["flight"]))
#   EOF
# The HotStuff runs' counters (nonzero totals) and recorders, made the same
# way: hotstuff-100k with drops and churn and the hostile run, whose honest
# views move apart (view_spread_max, desync_rounds and sync_msgs_delivered
# count).
HOTSTUFF_100K_TOTALS = {
    "qc_formed": 512, "blocks_committed": 496, "commits_learned": 48791852,
    "proposals_delivered": 50687707, "votes_counted": 50180605,
    "view_spread_max": 552, "desync_rounds": 512,
    "sync_msgs_delivered": 499181}
HOTSTUFF_100K_FLIGHT = \
    "b0ff7ed6693e70ece9e099160b4794b955c093ddbd79fa5a0d1fc43ec50ceccd"
HOTSTUFF_HOSTILE_TOTALS = {
    "qc_formed": 96, "blocks_committed": 90, "commits_learned": 26038,
    "view_changes": 11074, "proposals_delivered": 26179,
    "votes_counted": 22267, "view_spread_max": 214, "desync_rounds": 164,
    "sync_msgs_delivered": 5126}
HOTSTUFF_HOSTILE_FLIGHT = \
    "4580868f398cac4104a4e3ed0281146165c8d0bef797835373de87961a8c82d2"
BFT_TELEMETRY = {
    "pbft-f128": (
        dict(PBFT_ADV, f=128, n_nodes=385), PBFT_DIGESTS[128],
        {"prepare_quorums": 12187, "commit_quorums": 12187,
         "commits_adopted": 133},
        "ffcd8aa056ac535b4bdc03a4eaa9137d8ab066b4702a25b29b6930da8dda24d9"),
    "pbft-100k-bcast": (
        BCAST_FLAGSHIP, BCAST_DIGEST,
        {"prepare_quorums": 12800000, "prepare_missed": 1,
         "commit_quorums": 12800000, "view_changes": 4000000},
        "fdb9f58a15df4fbe8eb69f09aaa638cb18dc3ad7b59623b607c300a15603d9f9"),
    "dpos-100k": (
        DPOS_FLAGSHIP, DPOS_DIGEST,
        {"blocks_appended": 25344989, "missed_appends": 255011,
         "producer_rotations": 255},
        "560464cac708e665661a66f44a86090950032d0323f181346b4444bfc986b69e"),
    "paxos-10kx10k": (
        PAXOS_FLAGSHIP, PAXOS_DIGEST,
        {"promises": 994044637, "nacks": 573960115, "accepts": 989843283,
         "proposals_decided": 101004, "values_learned": 99999998},
        "e462384dfb5373cfb4e56c9535257ac7571e2a5588dc6787b9ebb293d1105072"),
    "pbft-hostile": (
        PBFT_HOSTILE,
        "5466fdc11f31297d1f42fd380ff698b7fb4a7af7874ff41f370d8594e7d56291",
        {"prepare_quorums": 733, "prepare_missed": 302,
         "commit_quorums": 588, "commit_missed": 247,
         "commits_adopted": 212, "view_changes": 275},
        "ba035eb18126ad4357ad7dfb534ff78d7b9c991c755e44499a8c1126bd98e02b"),
    "dpos-hostile": (
        DPOS_HOSTILE, DPOS_HOSTILE_DIGEST,
        {"blocks_appended": 7680000, "missed_appends": 10320000,
         "producer_rotations": 896, "churn_slots": 47},
        "77fb80d4e46f75e2d358507c08f1591c817ec3f9854f47bb42f6252fa522cd2a"),
    "paxos-hostile": (
        PAXOS_HOSTILE, PAXOS_HOSTILE_DIGEST,
        {"promises": 12568384, "nacks": 1632861, "accepts": 11160421,
         "proposals_decided": 13794, "values_learned": 1999061},
        "680196000275343dfdc4bcd9a6c9e5fb2089e8ca5621fcc4a13dbf228aba136e"),
    "hotstuff-100k": (
        HOTSTUFF_FLAGSHIP, HOTSTUFF_DIGEST, HOTSTUFF_100K_TOTALS,
        HOTSTUFF_100K_FLIGHT),
    "hotstuff-hostile": (
        HOTSTUFF_HOSTILE, HOTSTUFF_HOSTILE_DIGEST, HOTSTUFF_HOSTILE_TOTALS,
        HOTSTUFF_HOSTILE_FLIGHT),
}
# The flagships, whose replays phase 13 times with telemetry off and on.
BFT_FLAGSHIPS = ("pbft-f128", "pbft-100k-bcast", "dpos-100k",
                 "paxos-10kx10k", "hotstuff-100k")
# Counters that some run of phase 13 must count (not 0 in all of them).
MUST_COUNT = ("prepare_missed", "commit_missed", "commits_adopted",
              "view_changes", "nacks", "churn_slots", "missed_appends")
# The SPEC §B counters that some HotStuff run of phase 13 must count: the
# first real runs in which the honest views move apart.
HOTSTUFF_MUST_COUNT = ("view_spread_max", "desync_rounds",
                       "sync_msgs_delivered")
# The kernels a telemetry run of each engine launches, by engine name.
TELEMETRY_PATHS = {"pbft": ("delivery",) + PBFT + ("pbft_telemetry",),
                   "pbft-bcast": BCAST + ("pbft_telemetry",),
                   "dpos": DPOS + ("dpos_telemetry",),
                   "paxos": ("delivery",) + PAXOS + ("paxos_telemetry",),
                   "hotstuff": HOTSTUFF_ALL}


def check_bft_telemetry(card: str, smi: str) -> dict[str, int]:
    """Phase 13: ``simulator.run`` with telemetry and 8-round windows of
    each run of BFT_TELEMETRY, replayed as one CUDA graph, with every
    launch count set to 0 just before and read just after: its digest (the
    telemetry-off anchor), counter totals and flight recorder (the JAX
    anchors), windows that sum to the totals, the graph replay equal to
    the eager loop, the engine's kernels and its telemetry kernel launched
    and no other. Each flagship's replay under the profiler without and
    with telemetry, alternated (without, with, with, without). Some run
    must count each of MUST_COUNT. Returns the telemetry kernels'
    launches, each from its engine's flagship run (KAA from
    pbft-100k-bcast's)."""
    from consensus_tpu_torch.network import runner, simulator
    rows = {}
    for name, (kw, digest, nonzero, flight) in BFT_TELEMETRY.items():
        cfg = protocol_config(kw, telemetry_window=WINDOW)
        eng = runner.engine(cfg)
        res, launches = counted(lambda: simulator.run(cfg, telemetry=True))
        tel, fl = res.extras["telemetry"], res.extras["flight"]
        per = tel["per_sweep"]
        eager = runner.telemetry_stats(cfg, runner.run_device(
            cfg, telemetry=True, graph=False))
        want = {k: nonzero.get(k, 0) for k in eng.telemetry_names}
        rows[name] = row = dict(
            digest=res.digest, digest_ok=res.digest == digest,
            totals=tel["totals"], totals_ok=tel["totals"] == want,
            flight_sha256=flight_digest(fl),
            flight_ok=flight_digest(fl) == flight,
            windows_sum_to_totals=all(
                np.array_equal(fl["windows"][k].sum(1), v)
                for k, v in per.items()),
            graph_equals_eager=flight_digest(eager["flight"]) ==
            flight_digest(fl) and all(np.array_equal(eager["telemetry"][k],
                                                     per[k]) for k in per),
            steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
            launches=launches)
        if name in BFT_FLAGSHIPS:
            row["profiles_without_with_with_without"] = [
                profile_replay(protocol_config(
                    kw, telemetry_window=WINDOW if on else 0), telemetry=on)
                for on in (False, True, True, False)]
            runner.clear_graphs()
        require_launched(launches, TELEMETRY_PATHS[eng.name],
                         f"{name} with telemetry")
    counted_by = {k: [name for name, row in rows.items()
                      if row["totals"].get(k)] for k in
                  {k for row in rows.values() for k in row["totals"]}}
    emit("telemetry_bft", runs=rows, counted_by=counted_by,
         view_spread_counted=bool(counted_by["view_spread_max"]),
         sync_msgs_counted=bool(counted_by["sync_msgs_delivered"]),
         desync_counted=bool(counted_by["desync_rounds"]),
         card=card, power=smi)
    for name, row in rows.items():
        for check in ("digest_ok", "totals_ok", "flight_ok",
                      "windows_sum_to_totals", "graph_equals_eager"):
            require(row[check], f"{name} with telemetry: {check} fails")
    for k in MUST_COUNT:
        require(counted_by[k], f"no run of phase 13 counts {k}")
    for k in HOTSTUFF_MUST_COUNT:
        require(any(name.startswith("hotstuff") for name in counted_by[k]),
                f"no HotStuff run of phase 13 counts {k}")
    return {"pbft_telemetry": rows["pbft-100k-bcast"]["launches"]
            ["pbft_telemetry"],
            "dpos_telemetry": rows["dpos-100k"]["launches"]
            ["dpos_telemetry"],
            "paxos_telemetry": rows["paxos-10kx10k"]["launches"]
            ["paxos_telemetry"]}


# --- phase 14: HotStuff ------------------------------------------------------

def replay_ops_per_round(cfg, telemetry=False) -> dict:
    """The device operations a round of ``cfg``'s graph replay takes: the
    difference between the replays of ``cfg`` and of ``cfg`` with half its
    rounds (init's operations cancel), over the rounds between; and each
    replay's hand kernels by ``__global__`` function (count, ms)."""
    half = dataclasses.replace(cfg, n_rounds=cfg.n_rounds // 2)
    full, part = (profile_replay(c, telemetry=telemetry) for c in (cfg, half))
    return dict(
        ops_per_round=(full["device_launches"] - part["device_launches"])
        / (cfg.n_rounds - half.n_rounds),
        full=full, half_rounds=dict(
            device_launches=part["device_launches"],
            hand_function_ms=part["hand_function_ms"],
            other_ops=part["other_ops"]))


def check_hotstuff_path(card: str, smi: str) -> dict[str, int]:
    """Phase 14: ``simulator.run`` of hotstuff-100k, hotstuff-1k and the
    hostile run HOTSTUFF_HOSTILE, each replayed as one CUDA graph, with
    every launch count set to 0 just before each run and read just after
    it: their JAX and oracle anchors, the eager loop's digest equal to the
    replay's, KAD-KAF launched an equal number of times, KAG once (the
    extraction, after the replay) and no other kernel; steps per second,
    replay wall, busy share and the graph's memory; another seed on
    hotstuff-100k's graph against the eager loop. Then hotstuff-100k's
    replay without and with telemetry against its half-length replay:
    three device operations a round, each a KAD, KAE or KAF launch (no
    memset, no PyTorch op). Returns hotstuff-100k's launches."""
    from consensus_tpu_torch.network import runner, simulator
    runs = {"hotstuff-100k": (HOTSTUFF_FLAGSHIP, HOTSTUFF_DIGEST),
            "hotstuff-1k": (HOTSTUFF_1K, HOTSTUFF_1K_DIGEST),
            "hotstuff-hostile": (HOTSTUFF_HOSTILE, HOTSTUFF_HOSTILE_DIGEST)}
    rows = {}
    for name, (kw, digest) in runs.items():
        cfg = protocol_config(kw)
        memory, launches = counted(lambda: memory_use(
            lambda: simulator.run(cfg)))
        res = memory.pop("result")
        eager = eager_digest(cfg, res)
        prof = profile_replay(cfg)
        rows[name] = dict(
            digest=res.digest, digest_ok=res.digest == digest,
            eager_digest=eager, steps_per_sec=res.steps_per_sec,
            wall_s=res.wall_s, min_clen=int(res.counts.min()),
            max_clen=int(res.counts.max()), launches=launches, **memory,
            replay_wall_ms=prof["replay_wall_ms"],
            busy_share=prof["busy_share"],
            unprofiled_busy_share=prof["unprofiled_busy_share"],
            device_launches=prof["device_launches"],
            hand_function_ms=prof["hand_function_ms"],
            other_ops=prof["other_ops"])
        require(res.counts.shape == (cfg.n_sweeps, cfg.n_nodes)
                and int(res.counts.max()) > 0,
                f"{name}: decided logs of the wrong shape, or empty")
        require(res.digest == digest, f"{name} digest {res.digest} != "
                f"{digest}")
        require(eager == digest, f"{name}: the eager loop's digest {eager}")
        require_launched(launches, HOTSTUFF_ALL, name)
        require(launches["hotstuff_extract"] == 1
                and len({launches[k] for k in HOTSTUFF}) == 1,
                f"{name}: launches {launches}")
        for fn in ("hotstuff_propose_kernel", "hotstuff_vote_kernel",
                   "hotstuff_learn_kernel"):
            require(prof["hand_function_ms"].get(fn, (0,))[0]
                    == cfg.n_rounds, f"{name}: {fn} launched "
                    f"{prof['hand_function_ms'].get(fn)} times in a replay")
        if name == "hotstuff-100k":
            # Its graph is the cached one now.
            check_seed_sharing(cfg, digest)
    per_round = {on: replay_ops_per_round(
        protocol_config(HOTSTUFF_FLAGSHIP,
                        telemetry_window=WINDOW if on else 0), telemetry=on)
        for on in (False, True)}
    runner.clear_graphs()
    emit("hotstuff", runs=rows,
         ops_per_round=per_round[False]["ops_per_round"],
         ops_per_round_telemetry=per_round[True]["ops_per_round"],
         replays={"off": per_round[False], "on": per_round[True]},
         card=card, power=smi)
    for on, got in per_round.items():
        require(got["ops_per_round"] == 3,
                f"hotstuff-100k (telemetry {on}): {got['ops_per_round']} "
                "device operations a round")
    return rows["hotstuff-100k"]["launches"]


# --- phase 15: SPEC §A.2 delayed retransmission -----------------------------

# The six kernels that draw delivery, each with ctt::delayed_open (K13
# delayed_open, csrc/rng.cuh) inline.
DELAY = ("delivery_edges", "delivery", "bcast_view_preprepare", "dpos_round",
         "hotstuff_propose", "hotstuff_vote")
# consensus_tpu/scenarios/__init__.py delay-storm's overrides.
STORM = dict(drop_rate=0.55, max_delay_rounds=8)
DELAYS = (1, 8, 16)
# Rounds 0, 3 and 7 lie under D = 8 and 16 (the r >= d guard), 20 above.
DELAY_ROUNDS = (0, 3, 7, 20)
# The storm runs: (config maker, its overrides, anchor): each flagship at
# its own shape with delay-storm's overrides (raft-1kx1k at
# GATE_1KX1K_ROUNDS rounds, a cut that leaves its digest), and raft-100k at
# its own drop 0.01 with the deepest delay, D = 16. The anchors were made by
# the JAX package on the CPU and again by the C++ oracle (engine="cpu"),
# which agrees on each:
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   for name, (make, kw, _) in chip_smoke.STORM_RUNS.items():
#       cfg = Config(**dataclasses.asdict(make(**kw)))
#       print(name, simulator.run(cfg, warmup=False).digest,
#             simulator.run(dataclasses.replace(cfg, engine="cpu"),
#                           warmup=False).digest)
#   EOF
#
# (the JAX runs took 3-180 s each on eight cores: raft-1kx1k 180 s,
# pbft-100k-bcast 162 s, paxos-10kx10k 237 s). At these knobs
# dense and §6b PBFT still commit every slot with the values they commit
# without the delay, so pbft-f128's, pbft-100k-bcast's and the full-width
# bcast ladder's digests are their flat anchors again; their telemetry
# (STORM_TELEMETRY) tells the storm from the flat run.
STORM_RUNS = {
    "raft-100k": (
        flagship_config, STORM,
        "f4ab9cbe5c1ace8cccbcc30bbfb6e4593a05dcaebcf23893944df8950cbdc1d9"),
    "raft-100k-d16": (
        flagship_config, dict(max_delay_rounds=16),
        "6937cffb484ee7afdf696a57b84657bea53cbd2c7b0836b398036c09887462c2"),
    "raft-1kx1k": (
        gate_1kx1k, STORM,
        "1819fb537edbe769ebd9c562f592fc09df6b0b8e69a3b57175179e88ecdd127d"),
    "pbft-f128": (lambda **kw: pbft_config(128, **kw), STORM,
                  PBFT_DIGESTS[128]),
    "pbft-100k-bcast": (bcast_config, STORM, BCAST_DIGEST),
    "dpos-100k": (
        lambda **kw: protocol_config(DPOS_FLAGSHIP, **kw), STORM,
        "7c4e297c60928b692184ebc83bc9518e97c2fd3ad3325facadcfa0811f6b338a"),
    "paxos-10kx10k": (
        lambda **kw: protocol_config(PAXOS_FLAGSHIP, **kw), STORM,
        "82a70f7fd62a821db706954586af0de609ef928fd1daa292ff427b900b4b3df0"),
    "hotstuff-100k": (
        lambda **kw: protocol_config(HOTSTUFF_FLAGSHIP, **kw), STORM,
        "102aa51e2a79fef405d5afb95a79c2004f23eab7d5ae5615a02db2a082b8803f"),
}
# dpos-100k's LIB under the storm (extras["lib"], hashed as
# DPOS_LIB_SHA256 is).
DPOS_STORM_LIB_SHA256 = \
    "9939e545ca0c8a156e6818c6e63a22d0c88a40f5dc9b87b7229b451368bc3fa7"
# The ladders with STORM added to their knobs, (base config, rungs,
# anchor), made by the JAX package as the bcast ladders' anchors above.
STORM_LADDERS = {
    "dense-ladder": (
        lambda: pbft_config(1, **STORM), LADDER,
        "346494e7698190ed1cebfecb4a6d1c2d2394f412e682a6c803d7ac016b939b2f"),
    "wide-bcast-ladder": (lambda: wide_base(**STORM), WIDE_RUNGS,
                          WIDE_DIGEST),
}
# Storm runs again with telemetry and 8-round windows: (nonzero counter
# totals, flight_digest), made by the JAX package on the CPU as
# BFT_TELEMETRY's were.
STORM_TELEMETRY = {
    "pbft-f128": (
        {"prepare_quorums": 11621, "prepare_missed": 1950,
         "commit_quorums": 11620, "commit_missed": 353,
         "commits_adopted": 700},
        "5e139176c6b6af85431b338d106fed99a4139352a0d1dcb36cfcd8a1e12eaff3"),
    "pbft-100k-bcast": (
        {"prepare_quorums": 12800000, "prepare_missed": 1200031,
         "commit_quorums": 12800000, "view_changes": 4000000},
        "7f7820fe8e589f6c687375707ca3bbc32aa151baf7fab3e1b7620c36b71cd907"),
    "dpos-100k": (
        {"blocks_appended": 23996919, "missed_appends": 1603081,
         "producer_rotations": 255},
        "43712437fffdeaf7d2ac9c6cb8076b24194f267f4e5204ca4a479e1cdc79ed72"),
    "hotstuff-100k": (
        {"qc_formed": 478, "blocks_committed": 462,
         "commits_learned": 45351919, "proposals_delivered": 46890619,
         "votes_counted": 43472148, "view_spread_max": 994,
         "desync_rounds": 480, "sync_msgs_delivered": 2680569},
        "248255bd5c53472229c67742f3b84e94394ad72b5838b8374162b02509e9c584"),
}
# The runs of N = 1 and 7 on which phase 15 also holds each kernel.
DELAY_SMALL = {
    "delivery_edges": [dict(protocol="raft", n_nodes=n, max_active=a,
                            log_capacity=16, max_entries=12, n_sweeps=3)
                       for n, a in ((1, 1), (7, 4))],
    "delivery": [dict(protocol="raft", n_nodes=n, log_capacity=16,
                      max_entries=12, n_sweeps=3) for n in (1, 7)],
    "bcast_view_preprepare": [dict(protocol="pbft", fault_model="bcast",
                                   f=f, n_nodes=3 * f + 1, log_capacity=8,
                                   n_sweeps=3) for f in (0, 2)],
    "dpos_round": [dict(protocol="dpos", n_nodes=n, n_candidates=c,
                        n_producers=k, epoch_len=4, log_capacity=32,
                        n_sweeps=3) for n, c, k in ((1, 1, 1), (7, 5, 3))],
    "hotstuff_propose": [dict(protocol="hotstuff", f=f, n_nodes=3 * f + 1,
                              log_capacity=32, view_timeout=4, n_sweeps=3)
                         for f in (0, 2)]}
DELAY_SMALL["hotstuff_vote"] = DELAY_SMALL["hotstuff_propose"]


def path_kernels(engine_name: str) -> tuple[str, ...]:
    """The kernels a run of the engine ``engine_name`` launches (without
    telemetry)."""
    from consensus_tpu_torch import _build
    if engine_name == "raft-sparse":
        return tuple(k for k in _build.SOURCES
                     if k not in NOT_CAPPED + ("telemetry",))
    return {"raft": ("random_u32",) + DENSE, "pbft": ("delivery",) + PBFT,
            "pbft-bcast": BCAST, "dpos": DPOS,
            "paxos": ("delivery",) + PAXOS,
            "hotstuff": HOTSTUFF_ALL}[engine_name]


def storm_configs() -> dict:
    """The storm runs' configs, by name."""
    return {name: make(**kw) for name, (make, kw, _) in STORM_RUNS.items()}


def capture_calls(cfg, rounds, name, rungs=None, device="cuda") -> dict:
    """{r: [arguments]}: every call of wrapper ``name`` in each round r of
    ``rounds`` of ``cfg``'s eager run (a ladder with ``rungs``) on
    ``device``, cloned as it arrives (the capped round calls KB four
    times)."""
    from consensus_tpu_torch.network import runner
    eng = runner.engine(cfg)
    module = sys.modules[eng.round.__module__]
    lanes = runner.device_lanes(cfg, rungs, device)
    st = eng.init(cfg, lanes.pop("seed"))
    statics = eng.statics(cfg, rungs) if eng.statics else {}
    out, r0 = {}, 0
    for r in sorted(rounds):
        st = runner.advance(cfg, st, r0, r - r0, lanes=lanes, rungs=rungs)
        calls = out[r] = []

        def recorder(_, fn, calls=calls):
            def record(*args):
                calls.append(clone_args(args))
                return fn(*args)
            return record
        with standing_in(module, (name,), recorder):
            st = eng.round(cfg, st, r, **lanes, **statics)
        require(bool(calls), f"round {r} of {eng.name} did not call {name}")
        r0 = r + 1
    return out


def with_delay(name: str, args, delay: int, drop: float | None = None):
    """``args`` of wrapper ``name`` with the delay ``delay`` and, where
    given, the drop rate ``drop``: KB and KL take both as arguments, the
    others through their Config."""
    from consensus_tpu_torch.core import rng
    if name in ("delivery_edges", "delivery"):
        at_drop, at_delay = (4, 7) if name == "delivery_edges" else (3, 5)
        out = list(args) + [0] * (at_delay + 1 - len(args))
        out[at_delay] = delay
        if drop is not None:
            out[at_drop] = rng.prob_threshold_u32(drop)
        return tuple(out)
    kw = {"max_delay_rounds": delay}
    if drop is not None:
        kw["drop_rate"] = drop
    return (dataclasses.replace(args[0], **kw), *args[1:])


def loop_draws(useed, r: int, i, j, need, drop: int, delay: int) -> int:
    """The mixer draws ctt::delayed_open makes on the edges i -> j where
    ``need`` holds (those whose round draw the kernel makes): where the
    round's draw dropped, one draw at q = r - d for each d until one opens,
    and the retransmission draw where that one dropped too."""
    from consensus_tpu_torch.core import rng
    alive = need & (rng.delivery_u32_plain(useed, r, i, j) < drop)
    draws = 0
    for d in range(1, min(delay, r) + 1):
        q = r - d
        draws += int(alive.sum())
        lost = alive & (rng.delivery_u32_plain(useed, q, i, j) < drop)
        draws += int(lost.sum())
        alive = alive & ~(lost & (rng.delay_u32_plain(useed, q, d, i, j)
                                  >= drop))
    return draws


def delay_draws(name: str, args) -> int:
    """The draws of kernel ``name``'s delay loop on ``args``, on the edges
    whose round draw the kernel makes (see each source's note)."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.engines import dpos, hotstuff
    seed, r = (args[0], args[1]) if name in ("delivery_edges", "delivery") \
        else (args[1], args[2])
    dev = seed.device
    if name == "delivery":
        n, drop, delay = args[2], args[3], args[5]
        i = torch.arange(n, device=dev)[:, None]
        j = torch.arange(n, device=dev)[None, :]
        return loop_draws(rng.as_u32(seed)[:, None, None], r, i, j,
                          (i != j)[None], drop, delay)
    if name == "delivery_edges":
        ids, n, drop, src, delay = args[2], args[3], args[4], args[6], args[7]
        nodes = torch.arange(n, device=dev)
        ids = ids.to(torch.int64)
        i, j = (ids[:, :, None], nodes[None, None, :]) if src else \
            (nodes[None, :, None], ids[:, None, :])
        need = ((ids[:, :, None] if src else ids[:, None, :]) >= 0) & (i != j)
        return loop_draws(rng.as_u32(seed)[:, None, None], r,
                          rng.as_u32(i), rng.as_u32(j), need, drop, delay)
    cfg = args[0]
    drop, delay = cfg.drop_cutoff, cfg.max_delay_rounds
    useed = rng.as_u32(seed)[:, None]
    if name == "bcast_view_preprepare":
        n_real, n = args[3], args[5].shape[1]
        idx = torch.arange(n, device=dev)[None, :]
        return loop_draws(useed, r, idx, idx, idx < n_real[:, None], drop,
                          delay)
    if name == "dpos_round":
        producers, chain_r, chain_len = args[3], args[4], args[6]
        v = torch.arange(chain_len.shape[1], device=dev)[None, :]
        p = dpos.round_producer(cfg, producers, r).to(torch.int64)[:, None]
        churn = rng.random_u32_plain(seed, rng.STREAM_CHURN, r, 0, 0) \
            < cfg.churn_cutoff                                   # [B, 1]
        need = (v != p) & (chain_len < chain_r.shape[2]) & ~churn
        return loop_draws(useed, r, p, v, need, drop, delay)
    n = args[3].shape[1]
    idx = torch.arange(n, device=dev)[None, :]
    if name == "hotstuff_propose":
        view, top = args[3], args[5][:, hotstuff.TOP]
        vm = (top >> 32)[:, None]
        m = (n - 1 - (top & 0xFFFFFFFF))[:, None]
        return loop_draws(useed, r, m.clamp(0, n - 1), idx,
                          (vm >= 0) & (idx != m) & (view < vm), drop, delay)
    view1, vstar = args[3], args[4][:, hotstuff.VMAX][:, None]
    ell = torch.where(vstar >= 0, vstar % n, 0)
    pdel = hotstuff.hotstuff_vote_plain(*clone_args(args))[0]
    return loop_draws(useed, r, ell, idx,
                      (vstar >= 0) & (view1 <= vstar) & (idx != ell), drop,
                      delay) \
        + loop_draws(useed, r, idx, ell, pdel & (idx != ell), drop, delay)


def flat_work(name: str, args) -> tuple[float, float]:
    """(bytes, 32-bit operations) that kernel ``name``'s bound on its flat
    arguments ``args`` counts: phase 3's bound function of the kernel (KB's
    and KC's as check_delivery_edges and check_top_active count them),
    with ``bound`` swapped for the pair while it runs."""
    global bound
    if name == "delivery_edges":
        b, a = args[2].shape
        n = args[3]
        return b * a * n + 4 * b * a + 4 * b, EDGE_OPS * b * a * n
    if name == "top_active":
        b, n = args[0].shape
        return b * n * 5 + 4 * b * args[2], 4 * b * n
    fn = {**dict.fromkeys(PHASES, phase_bound),
          **dict.fromkeys(DENSE, dense_bound),
          "dense_telemetry": pbft_bound, **dict.fromkeys(PBFT, pbft_bound),
          **dict.fromkeys(BCAST, bcast_bound),
          **dict.fromkeys(DPOS, dpos_bound),
          **dict.fromkeys(PAXOS, paxos_bound),
          **dict.fromkeys(TELEMETRY, telemetry_bound),
          **dict.fromkeys(HOTSTUFF, hotstuff_bound)}[name]
    saved = bound
    bound = lambda nbytes, ops: (nbytes, ops)   # noqa: E731
    try:
        return fn(name, args)
    finally:
        bound = saved


def delay_bound(name: str, args) -> tuple[float, str]:
    """The least time of kernel ``name``'s work on ``args``: the bytes and
    operations of its bound without the delay, plus EDGE_OPS for each draw
    of the delay loop that these inputs need (:func:`delay_draws`)."""
    nbytes, ops = flat_work(name, args)
    return bound(nbytes, ops + EDGE_OPS * delay_draws(name, args))


def random_delivery_args(name: str, dev, gen) -> list:
    """KB's or KL's arguments on random seeds and ids (negative ones
    included) at N = 1, 7 and 1 000, rounds under and over the delays
    (one near 2**32), drop 0.55 and 0.99 and a partition every other
    round, at every delay of DELAYS."""
    from consensus_tpu_torch.core import rng
    out = []
    for n in (1, 7, 1000):
        seeds = torch.randint(0, 2**32, (3,), generator=gen, device=dev,
                              dtype=torch.int64).to(torch.uint32)
        ids = torch.randint(-1, n, (3, 4), generator=gen, device=dev,
                            dtype=torch.int32)
        for r in (0, 5, 20, 0xFFFFFFF0):
            part = rng.prob_threshold_u32(0.5)
            for drop in (0.55, 0.99):
                cut = rng.prob_threshold_u32(drop)
                for delay in DELAYS:
                    if name == "delivery":
                        out.append((seeds, r, n, cut, part, delay))
                    else:
                        out += [(seeds, r, ids, n, cut, part, src, delay)
                                for src in (True, False)]
    return out


def check_delay_kernels(dev, gen, names=DELAY):
    """Phase 15's kernels ``names``, a row each as it is done: KB, KL, KT,
    KX, KAD and KAE against their plain versions with the delay at 1, 8
    and 16, on rounds DELAY_ROUNDS of the full-width storm runs (KB:
    raft-100k; KL: raft-1kx1k and pbft-f128, round 20 of the storm's
    fs = 1..128 ladder, paxos-10kx10k's round 7 at D = 8 only; KT:
    pbft-100k-bcast, round 20 of the storm's full-width ladder; KX:
    dpos-100k; KAD and KAE: hotstuff-100k), on round 20 of each also at
    drop 0.55 and 0.99, on the N = 1 and 7 runs DELAY_SMALL at their own
    drop, 0.55 and 0.99, and KB and KL on random inputs
    (:func:`random_delivery_args`). Then each kernel's device time, its
    plain version's and its bound on its storm run's round 20 (D = 8),
    and the kernel's time and bound on the same inputs at D = 0."""
    from consensus_tpu_torch.engines import pbft_sweep
    storm = storm_configs()
    ladder = pbft_sweep._fsweep_static(STORM_LADDERS["dense-ladder"][0](),
                                       LADDER)[1]
    wide = pbft_sweep._fsweep_static(
        STORM_LADDERS["wide-bcast-ladder"][0](), WIDE_RUNGS)[1]
    # (config, rungs, rounds, delays) of each kernel's full-width runs;
    # the first is the one timed.
    full = {
        "delivery_edges": [(storm["raft-100k"], None, DELAY_ROUNDS, DELAYS)],
        "delivery": [(storm["raft-1kx1k"], None, DELAY_ROUNDS, DELAYS),
                     (storm["pbft-f128"], None, DELAY_ROUNDS, DELAYS),
                     (ladder, LADDER, (20,), DELAYS),
                     (storm["paxos-10kx10k"], None, (7,), (8,))],
        "bcast_view_preprepare": [
            (storm["pbft-100k-bcast"], None, DELAY_ROUNDS, DELAYS),
            (wide, WIDE_RUNGS, (20,), DELAYS)],
        "dpos_round": [(storm["dpos-100k"], None, DELAY_ROUNDS, DELAYS)],
        "hotstuff_propose": [(storm["hotstuff-100k"], None, DELAY_ROUNDS,
                              DELAYS)],
        "hotstuff_vote": [(storm["hotstuff-100k"], None, DELAY_ROUNDS,
                           DELAYS)]}
    for name in names:
        small = [(protocol_config(kw, n_rounds=24, seed=11, **STORM), None,
                  DELAY_ROUNDS, DELAYS) for kw in DELAY_SMALL[name]]
        err, cases, timed = 0.0, 0, None
        for k, (cfg, rungs, rounds, delays) in enumerate(full[name] + small):
            got = capture_calls(cfg, rounds, name, rungs, dev)
            if k == 0:
                # The round's call with the most delay work (KB's four
                # differ: ids of -1 draw nothing).
                timed = max(got[20], key=lambda a: delay_draws(name, a))
            for r, calls in got.items():
                # Every run here is at the storm's drop 0.55.
                drops = (None, 0.99) if r == 20 or cfg.n_nodes <= 7 \
                    else (None,)
                for args in calls:
                    for delay in delays:
                        for drop in drops:
                            err = max(err, max_abs_err(run_pair(
                                name, with_delay(name, args, delay, drop))))
                            cases += 1
        if name in ("delivery_edges", "delivery"):
            for args in random_delivery_args(name, dev, gen):
                err = max(err, max_abs_err(run_pair(name, args)))
                cases += 1
        mod = kernel_module(name)
        flat = with_delay(name, timed, 0)
        yield dict(
            name=name, cases=cases, max_abs_err=err,
            timed_on=f"{full[name][0][0].protocol} storm round 20, D = 8",
            ms=graph_ms(getattr(mod, name), timed),
            plain_ms=event_ms(getattr(mod, name + "_plain"), timed),
            loop_draws=delay_draws(name, timed),
            bound=delay_bound(name, timed),
            ms_delay_0=graph_ms(getattr(mod, name), flat),
            bound_delay_0=delay_bound(name, flat))


def check_storm_runs(card: str, smi: str) -> None:
    """Phase 15's runs: ``simulator.run`` of each storm run STORM_RUNS and
    ``pbft_fsweep_timed`` of each ladder STORM_LADDERS, replayed as one
    CUDA graph, with every launch count set to 0 just before each run and
    read just after it: its anchor from the replay and from the eager
    loop, its engine's kernels launched and no other (dpos-100k: its LIB
    against the JAX package's); steps per second, replay wall and busy
    share. Then STORM_TELEMETRY's runs with telemetry and 8-round windows:
    counter totals and recorder equal to their JAX anchors and to the
    eager loop's, the engine's telemetry kernel launched too."""
    from consensus_tpu_torch.core import serialize
    from consensus_tpu_torch.engines import pbft_sweep
    from consensus_tpu_torch.network import runner, simulator
    rows = {}
    for name, cfg in storm_configs().items():
        digest = STORM_RUNS[name][2]
        memory, launches = counted(lambda: memory_use(
            lambda: simulator.run(cfg)))
        res = memory.pop("result")
        eager = eager_digest(cfg, res)
        prof = profile_replay(cfg)
        rows[name] = row = dict(
            digest=res.digest, digest_ok=res.digest == digest,
            eager_digest=eager, steps_per_sec=res.steps_per_sec,
            wall_s=res.wall_s, launches=launches, **memory,
            replay_wall_ms=prof["replay_wall_ms"],
            busy_share=prof["busy_share"],
            unprofiled_busy_share=prof["unprofiled_busy_share"],
            device_ms=prof["device_ms"],
            device_launches=prof["device_launches"],
            hand_kernel_ms={k: v for k, v in prof["hand_kernel_ms"].items()
                            if v})
        if cfg.protocol == "dpos":
            row["lib_sha256"] = hashlib.sha256(np.ascontiguousarray(
                res.extras["lib"], dtype="<i8").tobytes()).hexdigest()
            require(row["lib_sha256"] == DPOS_STORM_LIB_SHA256,
                    f"{name}: LIB {row['lib_sha256']}")
        require(int(res.counts.max()) > 0, f"{name}: empty decided logs")
        require(res.digest == digest, f"{name} digest {res.digest} != "
                f"{digest}")
        require(eager == digest, f"{name}: the eager loop's digest {eager}")
        require_launched(launches, path_kernels(runner.engine(cfg).name),
                         name)
        runner.clear_graphs()
    for name, (make, rungs, digest) in STORM_LADDERS.items():
        base = make()
        memory, launches = counted(lambda: memory_use(
            lambda: pbft_sweep.pbft_fsweep_timed(base, rungs, repeats=3)))
        out, first_s, best, real_steps = memory.pop("result")
        got = serialize.digest(pbft_sweep.fsweep_payload(out))
        eager = serialize.digest(pbft_sweep.fsweep_payload(
            pbft_sweep.pbft_fsweep_run(base, rungs, graph=False)))
        cfg_pad = pbft_sweep._fsweep_static(base, rungs)[1]
        prof = profile_replay(cfg_pad, rungs=rungs)
        rows[name] = dict(
            digest=got, digest_ok=got == digest, eager_digest=eager,
            real_steps=real_steps, wall_s=best,
            real_steps_per_sec=real_steps / best, first_run_s=first_s,
            launches=launches, **memory,
            replay_wall_ms=prof["replay_wall_ms"],
            busy_share=prof["busy_share"],
            unprofiled_busy_share=prof["unprofiled_busy_share"],
            device_ms=prof["device_ms"],
            device_launches=prof["device_launches"])
        require(got == digest and eager == digest,
                f"{name}: digests {got} (replay), {eager} (eager) != "
                f"{digest}")
        require_launched(launches, path_kernels(runner.engine(cfg_pad).name),
                         name)
        runner.clear_graphs()
    telemetry = {}
    for name, (nonzero, flight) in STORM_TELEMETRY.items():
        make, kw, digest = STORM_RUNS[name]
        cfg = make(**kw, telemetry_window=WINDOW)
        eng = runner.engine(cfg)
        res, launches = counted(lambda: simulator.run(cfg, telemetry=True))
        tel, fl = res.extras["telemetry"], res.extras["flight"]
        eager = runner.telemetry_stats(cfg, runner.run_device(
            cfg, telemetry=True, graph=False))
        want = {k: nonzero.get(k, 0) for k in eng.telemetry_names}
        telemetry[name] = row = dict(
            digest=res.digest, digest_ok=res.digest == digest,
            totals=tel["totals"], totals_ok=tel["totals"] == want,
            flight_sha256=flight_digest(fl),
            flight_ok=flight_digest(fl) == flight,
            graph_equals_eager=flight_digest(eager["flight"]) ==
            flight_digest(fl) and all(
                np.array_equal(eager["telemetry"][k], v)
                for k, v in tel["per_sweep"].items()),
            steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
            launches=launches)
        for check in ("digest_ok", "totals_ok", "flight_ok",
                      "graph_equals_eager"):
            require(row[check], f"{name} storm with telemetry: {check} "
                    "fails")
        require_launched(launches, TELEMETRY_PATHS[eng.name],
                         f"{name} storm with telemetry")
        runner.clear_graphs()
    emit("delay", runs=rows, telemetry=telemetry,
         profiler_sessions_redone=REDONE, card=card, power=smi)


# --- phase 16: SPEC §6c crash-recover ----------------------------------------

# consensus_tpu/scenarios/__init__.py crash-churn-under-partition's overrides
# (lines 216-218): at N = 100 000 the cap of 2 binds nearly every round.
CHURN_PARTITION = dict(crash_prob=0.12, recover_prob=0.35, max_crashed=2,
                       partition_rate=0.25, churn_rate=0.05, drop_rate=0.05)
# tests/test_crash.py's CRASH (line 32), no cap, over each flagship's own
# drop and churn: about a third of the nodes are down, which loads the
# freeze.
CRASH = dict(crash_prob=0.15, recover_prob=0.3)
# The six flagships of the engines that run §6c, at their own shapes.
CRASH_FLAGSHIPS = {
    "raft-100k": flagship_config,
    "raft-1kx1k": gate_1kx1k,
    "pbft-f128": lambda **kw: pbft_config(128, **kw),
    "pbft-100k-bcast": bcast_config,
    "paxos-10kx10k": lambda **kw: protocol_config(PAXOS_FLAGSHIP, **kw),
    "dpos-100k": lambda **kw: protocol_config(DPOS_FLAGSHIP, **kw),
}
CRASH_SETTINGS = {"capped": CHURN_PARTITION, "uncapped": CRASH,
                  "composed": dict(CRASH, max_delay_rounds=6)}
# The crash runs' anchors, made by the JAX package on the CPU and again by
# the C++ oracle (engine="cpu"), which agrees on each:
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   for key in chip_smoke.CRASH_RUNS:
#       cfg = Config(**dataclasses.asdict(chip_smoke.crash_config(key)))
#       print(key, simulator.run(cfg, warmup=False).digest,
#             simulator.run(dataclasses.replace(cfg, engine="cpu"),
#                           warmup=False).digest)
#   EOF
#
# (the JAX runs took 2.5-389 s each on eight cores: paxos-10kx10k
# uncapped 389 s; the raft-1kx1k runs at GATE_1KX1K_ROUNDS rounds 21 and
# 206 s, 524 s at all 1 024 rounds, a cut). "composed" is
# raft-100k with the uncapped crash and max_delay_rounds = 6, as
# chained-commit-stall composes a crash with a delay.
CRASH_RUNS = {
    "raft-100k/capped":
        "1c628d861580d94c3fff8b95ad25bddd60ca7baebefc32a8d590c43b39dd8f03",
    "raft-100k/uncapped":
        "9cb5a3412169891321f5794db88a2805b4861a52ac9d36f13adef7f13875a346",
    "raft-100k/composed":
        "9fe2192dbc06dd922e54221eef2b8ceb9008bab3ad48f46388ff6648f944c00a",
    "raft-1kx1k/capped":
        "d634824c20e23ba0bdf3498ab73ccb1e8af6fcee69accac9f17887bf370dfad6",
    "raft-1kx1k/uncapped":
        "5699c500d312f14555232f30f362aeb3469225b9a395241da4c90f26bc30cf04",
    "pbft-f128/capped":
        "0a5e5c1646063c5bd1b6bda99f73d28075aebcc98e017735f53a90903c37e683",
    "pbft-f128/uncapped":
        "186525cde1e28f8ae11f0e99679744c7e902594f8c294f8b7192b3e72022261c",
    "pbft-100k-bcast/capped":
        "7616e77c118d61375c12910024b9e237f5725ab6ba1fe78fd1c0e4c5bd155dd2",
    "pbft-100k-bcast/uncapped":
        "396a17add49b3e125d31a13d052f2a58582c86c755ed599c2ad46b256a516317",
    "paxos-10kx10k/capped":
        "60640d8d8e47668f8f15544271e7926a2467826ebf8408ad11256a5749635268",
    "paxos-10kx10k/uncapped":
        "9b6be8f77b6a953aaf4278d35124130703f6b8cc5879f32d772cd8631a2c6205",
    "dpos-100k/capped":
        "2328d9899e2836506c64e808a1f6b03a14471efe2a163cc4e49cf5488ddabfb7",
    "dpos-100k/uncapped":
        "66d7a0664014aec4af2122a84153c5a065db42aecd8b65b0b8dfe96413c1db48",
}
# dpos-100k's LIB under each crash setting (extras["lib"], hashed as
# DPOS_LIB_SHA256 is), made by the JAX package with the anchors above.
CRASH_DPOS_LIB_SHA256 = {
    "dpos-100k/capped":
        "e049d8deac20334e86661468a6fd81becbb2fa9fa55835f9b3795d8315930b2e",
    "dpos-100k/uncapped":
        "6c72cae9e005e0449c9861b5205b3c0221d05cb66ca5a8df29e615c7230e227c"}
# The uncapped runs again with telemetry and 8-round windows: (nonzero
# counter totals, flight_digest), made by the JAX package on the CPU as
# BFT_TELEMETRY's were.
CRASH_TELEMETRY = {
    "raft-100k": (
        {"leader_elections": 62, "append_accepted": 11796319,
         "append_rejected": 6852141, "entries_committed": 13327116,
         "crashes": 5765336, "recoveries": 5468659, "nodes_down": 18527198},
        "329dfead2f46de86bf708cd9971abccc0c68386c93c9517a0a2c7639e7e52a18"),
    "pbft-100k-bcast": (
        {"prepare_quorums": 1864956, "prepare_missed": 500261660,
         "commit_quorums": 1864956, "commits_adopted": 635044,
         "view_changes": 1474388, "crashes": 5764054, "recoveries": 5466661,
         "nodes_down": 18528074, "view_spread_max": 1435,
         "desync_rounds": 419},
        "b8efefe5d93f04bfc52f16960f7a86f6d32454f07a1ecbcd5e7c80dfe3c14f50"),
    "paxos-10kx10k": (
        {"promises": 509685233, "nacks": 191065747, "accepts": 508123449,
         "proposals_decided": 77458, "values_learned": 98704795,
         "crashes": 18678, "recoveries": 15009, "nodes_down": 53455},
        "231de5fcfd04b99b18162501b9bf76e891e791d6f754ee37504f8690f7b5e7b9"),
    "dpos-100k": (
        {"blocks_appended": 9636590, "missed_appends": 15963410,
         "producer_rotations": 255, "crashes": 2854639, "recoveries": 2817675,
         "nodes_down": 9429871},
        "f3d548d7894fee53e4a089536dbe7436e33fad262e7537c928301c54ad88924c"),
}
# The round of each crash run whose kernel calls phase 16 holds against the
# plain versions and times (paxos-10kx10k has 16 rounds: its last).
CRASH_ROUND = {"paxos-10kx10k": 15}
# The kernels with a CRASH instance; each takes what picks it (the round's
# flag word, or a crash mode) as its last positional argument.
CRASH_INSTANCES = ("delivery_edges", "candidacy", "elect", "acks_commit",
                   "delivery", "dense_elect", "dense_append",
                   "dense_acks_commit", "pbft_view_preprepare",
                   "bcast_view_preprepare", "bcast_tally", "bcast_decide",
                   "pbft_telemetry", "dpos_round", "paxos_promise")
CRASH_OWN = ("crash_transition", "freeze_down")
CRASH_REPLACES = {
    "crash_transition": "consensus_tpu/ops/adversary.py:101 "
                        "crash_transition, :143 crash_counts",
    "freeze_down": "consensus_tpu/ops/adversary.py:133 freeze_down"}


def crash_config(key: str, **kw):
    """The crash run ``key`` ("<flagship>/<setting>"), changed by ``kw``."""
    name, setting = key.split("/")
    return CRASH_FLAGSHIPS[name](**CRASH_SETTINGS[setting], **kw)


def crash_path(engine_name: str, telemetry: bool = False):
    """The kernels a crash run of the engine launches: its flat path's
    (with telemetry, its telemetry path's), KAH, and KAI where the engine
    freezes by a launch of its own."""
    raft_tail = {"raft-sparse": ("telemetry",), "raft": ("dense_telemetry",)}
    if telemetry and engine_name in raft_tail:
        base = path_kernels(engine_name) + raft_tail[engine_name]
    elif telemetry:
        base = TELEMETRY_PATHS[engine_name]
    else:
        base = path_kernels(engine_name)
    freeze = ("freeze_down",) if engine_name in ("pbft", "pbft-bcast") \
        else ()
    return base + ("crash_transition",) + freeze


@contextlib.contextmanager
def recording_everywhere(got):
    """Every kernel wrapper, in every module of the port that holds it,
    replaced by a stand-in that appends a clone of its arguments to
    ``got[name]`` and calls it (the §6c wrappers are called from several
    modules)."""
    from consensus_tpu_torch.network import runner
    wrappers = {name: getattr(mod, name) for mod, name in runner.KERNELS}
    swapped = []
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("consensus_tpu_torch"):
            continue
        for name, fn in wrappers.items():
            if getattr(mod, name, None) is fn:
                def record(*args, fn=fn, name=name):
                    got.setdefault(name, []).append(clone_args(args))
                    return fn(*args)
                record.launches = record.switch_launches = 0
                record.knob_launches = 0
                setattr(mod, name, record)
                swapped.append((mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in swapped:
            setattr(mod, name, fn)


def capture_round_calls(cfg, r: int, telemetry: bool, device="cuda"):
    """{wrapper: [arguments]}: every kernel call of round ``r`` of
    ``cfg``'s eager run on ``device``, with telemetry and the recorder
    where asked, cloned as it arrives."""
    from consensus_tpu_torch.network import runner
    eng = runner.engine(cfg)
    lanes = runner.device_lanes(cfg, None, device)
    seeds = lanes.pop("seed")
    telem, flight = (runner.accumulators(cfg, device) if telemetry
                     else (None, None))
    st = runner.advance(cfg, eng.init(cfg, seeds), 0, r, telem=telem,
                        flight=flight, lanes=lanes)
    acc = {} if telem is None else dict(telem=telem, flight=flight)
    statics = eng.statics(cfg, None) if eng.statics else {}
    got: dict = {}
    with recording_everywhere(got):
        eng.round(cfg, st, r, **lanes, **acc, **statics)
    return got


# The CRASH instances picked by a crash argument, and its flat value; the
# others are picked by the round's flag word (None on the flat path).
CRASH_MODES = {"bcast_tally": False, "bcast_decide": False,
               "pbft_telemetry": 0}


def flat_instance(name: str, args):
    """``args`` of CRASH-instance kernel ``name`` with its last positional
    argument, which picks the instance, set to the flat path's value."""
    return (*args[:-1], CRASH_MODES.get(name))


def crash_kernel_bound(name: str, args) -> tuple[float, str]:
    """The least time of kernel ``name``'s work on crash-run ``args``:
    for KAH the three [B, N] byte rows and the Threefry draws these masks
    need, for KAI the flag bytes and each down node's rows read and
    written once, for any other kernel its flat bound on the same inputs
    plus one flag byte a node where its CRASH instance reads the flags."""
    from consensus_tpu_torch.ops import adversary
    if name == "crash_transition":
        seed, down = args[0], args[2]
        b, n = down.shape
        draws = int(down.sum()) + int((~down).sum())
        return bound(3 * b * n + 4 * b, THREEFRY_OPS * draws + 8 * b * n)
    if name == "freeze_down":
        flags, leaves = args
        dn = int(((flags & adversary.CRASH_DOWN) != 0).sum())
        row = sum(d[0, 0].numel() * d.element_size() for d, _, _ in leaves)
        return bound(flags.numel() + 2 * dn * row, flags.numel())
    flat = flat_instance(name, args) if name in CRASH_MODES else args[:-1] \
        if name in CRASH_INSTANCES else args
    # The bound functions that unpack a flat call without its options.
    flat = flat[:{"bcast_view_preprepare": 12, "dpos_round": 7}.get(
        name, len(flat))]
    nbytes, ops = flat_work(name, flat)
    flags = args[-1]
    if isinstance(flags, torch.Tensor):
        nbytes += flags.numel()
    return bound(nbytes, ops)


def reps_for(args) -> int:
    """Calls a timing of ``args`` makes (each on clones of its own): 20,
    fewer where that would take more than 8 GB (paxos-10kx10k's rows)."""
    size = sum(t.nbytes for t in tensors_of(args))
    return max(2, min(20, (8 << 30) // (2 * max(size, 1))))


def random_crash_args(dev, gen) -> list:
    """KAH's arguments on random down masks at N = 1, 7 and 100 000 (B =
    8), max_crashed 0, 1, 3 and N, cutoffs (0.12, 0.35) and (0.99, 0.99),
    rounds 0, 3 and 20, with the totals and the window ring."""
    from consensus_tpu_torch.core import rng
    out = []
    for n in (1, 7, N):
        seeds = torch.randint(0, 2**32, (B,), generator=gen, device=dev,
                              dtype=torch.int64).to(torch.uint32)
        for cap in sorted({0, 1, 3, n}):
            for crash, rec in ((0.12, 0.35), (0.99, 0.99)):
                for r in (0, 3, 20):
                    down = torch.rand((B, n), generator=gen, device=dev) \
                        < 0.3
                    t = torch.randint(0, 9, (B, 11), generator=gen,
                                      device=dev, dtype=torch.int32)
                    w = torch.randint(0, 9, (B, 3, 11), generator=gen,
                                      device=dev, dtype=torch.int32)
                    out.append((seeds, r, down,
                                rng.prob_threshold_u32(crash),
                                rng.prob_threshold_u32(rec), cap, t, w, 5,
                                2))
    return out


def check_crash_kernels(dev, gen):
    """Phase 16's kernel rows. KAH against its plain version on random
    masks (:func:`random_crash_args`); then, for each flagship, every
    kernel call of round 20 (paxos-10kx10k: 15) of its uncapped crash run
    with telemetry and 8-round windows and of its capped one without,
    against the plain versions (KAI's on its leaves), each kernel timed
    on the uncapped call (the largest where a round calls it more than
    once), the CRASH instances also through their flat instance on the
    same inputs, with the plain version's time and the bound. Yields the
    rows of KAH and KAI first (with the phase-3 keys) and then one row a
    (flagship, kernel)."""
    random_args = random_crash_args(dev, gen)
    err = max(max_abs_err(run_pair("crash_transition", a))
              for a in random_args)
    cases = {"crash_transition": len(random_args), "freeze_down": 0}
    timed: dict = {}
    errs = {"crash_transition": err, "freeze_down": 0.0}
    rows = []
    for flag, make in CRASH_FLAGSHIPS.items():
        r = CRASH_ROUND.get(flag, 20)
        for setting, telemetry in (("uncapped", True), ("capped", False)):
            kw = dict(telemetry_window=WINDOW) if telemetry else {}
            cfg = crash_config(f"{flag}/{setting}", **kw)
            calls = capture_round_calls(cfg, r, telemetry, dev)
            for name, arg_list in calls.items():
                for args in arg_list:
                    e = max_abs_err(run_pair(name, args))
                    if name in errs:
                        errs[name] = max(errs[name], e)
                        cases[name] += 1
                    require(e == 0.0, f"{name} on {flag}/{setting} round "
                            f"{r} disagrees with its plain version")
                if not telemetry:
                    continue
                # The call timed: the one with the most work.
                args = max(arg_list, key=lambda a: crash_kernel_bound(
                    name, a)[0])
                if name in CRASH_OWN:
                    if name not in timed or crash_kernel_bound(
                            name, args)[0] > crash_kernel_bound(
                                name, timed[name][1])[0]:
                        timed[name] = (flag, args)
                    continue
                mod = kernel_module(name)
                reps = reps_for(args)
                row = dict(flagship=flag, name=name, round=r,
                           calls_a_round=len(arg_list),
                           crash_instance=name in CRASH_INSTANCES,
                           ms=graph_ms(getattr(mod, name), args, reps),
                           plain_ms=event_ms(getattr(mod, name + "_plain"),
                                             args, min(5, reps)),
                           bound=crash_kernel_bound(name, args))
                if name in CRASH_INSTANCES:
                    flat = flat_instance(name, args)
                    row["flat_instance_ms"] = graph_ms(getattr(mod, name),
                                                       flat, reps)
                rows.append(row)
    from consensus_tpu_torch.ops import adversary
    for name in CRASH_OWN:
        flag, args = timed[name]
        ms = graph_ms(getattr(adversary, name), args)
        plain = event_ms(getattr(adversary, name + "_plain"), args)
        yield dict(name=name, route="cuda",
                   source=f"consensus_tpu_torch/csrc/{name}.cu",
                   replaces=CRASH_REPLACES[name], max_abs_err=errs[name],
                   cases=cases[name], timed_on=f"{flag} uncapped crash "
                   f"round {CRASH_ROUND.get(flag, 20)}", ms=ms,
                   plain_ms=plain, bound=crash_kernel_bound(name, args),
                   library_ms=None)
    # KAH's cap instance, on raft-100k's capped round 20.
    capped = capture_round_calls(crash_config("raft-100k/capped"), 20, False,
                                 dev)["crash_transition"][0]
    yield dict(name="crash_transition (cap instance)", flagship="raft-100k",
               capped=True, ms=graph_ms(adversary.crash_transition, capped),
               plain_ms=event_ms(adversary.crash_transition_plain, capped),
               bound=crash_kernel_bound("crash_transition", capped))
    yield from rows


def check_crash_runs(card: str, smi: str) -> dict[str, int]:
    """Phase 16's runs: ``simulator.run`` of each crash run CRASH_RUNS,
    replayed as one CUDA graph, with every launch count set to 0 just
    before each run and read just after it: its anchor from the replay and
    from the eager loop, its engine's kernels, KAH and (PBFT) KAI launched
    and no other; steps per second, replay wall, busy share and KAH's
    share of the device time. Then CRASH_TELEMETRY's runs with telemetry
    and 8-round windows: counters (crash tail included) and recorder equal
    to their JAX anchors and to the eager loop's. Returns KAH's and KAI's
    launches in raft-100k's and pbft-100k-bcast's uncapped runs."""
    from consensus_tpu_torch.network import runner, simulator
    rows, own = {}, {}
    for key, digest in CRASH_RUNS.items():
        cfg = crash_config(key)
        memory, launches = counted(lambda: memory_use(
            lambda: simulator.run(cfg)))
        res = memory.pop("result")
        eager = eager_digest(cfg, res)
        prof = profile_replay(cfg)
        rows[key] = dict(
            digest=res.digest, digest_ok=res.digest == digest,
            eager_digest=eager, steps_per_sec=res.steps_per_sec,
            wall_s=res.wall_s, launches=launches, **memory,
            replay_wall_ms=prof["replay_wall_ms"],
            busy_share=prof["busy_share"],
            unprofiled_busy_share=prof["unprofiled_busy_share"],
            device_ms=prof["device_ms"],
            device_launches=prof["device_launches"],
            crash_transition_share=prof["hand_kernel_ms"]["crash_transition"]
            / prof["device_ms"],
            hand_kernel_ms={k: v for k, v in prof["hand_kernel_ms"].items()
                            if v})
        if key in CRASH_DPOS_LIB_SHA256:
            rows[key]["lib_sha256"] = hashlib.sha256(np.ascontiguousarray(
                res.extras["lib"], dtype="<i8").tobytes()).hexdigest()
            require(rows[key]["lib_sha256"] == CRASH_DPOS_LIB_SHA256[key],
                    f"{key}: LIB {rows[key]['lib_sha256']}")
        emit("crash_run", run=key, **rows[key], card=card, power=smi)
        require(int(res.counts.max()) > 0, f"{key}: empty decided logs")
        require(res.digest == digest, f"{key} digest {res.digest} != "
                f"{digest}")
        require(eager == digest, f"{key}: the eager loop's digest {eager}")
        require_launched(launches, crash_path(runner.engine(cfg).name), key)
        if key in ("raft-100k/uncapped", "pbft-100k-bcast/uncapped"):
            own[key.split("/")[0]] = launches
        runner.clear_graphs()
    for name, (nonzero, flight) in CRASH_TELEMETRY.items():
        cfg = crash_config(f"{name}/uncapped", telemetry_window=WINDOW)
        eng = runner.engine(cfg)
        res, launches = counted(lambda: simulator.run(cfg, telemetry=True))
        tel, fl = res.extras["telemetry"], res.extras["flight"]
        eager = runner.telemetry_stats(cfg, runner.run_device(
            cfg, telemetry=True, graph=False))
        want = {k: nonzero.get(k, 0) for k in eng.telemetry_names}
        row = dict(
            digest=res.digest,
            digest_ok=res.digest == CRASH_RUNS[f"{name}/uncapped"],
            totals=tel["totals"], totals_ok=tel["totals"] == want,
            flight_sha256=flight_digest(fl),
            flight_ok=flight_digest(fl) == flight,
            graph_equals_eager=flight_digest(eager["flight"]) ==
            flight_digest(fl) and all(
                np.array_equal(eager["telemetry"][k], v)
                for k, v in tel["per_sweep"].items()),
            steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
            launches=launches)
        emit("crash_telemetry", run=name, **row, card=card, power=smi)
        for check in ("digest_ok", "totals_ok", "flight_ok",
                      "graph_equals_eager"):
            require(row[check], f"{name} crash with telemetry: {check} "
                    "fails")
        require(min(tel["totals"][k] for k in ("crashes", "recoveries",
                                                "nodes_down")) > 0,
                f"{name}: the crash tail counted nothing")
        require_launched(launches, crash_path(eng.name, telemetry=True),
                         f"{name} crash with telemetry")
        runner.clear_graphs()
    return {"crash_transition": own["raft-100k"]["crash_transition"],
            "freeze_down": own["pbft-100k-bcast"]["freeze_down"]}


# --- phase 17: SPEC §B view desync, and SPEC §6c on HotStuff -----------------

# consensus_tpu/scenarios/__init__.py view-desync-storm's overrides (lines
# 198-199). At hotstuff-100k no QC forms under them: of the 66 667 votes a
# QC needs, about 0.75 x 0.75 x 100 000 reach the leader, so its decided
# logs stay empty, and the views (VIEWS_SHA256) and the telemetry tell its
# runs apart.
DESYNC = dict(desync_rate=0.15, max_skew_rounds=4, drop_rate=0.25,
              view_timeout=4)
DESYNC_FLAGSHIPS = {
    "hotstuff-100k": lambda **kw: protocol_config(HOTSTUFF_FLAGSHIP, **kw),
    "pbft-f128": lambda **kw: pbft_config(128, **kw),
    "pbft-100k-bcast": bcast_config,
}
# Phase 17's runs, "<flagship>/<setting>": (overrides, anchor). "capped"
# and "uncapped" are phase 16's CHURN_PARTITION and CRASH; "composed" is
# CRASH with the desync (and, on HotStuff, max_delay_rounds = 2). The
# anchors were made by the JAX package on the CPU and again by the C++
# oracle (engine="cpu"), which agrees on each:
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   for key in chip_smoke.DESYNC_RUNS:
#       cfg = Config(**dataclasses.asdict(chip_smoke.desync_config(key)))
#       print(key, simulator.run(cfg, warmup=False).digest,
#             simulator.run(dataclasses.replace(cfg, engine="cpu"),
#                           warmup=False).digest)
#   EOF
#
# (the JAX runs took 2.4-197 s each on eight cores: pbft-100k-bcast 197 s;
# nothing cut).
DESYNC_RUNS = {
    "hotstuff-100k/desync": (
        DESYNC,
        "f378cec60161f4cc24d5473db85cd828519ebcb5254674eeae90ffd110d00168"),
    "hotstuff-100k/capped": (
        CHURN_PARTITION,
        "1547fd3b473112a9c88fa05f0c19d5d14b54ee7ffdb2706ec83a241e33d5ef61"),
    "hotstuff-100k/uncapped": (
        CRASH,
        "37a8478797a5551cbe5900f9ccfacf4d41a1be8872503db8f7b665131ec3c6db"),
    "hotstuff-100k/composed": (
        dict(CRASH, **DESYNC, max_delay_rounds=2),
        "f378cec60161f4cc24d5473db85cd828519ebcb5254674eeae90ffd110d00168"),
    "pbft-f128/desync": (
        DESYNC,
        "984447806eeb5e0eb3a84b7edd4935f7061abeb23546649d5f546b83c20c51e5"),
    "pbft-f128/composed": (
        dict(CRASH, **DESYNC),
        "0a46d25f9e81c962756c47a1010f211591a73d98df51ce1d1cbc516753bce527"),
    "pbft-100k-bcast/desync": (
        DESYNC,
        "370b7aef4e5a66b62a1327abc37f5b07a3591fb7893c34481be4625a8908932e"),
}
# SHA-256 of the HotStuff runs' final views (the extract's "view", [B, N]
# little-endian int32), made by the JAX package with the anchors above
# (consensus_tpu.network.runner.run of the same configs).
VIEWS_SHA256 = {
    "hotstuff-100k/desync":
        "2a4762252ef21df66b6d0dac54b9d98f3b6d7b47974a089fa4c83d4a65d80775",
    "hotstuff-100k/capped":
        "56b4c4ca10bcd1ca64c87034602e8c3ee15c3e8b213cd9a6afe05609494bd57c",
    "hotstuff-100k/uncapped":
        "580edfa4b7767c70090cd09dcadeb8c33d1cb99dfe7853846e3ad9b1b482d5d8",
    "hotstuff-100k/composed":
        "2a810c707659d7b9ddf68369cfe29890b24c71619e81ab569b72b7d287284d1f"}
# The two ladders with DESYNC added to their knobs, (base config, rungs,
# anchor), made by the JAX package as the bcast ladders' anchors above
# (pbft_sweep.pbft_fsweep_run; 54 s and 69 s).
DESYNC_LADDERS = {
    "dense-ladder": (
        lambda: pbft_config(1, **DESYNC), LADDER,
        "5e98d4d4e8a7bcd2e010fe2d7f85f7f7016139c66912fde105dcb68af0e1d83a"),
    "wide-bcast-ladder": (
        lambda: wide_base(**DESYNC), WIDE_RUNGS,
        "606082b0d8b16fdf25d0c5783664ef358e2211b477b0c16e8859695ffc710545"),
}
# Runs again with telemetry and 8-round windows: (nonzero counter totals,
# flight_digest), made by the JAX package on the CPU as BFT_TELEMETRY's
# were.
DESYNC_TELEMETRY = {
    "hotstuff-100k/desync": (
        {"view_changes": 2414158, "proposals_delivered": 29003540,
         "votes_counted": 21751758, "view_spread_max": 1762,
         "desync_rounds": 512, "sync_msgs_delivered": 37087958},
        "3812a09cc5acf999dba7911ed9c7b0b3d01e05aa7ffc8e72478678e80df651d3"),
    "hotstuff-100k/uncapped": (
        {"qc_formed": 15, "blocks_committed": 2, "commits_learned": 200000,
         "view_changes": 30580, "proposals_delivered": 20983867,
         "votes_counted": 20774425, "crashes": 5763223,
         "recoveries": 5465584, "nodes_down": 18524432,
         "view_spread_max": 1027, "desync_rounds": 362,
         "sync_msgs_delivered": 4851239},
        "5295b8bc95b33feffaea87b42232694019874f1e837e1f8fa0954942c891652a"),
    "pbft-100k-bcast/desync": (
        {"prepare_quorums": 11925370, "prepare_missed": 66625317,
         "commit_quorums": 11925370, "commits_adopted": 874630,
         "view_changes": 12479144, "view_spread_max": 2609,
         "desync_rounds": 512, "sync_msgs_delivered": 5656890},
        "c39a4e24d0a75e5d7eaf475a98ac5b1aeba5ee7b8dc49432d7dfee47b6bcf87d"),
}
# The rounds phase 17 holds every kernel call of against its plain version.
DESYNC_ROUNDS = (3, 20)
# The kernel this slice adds, and the kernels with a DESYNC or (HotStuff) a
# CRASH instance this slice adds; each instance is picked by the Config
# (KQ, KT) or by the round's flag word (KAD, KAE: their last positional
# argument; KAF: its ``crash`` triple).
DESYNC_OWN = ("hotstuff_prologue",)
DESYNC_INSTANCES = ("pbft_view_preprepare", "bcast_view_preprepare",
                    "hotstuff_propose", "hotstuff_vote", "hotstuff_learn")
DESYNC_REPLACES = {
    "hotstuff_prologue": "consensus_tpu/engines/hotstuff.py:207 "
                         "hotstuff_round §6c/§B prologue and P1's key, "
                         "consensus_tpu/ops/viewsync.py:40 desync_skew"}
# The kernel of each instance timed, with the run and round it is timed on.
DESYNC_TIMED = {"pbft_view_preprepare": "pbft-f128/desync",
                "bcast_view_preprepare": "pbft-100k-bcast/desync",
                "hotstuff_prologue": "hotstuff-100k/composed",
                "hotstuff_propose": "hotstuff-100k/uncapped",
                "hotstuff_vote": "hotstuff-100k/uncapped",
                "hotstuff_learn": "hotstuff-100k/uncapped"}


def desync_config(key: str, **kw):
    """Phase 17's run ``key`` ("<flagship>/<setting>"), changed by ``kw``."""
    name = key.split("/")[0]
    return DESYNC_FLAGSHIPS[name](**DESYNC_RUNS[key][0], **kw)


def desync_path(cfg, telemetry: bool = False) -> tuple[str, ...]:
    """The kernels a run of ``cfg`` launches: its engine's path (with
    telemetry, its telemetry path), KAH and (PBFT) KAI with a crash, KAJ
    on a gated HotStuff run, and KAK on an equivocating §6b run."""
    from consensus_tpu_torch.engines import hotstuff
    from consensus_tpu_torch.network import runner
    eng = runner.engine(cfg).name
    if cfg.crash_on:
        base = crash_path(eng, telemetry)
    else:
        base = TELEMETRY_PATHS[eng] if telemetry else path_kernels(eng)
    if eng == "hotstuff" and hotstuff.gated(cfg):
        base = base + DESYNC_OWN
    if eng == "pbft-bcast" and cfg.byz == 2:
        base = base + BYZ_BCAST_OWN
    return base


def views_sha256(view) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        view, dtype="<i4").tobytes()).hexdigest()


def desync_flat(name: str, args):
    """``args`` of kernel ``name`` with its DESYNC or CRASH instance turned
    off: the Config's desync (KQ, KT), the flag word (KAD, KAE) or the
    crash triple (KAF)."""
    if name in ("pbft_view_preprepare", "bcast_view_preprepare"):
        return (dataclasses.replace(args[0], desync_rate=0.0,
                                    max_skew_rounds=1), *args[1:])
    return (*args[:-1], None)


def skew_draws(cfg, seed, r: int, n: int) -> int:
    """The Threefry draws ctt::desync_skew makes for the [B] ``seed`` lanes
    of ``n`` nodes in round ``r``: each node's activation draw, and its
    depth draw where that fires; none without a desync."""
    from consensus_tpu_torch.ops import viewsync
    if not cfg.desync_on:
        return 0
    ids = torch.arange(n, dtype=torch.int64, device=seed.device)
    fired = int((viewsync.desync_skew_plain(
        seed, r, ids, cfg.desync_cutoff, cfg.max_skew_rounds) > 0).sum())
    return seed.shape[0] * n + fired


def prologue_bound(args) -> tuple[float, str]:
    """KAJ's least time on ``args``: each node's view and timer read and
    written once, its flag byte where a crash is on, and the skew's draws
    (:func:`skew_draws`)."""
    cfg, seed, r, view = args[:4]
    flags = args[6] if len(args) > 6 else None
    b, n = view.shape
    nbytes = 16 * b * n + 16 * b + (0 if flags is None else b * n)
    return bound(nbytes, THREEFRY_OPS * skew_draws(cfg, seed, r, n)
                 + 8 * b * n)


def desync_kernel_bound(name: str, args) -> tuple[float, str]:
    """The least time of kernel ``name``'s work on a gated round's
    ``args``: KAJ's own (:func:`prologue_bound`); for KQ and KT their flat
    bound plus the skew's draws; for KAD-KAF their flat bound plus one
    flag byte a node where the CRASH instance reads the flags (KAF: and
    the input view and timer of the down nodes)."""
    from consensus_tpu_torch.ops import adversary
    if name == "hotstuff_prologue":
        return prologue_bound(args)
    flat = desync_flat(name, args)
    nbytes, ops = flat_work(name, flat[:12] if name ==
                            "bcast_view_preprepare" else flat)
    cfg = args[0]
    if name in ("pbft_view_preprepare", "bcast_view_preprepare"):
        view = args[6 if name == "pbft_view_preprepare" else 5]
        ops += THREEFRY_OPS * skew_draws(cfg, args[1], args[2],
                                         view.shape[1])
    crash = args[-1]
    if isinstance(crash, tuple):
        flags = crash[0]
        dn = int(((flags & adversary.CRASH_DOWN) != 0).sum())
        nbytes += flags.numel() + 8 * dn
    elif isinstance(crash, torch.Tensor):
        nbytes += crash.numel()
    return bound(nbytes, ops)


def calls_from(cfg, st, r: int, telemetry: bool, device="cuda"):
    """{wrapper: [arguments]}: every kernel call of round ``r`` of ``cfg``
    from state ``st`` on ``device`` (fresh accumulators where asked)."""
    from consensus_tpu_torch.network import runner
    eng = runner.engine(cfg)
    telem, flight = (runner.accumulators(cfg, device) if telemetry
                     else (None, None))
    acc = {} if telem is None else dict(telem=telem, flight=flight)
    got: dict = {}
    with recording_everywhere(got):
        eng.round(cfg, st, r, **acc)
    return got


def hotstuff_gate_states(dev) -> list:
    """(cfg, state, round) of HotStuff states built around their round's
    crash transition (KAH's plain version on the state's seeds and down
    mask), at N = 13 (B = 6) and at hotstuff-100k's width (B = 8): a node
    down at the round's end holds the unique highest view; every node is
    down (crash 1.0, recover 0: no gossip); a recovered node had the
    highest view and ties the live nodes at view 0 after its reset; down
    nodes skewed with their timers one short of the timeout (desync 0.9),
    so that their frozen timers must drop the skew. tests/
    test_torch_crash.py holds the same cases to the JAX package."""
    from consensus_tpu_torch import convert
    from consensus_tpu_torch.engines import hotstuff
    from consensus_tpu_torch.ops import adversary
    gen = np.random.default_rng(17)
    out = []
    cases = {"top-down": dict(crash_prob=0.3, recover_prob=0.5),
             "all-down": dict(crash_prob=1.0, recover_prob=0.0),
             "rec-tie": dict(crash_prob=0.3, recover_prob=0.5),
             "skewed-down": dict(crash_prob=0.3, recover_prob=0.5,
                                 desync_rate=0.9, max_skew_rounds=4)}
    for f, b, s in ((4, 6, 16), (33_333, B, 64)):
        n = 3 * f + 1
        for case, kw in cases.items():
            cfg = protocol_config(HOTSTUFF_FLAGSHIP, f=f, n_nodes=n,
                                  n_sweeps=b, log_capacity=s, view_timeout=4,
                                  **kw)
            r = 11
            seeds = np.arange(90, 90 + b, dtype=np.uint32)
            down = gen.random((b, n)) < 0.4
            _, flags = adversary.crash_transition_plain(
                torch.from_numpy(seeds), r, torch.from_numpy(down),
                cfg.crash_cutoff, cfg.recover_cutoff, cfg.max_crashed)
            fl = flags.numpy()
            now_down = (fl & adversary.CRASH_DOWN) != 0
            rec = (fl & adversary.CRASH_REC) != 0
            view = gen.integers(2, 9, (b, n)).astype(np.int32)
            timer = gen.integers(0, 3, (b, n)).astype(np.int32)
            for k in range(b):
                if case == "top-down" and now_down[k].any():
                    view[k, np.flatnonzero(now_down[k])[-1]] = 40
                if case == "rec-tie" and rec[k].any():
                    view[k] = np.where(now_down[k], view[k], 0)
                    view[k, np.flatnonzero(rec[k])[-1]] = 40
                if case == "skewed-down":
                    timer[k] = np.where(now_down[k], 3, timer[k])
            leaves = {
                "seed": seeds, "b1_v": np.full(b, 3, np.int32),
                "b1_h": np.full(b, 2, np.int32),
                "b2_v": np.full(b, 2, np.int32),
                "b2_h": np.full(b, 1, np.int32),
                "b3_v": np.full(b, 1, np.int32),
                "b3_h": np.zeros(b, np.int32),
                "gcommit": np.ones(b, np.int32),
                "chain_v": np.where(np.arange(s) < 3, np.arange(s) + 1, -1)
                .astype(np.int32)[None].repeat(b, 0),
                "chain_vid": np.zeros((b, s), np.int32),
                "fvec": np.zeros((b, n), np.int32),
                "ftab_v": np.full((b, hotstuff.FORK_TABLE), -1, np.int32),
                "ftab_h": np.full((b, hotstuff.FORK_TABLE), -1, np.int32),
                "fnum": np.zeros(b, np.int32), "view": view, "timer": timer,
                "clen": gen.integers(0, 2, (b, n)).astype(np.int32),
                "down": down}
            out.append((cfg, convert.state_from_numpy(leaves, dev), r))
    return out


def hold_calls(calls: dict, where: str, errs: dict, cases: dict) -> None:
    """Every call of ``calls`` ({wrapper: [arguments]}) against its plain
    version, exact; for each wrapper that ``errs`` names, its largest
    error into ``errs`` and its count of calls into ``cases``."""
    for name, arg_list in calls.items():
        for args in arg_list:
            e = max_abs_err(run_pair(name, args))
            require(e == 0.0, f"{name} on {where} disagrees with its plain "
                    "version")
            if name in errs:
                errs[name] = max(errs[name], e)
                cases[name] += 1


def check_desync_kernels(dev):
    """Phase 17's kernel rows. Every kernel call of rounds 3 and 20 of each
    run DESYNC_RUNS (with telemetry and 8-round windows where
    DESYNC_TELEMETRY has the run), of KQ on the desync fs = 1..128
    ladder's rounds and of KT on the desync full-width ladder's, and every
    call of one round from each built state (:func:`hotstuff_gate_states`,
    with telemetry and the recorder), against the plain versions (the
    skew, ctt::desync_skew, is held through KQ's, KT's and KAJ's timers).
    Then KAJ's and each instance's time on round 20 of its DESYNC_TIMED
    run, its plain version's and its bound, and each instance's time
    through its flat instance on the same inputs. Yields KAJ's row (with
    the phase-3 keys) and one row an instance."""
    from consensus_tpu_torch.engines import pbft_sweep
    errs = {name: 0.0 for name in DESYNC_OWN + DESYNC_INSTANCES}
    cases = dict.fromkeys(errs, 0)
    timed = {}

    def hold(calls, where):
        hold_calls(calls, where, errs, cases)
    for key in DESYNC_RUNS:
        telemetry = key in DESYNC_TELEMETRY
        cfg = desync_config(key, **(dict(telemetry_window=WINDOW)
                                    if telemetry else {}))
        for r in DESYNC_ROUNDS:
            calls = capture_round_calls(cfg, r, telemetry, dev)
            hold(calls, f"{key} round {r}")
            for name, run in DESYNC_TIMED.items():
                if run == key and r == 20:
                    timed[name] = max(calls[name], key=lambda a: sum(
                        t.numel() for t in tensors_of(a)))
    for name, (make, rungs, _) in DESYNC_LADDERS.items():
        cfg_pad = pbft_sweep._fsweep_static(make(), rungs)[1]
        wrapper = "pbft_view_preprepare" if cfg_pad.fault_model == "edge" \
            else "bcast_view_preprepare"
        got = capture_calls(cfg_pad, DESYNC_ROUNDS, wrapper, rungs, dev)
        hold({wrapper: [a for calls in got.values() for a in calls]},
             f"the desync {name}")
    for cfg, st, r in hotstuff_gate_states(dev):
        cfg = dataclasses.replace(cfg, telemetry_window=WINDOW,
                                  n_rounds=16)
        hold(calls_from(cfg, st, r, True, dev),
             f"a built HotStuff state (N = {cfg.n_nodes})")
    from consensus_tpu_torch.engines import hotstuff
    for name in DESYNC_OWN + DESYNC_INSTANCES:
        args = timed[name]
        mod = kernel_module(name)
        reps = reps_for(args)
        row = dict(name=name, max_abs_err=errs[name], cases=cases[name],
                   timed_on=f"{DESYNC_TIMED[name]} round 20",
                   ms=graph_ms(getattr(mod, name), args, reps),
                   plain_ms=event_ms(getattr(mod, name + "_plain"), args,
                                     min(5, reps)),
                   bound=desync_kernel_bound(name, args))
        if name in DESYNC_OWN:
            launches_on = DESYNC_TIMED[name].split("/")[0] + " composed"
            row.update(route="cuda",
                       source=f"consensus_tpu_torch/csrc/{name}.cu",
                       replaces=DESYNC_REPLACES[name], library_ms=None,
                       launches_from=launches_on)
            # Its other instances on their own runs' round 20.
            for other in ("hotstuff-100k/desync", "hotstuff-100k/uncapped"):
                a = capture_round_calls(desync_config(other), 20, False,
                                        dev)[name][0]
                row[f"ms_{other.split('/')[1]}"] = graph_ms(
                    hotstuff.hotstuff_prologue, a, reps)
        else:
            row["flat_instance_ms"] = graph_ms(
                getattr(mod, name), desync_flat(name, args), reps)
            row["flat_instance_bound"] = desync_kernel_bound(
                name, desync_flat(name, args))
        yield row


def anchored_run(cfg, digest: str, ops: bool = False) -> tuple:
    """``simulator.run`` of ``cfg`` (phases 17-19), replayed as one CUDA
    graph, with every launch count set to 0 just before it and read just
    after: its row (its digest and the eager loop's against ``digest``,
    node-round-steps per second, memory, replay wall, busy share, device
    operations a replay and a round, device ms by kernel), its launches,
    the replay's and the eager loop's extracts and the full replay's
    profile. With ``ops`` the device operations a round are the exact
    difference of two profiled replays (:func:`replay_ops_per_round`),
    which a caller checks; without it one profiled replay gives them with
    init's spread over the rounds (``launches_per_round``). The caller
    emits the row, then requires the digests (:func:`hold_run`)."""
    from consensus_tpu_torch.network import runner, simulator
    memory, launches = counted(lambda: memory_use(
        lambda: simulator.run(cfg)))
    res = memory.pop("result")
    replayed = runner.run(cfg)
    eager = runner.run(cfg, graph=False)
    eager_sha = eager_digest(cfg, res, eager)
    if ops:
        prof = replay_ops_per_round(cfg)
        full, per_round = prof["full"], prof["ops_per_round"]
    else:
        full, per_round = profile_replay(cfg), None
    row = dict(
        digest=res.digest, digest_ok=res.digest == digest,
        eager_digest=eager_sha, steps_per_sec=res.steps_per_sec,
        wall_s=res.wall_s, launches=launches, **memory,
        replay_wall_ms=full["replay_wall_ms"], busy_share=full["busy_share"],
        unprofiled_busy_share=full["unprofiled_busy_share"],
        device_ms=full["device_ms"], device_launches=full["device_launches"],
        ops_per_round=per_round,
        launches_per_round=full["launches_per_round"],
        hand_kernel_ms={k: v for k, v in full["hand_kernel_ms"].items()
                        if v})
    return row, launches, replayed, eager, full


def hold_run(key: str, row: dict, digest: str, cfg, launches) -> None:
    """An anchored run's requirements: its anchor from the replay and the
    eager loop, its path's kernels launched and no other."""
    from consensus_tpu_torch.network import runner
    require(row["digest"] == digest, f"{key} digest {row['digest']} != "
            f"{digest}")
    require(row["eager_digest"] == digest,
            f"{key}: the eager loop's digest {row['eager_digest']}")
    require_launched(launches, desync_path(cfg), key)
    runner.clear_graphs()


def anchored_ladder(name: str, base, rungs, digest: str, phase: str,
                    card: str, smi: str) -> None:
    """``pbft_fsweep_timed`` of the ladder ``rungs`` of ``base`` (phases 17
    and 18), replayed as one CUDA graph and counted from 0: its anchor
    ``digest`` from the replay and the eager loop, real steps per second,
    replay wall, busy share, its path's kernels launched and no other."""
    from consensus_tpu_torch.core import serialize
    from consensus_tpu_torch.engines import pbft_sweep
    from consensus_tpu_torch.network import runner
    memory, launches = counted(lambda: memory_use(
        lambda: pbft_sweep.pbft_fsweep_timed(base, rungs, repeats=3)))
    out, first_s, best, real_steps = memory.pop("result")
    got = serialize.digest(pbft_sweep.fsweep_payload(out))
    eager = serialize.digest(pbft_sweep.fsweep_payload(
        pbft_sweep.pbft_fsweep_run(base, rungs, graph=False)))
    cfg_pad = pbft_sweep._fsweep_static(base, rungs)[1]
    prof = profile_replay(cfg_pad, rungs=rungs)
    emit(phase, run=name, digest=got, digest_ok=got == digest,
         eager_digest=eager, real_steps=real_steps, wall_s=best,
         real_steps_per_sec=real_steps / best, first_run_s=first_s,
         launches=launches, **memory, replay_wall_ms=prof["replay_wall_ms"],
         busy_share=prof["busy_share"],
         unprofiled_busy_share=prof["unprofiled_busy_share"],
         device_ms=prof["device_ms"],
         device_launches=prof["device_launches"],
         card=card, power=smi)
    require(got == digest and eager == digest,
            f"{name}: digests {got} (replay), {eager} (eager) != {digest}")
    require_launched(launches, desync_path(cfg_pad), name)
    runner.clear_graphs()


def anchored_telemetry(key: str, cfg, digest: str, nonzero: dict,
                       flight: str, phase: str, card: str, smi: str) -> dict:
    """``simulator.run`` of ``cfg`` with telemetry (phases 17 and 18),
    replayed and counted from 0: its digest, counters (those not in
    ``nonzero`` 0) and recorder (``flight``) against their JAX anchors and
    the eager loop's, its telemetry path's kernels launched and no other.
    Returns the counter totals."""
    from consensus_tpu_torch.network import runner, simulator
    eng = runner.engine(cfg)
    res, launches = counted(lambda: simulator.run(cfg, telemetry=True))
    tel, fl = res.extras["telemetry"], res.extras["flight"]
    eager = runner.telemetry_stats(cfg, runner.run_device(
        cfg, telemetry=True, graph=False))
    want = {k: nonzero.get(k, 0) for k in eng.telemetry_names}
    row = dict(
        digest=res.digest, digest_ok=res.digest == digest,
        totals=tel["totals"], totals_ok=tel["totals"] == want,
        flight_sha256=flight_digest(fl),
        flight_ok=flight_digest(fl) == flight,
        graph_equals_eager=flight_digest(eager["flight"]) ==
        flight_digest(fl) and all(
            np.array_equal(eager["telemetry"][k], v)
            for k, v in tel["per_sweep"].items()),
        steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
        launches=launches)
    emit(phase, run=key, **row, card=card, power=smi)
    for check in ("digest_ok", "totals_ok", "flight_ok",
                  "graph_equals_eager"):
        require(row[check], f"{key} with telemetry: {check} fails")
    require_launched(launches, desync_path(cfg, telemetry=True),
                     f"{key} with telemetry")
    runner.clear_graphs()
    return tel["totals"]


def check_desync_runs(card: str, smi: str) -> dict[str, int]:
    """Phase 17's runs: each run DESYNC_RUNS (:func:`anchored_run`; HotStuff:
    its final views too, VIEWS_SHA256, and KAJ's share of the device time)
    and each ladder DESYNC_LADDERS (:func:`anchored_ladder`); then
    DESYNC_TELEMETRY's runs with telemetry and 8-round windows
    (:func:`anchored_telemetry`), whose §B tail must count. Returns KAJ's
    launches in hotstuff-100k's composed run."""
    own = {}
    for key, (_, digest) in DESYNC_RUNS.items():
        cfg = desync_config(key)
        row, launches, replayed, eager, full = anchored_run(cfg, digest)
        if key in VIEWS_SHA256:
            row["views_sha256"] = views_sha256(replayed["view"])
            row["eager_views_sha256"] = views_sha256(eager["view"])
            row["prologue_share"] = full["hand_kernel_ms"][
                "hotstuff_prologue"] / full["device_ms"]
            require(row["views_sha256"] == VIEWS_SHA256[key]
                    and row["eager_views_sha256"] == VIEWS_SHA256[key],
                    f"{key}: views {row['views_sha256']} (replay), "
                    f"{row['eager_views_sha256']} (eager)")
        emit("desync_run", run=key, **row, card=card, power=smi)
        hold_run(key, row, digest, cfg, launches)
        if key == "hotstuff-100k/composed":
            own = launches
    for name, (make, rungs, digest) in DESYNC_LADDERS.items():
        anchored_ladder(name, make(), rungs, digest, "desync_run", card, smi)
    for key, (nonzero, flight) in DESYNC_TELEMETRY.items():
        totals = anchored_telemetry(
            key, desync_config(key, telemetry_window=WINDOW),
            DESYNC_RUNS[key][1], nonzero, flight, "desync_telemetry", card,
            smi)
        require(min(totals[k] for k in ("view_spread_max",
                                        "desync_rounds")) > 0,
                f"{key}: the desync tail counted nothing")
    return {"hotstuff_prologue": own["hotstuff_prologue"]}


# --- phase 18: SPEC §3c/§7c byzantine nodes ----------------------------------

# The flagships under byzantine nodes: (config maker, the byzantine count of
# each mode). Raft takes the 2-of-5 share of tests/test_raft_byz.py:22
# (40 000 and 409), pbft-f128 n_byzantine = f, hotstuff-100k 10 000
# silent and f equivocating. At hotstuff-100k's and hotstuff-1k's shapes
# the views stay below the first byzantine id, so no byzantine node leads
# and no variant-1 block forms; "hotstuff-1k-long" is hotstuff-1k with 1 024
# rounds and 1 024 heights, whose views wrap the population: its byzantine
# leaders certify variant 1 at 117 heights (chain_vid = 1).
BYZ_FLAGSHIPS = {
    "raft-100k": (flagship_config, 40_000, 40_000),
    "raft-1kx1k": (gate_1kx1k, 409, 409),
    "pbft-f128": (lambda **kw: pbft_config(128, **kw), 128, 128),
    "hotstuff-100k": (lambda **kw: protocol_config(HOTSTUFF_FLAGSHIP, **kw),
                      10_000, 33_333),
    "hotstuff-1k-long": (lambda **kw: protocol_config(
        HOTSTUFF_1K, n_rounds=1024, log_capacity=1024, **kw), 341, 341),
}
BYZ_COMPOSED = dict(CRASH, **DESYNC)
# Phase 18's runs, "<flagship>/<mode>": anchor. "composed" is the
# equivocating run with phase 16's CRASH and phase 17's desync overrides.
# The anchors were made by the JAX package on the CPU and again by the C++
# oracle (engine="cpu"), which agrees on each:
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   for key in chip_smoke.BYZ_RUNS:
#       cfg = Config(**dataclasses.asdict(chip_smoke.byz_config(key)))
#       print(key, simulator.run(cfg, warmup=False).digest,
#             simulator.run(dataclasses.replace(cfg, engine="cpu"),
#                           warmup=False).digest)
#   EOF
#
# (the JAX runs took 2.7-72 s each on eight cores; raft-1kx1k's at
# GATE_1KX1K_ROUNDS rounds, a cut, which leaves their digests). Several
# equal their flat runs' digests: equivocating Raft voters re-elect the
# same leaders at these drop rates (raft-100k 0e9cc1dd…, raft-1kx1k
# 8748ac4f…), hotstuff-100k's byzantine nodes never lead and its honest
# votes reach the quorum without theirs (5bcc22a0…), and under the desync
# overrides no QC forms (f378cec6…, phase 17's). pbft-f128 with 128 silent
# nodes leaves 2f + 1 = 257 honest ones, whose quorums the drops break:
# it commits nothing, as its composed run does (0a46d25f…, phase 17's
# pbft-f128/composed). The views (BYZ_VIEWS_SHA256) and the telemetry
# (BYZ_TELEMETRY) tell these runs from the flat ones.
BYZ_RUNS = {
    "raft-100k/silent":
        "2ff2a5faf0ff571aca60b1beb7d1fce68f582588c6084c1bcac49c7b87f41b76",
    "raft-100k/equivocate":
        "0e9cc1ddc8b04d96240cdeb5f19877bbd3aad2b23883a585fa1e1c78a961ca5b",
    "raft-1kx1k/silent":
        "51e1bcb029feaad5b632b9af443619dbc2df89e82565c3dcf51e21a4bb251576",
    "raft-1kx1k/equivocate":
        "8748ac4fce3ad51b006d1d6542aa853f6d2f25839915ead9327bf7ca948f3308",
    "pbft-f128/silent":
        "0a46d25f9e81c962756c47a1010f211591a73d98df51ce1d1cbc516753bce527",
    "pbft-f128/equivocate":
        "6c763cb1ffab1cbdd82f763bc73732ed00db7b03d523824de7d1f46d1cd3a252",
    "pbft-f128/composed":
        "0a46d25f9e81c962756c47a1010f211591a73d98df51ce1d1cbc516753bce527",
    "hotstuff-100k/silent":
        "5bcc22a0d6392871185ce0fe9a3a4f8b58821aa8b36f9c19f3b02354c96eda16",
    "hotstuff-100k/equivocate":
        "5bcc22a0d6392871185ce0fe9a3a4f8b58821aa8b36f9c19f3b02354c96eda16",
    "hotstuff-100k/composed":
        "f378cec60161f4cc24d5473db85cd828519ebcb5254674eeae90ffd110d00168",
    "hotstuff-1k-long/equivocate":
        "07deb0a12aa18614c84f3de58459bc37c86c85cb0f619ed4520ad222987dcd4e",
}
# SHA-256 of the HotStuff runs' final views (as VIEWS_SHA256), and the
# variant-1 heights of each run's chain (chain_vid = 1, over its lanes),
# made by the JAX package with the anchors above.
BYZ_VIEWS_SHA256 = {
    "hotstuff-100k/silent":
        "04fceacf3447a950ca61905bbaffb70e13c1026d456867398e5d76fc37a9e7d7",
    "hotstuff-100k/equivocate":
        "04fceacf3447a950ca61905bbaffb70e13c1026d456867398e5d76fc37a9e7d7",
    "hotstuff-100k/composed":
        "88b46fabd171fe1d28d79785db8bfabfdd75d9c79f4153bce6953d40f2aabdfe",
    "hotstuff-1k-long/equivocate":
        "d1a2111f51499ff7ff9895d6f04c2af206083ed78d10af79e5696413741502a1"}
BYZ_VARIANT1 = {"hotstuff-100k/silent": 0, "hotstuff-100k/equivocate": 0,
                "hotstuff-100k/composed": 0,
                "hotstuff-1k-long/equivocate": 117}
# The fs = 1..128 dense ladder with one byzantine node a lane (the most that
# pbft_fsweep_run allows: its smallest rung is f = 1), each mode: (base
# config, rungs, anchor), made by the JAX package as the ladders' anchors
# above (pbft_sweep.pbft_fsweep_run; 45 s and 41 s). At these calm knobs one
# byzantine node a lane moves no decision: both equal LADDER_DIGEST.
BYZ_LADDERS = {
    "dense-ladder/silent": (lambda: pbft_config(1, n_byzantine=1), LADDER,
                            LADDER_DIGEST),
    "dense-ladder/equivocate": (
        lambda: pbft_config(1, n_byzantine=1, byz_mode="equivocate"), LADDER,
        LADDER_DIGEST),
}
# The equivocating flagships again with telemetry and 8-round windows:
# (nonzero counter totals, flight_digest), made by the JAX package on the
# CPU as BFT_TELEMETRY's were (4.0 s and 18.4 s). The safety tail stays 0:
# with at most f byzantine nodes no PBFT slot forks, and no flat HotStuff
# QC can (both variants' quorums would need 4f + 2 votes of at most
# 4f + 1); phase 18 holds it on built states.
BYZ_TELEMETRY = {
    "pbft-f128/equivocate": (
        {"prepare_quorums": 12187, "commit_quorums": 12187,
         "commits_adopted": 133},
        "ffcd8aa056ac535b4bdc03a4eaa9137d8ab066b4702a25b29b6930da8dda24d9"),
    "hotstuff-100k/equivocate": (
        {"qc_formed": 512, "blocks_committed": 496,
         "commits_learned": 48791852, "proposals_delivered": 50687707,
         "votes_counted": 66906901, "view_spread_max": 541,
         "desync_rounds": 512, "sync_msgs_delivered": 499181},
        "b449c03c15856ce9e115f58876529df98cc71a10b60720d4a9a0afff2ab5bb46"),
}
# The rounds phase 18 holds every kernel call of against its plain version.
BYZ_ROUNDS = (3, 20)
# The kernels with a BYZ instance, each picked by the Config's byzantine
# mode (KR, KS: their trailing Byz argument) and timed on round 20 of a
# run; KAJ takes the honest count with no instance of its own.
BYZ_TIMED = {"candidacy": "raft-100k/silent", "elect": "raft-100k/equivocate",
             "propose": "raft-100k/silent", "acks_commit": "raft-100k/silent",
             "dense_elect": "raft-1kx1k/equivocate",
             "dense_append": "raft-1kx1k/silent",
             "dense_acks_commit": "raft-1kx1k/silent",
             "pbft_view_preprepare": "pbft-f128/equivocate",
             "pbft_tally": "pbft-f128/equivocate",
             "pbft_decide": "pbft-f128/equivocate",
             "pbft_telemetry": "pbft-f128/equivocate",
             "hotstuff_propose": "hotstuff-100k/silent",
             "hotstuff_vote": "hotstuff-100k/equivocate",
             "hotstuff_learn": "hotstuff-100k/equivocate",
             "hotstuff_prologue": "hotstuff-100k/composed"}


def byz_config(key: str, **kw):
    """Phase 18's run ``key`` ("<flagship>/<mode>"), changed by ``kw``."""
    name, mode = key.split("/")
    make, silent, equiv = BYZ_FLAGSHIPS[name]
    if mode == "silent":
        return make(n_byzantine=silent, **kw)
    extra = BYZ_COMPOSED if mode == "composed" else {}
    return make(n_byzantine=equiv, byz_mode="equivocate", **extra, **kw)


def byz_flat(name: str, args):
    """``args`` of kernel ``name`` with its BYZ instance turned off: no
    byzantine node in its Config, and the arguments that only the BYZ
    instances take (KR's and KS's Byz, KAA's values, KAE's and KAF's fork
    state) dropped."""
    if name in ("pbft_tally", "pbft_decide"):
        return args[:-1]
    flat = (dataclasses.replace(args[0], n_byzantine=0, byz_mode="silent"),
            *args[1:])
    if name in ("hotstuff_vote", "hotstuff_learn", "pbft_telemetry") \
            and args[0].byz == 2:
        return flat[:-1]
    return flat


def byz_kernel_bound(name: str, args) -> tuple[float, str]:
    """The least time of kernel ``name``'s work on a byzantine round's
    ``args``: its flat bound on the same inputs, plus what equivocation
    adds where its instance does it: KR's stance draws (n_byzantine a
    receiver) and their delivery bytes, KQ's (one a receiver of a
    byzantine primary, and a value a slot), KAE's (one a receiver of a
    byzantine leader) and its deceived flags, KAF's deceived flags and
    fork bits, KAA's three value planes."""
    from consensus_tpu_torch.engines import hotstuff
    if name == "hotstuff_prologue":
        return prologue_bound(args)
    nbytes, ops = flat_work(name, byz_flat(name, args))
    cfg = args[0] if name not in ("pbft_tally", "pbft_decide") else None
    if name == "pbft_tally" and args[-1].mode == 2:
        deliver, n_real = args[0], args[1]
        b, n = deliver.shape[:2]
        nb = args[-1].nb
        ops += THREEFRY_OPS * nb * int(n_real.sum())
        nbytes += nb * int(n_real.sum()) + 4 * b * n
    elif name == "pbft_view_preprepare" and cfg.byz == 2:
        from consensus_tpu_torch.engines import pbft
        n_real, s = args[4], args[8].shape[2]
        view = pbft.pbft_view_preprepare_plain(*clone_args(args))[0]
        prim = view.remainder(n_real[:, None])
        byz = int((prim >= (n_real - cfg.n_byzantine)[:, None]).sum())
        ops += THREEFRY_OPS * byz * (1 + s)
    elif name == "pbft_telemetry" and cfg.byz == 2:
        nbytes += 12 * args[-1][0].numel()
    elif name == "hotstuff_vote" and cfg.byz == 2:
        view1, lane = args[3], args[4]
        b, n = view1.shape
        vstar = lane[:, hotstuff.VMAX]
        byz_l = (vstar >= 0) & (vstar % n >= cfg.n_honest)
        ops += THREEFRY_OPS * int(((view1 <= vstar[:, None])
                                   & byz_l[:, None]).sum())
        nbytes += b * n + 8 * b * (args[-1][0].shape[1] + 17)
    elif name == "hotstuff_learn" and cfg.byz == 2:
        nbytes += 9 * args[2].numel()
    return bound(nbytes, ops)


def hotstuff_fork_cases(dev) -> list:
    """KAE's arguments on built equivocating lanes at N = 13 (B = 6) and at
    hotstuff-100k's width (B = 8): preset vote words force a forked QC, a
    variant-1 QC alone or none whatever the round's votes, one lane's
    leader is byzantine, one lane's fork table is full; random fork bits,
    heights and prefixes (tests/test_torch_byz.py holds the same cases'
    plain versions to a transcription of the JAX round). Each case is
    (KAE's args, KAF's inputs but those KAE gives)."""
    from consensus_tpu_torch.engines import hotstuff
    out = []
    for f, b, s in ((4, 6, 16), (33_333, B, 64)):
        n = 3 * f + 1
        g = np.random.default_rng(f)
        cfg = protocol_config(HOTSTUFF_FLAGSHIP, f=f, n_nodes=n, n_sweeps=b,
                              log_capacity=s, drop_rate=0.2, n_byzantine=f,
                              byz_mode="equivocate", telemetry_window=WINDOW,
                              n_rounds=16)
        q = 2 * f + 1

        def ints(lo, hi, shape):
            return torch.from_numpy(g.integers(lo, hi, shape).astype(
                np.int32)).to(dev)
        view1 = ints(8, 14, (b, n))
        lane = hotstuff.lane_at_rest(view1, cfg.n_honest)
        vstar = torch.from_numpy(g.integers(9, 14, b)).to(dev)
        vstar[1] = 2 * n - 1                       # byzantine leader n - 1
        lane[:, hotstuff.VMAX] = vstar
        forced = [(q, q), (q, q), (-2 * n, q), (-2 * n, q), (-2 * n, -2 * n)]
        forced += [(-2 * n, -2 * n)] * (b - len(forced))
        lane[:, hotstuff.VOTES] = torch.tensor([x for x, _ in forced],
                                               device=dev)
        lane[:, hotstuff.VOTES1] = torch.tensor([y for _, y in forced],
                                                device=dev)
        regs = [ints(3, 6, b), ints(4, 9, b), ints(2, 3, b), ints(2, 4, b),
                ints(1, 2, b), ints(0, 2, b), ints(2, 7, b)]
        fnum = ints(0, 9, b)
        fnum[0] = 8
        fork = (ints(0, 2, (b, s)), ints(-1, 12, (b, 8)), ints(0, 9, (b, 8)),
                fnum)
        seeds = torch.from_numpy(g.integers(0, 2**32, b)).to(dev).to(
            torch.uint32)
        vote = (cfg, seeds, 5, view1, lane, *regs, ints(-1, 9, (b, s)), None,
                fork)
        learn = dict(adv=torch.from_numpy(g.random((b, n)) < 0.2).to(dev),
                     timer=ints(0, 9, (b, n)), clen=ints(0, 6, (b, n)),
                     fvec=ints(0, 256, (b, n)))
        out.append((vote, learn))
    return out


def pbft_safety_cases(dev) -> list:
    """KAA's arguments on built equivocating rounds at N = 10 (4 lanes,
    n_real 10, 10, 7 and 4) and at pbft-f128's width: random commits and
    values from four choices, so that slots fork and conflict, with and
    without down nodes (tests/test_torch_byz.py holds the N = 10 cases'
    plain version to a transcription of the JAX tail)."""
    from consensus_tpu_torch.engines import pbft
    from consensus_tpu_torch.network import runner
    out = []
    for f, lanes in ((3, (10, 10, 7, 4)), (128, (385,) * B)):
        n, b, s = 3 * f + 1, len(lanes), 32
        g = np.random.default_rng(f)
        cfg = pbft_config(f, n_sweeps=b, n_byzantine=2 if f == 3 else f,
                          byz_mode="equivocate", telemetry_window=WINDOW)
        n_real = torch.tensor(lanes, dtype=torch.int32, device=dev)

        def flags(p, shape=(b, n, s)):
            return torch.from_numpy(g.random(shape) < p).to(dev)

        def vals():
            return torch.from_numpy(g.integers(-2, 2, (b, n, s)).astype(
                np.int32) * 2**30).to(dev)
        view = torch.from_numpy(g.integers(0, 9, (b, n)).astype(
            np.int32)).to(dev)
        committed_in, tallied = flags(0.3), flags(0.6)
        for crash in (0, pbft.CRASH_VIEWS):
            down = flags(0.3, (b, n)) if crash else torch.zeros(
                (b, n), dtype=torch.bool, device=dev)
            t, (w, lat) = runner.accumulators(cfg, dev)
            out.append((cfg, 3, n_real, view, view, view + 1,
                        flags(0.2, (b, n)), down, flags(0.5), flags(0.3),
                        flags(0.4), committed_in, tallied,
                        tallied | flags(0.2), t, w, lat, crash,
                        (vals(), vals(), vals())))
    return out


def check_byz_kernels(dev):
    """Phase 18's kernel rows. Every kernel call of rounds 3 and 20 of each
    run BYZ_RUNS (with telemetry and 8-round windows where BYZ_TELEMETRY
    has the run), of KQ-KS on both byzantine ladders' rounds, of KAE and
    KAF on built equivocating HotStuff lanes (hotstuff_fork_cases: forked
    QCs, variant-1 QCs, a full fork table, conflicting commits) and of KAA
    on built equivocating PBFT rounds (pbft_safety_cases: forked and
    conflicting slots), against the plain versions, exact. Then each BYZ
    instance's time on round 20 of its BYZ_TIMED run, its plain version's
    and its bound, and its flat instance's time and bound on the same
    inputs. Yields one row an instance."""
    from consensus_tpu_torch.engines import hotstuff, pbft_sweep
    from consensus_tpu_torch.network import runner
    errs = dict.fromkeys(BYZ_TIMED, 0.0)
    cases = dict.fromkeys(BYZ_TIMED, 0)
    timed = {}

    def hold(calls, where):
        hold_calls(calls, where, errs, cases)
    for key in BYZ_RUNS:
        telemetry = key in BYZ_TELEMETRY
        cfg = byz_config(key, **(dict(telemetry_window=WINDOW)
                                 if telemetry else {}))
        for r in BYZ_ROUNDS:
            calls = capture_round_calls(cfg, r, telemetry, dev)
            hold(calls, f"{key} round {r}")
            for name, run in BYZ_TIMED.items():
                if run == key and r == 20:
                    timed[name] = max(calls[name], key=lambda a: sum(
                        t.numel() for t in tensors_of(a)))
    for name, (make, rungs, _) in BYZ_LADDERS.items():
        cfg_pad = pbft_sweep._fsweep_static(make(), rungs)[1]
        for wrapper in PBFT:
            got = capture_calls(cfg_pad, BYZ_ROUNDS, wrapper, rungs, dev)
            hold({wrapper: [a for calls in got.values() for a in calls]},
                 f"the {name}")
    for vote, learn in hotstuff_fork_cases(dev):
        hold({"hotstuff_vote": [vote]}, "built equivocating HotStuff lanes")
        args = clone_args(vote)
        cfg, lane, regs, fork = args[0], args[4], args[5:12], args[-1]
        pdel, _, b1_h, _, _, _, _, gcommit, deceived = \
            hotstuff.hotstuff_vote_plain(*args)
        t, (w, lat) = runner.accumulators(cfg, dev)
        hold({"hotstuff_learn": [
            (cfg, 5, args[3], pdel, learn["adv"], learn["timer"],
             learn["clen"], lane, regs[6], b1_h, gcommit, t, w, lat, None,
             (deceived, learn["fvec"], fork[2], fork[3]))]},
             "built equivocating HotStuff lanes")
    hold({"pbft_telemetry": pbft_safety_cases(dev)},
         "built equivocating PBFT rounds")
    for name, run in BYZ_TIMED.items():
        args = timed[name]
        mod = kernel_module(name)
        reps = reps_for(args)
        flat = byz_flat(name, args)
        yield dict(name=name, max_abs_err=errs[name], cases=cases[name],
                   timed_on=f"{run} round 20",
                   ms=graph_ms(getattr(mod, name), args, reps),
                   plain_ms=event_ms(getattr(mod, name + "_plain"), args,
                                     min(5, reps)),
                   bound=byz_kernel_bound(name, args),
                   flat_instance_ms=graph_ms(getattr(mod, name), flat, reps),
                   flat_instance_bound=byz_kernel_bound(name, flat)
                   if name == "hotstuff_prologue"
                   else bound(*flat_work(name, flat)))


def check_byz_runs(card: str, smi: str) -> None:
    """Phase 18's runs: each run BYZ_RUNS (:func:`anchored_run`; HotStuff:
    its final views and variant-1 heights too, and 3 device operations a
    round without a crash or a desync, as the flat round) and each ladder
    BYZ_LADDERS (:func:`anchored_ladder`); then BYZ_TELEMETRY's runs with
    telemetry and 8-round windows (:func:`anchored_telemetry`), the safety
    tail among their counters."""
    from consensus_tpu_torch.engines import hotstuff
    from consensus_tpu_torch.network import runner
    for key, digest in BYZ_RUNS.items():
        cfg = byz_config(key)
        row, launches, replayed, eager, _ = anchored_run(
            cfg, digest, ops=cfg.protocol == "hotstuff"
            and not hotstuff.gated(cfg))
        if key in BYZ_VIEWS_SHA256:
            state = runner.run_device(cfg).state
            row["views_sha256"] = views_sha256(replayed["view"])
            row["eager_views_sha256"] = views_sha256(eager["view"])
            row["variant1_heights"] = int((state.chain_vid == 1).sum())
            require(row["views_sha256"] == BYZ_VIEWS_SHA256[key]
                    and row["eager_views_sha256"] == BYZ_VIEWS_SHA256[key],
                    f"{key}: views {row['views_sha256']} (replay), "
                    f"{row['eager_views_sha256']} (eager)")
            require(row["variant1_heights"] == BYZ_VARIANT1[key],
                    f"{key}: {row['variant1_heights']} variant-1 heights")
            if not hotstuff.gated(cfg):
                require(row["ops_per_round"] == 3.0,
                        f"{key}: {row['ops_per_round']} device operations "
                        "a round")
        emit("byz_run", run=key, **row, card=card, power=smi)
        hold_run(key, row, digest, cfg, launches)
    for name, (make, rungs, digest) in BYZ_LADDERS.items():
        anchored_ladder(name, make(), rungs, digest, "byz_run", card, smi)
    for key, (nonzero, flight) in BYZ_TELEMETRY.items():
        anchored_telemetry(key, byz_config(key, telemetry_window=WINDOW),
                           BYZ_RUNS[key], nonzero, flight, "byz_telemetry",
                           card, smi)


# --- phase 19: SPEC §3c/§7c byzantine nodes on the §6b engine ----------------

# pbft-100k-bcast with n_byzantine = f = 33 333, each mode: the silent run at
# its 8 sweeps, the equivocating ones at one. The JAX package builds each
# equivocating round's [nb, N] stance grid (3.33e9 draws a sweep, about 5
# bytes each on its CPU backend: 18 GB a sweep, and its runs vmap the
# sweeps), so its anchor of more than one sweep does not fit the memory of
# the machine that makes it; N, f and n_byzantine are pbft-100k-bcast's.
BYZ_BCAST_NB = 33_333
# Phase 19's runs, "pbft-100k-bcast/<mode>": anchor. "composed" is the
# equivocating run with phase 16's CRASH and phase 17's desync overrides
# (BYZ_COMPOSED, as phase 18's). The anchors and BYZ_BCAST_VIEWS_SHA256 were
# made by the JAX package on the CPU:
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, hashlib, numpy as np, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import runner, simulator
#   for key in chip_smoke.BYZ_BCAST_RUNS:
#       cfg = Config(**dataclasses.asdict(chip_smoke.byz_bcast_config(key)))
#       view = runner.run(cfg, simulator.engine_def(cfg))["view"]
#       print(key, simulator.run(cfg, warmup=False).digest,
#             hashlib.sha256(np.ascontiguousarray(
#                 np.asarray(view), dtype="<i4").tobytes()).hexdigest())
#   EOF
#
# (197 s for the silent run on eight cores, 145 s and 149 s for the
# equivocating ones, at about 18 GB each). The C++ oracle agrees on the
# silent run (engine="cpu", 48.5 s) and made neither equivocating anchor:
# its per-receiver §6b round draws the 3.33e9 stances of a sweep and round
# one at a time (the full-width ladder's first rung, 1.3e10 draws in all,
# took it 503 s). The silent run leaves 2f + 1 = 66 667 honest nodes, whose
# quorums the 1% drops break, so it commits nothing. The equivocating run differs from it
# only by each receiver's extra (no byzantine node leads at these views):
# about half of the 33 333 equivocators' stances are set toward each
# receiver, which makes up for the honest nodes whose broadcast dropped,
# and it commits what the flat run of one sweep commits (its digest and
# views are that run's, 70a43bdb… and d19ea3a3…); its telemetry
# (BYZ_BCAST_TELEMETRY) counts every slot's quorums.
BYZ_BCAST_RUNS = {
    "pbft-100k-bcast/silent":
        "4408ef2ebbc92b99378924d2a70fb3123fbf5e57b0b8c6d3184964118511b5ba",
    "pbft-100k-bcast/equivocate":
        "70a43bdba66b9e0d0ac86f7a20fe204ba68541ece618d7002ec2191cff9dada8",
    "pbft-100k-bcast/composed":
        "bac7f1cb3b9c497c7f7257fd0431e4c3d53ce68c5737f83e8902f7e0ca7f6d43",
}
BYZ_BCAST_VIEWS_SHA256 = {
    "pbft-100k-bcast/silent":
        "d4a33cb72e4ca6b1a1f39cafe4860cf8ef3b5b62477edb56a69e4ea01917ddd4",
    "pbft-100k-bcast/equivocate":
        "d19ea3a3b3c0a39ad7e31c83715b85378e4f3ec5bddfb50e654b66720f4820b6",
    "pbft-100k-bcast/composed":
        "31b0e1d67a683480d1654d7864d73f6a37ef30465b76e81cb4a1d0da0deb70ad",
}
# The bcast ladders with byzantine nodes, each mode: (base config, rungs,
# anchor), made by the JAX package as the ladders' anchors above: the fs =
# 1..128 ladder with one byzantine node a lane (its smallest rung's f;
# pbft_sweep.pbft_fsweep_run, 12 s and 16 s), the full-width ladder with
# n_byzantine = 8 333 (its smallest rung's f) from standalone runs of its
# rungs (f = fs[k], seed 7 + k, one sweep; 58 s and 110 s: the JAX ladder
# would draw the padded [N_pad, N_pad] stance grid, 1e10 draws a lane and
# round), whose payloads the ladder's concatenates, and the partitioned
# hostile ladder fs = 1..32 (HOSTILE_BCAST_FS) with one equivocator a lane
# (pbft_sweep.pbft_fsweep_run, 6 s), whose f = 1 lanes lead with their
# byzantine node and keep tables of four values:
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.core import serialize
#   from consensus_tpu.engines import pbft_sweep
#   from consensus_tpu.network import simulator
#   for name, (make, fs, _) in chip_smoke.BYZ_BCAST_LADDERS.items():
#       base = Config(**dataclasses.asdict(make()))
#       if name.startswith("wide"):
#           payloads = [simulator.run(dataclasses.replace(
#               base, f=f, n_nodes=3 * f + 1, seed=base.seed + k),
#               warmup=False).payload for k, f in enumerate(fs)]
#           print(name, serialize.digest(b"".join(payloads)))
#       else:
#           print(name, serialize.digest(pbft_sweep.fsweep_payload(
#               pbft_sweep.pbft_fsweep_run(base, fs))))
#   EOF
#
# At these knobs one byzantine node a lane moves no decision of the two
# fs = 1..128 ladders (both equal BCAST_LADDER_DIGEST) nor of the hostile
# one (HOSTILE_BCAST_DIGEST); the full-width ladder's equivocators give the
# flat ladder's digest, its silent nodes break the quorums of its first
# rung (the rung digests 9bf8cd52…, 2e2af0cf…, 181f27e4…). The C++ oracle
# agrees on every rung of the five ladders (engine="cpu"; the equivocating
# full-width rungs took it 503, 1 014 and 2 063 s; tests/
# test_torch_byz_bcast_steps.py holds smaller ladders).
BYZ_BCAST_LADDERS = {
    "bcast-ladder/silent": (
        lambda: pbft_config(1, fault_model="bcast", n_byzantine=1), LADDER,
        BCAST_LADDER_DIGEST),
    "bcast-ladder/equivocate": (
        lambda: pbft_config(1, fault_model="bcast", n_byzantine=1,
                            byz_mode="equivocate"), LADDER,
        BCAST_LADDER_DIGEST),
    "wide-ladder/silent": (
        lambda: wide_base(f=WIDE_RUNGS[0], n_nodes=3 * WIDE_RUNGS[0] + 1,
                          n_byzantine=WIDE_RUNGS[0]), WIDE_RUNGS,
        "280bf80be8db9bce6f97622c615c9ac8673600cabe4063085cc74141eb9fe21e"),
    "wide-ladder/equivocate": (
        lambda: wide_base(f=WIDE_RUNGS[0], n_nodes=3 * WIDE_RUNGS[0] + 1,
                          n_byzantine=WIDE_RUNGS[0], byz_mode="equivocate"),
        WIDE_RUNGS, WIDE_DIGEST),
    "hostile-ladder/equivocate": (
        lambda: pbft_config(1, fault_model="bcast", n_rounds=24,
                            log_capacity=8, seed=7, n_byzantine=1,
                            byz_mode="equivocate", **HOSTILE),
        HOSTILE_BCAST_FS, HOSTILE_BCAST_DIGEST),
}
# The equivocating run again with telemetry and 8-round windows: (nonzero
# counter totals, flight_digest), made by the JAX package on the CPU with
# its anchor (simulator.run(cfg, telemetry=True), 145 s). Every node
# prepares and commits each of the 16 slots once; the safety tail stays 0
# (no slot forks with at most f byzantine nodes), which phase 19 holds on
# built states (pbft_safety_cases, phase 18's, and §6b's own below).
BYZ_BCAST_TELEMETRY = {
    "pbft-100k-bcast/equivocate": (
        {"prepare_quorums": 1_600_000, "commit_quorums": 1_600_000,
         "view_changes": 500_000},
        "7eea944a1a95164bb8b17d785ae2117bc53e851fd86be3940d8266357c4de1eb"),
}
# Phase 19's own kernel (KAK), and the rows it times: row name -> (the run
# whose round 20 it is timed on, the wrapper where the row name is not one).
BYZ_BCAST_OWN = ("bcast_equiv_support",)
BYZ_BCAST_REPLACES = {
    "bcast_equiv_support": "consensus_tpu/engines/pbft_bcast.py:415 "
                           "pbft_bcast_round eq_extra (:425-433), "
                           "consensus_tpu/engines/pbft_sweep.py:335 "
                           "pbft_bcast_round_padded eq_extra (:335-350)"}
BYZ_BCAST_TIMED = {
    "bcast_view_preprepare": ("pbft-100k-bcast/equivocate", None),
    "bcast_tally": ("pbft-100k-bcast/equivocate", None),
    "bcast_tally m=4": ("bcast-ladder/equivocate", "bcast_tally"),
    "bcast_decide": ("pbft-100k-bcast/equivocate", None),
    "bcast_equiv_support": ("pbft-100k-bcast/equivocate", None),
    "pbft_telemetry": ("pbft-100k-bcast/equivocate", None),
}


def byz_bcast_config(key: str, **kw):
    """Phase 19's run ``key`` ("pbft-100k-bcast/<mode>"), changed by
    ``kw``."""
    mode = key.split("/")[1]
    if mode == "silent":
        return bcast_config(n_byzantine=BYZ_BCAST_NB, **kw)
    extra = BYZ_COMPOSED if mode == "composed" else {}
    return bcast_config(**{"n_sweeps": 1, **extra,
                           "n_byzantine": BYZ_BCAST_NB,
                           "byz_mode": "equivocate", **kw})


def bcast_byz_flat(name: str, args):
    """``args`` of §6b kernel ``name`` with its BYZ instance turned off: no
    byzantine node in KT's and KAA's Config (KAA without its values), no
    byz pair for KU (whose flat table width is the lanes' own without
    equivocators) and KV."""
    from consensus_tpu_torch.engines import pbft_bcast as pb
    if name == "bcast_tally":
        f = args[2]
        m = max(pb.table_width(3 * x + 1, x) for x in f.tolist())
        return (m, *args[1:10])
    if name == "bcast_decide":
        return args[:7]
    return byz_flat(name, args)


def support_draws(args) -> int:
    """The stance draws KAK's call ``args`` needs: for each broadcasting
    byzantine sender, the real receivers of its side (all of them where the
    partition is off), itself left out."""
    seed, r, n_real, nb, bits = args
    b, n = bits.shape
    bc = (bits & 1).bool()
    side = ((bits >> 1) & 1).long()
    idx = torch.arange(n, device=bits.device)
    real = idx[None, :] < n_real[:, None]
    byz = real & (idx[None, :] >= (n_real - nb)[:, None])
    sends = byz & bc
    per_side = torch.stack([(real & (side == s)).sum(1) for s in (0, 1)], 1)
    mine = per_side.gather(1, side)                        # [B, N]
    return int(torch.where(sends, mine - 1, 0).sum())


def byz_bcast_bound(name: str, args) -> tuple[float, str]:
    """The least time of §6b kernel ``name``'s work on a byzantine round's
    ``args``: KAK's stance draws and its bytes (a node byte read, an int32
    written, a node); for KT-KV their flat bound on the same inputs, plus
    what the BYZ instance adds: KT's stance and value draws (one each a
    (receiver, slot) of an equivocating primary that reaches it), KU's
    extra read twice; KAA's as phase 18 counts it."""
    from consensus_tpu_torch.engines import pbft_bcast as pb
    if name == "bcast_equiv_support":
        bits = args[4]
        return bound(5 * bits.numel(), THREEFRY_OPS * support_draws(args))
    if name == "pbft_telemetry":
        return byz_kernel_bound(name, args)
    nbytes, ops = flat_work(name, bcast_byz_flat(name, args)[:12])
    if name == "bcast_tally" and args[-1] is not None \
            and args[-1][1] is not None:
        nbytes += 8 * args[-1][1].numel()
    elif name == "bcast_view_preprepare" and args[0].byz == 2:
        cfg, n_real = args[0], args[3]
        s = args[7].shape[2]
        got = pb.bcast_view_preprepare_plain(*clone_args(args))
        view, bits = got[0], got[6]
        prim = view.remainder(n_real[:, None]).long()
        idx = torch.arange(view.shape[1], device=view.device)
        real = idx[None, :] < n_real[:, None]
        byzp = prim >= (n_real - cfg.n_byzantine)[:, None]
        pb_ = bits.gather(1, prim)
        reach = real & ((prim == idx) | (((pb_ & 1) != 0)
                                         & (((pb_ ^ bits) & 2) == 0)))
        ops += 2 * THREEFRY_OPS * s * int((byzp & reach).sum())
    return bound(nbytes, ops)


def bcast_byz_edge_inputs(dev, gen) -> dict:
    """Built inputs of the §6b BYZ instances and KAK: {name: [args]}. KU at
    the threshold at each table width: lanes whose counting senders (the
    honest broadcasting nodes of the larger side) hold value 7 in exactly
    Q - 1 - e - 1 .. Q - 1 - e + 1 of them (e a receiver's extra), on
    lanes of f = 2..8 with nb = f (m = 3 under equivocation) and nb < f
    (m = 1), and four-node lanes (f = 1) whose four nodes hold four
    distinct values in every other slot and values drawn from the same
    four in the rest (m = 4 under equivocation, 2 in silent mode); KT on
    random states whose primaries are byzantine for about half the
    receivers, both modes, with a partition; KV with honest and byzantine
    deciders; KAK on random node bytes at N = 3 001 (ragged lanes, a
    partition on some) and at N = 1."""
    from consensus_tpu_torch.engines import pbft_bcast as pb
    out = {name: [] for name in BCAST + BYZ_BCAST_OWN}

    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def coin(p, shape):
        return torch.rand(shape, generator=gen, device=dev) < p

    # KU at the threshold.
    B, S = 16, 24
    for fs, nbf, equiv in (((2, 9), lambda f: f, True),
                           ((2, 9), lambda f: f, False),
                           ((4, 9), lambda f: 2, True),
                           ((1, 2), lambda f: 1, True),
                           ((1, 2), lambda f: 1, False)):
        f = ri(*fs, (B,))
        nb = int(nbf(int(f.min())))
        n_real = 3 * f + 1
        N = int(n_real.max())
        idx = torch.arange(N, device=dev)
        real = idx[None, :] < n_real[:, None]
        honest = idx[None, :] < (n_real - nb)[:, None]
        bc = real & coin(0.9, (B, N))
        big = (torch.arange(B, device=dev) % 2).bool()
        side = coin(0.95, (B, N)) == big[:, None]
        bits = (bc.to(torch.uint8) | (side.to(torch.uint8) << 1))
        extra = torch.where(real, ri(0, nb + 1, (B, N)), 0) if equiv \
            else torch.zeros((B, N), dtype=torch.int32, device=dev)
        if int(f.max()) == 1:
            # Four nodes: four distinct values (7-10) in every other slot,
            # values drawn from the same four in the rest.
            turn = 7 + (idx[None, :, None] + ri(0, 4, (B, 1, S))) % 4
            pp_val = torch.where(torch.arange(S, device=dev) % 2 == 0,
                                 turn, 7 + ri(0, 4, (B, N, S))
                                 ).to(torch.int32).contiguous()
        else:
            counted = (honest & bc & (side == big[:, None]))[:, :, None] \
                .expand(B, N, S)
            rank = torch.rand((B, N, S), generator=gen, device=dev) \
                .masked_fill(~counted, 2.0).argsort(1).argsort(1)
            q = 2 * f + 1
            k = (q - 1 - nb // 2)[:, None] + ri(-1, 2, (B, S))
            pp_val = torch.where(counted,
                                 torch.where(rank < k[:, None, :], 7, 8),
                                 7 + ri(0, 2, (B, N, S))).to(torch.int32)
        pp_seen = real[:, :, None].expand(B, N, S).contiguous()
        prepared = pp_seen & coin(0.3, (B, N, S))
        committed = prepared & coin(0.2, (B, N, S))
        m = max(pb.table_width(3 * x + 1, x, nb if equiv else 0)
                for x in f.tolist())
        ku = (m, n_real, f, bits.contiguous(), pp_seen, pp_val, prepared,
              committed, ri(0, 9, (B, N, S)), False,
              (nb, extra if equiv else None))
        hit = pb.bcast_tally_plain(*clone_args(ku))[0] & ~prepared
        require(bool(hit.any()) and bool((pp_seen & ~prepared
                                          & ~hit).any()),
                "byzantine edge inputs: no prepare at the threshold, or no "
                "miss")
        out["bcast_tally"].append(ku)
        out["bcast_decide"].append((
            bits.contiguous(), committed | coin(0.2, (B, N, S)),
            ri(0, 9, (B, N, S)), committed & coin(0.5, (B, N, S)),
            ri(0, 9, (B, N)), coin(0.3, (B, N)), False, (n_real, nb)))
    widths = sorted({a[0] for a in out["bcast_tally"]})
    require(widths == [1, 2, 3, 4],
            f"byzantine edge inputs: table widths {widths}, not 1-4")

    # KT with byzantine primaries for about half the receivers.
    B, N, S = 12, 97, 40
    for mode in ("silent", "equivocate"):
        cfg = pbft_config(32, fault_model="bcast", log_capacity=S,
                          view_timeout=4, drop_rate=0.2, partition_rate=0.6,
                          n_byzantine=4, byz_mode=mode)
        vmax = 2 * cfg.n_rounds + 2
        seeds = torch.arange(31, 31 + B, dtype=torch.int64,
                             device=dev).to(torch.uint32)
        f = ri(4, 33, (B,))
        n_real = 3 * f + 1
        view = ri(0, vmax, (B, N))
        # Views whose primary is one of the 4 byzantine ids of the lane.
        byzv = (n_real - 1 - ri(0, 4, (B,)))[:, None] + n_real[:, None] \
            * ri(0, 2, (B, N))
        view = torch.where(coin(0.5, (B, N)), byzv, view).to(torch.int32)
        pp_seen = coin(0.6, (B, N, S))
        pp_view = torch.where(pp_seen, torch.minimum(
            ri(-1, vmax, (B, N, S)), view[:, :, None]), 0)
        pp_val = ri(0, 3, (B, N, S))
        prepared = (pp_seen | coin(0.05, (B, N, S))) & coin(0.5, (B, N, S))
        committed = prepared & coin(0.4, (B, N, S))
        for r in (3, 7):
            out["bcast_view_preprepare"].append(
                (cfg, seeds, r, n_real, f, view, ri(0, 6, (B, N)), pp_seen,
                 pp_view, pp_val, prepared, committed))

    # KAK on random node bytes.
    for b, n, nb, lanes in ((4, 3001, 333, (3001, 2500, 1999, 1000)),
                            (2, 1, 1, (1, 1))):
        n_real = torch.tensor(lanes, dtype=torch.int32, device=dev)
        seeds = torch.randint(0, 2**32, (b,), generator=gen, device=dev,
                              dtype=torch.int64).to(torch.uint32)
        idx = torch.arange(n, device=dev)
        real = idx[None, :] < n_real[:, None]
        active = torch.tensor([True, False] * (b // 2), device=dev)
        side = coin(0.5, (b, n)) & active[:, None]
        for r in (0, 5):
            bits = ((real & coin(0.8, (b, n))).to(torch.uint8)
                    | (side.to(torch.uint8) << 1)).contiguous()
            out["bcast_equiv_support"].append((seeds, r, n_real, nb, bits))
    return out


def check_byz_bcast_kernels(dev, gen):
    """Phase 19's kernel rows. Every kernel call of rounds 3 and 20 of each
    run BYZ_BCAST_RUNS (the equivocating one with telemetry and 8-round
    windows), of KT, KU, KV and KAK on every ladder BYZ_BCAST_LADDERS'
    rounds 3 and 20, of KAA on phase 18's built equivocating PBFT rounds
    under §6b's crash mode, and the built inputs
    (:func:`bcast_byz_edge_inputs`), against the plain versions, exact.
    Then each timed instance BYZ_BCAST_TIMED on round 20 of its run: its
    time, its plain version's and its bound, and its flat instance's time
    and bound on the same inputs (KAK, which has none, gets the kernels
    line's keys). Yields one row an instance."""
    from consensus_tpu_torch.engines import pbft, pbft_sweep
    errs = dict.fromkeys(BCAST + BYZ_BCAST_OWN + ("pbft_telemetry",), 0.0)
    cases = dict.fromkeys(errs, 0)
    timed = {}

    def hold(calls, where):
        hold_calls(calls, where, errs, cases)
    for key in BYZ_BCAST_RUNS:
        telemetry = key in BYZ_BCAST_TELEMETRY
        cfg = byz_bcast_config(key, **(dict(telemetry_window=WINDOW)
                                       if telemetry else {}))
        for r in BYZ_ROUNDS:
            calls = capture_round_calls(cfg, r, telemetry, dev)
            hold(calls, f"{key} round {r}")
            for name, (run, wrapper) in BYZ_BCAST_TIMED.items():
                if run == key and r == 20:
                    timed[name] = calls[wrapper or name][0]
    for name, (make, rungs, _) in BYZ_BCAST_LADDERS.items():
        cfg_pad = pbft_sweep._fsweep_static(make(), rungs)[1]
        wrappers = BCAST + (BYZ_BCAST_OWN if cfg_pad.byz == 2 else ())
        for wrapper in wrappers:
            got = capture_calls(cfg_pad, BYZ_ROUNDS, wrapper, rungs, dev)
            hold({wrapper: [a for calls in got.values() for a in calls]},
                 f"the {name}")
            for tname, (run, w) in BYZ_BCAST_TIMED.items():
                if run == name and w == wrapper:
                    timed[tname] = got[20][0]
    safety = [(*a[:17], pbft.CRASH_VIEWS | pbft.CRASH_COMMITS, a[18])
              for a in pbft_safety_cases(dev) if a[17]]
    hold({"pbft_telemetry": safety}, "built equivocating §6b rounds")
    hold(bcast_byz_edge_inputs(dev, gen), "built byzantine §6b inputs")
    for name, (run, wrapper) in BYZ_BCAST_TIMED.items():
        kernel = wrapper or name
        args = timed[name]
        mod = kernel_module(kernel)
        fn, plain = getattr(mod, kernel), getattr(mod, kernel + "_plain")
        own = kernel in BYZ_BCAST_OWN
        reps = 3 if own else reps_for(args)
        row = dict(name=name, max_abs_err=errs[kernel],
                   cases=cases[kernel], timed_on=f"{run} round 20",
                   ms=graph_ms(fn, args, reps),
                   plain_ms=event_ms(plain, args, 1 if own else 5),
                   bound=byz_bcast_bound(kernel, args))
        if own:
            row.update(route="cuda",
                       source=f"consensus_tpu_torch/csrc/{kernel}.cu",
                       replaces=BYZ_BCAST_REPLACES[kernel], library_ms=None)
        else:
            flat = bcast_byz_flat(kernel, args)
            row.update(flat_instance_ms=graph_ms(fn, flat, reps),
                       flat_instance_bound=bound(*flat_work(
                           kernel, flat[:12] if kernel in BCAST else flat)))
        yield row


def check_byz_bcast_runs(card: str, smi: str) -> dict[str, int]:
    """Phase 19's runs: each run BYZ_BCAST_RUNS (:func:`anchored_run`: its
    anchor and views from the replay and the eager loop, KAK once a round
    under equivocation and never in silent mode, KAK's share of the
    replay's device time) and each ladder BYZ_BCAST_LADDERS
    (:func:`anchored_ladder`); then BYZ_BCAST_TELEMETRY's run with
    telemetry and 8-round windows (:func:`anchored_telemetry`). Returns
    KAK's launches in pbft-100k-bcast's equivocating run."""
    own = {}
    for key, digest in BYZ_BCAST_RUNS.items():
        cfg = byz_bcast_config(key)
        row, launches, replayed, eager, full = anchored_run(cfg, digest)
        row["views_sha256"] = views_sha256(replayed["view"])
        row["eager_views_sha256"] = views_sha256(eager["view"])
        kak = full["hand_kernel_ms"].get("bcast_equiv_support", 0.0)
        row["support_share"] = kak / full["device_ms"]
        emit("byz_bcast_run", run=key, **row, card=card, power=smi)
        require(row["views_sha256"] == BYZ_BCAST_VIEWS_SHA256[key]
                and row["eager_views_sha256"] == BYZ_BCAST_VIEWS_SHA256[key],
                f"{key}: views {row['views_sha256']} (replay), "
                f"{row['eager_views_sha256']} (eager)")
        require(launches["bcast_equiv_support"] == (
            launches["bcast_view_preprepare"] if cfg.byz == 2 else 0),
            f"{key}: KAK launched {launches['bcast_equiv_support']} times")
        hold_run(key, row, digest, cfg, launches)
        if key == "pbft-100k-bcast/equivocate":
            own = launches
    for name, (make, rungs, digest) in BYZ_BCAST_LADDERS.items():
        anchored_ladder(name, make(), rungs, digest, "byz_bcast_run", card,
                        smi)
    for key, (nonzero, flight) in BYZ_BCAST_TELEMETRY.items():
        anchored_telemetry(key, byz_bcast_config(key,
                                                 telemetry_window=WINDOW),
                           BYZ_BCAST_RUNS[key], nonzero, flight,
                           "byz_bcast_telemetry", card, smi)
    return {name: own[name] for name in BYZ_BCAST_OWN}


# --- phase 20: SPEC §A.1 and §A.4 on DPoS, SPEC §A.3 on both Raft engines ----

# The sticky runs' targets: the first leader of sweep 0 in each flat run,
# read from the JAX package (node 5 of raft-100k and node 3 of raft-1kx1k,
# both elected in round 3).
STICKY_TARGETS = {"raft-100k": 5, "raft-1kx1k": 3}
GATE_FLAGSHIPS = {
    "raft-100k": flagship_config,
    "raft-1kx1k": gate_1kx1k,
    "dpos-100k": lambda **kw: protocol_config(DPOS_FLAGSHIP, **kw)}
# Each gate's overrides: rolling-producer-outage's (consensus_tpu/
# scenarios/__init__.py:111-125) and the adversary knobs of
# tests/test_aggregate.py:258-263's SUPPRESS_BASE on dpos-100k;
# repeated-election-disruption's (scenarios/__init__.py:96-109) and the
# sticky attack at rate 1 on STICKY_TARGETS on the Raft flagships.
GATE_SETTINGS = {
    "rolling-producer-outage": dict(miss_rate=0.35, crash_prob=0.08,
                                    recover_prob=0.25, drop_rate=0.1),
    "suppress-base": dict(drop_rate=0.2, churn_rate=0.02, miss_rate=0.1,
                          max_delay_rounds=2, crash_prob=0.05,
                          recover_prob=0.3, suppress_rate=0.3,
                          suppress_window=24),
    "elect": dict(attack="elect", attack_rate=0.85, drop_rate=0.05),
    "sticky": dict(attack="sticky", attack_rate=1.0)}
# Phase 20's runs, each with telemetry and 8-round windows (raft-1kx1k's at
# GATE_1KX1K_ROUNDS rounds, a cut): (digest, the
# nonzero counter totals, flight_digest, the C++ oracle's digest or None
# where the oracle does not run the gate, §A.3). The JAX package made each
# on the CPU, and the oracle the DPoS digests (engine="cpu", telemetry
# off), which agree (10-64 s a JAX run on eight cores, 8-9 s an oracle
# run):
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   for key in chip_smoke.GATE_RUNS:
#       c = chip_smoke.gate_config(key)
#       cfg = Config(**{k: getattr(c, k) for k in c.__dataclass_fields__})
#       res = simulator.run(cfg, warmup=False, telemetry=True)
#       print(key, res.digest, {k: v for k, v in
#             res.extras["telemetry"]["totals"].items() if v},
#             chip_smoke.flight_digest(res.extras["flight"]))
#       if cfg.protocol == "dpos":
#           print(simulator.run(dataclasses.replace(
#               cfg, engine="cpu", telemetry_window=0), warmup=False).digest)
#   EOF
GATE_RUNS = {
    "dpos-100k/rolling-producer-outage": (
        "c9c92c9cf8695d671cb2faf242e7d46ccc64125de15b7d6538f985d0979b5119",
        {"blocks_appended": 7926786, "missed_appends": 17673214,
         "producer_rotations": 255, "missed_slots": 93, "crashes": 1657331,
         "recoveries": 1631483, "nodes_down": 6549198},
        "6799f096a1c60e3729e40220d92b2a43302f3d8f3c9d86b4dc4f4e81bac1deef",
        "c9c92c9cf8695d671cb2faf242e7d46ccc64125de15b7d6538f985d0979b5119"),
    "dpos-100k/suppress-base": (
        "401df0bd91ac4d03589f4250a738e379e7483a546eeb49e2c05855027ee51ff7",
        {"blocks_appended": 10682874, "missed_appends": 14917126,
         "producer_rotations": 255, "churn_slots": 4, "missed_slots": 27,
         "suppressed_slots": 64, "crashes": 1148612, "recoveries": 1133601,
         "nodes_down": 3790498},
        "f08908c97544b201b437f8acc2e0f5e456d9364f3c4c0fb91df996ad347ba2b0",
        "401df0bd91ac4d03589f4250a738e379e7483a546eeb49e2c05855027ee51ff7"),
    "raft-100k/elect": (
        "7421ddae44039627662b82e000dabef31ed9d4cef6b3d721df318348afb90152",
        {"leader_elections": 28, "append_accepted": 13683160,
         "append_rejected": 122178, "entries_committed": 13633044,
         "attack_rounds": 360},
        "19be1acbb9c7f324676677dc0b6e7ec6c3846f959affe79aff4cd82e6adba1e6",
        None),
    "raft-100k/sticky": (
        "725e3fc6fdfda992cf1015c14bd5c492ccabda5bb0f2a5d7b96d7c59116ddb1b",
        {"leader_elections": 21, "append_accepted": 44431719,
         "append_rejected": 21738, "entries_committed": 43984267,
         "attack_rounds": 164},
        "b5b59459c9d18925505c95035128c133644a2982fb873adbf40670ee7cd0554f",
        None),
    "raft-1kx1k/elect": (
        "b28f339a54014d143eff5dcd66666645d24ae200f76cc1cd0e9d9129b22c7371",
        {"leader_elections": 57, "append_accepted": 1783922,
         "append_rejected": 1071, "entries_committed": 819200,
         "attack_rounds": 188},
        "da39acbc0e6b74e2e664fae3268b5c37afc10c0c4dba120573b446a69f587b87",
        None),
    "raft-1kx1k/sticky": (
        "56b4a2f21ca5e58cb49998dbd5c6d170c3b2f7fa4fbbd2c5ea9cf3bd4a6e7936",
        {"leader_elections": 9, "append_accepted": 2048023,
         "entries_committed": 717824, "attack_rounds": 252},
        "a564c553f318f4befdf9bfc748645073a071f49b2cfdf1acfdb7d9b50a028c03",
        None),
}
# The instances phase 20 times, each on round 20 of a run: (wrapper, run).
GATE_TIMED = {
    "candidacy/elect": ("candidacy", "raft-100k/elect"),
    "candidacy/sticky": ("candidacy", "raft-100k/sticky"),
    "delivery_edges/elect": ("delivery_edges", "raft-100k/elect"),
    "delivery_edges/sticky": ("delivery_edges", "raft-100k/sticky"),
    "telemetry/elect": ("telemetry", "raft-100k/elect"),
    "delivery/sticky": ("delivery", "raft-1kx1k/sticky"),
    "dense_elect/elect": ("dense_elect", "raft-1kx1k/elect"),
    "dense_elect/sticky": ("dense_elect", "raft-1kx1k/sticky"),
    "dense_telemetry/elect": ("dense_telemetry", "raft-1kx1k/elect"),
    "dpos_round/gates": ("dpos_round", "dpos-100k/suppress-base"),
    "dpos_telemetry/gates": ("dpos_telemetry", "dpos-100k/suppress-base")}
GATE_ROUNDS = (3, 20)
# The wrappers whose last positional argument is the attack operand (the
# word, or KL's sticky triple), by their arity with it; the others take
# the gate from the Config.
ATTACK_ARG = {"delivery_edges": 10, "delivery": 8, "telemetry": 16,
              "dense_telemetry": 15}


def gate_config(key: str, **kw):
    """Phase 20's run ``key`` ("<flagship>/<setting>"), with telemetry
    and 8-round windows, changed by ``kw``."""
    name, setting = key.split("/")
    extra = dict(GATE_SETTINGS[setting])
    if setting == "sticky":
        extra["attack_target"] = STICKY_TARGETS[name]
    return GATE_FLAGSHIPS[name](**{**extra, "telemetry_window": WINDOW,
                                   **kw})


def gate_instance(name: str, args) -> bool:
    """Whether this call of wrapper ``name`` runs a gate instance."""
    if name in ATTACK_ARG:
        return len(args) == ATTACK_ARG[name] and args[-1] is not None
    cfg = args[0]
    return bool(cfg.attack_mode) if name in ("candidacy", "dense_elect") \
        else cfg.miss_on or cfg.suppress_on


def gate_flat(name: str, args):
    """``args`` of gate-instance call ``name`` with the gate turned off:
    the attack operand dropped, or the Config's gate knobs at their
    defaults."""
    if name in ATTACK_ARG:
        return args[:-1]
    if name in ("candidacy", "dense_elect"):
        off = dict(attack="none", attack_rate=1.0, attack_target=0)
    else:
        off = dict(miss_rate=0.0, suppress_rate=0.0, suppress_window=16)
    return (dataclasses.replace(args[0], **off), *args[1:])


def gate_bound(name: str, args) -> tuple[float, str]:
    """The least time of a gate instance's work on ``args``: its flat bound
    on the same inputs, plus what the gate adds: one activation draw a
    lane (KE, KM, KL) or the two §A.1/§A.4 draws of the lane's producer
    (KX, KAB), and the lane's attack word written or read once."""
    flat = gate_flat(name, args)
    nbytes, ops = flat_work(name, flat[:7] if name == "dpos_round" else flat)
    b = next(tensors_of(args)).shape[0]          # every call's lanes lead
    draws = {"candidacy": 1, "dense_elect": 1, "delivery": 1,
             "dpos_round": 2, "dpos_telemetry": 2}.get(name, 0)
    words = 0 if name.startswith("dpos") else 4
    return bound(nbytes + words * b, ops + draws * THREEFRY_OPS * b)


def gate_built_calls(base: dict, dev) -> dict[str, list]:
    """Gate-instance calls on built inputs, from round-20 calls of the
    runs (``base``: {run: {wrapper: [arguments]}}): KE and KM under elect
    at rate 1 with lane 0 holding only an old candidacy, lane 1 only a new
    candidacy of a node down at the round's end (its edges cut), lane 2
    one live new candidacy; KE and KM under sticky with the target and one
    other node leading in a churn round; KL's sticky column with the
    target leading in every other lane; KB with attack words set in every
    other lane, on the target and on every receiver; KX and KAB where each
    lane's producer is both missed and suppressed. The plain versions'
    results on them are required to show those cases."""
    from consensus_tpu_torch.core.config import ATTACK_STICKY
    from consensus_tpu_torch.engines import dpos, raft
    from consensus_tpu_torch.ops.adversary import CRASH_DOWN
    out: dict = {}
    for name, run in (("candidacy", "raft-100k"), ("dense_elect",
                                                   "raft-1kx1k")):
        role_at = 4 if name == "candidacy" else 5
        fn = kernel_module(name)
        plain = getattr(fn, name + "_plain")
        # Elect: an old candidacy alone, a down node's alone, a live one.
        args = list(clone_args(base[f"{run}/elect"][name][0]))
        args[0] = dataclasses.replace(args[0], attack_rate=1.0)
        role, timer, timeout = args[role_at], args[role_at + 2], \
            args[role_at + 3]
        role[:3] = torch.where(role[:3] == raft.ROLE_L, raft.ROLE_F,
                               role[:3])
        timer[:3] = 0
        role[0, 1] = raft.ROLE_C
        timer[1, 2] = timeout[1, 2]
        timer[2, 3] = timeout[2, 3]
        flags = torch.zeros(role.shape, dtype=torch.uint8, device=dev)
        flags[1, 2] = CRASH_DOWN
        if name == "dense_elect":                # KL cuts a down node
            args[3][1, 2, :] = False
            args[3][1, :, 2] = False
        for call in (tuple(args), (*args, flags)):
            word = plain(*clone_args(call))[-1]
            require(word[0] == 0 and word[2] == 1,
                    f"built {name} (elect): words {word[:3].tolist()}")
            out.setdefault(name, []).append(call)
        require(plain(*clone_args((*args, flags)))[-1][1] == 0,
                f"built {name}: a down node's candidacy jammed")
        # Sticky: the target and one more node lead in a churn round.
        args = list(clone_args(base[f"{run}/sticky"][name][0]))
        cfg = dataclasses.replace(args[0], churn_rate=1.0)
        require(cfg.attack_mode == ATTACK_STICKY, f"{name}: not sticky")
        args[0] = cfg
        tgt, other = cfg.attack_target, cfg.attack_target + 1
        args[role_at][:, tgt] = raft.ROLE_L
        args[role_at][:, other] = raft.ROLE_L
        if name == "dense_elect":                # KL's sticky column
            args[3][:, :, tgt] = False
        got = plain(*clone_args(args))
        require(bool((got[-1] == 1).all())
                and bool((got[1][:, tgt] == raft.ROLE_L).all())
                and not bool((got[1][:, other] == raft.ROLE_L).any()),
                f"built {name} (sticky): the target stepped down")
        out[name].append(tuple(args))
    # KL: the target leads in every other lane.
    args = list(clone_args(base["raft-1kx1k/sticky"]["delivery"][0]))
    role, tgt, _ = args[-1]
    role[0::2, tgt] = raft.ROLE_L
    role[1::2, tgt] = raft.ROLE_F
    args[-1] = (role, tgt, 0xFFFFFFFF)
    out["delivery"] = [tuple(args)]
    # KB: words in every other lane, on the target and on every receiver.
    for call in base["raft-100k/sticky"]["delivery_edges"][:2]:
        word = torch.zeros_like(call[-1][0])
        word[0::2] = 1
        for dst in (call[-1][1], -1):
            out.setdefault("delivery_edges", []).append(
                (*clone_args(call[:-1]), (word, dst)))
    # KX and KAB: every lane's producer missed and suppressed.
    both = dict(miss_rate=1.0, suppress_rate=1.0)
    for name in ("dpos_round", "dpos_telemetry"):
        args = clone_args(base["dpos-100k/suppress-base"][name][0])
        args = (dataclasses.replace(args[0], **both), *args[1:])
        out[name] = [args]
    t = out["dpos_telemetry"][0][6]
    before = t.clone()
    dpos.dpos_telemetry_plain(*clone_args(out["dpos_telemetry"][0][:6]), t,
                              *out["dpos_telemetry"][0][7:])
    cols = [dpos.DPOS_TELEMETRY.index(c) for c in ("missed_slots",
                                                   "suppressed_slots")]
    require(bool(((t - before)[:, cols] == 1).all()),
            "built KAB: a lane's producer not counted missed and suppressed")
    return out


def check_gate_kernels(dev):
    """Phase 20's kernel rows. Every kernel call of rounds 3 and 20 of each
    run GATE_RUNS (with telemetry and 8-round windows) and of the built
    cases (:func:`gate_built_calls`) against the plain versions, exact.
    Then each gate instance's time on round 20 of its GATE_TIMED run (the
    largest of its gate-instance calls there), its plain version's and its
    bound, and its flat instance's time and bound on the same inputs.
    Yields one row an instance."""
    wrappers = sorted({name for name, _ in GATE_TIMED.values()})
    errs = dict.fromkeys(wrappers, 0.0)
    cases = dict.fromkeys(wrappers, 0)
    base: dict = {}
    for key in GATE_RUNS:
        cfg = gate_config(key)
        for r in GATE_ROUNDS:
            calls = capture_round_calls(cfg, r, True, dev)
            hold_calls(calls, f"{key} round {r}", errs, cases)
            if r == 20:
                base[key] = calls
    hold_calls(gate_built_calls(base, dev), "built gate inputs", errs,
               cases)
    for row, (name, run) in GATE_TIMED.items():
        mine = [a for a in base[run][name] if gate_instance(name, a)]
        require(bool(mine), f"{run}: no gate-instance call of {name}")
        args = max(mine, key=lambda a: sum(t.numel() for t in tensors_of(a)))
        mod = kernel_module(name)
        reps = reps_for(args)
        flat = gate_flat(name, args)
        yield dict(name=row, max_abs_err=errs[name], cases=cases[name],
                   timed_on=f"{run} round 20",
                   ms=graph_ms(getattr(mod, name), args, reps),
                   plain_ms=event_ms(getattr(mod, name + "_plain"), args,
                                     min(3, reps)),
                   bound=gate_bound(name, args),
                   flat_instance_ms=graph_ms(getattr(mod, name), flat, reps),
                   flat_instance_bound=bound(*flat_work(
                       name, flat[:7] if name == "dpos_round" else flat)))


def gate_path(cfg) -> tuple[str, ...]:
    """The kernels a telemetry run of ``cfg`` launches: its engine's
    telemetry path, and KAH with a crash."""
    from consensus_tpu_torch.network import runner
    path = crash_path(runner.engine(cfg).name, telemetry=True)
    return path if cfg.crash_on else path[:-1]


def check_gate_runs(card: str, smi: str) -> None:
    """Phase 20's runs: ``simulator.run`` of each run GATE_RUNS with
    telemetry and 8-round windows, replayed as one CUDA graph and counted
    from 0: its digest, counter totals (the gate's own among them, above
    0) and flight recorder against the JAX anchors, from the replay and
    from the eager loop, the oracle's digest on DPoS, its path's kernels
    launched and no other; node-round-steps per second, the replay's wall,
    busy share and device operations a round (one profiled replay)."""
    from consensus_tpu_torch.network import runner, simulator
    for key, (digest, nonzero, flight, oracle) in GATE_RUNS.items():
        cfg = gate_config(key)
        eng = runner.engine(cfg)
        res, launches = counted(lambda: simulator.run(cfg, telemetry=True))
        tel, fl = res.extras["telemetry"], res.extras["flight"]
        stats: dict = {}
        eager = runner.run(cfg, graph=False, telemetry=True, stats=stats)
        eager_sha = eager_digest(cfg, res, eager)
        prof = profile_replay(cfg, telemetry=True)
        want = {k: nonzero.get(k, 0) for k in eng.telemetry_names}
        gate = "attack_rounds" if cfg.attack_mode else "missed_slots"
        row = dict(
            digest=res.digest, digest_ok=res.digest == digest,
            eager_digest=eager_sha, oracle_digest=oracle,
            totals=tel["totals"], totals_ok=tel["totals"] == want,
            flight_sha256=flight_digest(fl),
            flight_ok=flight_digest(fl) == flight,
            eager_equal=flight_digest(stats["flight"]) == flight_digest(fl)
            and all(np.array_equal(stats["telemetry"][k], v)
                    for k, v in tel["per_sweep"].items()),
            steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
            launches=launches, replay_wall_ms=prof["replay_wall_ms"],
            busy_share=prof["busy_share"],
            unprofiled_busy_share=prof["unprofiled_busy_share"],
            device_ms=prof["device_ms"],
            device_launches=prof["device_launches"],
            device_ops_per_round=prof["launches_per_round"],
            hand_kernel_ms={k: v for k, v in prof["hand_kernel_ms"].items()
                            if v})
        emit("gate_run", run=key, **row, card=card, power=smi)
        for check in ("digest_ok", "totals_ok", "flight_ok", "eager_equal"):
            require(row[check], f"{key}: {check} fails")
        require(eager_sha == digest,
                f"{key}: the eager loop's digest {eager_sha}")
        require(oracle is None or oracle == digest,
                f"{key}: the oracle's digest {oracle} != {digest}")
        require(tel["totals"][gate] > 0, f"{key}: {gate} counted nothing")
        if cfg.suppress_on:
            require(tel["totals"]["suppressed_slots"] > 0,
                    f"{key}: suppressed_slots counted nothing")
        require_launched(launches, gate_path(cfg), key)
        runner.clear_graphs()


# --- phase 21: SPEC §9 switch delivery, and §9b on HotStuff ------------------

# The switch knobs of the JAX package's §9 flagships (tools/hlocheck/
# registry.py:130-133, 164-171): K = 8 aggregators, 1% fail and stale
# draws, stale depth up to 4.
SWITCH_KNOBS = dict(net_model="switch", n_aggregators=8, agg_fail_rate=0.01,
                    agg_stale_rate=0.01, agg_max_stale=4)
# The parity grid's adversary (tests/test_aggregate.py:36-37) and the cap
# of its capped case (:53).
SWITCH_COMPOSED = dict(drop_rate=0.2, partition_rate=0.1, churn_rate=0.03,
                       max_delay_rounds=2, crash_prob=0.08, recover_prob=0.3,
                       max_crashed=5)
# discovered-silent-qc-fork (consensus_tpu/scenarios/discovered.json): its
# overrides, its tuned shape (N = 7, f = 2, 96 rounds, L = 96, view
# timeout 4), 2 sweeps and its 4-round window; the §9b knobs also go on
# hotstuff-100k with n_byzantine = f.
FORK_9B = dict(n_byzantine=2, byz_mode="equivocate", agg_byz=1,
               agg_poison_rate=0.8923, byz_uplink_rate=0.4391)
FORK_SCENARIO = dict(protocol="hotstuff", f=2, n_nodes=7, n_rounds=96,
                     log_capacity=96, view_timeout=4, n_sweeps=2,
                     net_model="switch", n_aggregators=2, drop_rate=0.0159,
                     telemetry_window=4, **FORK_9B)
FORK_SEEDS = (11, 23, 37)
# The scenario's bounds (min_counters, min_availability).
FORK_MIN = ("forked_qc", "conflict_commits", "safety_violations")
FORK_AVAILABILITY = 0.7
SWITCH_FLAGSHIPS = {
    "raft-100k": flagship_config,
    "raft-1kx1k": gate_1kx1k,
    "paxos-10kx10k": lambda **kw: protocol_config(PAXOS_FLAGSHIP, **kw),
    "hotstuff-100k": lambda **kw: protocol_config(HOTSTUFF_FLAGSHIP, **kw),
    "fork": lambda **kw: protocol_config(FORK_SCENARIO, **kw)}
SWITCH_SETTINGS = {
    "switch": dict(SWITCH_KNOBS, telemetry_window=WINDOW),
    "composed": dict(SWITCH_KNOBS, **SWITCH_COMPOSED,
                     telemetry_window=WINDOW),
    "9b": dict(SWITCH_KNOBS, **{**FORK_9B, "n_byzantine": 33_333},
               telemetry_window=WINDOW),
    **{str(s): dict(seed=s) for s in FORK_SEEDS}}
# Phase 21's runs, each with telemetry (8-round windows, the fork
# scenario's 4; raft-1kx1k at GATE_1KX1K_ROUNDS rounds, a cut): (digest,
# the nonzero counter totals, flight_digest, the
# C++ oracle's digest). The JAX package made each on the CPU (sweep_chunk 1
# on the 100k runs; 2-6 s a fork run, 1-2 min a 100k one, 18 min
# paxos-10kx10k on 8 cores), the oracle each digest (engine="cpu",
# telemetry off; at most 71 s); they agree:
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   for key in chip_smoke.SWITCH_RUNS:
#       c = chip_smoke.switch_config(key)
#       cfg = Config(**{k: getattr(c, k) for k in c.__dataclass_fields__})
#       res = simulator.run(dataclasses.replace(cfg, sweep_chunk=int(
#           cfg.n_nodes >= 100_000)), warmup=False, telemetry=True)
#       print(key, res.digest, {k: v for k, v in
#             res.extras["telemetry"]["totals"].items() if v},
#             chip_smoke.flight_digest(res.extras["flight"]))
#       print(simulator.run(dataclasses.replace(
#           cfg, engine="cpu", telemetry_window=0), warmup=False).digest)
#   EOF
SWITCH_RUNS = {
    "raft-100k/switch": (
        "0e9cc1ddc8b04d96240cdeb5f19877bbd3aad2b23883a585fa1e1c78a961ca5b",
        {"leader_elections": 18, "append_accepted": 45331391,
         "append_rejected": 10257, "entries_committed": 44992046,
         "agg_down_rounds": 50, "stale_serves": 40},
        "14d60fd63ed3e98479617197ae86a5f0629d46a73f3b652b4e8ff415acfc3641",
        "0e9cc1ddc8b04d96240cdeb5f19877bbd3aad2b23883a585fa1e1c78a961ca5b"),
    "raft-1kx1k/switch": (
        "8748ac4fce3ad51b006d1d6542aa853f6d2f25839915ead9327bf7ca948f3308",
        {"leader_elections": 10, "append_accepted": 2045993,
         "entries_committed": 819200, "agg_down_rounds": 166,
         "stale_serves": 176},
        "0f3044a0551e2d750db9e4d895bcb2c73c968c77856b9bae901648a4731eabd8",
        "8748ac4fce3ad51b006d1d6542aa853f6d2f25839915ead9327bf7ca948f3308"),
    "raft-100k/composed": (
        "5144090760df03c324462bc084f36afc8c798fa4dac02a3d46a7b1195cfeb892",
        {"leader_elections": 63, "append_accepted": 15992853,
         "append_rejected": 2697178, "entries_committed": 19460662,
         "crashes": 749, "recoveries": 709, "nodes_down": 2560,
         "agg_down_rounds": 50, "stale_serves": 40},
        "e8088ab43c4e9ac6c667b2064c40a71aab74f286648f467ae013bdbdb094ef08",
        "5144090760df03c324462bc084f36afc8c798fa4dac02a3d46a7b1195cfeb892"),
    "paxos-10kx10k/switch": (
        "4d64c2179c317a36b5330e5da3fe95842afbdde0a7af25714aedc6f27a2b41fa",
        {"promises": 976101511, "nacks": 601661807, "accepts": 972262964,
         "proposals_decided": 101004, "values_learned": 99999998,
         "agg_down_rounds": 1, "stale_serves": 1},
        "b00ef51beacdc4b817b7c29f9933252350d60e158009104fea64ad29a24f9ab3",
        "4d64c2179c317a36b5330e5da3fe95842afbdde0a7af25714aedc6f27a2b41fa"),
    "hotstuff-100k/switch": (
        "f35df9edc21282a4ff56022a58c6b983c80aa25de3a124e15229a9d3e9567824",
        {"qc_formed": 511, "blocks_committed": 495,
         "commits_learned": 48691840, "proposals_delivered": 50688245,
         "votes_counted": 49249286, "agg_down_rounds": 42,
         "stale_serves": 40, "view_spread_max": 550, "desync_rounds": 511,
         "sync_msgs_delivered": 497673},
        "40575ec5f51cd4fe7ae86082a3b16f3f91aa521187c1b3ccbf2b3ea02c266af2",
        "f35df9edc21282a4ff56022a58c6b983c80aa25de3a124e15229a9d3e9567824"),
    "hotstuff-100k/9b": (
        "f35df9edc21282a4ff56022a58c6b983c80aa25de3a124e15229a9d3e9567824",
        {"qc_formed": 511, "blocks_committed": 495,
         "commits_learned": 48691840, "proposals_delivered": 50688245,
         "votes_counted": 65942935, "agg_down_rounds": 42,
         "stale_serves": 40, "poisoned_serves": 450, "view_spread_max": 540,
         "desync_rounds": 511, "sync_msgs_delivered": 497673},
        "221f7f52dee90721e79a565160560e9ca9a91812dc56ccc0a547c04a1211518c",
        "f35df9edc21282a4ff56022a58c6b983c80aa25de3a124e15229a9d3e9567824"),
    "fork/11": (
        "740fd38be51fa567e678e79737ed579edcd2d1a5c8098d739e37a34a3a151ed9",
        {"qc_formed": 185, "blocks_committed": 181, "commits_learned": 1253,
         "proposals_delivered": 1319, "votes_counted": 1854,
         "poisoned_serves": 171, "forked_qc": 15, "conflict_commits": 36,
         "safety_violations": 14, "view_spread_max": 14, "desync_rounds": 14,
         "sync_msgs_delivered": 23},
        "2d8e644540244b727921bd1051ef8e74a66763d62efbd16a7048ccb7652e0dc6",
        "740fd38be51fa567e678e79737ed579edcd2d1a5c8098d739e37a34a3a151ed9"),
    "fork/23": (
        "0aecef84eccd4059b95280384be4397b397c4f4d97b4854c74bf5312867390eb",
        {"qc_formed": 187, "blocks_committed": 183, "commits_learned": 1267,
         "proposals_delivered": 1328, "votes_counted": 1859,
         "poisoned_serves": 173, "forked_qc": 13, "conflict_commits": 30,
         "safety_violations": 12, "view_spread_max": 9, "desync_rounds": 9,
         "sync_msgs_delivered": 15},
        "bf66562fe538998fd82fd366ac0bfb307762427e4f7393a4f0e616e3bd2047f4",
        "0aecef84eccd4059b95280384be4397b397c4f4d97b4854c74bf5312867390eb"),
    "fork/37": (
        "62c83483c6637c03a221c415126a05a3f38feccd9dd89c2ba405a9fad6ca8e38",
        {"qc_formed": 186, "blocks_committed": 182, "commits_learned": 1260,
         "proposals_delivered": 1330, "votes_counted": 1843,
         "poisoned_serves": 160, "forked_qc": 17, "conflict_commits": 33,
         "safety_violations": 13, "view_spread_max": 9, "desync_rounds": 9,
         "sync_msgs_delivered": 13},
        "f5e164a1f1539d77c2f4362ceac5ad1b46cdec32d40d1eecb0e3ef9c97c6ce44",
        "62c83483c6637c03a221c415126a05a3f38feccd9dd89c2ba405a9fad6ca8e38"),
}
# The wrapper timed for each SWITCH instance and KAL, each on round 20 of a
# run: (wrapper, run).
SWITCH_TIMED = {
    "delivery_edges (switch)": ("delivery_edges", "raft-100k/switch"),
    "dense_elect (switch)": ("dense_elect", "raft-1kx1k/switch"),
    "paxos_promise (switch)": ("paxos_promise", "paxos-10kx10k/switch"),
    "paxos_accept_learn (switch)": ("paxos_accept_learn",
                                    "paxos-10kx10k/switch"),
    "hotstuff_vote (switch)": ("hotstuff_vote", "hotstuff-100k/switch"),
    "hotstuff_vote (switch, 9b)": ("hotstuff_vote", "hotstuff-100k/9b"),
    "agg_round": ("agg_round", "hotstuff-100k/9b")}
SWITCH_ROUNDS = (3, 20)
# paxos-10kx10k runs 16 rounds: its later round is its last.
SWITCH_LAST = {"paxos-10kx10k": 15}
SWITCH_OWN = ("agg_round",)
SWITCH_REPLACES = {
    "agg_round": "consensus_tpu/ops/aggregate.py:93 agg_round, :119 "
                 "agg_counts, :132 agg_poison, :190 poison_count, :280 "
                 "uplink_edge",
    "delivery_edges (switch)": "consensus_tpu/engines/raft_sparse.py:301 "
                               "raft_sparse_round P2c §9 branch",
    "dense_elect (switch)": "consensus_tpu/engines/raft.py:367 raft_round "
                            "P2c §9 branch",
    "paxos_promise (switch)": "consensus_tpu/engines/paxos.py:153 "
                              "paxos_round promises §9 branch",
    "paxos_accept_learn (switch)": "consensus_tpu/engines/paxos.py:209 "
                                   "paxos_round accepts §9 branch",
    "hotstuff_vote (switch)": "consensus_tpu/engines/hotstuff.py:340 "
                              "hotstuff_round votes §9 branch",
    "hotstuff_vote (switch, 9b)": "consensus_tpu/engines/hotstuff.py:351 "
                                  "hotstuff_round votes §9b branch"}


def switch_config(key: str, **kw):
    """Phase 21's run ``key`` ("<flagship>/<setting>"), changed by
    ``kw``."""
    name, setting = key.split("/")
    return SWITCH_FLAGSHIPS[name](**{**SWITCH_SETTINGS[setting], **kw})


def switch_instance(name: str, args) -> bool:
    """Whether this call of wrapper ``name`` runs a SWITCH instance: its
    last positional argument is KAL's tables (KB: the pair of its phase-0
    uplinks and table)."""
    from consensus_tpu_torch.ops.aggregate import AggTables
    last = args[-1]
    if name == "delivery_edges":
        return len(args) == 11 and last is not None
    return isinstance(last, AggTables)


# The switch knobs at their flat defaults.
SWITCH_OFF = dict(net_model="flat", n_aggregators=0, agg_fail_rate=0.0,
                  agg_stale_rate=0.0, agg_max_stale=1, agg_byz=0,
                  agg_poison_rate=0.0, byz_uplink_rate=0.0)


def switch_flat(name: str, args):
    """``args`` of SWITCH-instance call ``name`` with the switch turned
    off: KAL's tables dropped and, where the wrapper takes a Config, its
    switch knobs at their defaults (the same inputs through the flat
    instance)."""
    flat = args[:-1]
    if name == "delivery_edges":
        return flat
    return (dataclasses.replace(flat[0], **SWITCH_OFF), *flat[1:])


def switch_bound(name: str, args) -> tuple[float, str]:
    """The least time of a SWITCH instance's work on ``args``: its flat
    instance's bytes on the same inputs, less the response bytes the switch
    does not read (KM's granted pairs), plus KAL's tables read once, and
    the operations of :func:`switch_ops`; KAL's own: its [B, K] words and
    rounds and [B, phases, N] uplinks written, the flags read, and the
    draws of :func:`agg_round_ops`."""
    if name == "agg_round":
        cfg, seed = args[0], args[1]
        b, n, k = seed.shape[0], cfg.n_nodes, cfg.n_aggregators
        from consensus_tpu_torch.ops.aggregate import n_phases
        p = n_phases(cfg)
        flags = args[3] if len(args) > 3 else None
        nbytes = 8 * b * k + b * p * n + (0 if flags is None else b * n)
        return bound(nbytes, agg_round_ops(cfg, seed, args[2], flags))
    flat = switch_flat(name, args)
    nbytes, ops = flat_work(name, flat)
    last = args[-1]
    tabs = last if name == "delivery_edges" else (last.tab, last.up)
    if name == "dense_elect":
        nbytes -= dense_granted(flat)
    return bound(nbytes + sum(t.nbytes for t in tabs),
                 switch_ops(name, args, ops))


def dense_granted(args) -> int:
    """The (voter, candidate) grants of KM's flat instance on ``args``,
    each a response byte it reads off the mask (:func:`dense_bound`)."""
    from consensus_tpu_torch.engines import raft
    term = args[4]
    got = raft.dense_elect_plain(*clone_args(args))
    idx = torch.arange(term.shape[1], device=term.device)
    return int(((got[2] >= 0) & (got[2] != idx) & got[5]).sum())


def switch_ops(name: str, args, flat_ops: float) -> float:
    """32-bit operations of SWITCH instance ``name`` on ``args``: its flat
    instance's, with the response draws that the two-hop replaces taken
    out (all of KB's; KAE's vote draw a node at or below V*; KM, KY and KZ
    read their flat responses off a mask and draw none), and the downlinks
    of :func:`downlink_ops` added, to KB's candidates, KM's candidates,
    KY's proposers, KZ's proposers that proceed (a majority of promises)
    and KAE's leader, with KAE's §9b lie draws, one a byzantine node."""
    from consensus_tpu_torch.engines import hotstuff, paxos
    last = args[-1]
    if name == "delivery_edges":
        seed, r, ids, n, drop, part, _, delay, flags, attack = args[:10]
        up, tab = last
        dst = ids.to(torch.int64)
        if flags is not None:
            from consensus_tpu_torch.ops.adversary import CRASH_DOWN
            down = ((flags & CRASH_DOWN) != 0).gather(1, dst.clamp(0, n - 1))
            dst = torch.where(down, -1, dst)
        if attack is not None:
            word, hit = attack
            cut = (word != 0)[:, None] & ((dst == hit) if hit >= 0 else True)
            dst = torch.where(cut, -1, dst)
        return downlink_ops(seed, r, tab, n, 0, dst, drop, part, delay)
    cfg, seed, r = args[0], args[1], args[2]
    n, b = cfg.n_nodes, seed.shape[0]
    ids = torch.arange(n, device=seed.device)[None, :].expand(b, n)

    def down(phase, dst):
        return downlink_ops(seed, r, last.tab, n, phase, dst,
                            cfg.drop_cutoff, cfg.partition_cutoff,
                            cfg.max_delay_rounds)

    if name == "dense_elect":
        role, timer, timeout = args[5], args[7], args[8]
        cand = (role == 1) | ((role != 2) & (timer >= timeout))
        return flat_ops + down(0, torch.where(cand, ids, -1))
    if name in ("paxos_promise", "paxos_accept_learn"):
        is_prop = paxos.proposals(cfg, seed, r, n, n)[0]
        if name == "paxos_promise":
            return flat_ops + down(0, torch.where(is_prop, ids, -1))
        proceed = is_prop & (args[6] >= n // 2 + 1)
        return flat_ops + down(1, torch.where(proceed, ids, -1))
    view1, lane = args[3], args[4]
    vmax = lane[:, hotstuff.VMAX][:, None]
    eligible = int((view1 <= vmax).sum())
    leader = torch.where(vmax >= 0, vmax % n, 0)
    lies = b * cfg.n_byzantine if cfg.uplink_lies_on else 0
    return (flat_ops - EDGE_OPS * eligible + THREEFRY_OPS * lies
            + down(0, leader))


def downlink_ops(seed, r: int, tab, n: int, phase: int, dst, drop: int,
                 part: int, delay: int) -> float:
    """32-bit operations of the downlinks a SWITCH instance needs at round
    r: the §2 draw of each live aggregator (KAL's words ``tab``) to each
    receiver of ``dst`` ([B, R] ids, negative: none) with the §A.2
    retransmissions its drop needs (:func:`loop_draws`), and, with
    partitions, each lane's activity and the receivers' sides where it is
    active (an aggregator's side is in its word)."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.ops import aggregate
    k = tab.shape[1]
    alive = (tab & aggregate.AGG_ALIVE) != 0                  # [B, K]
    recv = dst >= 0                                           # [B, R]
    need = alive[:, :, None] & recv[:, None, :]
    g = n + phase * k + torch.arange(k, device=seed.device)[None, :, None]
    draws = int(need.sum()) + loop_draws(
        rng.as_u32(seed)[:, None, None], r, rng.as_u32(g),
        rng.as_u32(dst.clamp(min=0))[:, None, :], need, drop, delay)
    sides = 0
    if part:
        active = rng.random_u32_plain(seed, rng.STREAM_PARTITION, r, 0,
                                      0) < part                 # [B]
        sides = seed.shape[0] + int((active & recv).sum())
    return EDGE_OPS * draws + THREEFRY_OPS * sides


def loop_draws_at(useed, q, i, j, need, drop: int, delay: int) -> int:
    """:func:`loop_draws` at per-edge rounds ``q`` (a tensor that
    broadcasts with ``need``): each edge's loop stops at round 0."""
    from consensus_tpu_torch.core import rng
    alive = need & (rng.delivery_u32_plain(useed, q, i, j) < drop)
    draws = 0
    for d in range(1, delay + 1):
        alive = alive & (q >= d)
        qd = (q - d).clamp(min=0)
        draws += int(alive.sum())
        lost = alive & (rng.delivery_u32_plain(useed, qd, i, j) < drop)
        draws += int(lost.sum())
        alive = alive & ~(lost & (rng.delay_u32_plain(useed, qd, d, i, j)
                                  >= drop))
    return draws


def agg_round_ops(cfg, seed, r: int, flags=None, n_real=None) -> float:
    """32-bit operations of the draws KAL's function needs on these inputs:
    per (lane, aggregator) its fail draw, its stale draw and, where that
    fires, its depth, its poison draw of each poisonable phase (the last
    agg_byz ones), its side at r, and, with partitions, the partition's
    activity at its round q and the side of N + a there where that is
    active; per (lane, uplink row, node up at the round's end) the
    uplink's mixer draw (the phase's vertex, or the §6b key (i, i)) with
    the §A.2 retransmissions its drop needs (:func:`loop_draws_at`); per
    (lane, node) its own side at q where the partition is active then and
    an uplink is open. A node's aggregator state is drawn once an
    aggregator, not once a member. ``n_real`` (PBFT) is each lane's vertex
    base and segmentation."""
    from consensus_tpu_torch.core import rng
    from consensus_tpu_torch.ops import aggregate
    from consensus_tpu_torch.ops.adversary import CRASH_DOWN
    k, n = cfg.n_aggregators, cfg.n_nodes
    b, dev = seed.shape[0], seed.device
    ua = torch.arange(k, dtype=torch.int64, device=dev)
    st = aggregate.agg_draws_plain(cfg, seed, r)
    threefry = b * k * (cfg.agg_fail_on + cfg.agg_stale_on)
    if cfg.agg_stale_on:
        threefry += int((rng.random_u32_plain(seed, rng.STREAM_AGG, r, 1, ua)
                         < cfg.agg_stale_cutoff).sum())
    if cfg.agg_poison_on:
        threefry += b * aggregate.poison_phases(cfg) * cfg.agg_byz
    sids = aggregate.lane_ids(n, k, n_real, dev)
    base = aggregate.vertex_base(cfg, seed, n_real)           # [B, 1]
    q = aggregate.take_seg_plain(st.q, sids, k)               # [B, N]
    need = torch.ones((b, n), dtype=torch.bool, device=dev)
    if flags is not None:
        need = (flags & CRASH_DOWN) == 0
    useed = rng.as_u32(seed)[:, None]
    ui = torch.arange(n, dtype=torch.int64, device=dev)
    mixer = 0
    opened = torch.zeros_like(need)
    for ph in range(aggregate.n_phases(cfg)):
        dst = ui if aggregate.bcast_uplink(cfg) else base + ph * k + sids
        mixer += int(need.sum()) + loop_draws_at(
            useed, q, ui, dst, need, cfg.drop_cutoff, cfg.max_delay_rounds)
        opened |= need & aggregate._open_edge_plain(cfg, seed, q, ui, dst)
    if cfg.partition_cutoff:
        active = rng.random_u32_plain(seed, rng.STREAM_PARTITION, st.q, 0,
                                      0) < cfg.partition_cutoff  # [B, K]
        threefry += 2 * b * k + int(active.sum()) \
            + int((opened & aggregate.take_seg_plain(active, sids,
                                                     k)).sum())
    return THREEFRY_OPS * threefry + EDGE_OPS * mixer


def switch_built_cases(dev) -> list:
    """Small runs whose round 20 holds the rare switch states: K = 1 on
    the capped engine under the composed adversary, K = N on the dense
    engine (N = 9), an empty trailing aggregator (Paxos, N = 9, K = 6:
    segments of 2), every aggregator stale at depth agg_max_stale (stale
    rate 1, depth 1), every aggregator poisoned and dead (fail and poison
    rates 1, agg_byz = K), and lying byzantine nodes that are down (uplink
    lies at rate 1, crash 0.6). The plain versions' results are required
    to show each case."""
    from consensus_tpu_torch.core.config import Config
    hs = dict(protocol="hotstuff", f=33, n_nodes=100, n_rounds=24,
              n_sweeps=3, log_capacity=32, seed=3, drop_rate=0.05,
              telemetry_window=WINDOW, net_model="switch")
    return [
        ("K = 1", Config(protocol="raft", n_nodes=1000, max_active=8,
                         n_rounds=24, n_sweeps=4, log_capacity=32,
                         max_entries=24, seed=11, net_model="switch",
                         n_aggregators=1, agg_fail_rate=0.2,
                         agg_stale_rate=0.5, agg_max_stale=4,
                         telemetry_window=WINDOW, **SWITCH_COMPOSED)),
        ("K = N", Config(protocol="raft", n_nodes=9, n_rounds=24,
                         n_sweeps=4, log_capacity=32, max_entries=24,
                         seed=5, net_model="switch", n_aggregators=9,
                         agg_fail_rate=0.2, agg_stale_rate=0.3,
                         agg_max_stale=3, telemetry_window=WINDOW,
                         **SWITCH_COMPOSED)),
        ("an empty trailing aggregator",
         Config(protocol="paxos", n_nodes=9, n_rounds=24, n_sweeps=4,
                log_capacity=12, seed=4, net_model="switch",
                n_aggregators=6, agg_fail_rate=0.1, agg_stale_rate=0.3,
                agg_max_stale=2, telemetry_window=WINDOW,
                **SWITCH_COMPOSED)),
        ("every aggregator stale at depth agg_max_stale",
         Config(**hs, n_aggregators=5, agg_stale_rate=1.0)),
        ("poisoned aggregators that are dead",
         Config(**hs, n_aggregators=4, agg_fail_rate=1.0, agg_byz=4,
                agg_poison_rate=1.0, n_byzantine=33,
                byz_mode="equivocate")),
        ("lying byzantine nodes that are down",
         Config(**hs, n_aggregators=6, n_byzantine=33, byz_uplink_rate=1.0,
                crash_prob=0.6, recover_prob=0.3))]


def check_built_case(what: str, cfg, calls) -> None:
    """The case a built run's round 20 must show, read off KAL's plain
    version on the recorded call."""
    from consensus_tpu_torch.ops import aggregate
    from consensus_tpu_torch.ops.adversary import CRASH_DOWN
    args = calls["agg_round"][0]
    tabs = aggregate.agg_round_plain(*clone_args(args))
    r = args[2]
    if what == "every aggregator stale at depth agg_max_stale":
        require(bool((tabs.q == r - cfg.agg_max_stale).all()),
                f"built {what}: q {tabs.q.tolist()} at round {r}")
    elif what == "poisoned aggregators that are dead":
        require(bool((tabs.tab == aggregate.AGG_POISON0).all()),
                f"built {what}: words {tabs.tab.tolist()}")
    elif what == "lying byzantine nodes that are down":
        seed, flags = args[1], args[3]
        byz = torch.arange(cfg.n_nodes, device=seed.device) >= cfg.n_honest
        lie, _ = aggregate.uplink_lies_plain(cfg, seed, r, byz)
        down = (flags & CRASH_DOWN) != 0
        require(bool((lie & down).any()),
                f"built {what}: no lying byzantine node is down")
    elif what == "an empty trailing aggregator":
        require(aggregate.n_segments(cfg.n_nodes, cfg.n_aggregators)
                * (cfg.n_aggregators - 1) >= cfg.n_nodes,
                f"built {what}: the last aggregator has members")


def check_switch_kernels(dev):
    """Phase 21's kernel rows. Every kernel call of rounds 3 and 20 of each
    run SWITCH_RUNS (with telemetry) and of round 20 of each built run
    (:func:`switch_built_cases`) against the plain versions, exact. Then
    KAL's and each SWITCH instance's time on round 20 of its SWITCH_TIMED
    run (the largest of its instance's calls there), its plain version's
    and its bound, and the flat instance's time and bound on the same
    inputs. Yields KAL's row (with the phase-3 keys) and one row an
    instance."""
    wrappers = sorted({name for name, _ in SWITCH_TIMED.values()})
    errs = dict.fromkeys(wrappers, 0.0)
    cases = dict.fromkeys(wrappers, 0)
    base: dict = {}
    for key in SWITCH_RUNS:
        cfg = switch_config(key)
        last = SWITCH_LAST.get(key.split("/")[0], SWITCH_ROUNDS[-1])
        for r in (*SWITCH_ROUNDS[:-1], last):
            calls = capture_round_calls(cfg, r, True, dev)
            hold_calls(calls, f"{key} round {r}", errs, cases)
            if r == last:
                base[key] = calls
    for what, cfg in switch_built_cases(dev):
        calls = capture_round_calls(cfg, 20, True, dev)
        check_built_case(what, cfg, calls)
        hold_calls(calls, f"built: {what}", errs, cases)
    for row, (name, run) in SWITCH_TIMED.items():
        mine = [a for a in base[run][name]
                if name == "agg_round" or switch_instance(name, a)]
        require(bool(mine), f"{run}: no SWITCH-instance call of {name}")
        args = max(mine, key=lambda a: sum(t.numel() for t in tensors_of(a)))
        mod = kernel_module(name)
        reps = reps_for(args)
        out = dict(name=row, route="cuda",
                   source=f"consensus_tpu_torch/csrc/{name}.cu",
                   replaces=SWITCH_REPLACES[row], max_abs_err=errs[name],
                   cases=cases[name], timed_on=f"{run} round "
                   f"{SWITCH_LAST.get(run.split('/')[0], 20)}",
                   ms=graph_ms(getattr(mod, name), args, reps),
                   plain_ms=event_ms(getattr(mod, name + "_plain"), args,
                                     min(3, reps)),
                   bound=switch_bound(name, args), library_ms=None,
                   launches_from=run)
        if name != "agg_round":
            flat = switch_flat(name, args)
            out["flat_instance_ms"] = graph_ms(getattr(mod, name), flat,
                                               reps)
            out["flat_instance_bound"] = bound(*flat_work(name, flat))
        yield out


def switch_path(cfg) -> tuple[str, ...]:
    """The kernels a telemetry run of ``cfg`` launches: its engine's
    telemetry path, KAL, KAH with a crash, KAJ where HotStuff's round is
    gated."""
    from consensus_tpu_torch.engines import hotstuff
    path = gate_path(cfg) + SWITCH_OWN
    if cfg.protocol == "hotstuff" and hotstuff.gated(cfg):
        path += ("hotstuff_prologue",)
    return path


def availability(windows) -> float:
    """The scenario's availability (consensus_tpu/obs/timeline.py:199-202,
    mean over sweeps): the share of windows with commit progress."""
    stall = np.asarray(windows) == 0
    return float((1.0 - stall.mean(axis=1)).mean())


def check_switch_runs(card: str, smi: str) -> tuple[dict, dict]:
    """Phase 21's runs: ``simulator.run`` of each run SWITCH_RUNS with
    telemetry, replayed as one CUDA graph and counted from 0 (the SWITCH
    instances apart): its digest, counter totals and flight recorder
    against the JAX anchors, from the replay and from the eager loop, the
    oracle's digest where it was run, its path's kernels launched and no
    other, the SWITCH instances launched; node-round-steps per second, the
    replay's wall, busy share and device operations a round (one profiled
    replay). The fork scenario's runs
    must count each of FORK_MIN and keep its availability. Returns KAL's
    and each SWITCH instance's launches, each from its SWITCH_TIMED
    run."""
    from consensus_tpu_torch.network import runner, simulator
    own: dict = {}
    for key, (digest, nonzero, flight, oracle) in SWITCH_RUNS.items():
        cfg = switch_config(key)
        eng = runner.engine(cfg)
        for mod, name in runner.SWITCH_KERNELS:
            getattr(mod, name).switch_launches = 0
        res, launches = counted(lambda: simulator.run(cfg, telemetry=True))
        inst = runner.switch_launch_counts()
        tel, fl = res.extras["telemetry"], res.extras["flight"]
        stats: dict = {}
        eager = runner.run(cfg, graph=False, telemetry=True, stats=stats)
        eager_sha = eager_digest(cfg, res, eager)
        fork = key.startswith("fork/")
        prof = profile_replay(cfg, telemetry=True)
        want = {k: nonzero.get(k, 0) for k in eng.telemetry_names}
        row = dict(
            digest=res.digest, digest_ok=res.digest == digest,
            eager_digest=eager_sha, oracle_digest=oracle,
            totals=tel["totals"], totals_ok=tel["totals"] == want,
            flight_sha256=flight_digest(fl),
            flight_ok=flight_digest(fl) == flight,
            eager_equal=flight_digest(stats["flight"]) == flight_digest(fl)
            and all(np.array_equal(stats["telemetry"][k], v)
                    for k, v in tel["per_sweep"].items()),
            steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
            launches=launches, switch_instance_launches=inst,
            **{k: prof[k] for k in (
                "replay_wall_ms", "busy_share", "unprofiled_busy_share",
                "device_ms", "device_launches")},
            device_ops_per_round=prof["launches_per_round"],
            hand_kernel_ms={k: v for k, v in prof["hand_kernel_ms"].items()
                            if v})
        if fork:
            row["availability"] = availability(
                fl["windows"]["commits_learned"])
        emit("switch_run", run=key, **row, card=card, power=smi)
        for check in ("digest_ok", "totals_ok", "flight_ok", "eager_equal"):
            require(row[check], f"{key}: {check} fails")
        require(eager_sha == digest,
                f"{key}: the eager loop's digest {eager_sha}")
        require(oracle is None or oracle == digest,
                f"{key}: the oracle's digest {oracle} != {digest}")
        require(tel["totals"]["agg_down_rounds"]
                + tel["totals"]["stale_serves"]
                + tel["totals"]["poisoned_serves"] > 0 or fork,
                f"{key}: the aggregation tail counted nothing")
        if fork:
            for name in FORK_MIN:
                require(tel["totals"][name] >= 1,
                        f"{key}: {name} {tel['totals'][name]} < 1")
            require(row["availability"] >= FORK_AVAILABILITY,
                    f"{key}: availability {row['availability']}")
        require_launched(launches, switch_path(cfg), key)
        on_path = {name for name in inst if launches.get(name)}
        require(all(inst[name] > 0 for name in on_path
                    if name in ("delivery_edges", "dense_elect",
                                "paxos_promise", "paxos_accept_learn",
                                "hotstuff_vote")),
                f"{key}: a SWITCH instance never launched: {inst}")
        for row_name, (name, run) in SWITCH_TIMED.items():
            if run == key:
                own[row_name] = launches[name] if name == "agg_round" \
                    else inst[name]
        runner.clear_graphs()
    return own


# --- phase 22: SPEC §9 switch tallies and §9b on PBFT ------------------------

PBFT_SWITCH_OWN = ("switch_combine", "switch_receive")
PBFT_SWITCH_REPLACES = {
    "switch_combine": "consensus_tpu/ops/aggregate.py:375 value_votes "
                      "(combine :415-435), :472 min_id_votes (:472-486), "
                      ":216-255 seg_sum/seg_max/seg_min, :154 uplink_lies; "
                      "engines/pbft_sweep.py:61 _padded_switch_phases",
    "switch_receive": "consensus_tpu/ops/aggregate.py:326 downlink, :348 "
                      "downlink_self, :375 value_votes (receivers :436-469), "
                      ":472 min_id_votes (:487-504); engines/pbft.py:264-366, "
                      "pbft_bcast.py:553-675"}
# pbft-100k-bcast's §9b run: n_byzantine = f equivocating, two of the K = 8
# aggregators byzantine, forged combines at 5%, lies at 10%. No stance grid
# is drawn under the switch, so all 8 sweeps run (phase 19 cut its
# equivocating run to one).
PBFT_9B = dict(n_byzantine=33_333, byz_mode="equivocate", agg_byz=2,
               agg_poison_rate=0.05, byz_uplink_rate=0.1)
# The base of the JAX package's pbft-cert-poison search space
# (tools/advsearch/search.py:217-221 with its _ADV, :117), at seeds 0-2.
CERT_POISON = dict(protocol="pbft", f=2, n_nodes=7, log_capacity=96,
                   net_model="switch", n_aggregators=2, agg_byz=1,
                   n_byzantine=2, byz_mode="equivocate",
                   agg_poison_rate=0.3, byz_uplink_rate=0.2, drop_rate=0.1,
                   n_rounds=96, telemetry_window=4)
CERT_SEEDS = (0, 1, 2)
PBFT_SWITCH_CONFIGS = {
    "pbft-f128/switch": lambda **kw: pbft_config(
        128, **SWITCH_KNOBS, telemetry_window=WINDOW, **kw),
    "pbft-100k-bcast/switch": lambda **kw: bcast_config(
        **SWITCH_KNOBS, telemetry_window=WINDOW, **kw),
    "pbft-100k-bcast/9b": lambda **kw: bcast_config(
        **SWITCH_KNOBS, **PBFT_9B, telemetry_window=WINDOW, **kw),
    **{f"pbft-cert-poison/{s}": (lambda s: lambda **kw: protocol_config(
        CERT_POISON, seed=s, **kw))(s) for s in CERT_SEEDS}}
# Phase 22's runs, each with telemetry: (digest, the nonzero counter
# totals, flight_digest, the C++ oracle's digest or None where it was not
# run). The JAX package made each on the CPU (sweep_chunk 1 on the 100k
# runs, 1.9-2.1 min each; 4-8 s the others), the oracle the small ones'
# digests (engine="cpu", telemetry off); they agree:
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import simulator
#   for key in chip_smoke.PBFT_SWITCH_RUNS:
#       c = chip_smoke.PBFT_SWITCH_CONFIGS[key]()
#       cfg = Config(**{k: getattr(c, k) for k in c.__dataclass_fields__})
#       res = simulator.run(dataclasses.replace(cfg, sweep_chunk=int(
#           cfg.n_nodes >= 100_000)), warmup=False, telemetry=True)
#       print(key, res.digest, {k: v for k, v in
#             res.extras["telemetry"]["totals"].items() if v},
#             chip_smoke.flight_digest(res.extras["flight"]))
#       print(simulator.run(dataclasses.replace(
#           cfg, engine="cpu", telemetry_window=0), warmup=False).digest)
#   EOF
#
# At the calm flagship knobs pbft-f128 and pbft-100k-bcast decide what
# their flat runs decide (PBFT_DIGESTS[128], BCAST_DIGEST); their counters
# and recorders are the switch's own.
PBFT_SWITCH_RUNS = {
    "pbft-f128/switch": (
        PBFT_DIGESTS[128],
        {"prepare_quorums": 12187, "commit_quorums": 12185,
         "commit_missed": 2, "commits_adopted": 135, "agg_down_rounds": 1,
         "stale_serves": 1},
        "6e58768a665e4c00fa6b8463c51aa7606e2d078546abb6b83f9a7c7d57c3255a",
        PBFT_DIGESTS[128]),
    "pbft-100k-bcast/switch": (
        BCAST_DIGEST,
        {"prepare_quorums": 12800000, "prepare_missed": 7425,
         "commit_quorums": 12785337, "commit_missed": 7240,
         "commits_adopted": 14663, "view_changes": 4000000,
         "agg_down_rounds": 42, "stale_serves": 38},
        "f6db1c4a9c07d4e5a6208d5de161dfe4faae707fd5dbd7aa90a096459cbd3e0e",
        None),
    "pbft-100k-bcast/9b": (
        "6704c6765744b76d2338668418060a95ff225ae2201571074af1c4b7351bb691",
        {"prepare_quorums": 12797011, "prepare_missed": 93439040,
         "commit_quorums": 11776719, "commit_missed": 157061724,
         "commits_adopted": 1023281, "view_changes": 4800000,
         "agg_down_rounds": 42, "stale_serves": 38,
         "poisoned_serves": 109},
        "4c705e629f1a19aac248f70ba1b68b5814b92bd96676bb7b3ad0009d1a0602f0",
        None),
    "pbft-cert-poison/0": (
        "5385a8a1cdce15a79fabac01e93890719ad72a227b825077a98485b0599223bb",
        {"prepare_quorums": 647, "prepare_missed": 491,
         "commit_quorums": 418, "commit_missed": 376,
         "commits_adopted": 254, "poisoned_serves": 56},
        "7db4f26f7f514038c4ca248745a45e706d465ac25631bdfd4e095a27ba7e836a",
        "5385a8a1cdce15a79fabac01e93890719ad72a227b825077a98485b0599223bb"),
    "pbft-cert-poison/1": (
        "b6971c0bf7c228647bb39bf20cd7ebcd3a5e1b14562eeab5254bd285e8d2be51",
        {"prepare_quorums": 655, "prepare_missed": 498,
         "commit_quorums": 426, "commit_missed": 450,
         "commits_adopted": 218, "poisoned_serves": 55},
        "835e532e18bdc7e1f2a7d7a8d7ea0be513a6a5dec430baecdd68068afcd23fcf",
        "b6971c0bf7c228647bb39bf20cd7ebcd3a5e1b14562eeab5254bd285e8d2be51"),
    "pbft-cert-poison/2": (
        "88ec405ca7a1bdbf55bd89e7859201db570a90d9f7a9b53c63233938c453d862",
        {"prepare_quorums": 650, "prepare_missed": 690,
         "commit_quorums": 460, "commit_missed": 480,
         "commits_adopted": 205, "poisoned_serves": 62},
        "5c364e1683b03a02963c9e1cbb089b73c8e6650e330d58e5e45a9d45e9bc6b51",
        "88ec405ca7a1bdbf55bd89e7859201db570a90d9f7a9b53c63233938c453d862"),
}
# The two ladders under the switch, made by the JAX package on the CPU
# (pbft_sweep.pbft_fsweep_run, 39 s and 3 min): the dense fs = 1..128
# ladder at K = 4 (K <= 3 min(fs) + 1) on BASELINE config 3's knobs, and
# the full-width bcast ladder (N_pad = 100 000) at K = 8, whose base
# config is its first rung's (K <= n_nodes). At these calm knobs each
# decides what its flat ladder decides (LADDER_DIGEST, WIDE_DIGEST).
PBFT_SWITCH_LADDERS = {
    "ladder/switch": (lambda: pbft_config(1, **{**SWITCH_KNOBS,
                                                "n_aggregators": 4}),
                      LADDER, LADDER_DIGEST),
    "bcast-ladder/switch": (lambda: wide_base(
        f=WIDE_RUNGS[0], n_nodes=3 * WIDE_RUNGS[0] + 1, **SWITCH_KNOBS),
        WIDE_RUNGS, WIDE_DIGEST)}
PBFT_SWITCH_ROUNDS = (3, 20)
# The run whose round 20 times KAM and KAN and whose run gives their
# launches (the kernels line), and the flat run timed beside it.
PBFT_SWITCH_MAIN = "pbft-100k-bcast/switch"
# The flat kernels a switch round does without.
PBFT_FLAT_ONLY = ("pbft_tally", "pbft_decide", "bcast_tally",
                  "bcast_decide", "bcast_equiv_support")


def pbft_switch_path(cfg, telemetry: bool = True) -> tuple[str, ...]:
    """The kernels a PBFT switch run of ``cfg`` launches: KL and KQ
    (dense) or KT (§6b), KAL, KAM, KAN, with telemetry KAA, and KAH and
    KAI with a crash."""
    dense = cfg.fault_model != "bcast"
    path = (("delivery", "pbft_view_preprepare") if dense
            else ("bcast_view_preprepare",)) + ("agg_round",) \
        + PBFT_SWITCH_OWN + (("pbft_telemetry",) if telemetry else ())
    if cfg.crash_on:
        path += ("crash_transition", "freeze_down")
    return path


def capture_ladder_calls(cfg_pad, rungs, r: int, device="cuda") -> dict:
    """{wrapper: [arguments]}: every kernel call of round ``r`` of the
    ladder ``rungs`` on its padded config's eager run."""
    from consensus_tpu_torch.network import runner
    eng = runner.engine(cfg_pad)
    lanes = runner.device_lanes(cfg_pad, rungs, device)
    seeds = lanes.pop("seed")
    statics = eng.statics(cfg_pad, rungs) if eng.statics else {}
    st = runner.advance(cfg_pad, eng.init(cfg_pad, seeds), 0, r,
                        lanes=lanes, rungs=rungs)
    got: dict = {}
    with recording_everywhere(got):
        eng.round(cfg_pad, st, r, **lanes, **statics)
    return got


def pbft_switch_built_cases() -> list:
    """Small runs whose round 20 holds the rare states of PBFT's switch
    tallies: K = 1 and K = N, an empty trailing aggregator (N = 7, K = 6:
    segments of 2), one liar among honest senders beside an all-liar
    segment (N = 10, K = 4: segment 2 is {6, 7, 8} with byzantine 7 and 8,
    segment 3 is {9}; lies at rate 1), and poisoned own segments (every
    aggregator byzantine, poison rate 1, beside equivocation and §6c)."""
    from consensus_tpu_torch.core.config import Config
    base = dict(protocol="pbft", f=3, n_nodes=10, n_rounds=24, n_sweeps=4,
                log_capacity=8, seed=5, drop_rate=0.1, partition_rate=0.2,
                telemetry_window=WINDOW, net_model="switch",
                agg_fail_rate=0.2, agg_stale_rate=0.3, agg_max_stale=2)
    return [
        ("K = 1", Config(**base, n_aggregators=1)),
        ("K = N", Config(**base, fault_model="bcast", n_aggregators=10)),
        ("an empty trailing aggregator",
         Config(**{**base, "f": 2, "n_nodes": 7}, n_aggregators=6)),
        ("one liar among honest senders, an all-liar segment",
         Config(**base, fault_model="bcast", n_aggregators=4, n_byzantine=3,
                byz_uplink_rate=1.0)),
        ("poisoned own segments",
         Config(**base, n_aggregators=4, agg_byz=4, agg_poison_rate=1.0,
                n_byzantine=3, byz_mode="equivocate", crash_prob=0.2,
                recover_prob=0.3))]


def check_pbft_built_case(what: str, cfg, calls) -> None:
    """The state a built run's round 20 must show, read off KAL's plain
    version on the recorded call."""
    from consensus_tpu_torch.ops import aggregate
    args = calls["agg_round"][0]
    tabs = aggregate.agg_round_plain(*clone_args(args))
    seed, r = args[1], args[2]
    if what.startswith("one liar"):
        byz = torch.arange(cfg.n_nodes, device=seed.device) >= cfg.n_honest
        lie, _ = aggregate.uplink_lies_plain(cfg, seed, r, byz)
        told = lie & tabs.up[:, 0]
        require(bool(told[:, 7:9].any()) and bool(told[:, 9].any()),
                f"built {what}: no delivered lie in segments 2 and 3")
    elif what == "poisoned own segments":
        require(bool(((tabs.tab & aggregate.AGG_POISON0) != 0).all()),
                f"built {what}: words {tabs.tab.tolist()}")
    elif what == "an empty trailing aggregator":
        require(aggregate.n_segments(cfg.n_nodes, cfg.n_aggregators)
                * (cfg.n_aggregators - 1) >= cfg.n_nodes,
                f"built {what}: the last aggregator has members")


def pbft_switch_bound(name: str, args) -> tuple[float, str]:
    """The least time of KAL's PBFT modes, KAM and KAN on ``args``, counting
    what the function needs. KAL: its [B, K] words and rounds and its
    uplink rows written, the flags read, :func:`agg_round_ops`. KAM, a
    vote phase: each honest sender's flag and pp_val (5 bytes a slot) and
    uplink byte, the tables written; the byzantine members' lie, forged
    value and stance draws as these inputs need them. KAM, the decide
    phase: each (aggregator, slot)'s flags up to its least live sender,
    the uplink bytes, the table written. KAN: a vote phase's flag, pp_val,
    base and result (and P5's dval in and out) a (node, slot), the tables
    read; the decide phase's committed, committed at entry, dval in and
    out, a winner's dval a adoption, the timers; the downlinks of
    :func:`downlink_ops` to every receiver and, under equivocation, a
    stance draw a byzantine receiver."""
    from consensus_tpu_torch.ops import aggregate, switch_tally
    if name == "agg_round":
        cfg, seed, r = args[0], args[1], args[2]
        flags, n_real = args[3], args[7]
        b, n, k = seed.shape[0], cfg.n_nodes, cfg.n_aggregators
        nbytes = 8 * b * k + b * aggregate.n_phases(cfg) * n \
            + (0 if flags is None else b * n) + 4 * b
        return bound(nbytes, agg_round_ops(cfg, seed, r, flags, n_real))
    cfg, seed, r, phase, agg, n_real = args[:6]
    b, k = seed.shape[0], cfg.n_aggregators
    nb = cfg.n_byzantine
    if name == "switch_combine":
        flag = args[6]
        n, s = flag.shape[1], flag.shape[2]
        n_hon = int((n_real - nb).sum())
        if phase != switch_tally.DECIDE:
            nbytes = n_hon * s * 5 + b * n + 2 * b * k * s * 4
            byz = switch_tally._byzantine(n_real, nb, n) \
                & agg.up[:, switch_tally.uplink_row(cfg, phase)]
            draws = int(byz.sum()) * (cfg.uplink_lies_on
                                      + (cfg.byz == 2))
            if cfg.uplink_lies_on:
                lie, _ = aggregate.uplink_lies_plain(cfg, seed, r, byz)
                draws += int(lie.sum())
            return bound(nbytes, THREEFRY_OPS * draws)
        (mid,) = switch_tally.switch_combine_plain(*clone_args(args))
        seg = (n_real.to(torch.int64) + k - 1) // k
        lo = torch.arange(k, device=seed.device)[None, :] * seg[:, None]
        hi = torch.minimum(lo + seg[:, None],
                           (n_real.to(torch.int64) - nb)[:, None])
        span = torch.where(mid < n, mid - lo[:, :, None] + 1,
                           (hi - lo).clamp(min=0)[:, :, None])
        return bound(int(span.sum()) + b * n + b * k * s * 4, 0.0)
    table, base = args[7], args[10]
    n, s = base.shape[1], base.shape[2]
    cells = b * n * s
    tables = sum(t.nbytes for t in table) + agg.tab.nbytes
    dst = torch.arange(n, device=seed.device)[None, :].expand(b, n)
    ops = downlink_ops(seed, r, agg.tab, cfg.n_nodes, phase, dst,
                       cfg.drop_cutoff, cfg.partition_cutoff,
                       cfg.max_delay_rounds)
    if phase == switch_tally.DECIDE:
        got = switch_tally.switch_receive_plain(*clone_args(args))
        adopted = int((got[0] & ~base).sum())
        nbytes = cells * 11 + 4 * adopted + b * n * 9 + tables
        return bound(nbytes, ops)
    if cfg.byz == 2:
        ops += THREEFRY_OPS * b * nb
    dval = args[11]
    nbytes = cells * (7 + (8 if dval is not None else 0)) + tables
    return bound(nbytes, ops)


def flat_tally_calls(cfg, calls) -> dict:
    """The flat round's P4-P7 kernels on a recorded switch round's own
    inputs: KR and KS on KL's mask and KQ's outputs (dense), KU and KV on
    KT's node bits and outputs (§6b), each wrapper's arguments by name."""
    from consensus_tpu_torch.engines import pbft, pbft_bcast
    from consensus_tpu_torch.ops import adversary
    _, _, _, _, _, _, _, _, _, _, _, dval, *_ = calls["switch_receive"][1]
    if cfg.fault_model == "bcast":
        kt = clone_args(calls["bcast_view_preprepare"][0])
        n_real, f, prepared, committed = kt[3], kt[4], kt[10], kt[11]
        _, timer, reset, pp_seen, _, pp_val, bits, *_ = \
            pbft_bcast.bcast_view_preprepare(*kt)
        ku = (pbft_bcast.table_cap(cfg), n_real, f, bits, pp_seen, pp_val,
              prepared, committed, dval)
        _, tallied, dval2 = pbft_bcast.bcast_tally(*clone_args(ku))
        return {"bcast_tally": ku, "bcast_decide": (
            bits, tallied, dval2, committed, timer, reset)}
    deliver = adversary.delivery(*clone_args(calls["delivery"][0]))
    kq = clone_args(calls["pbft_view_preprepare"][0])
    n_real, f, prepared, committed = kq[4], kq[5], kq[11], kq[12]
    _, timer, reset, pp_seen, _, pp_val, *_ = pbft.pbft_view_preprepare(*kq)
    kr = (deliver, n_real, f, pp_seen, pp_val, prepared, committed, dval)
    _, tallied, dval2 = pbft.pbft_tally(*clone_args(kr))
    return {"pbft_tally": kr, "pbft_decide": (
        deliver, n_real, tallied, dval2, committed, timer, reset)}


def check_pbft_switch_kernels(dev):
    """Phase 22's kernel rows. Every kernel call of rounds 3 and 20 of
    pbft-f128/switch, pbft-100k-bcast/switch and its §9b run (with
    telemetry), of both ladders' rounds 3 and 20, and of round 20 of each
    built run (:func:`pbft_switch_built_cases`) against the plain versions,
    exact; none of PBFT_FLAT_ONLY is called. Then, on round 20 of
    PBFT_SWITCH_MAIN and of pbft-f128/switch, KAL's, KAM's and KAN's time
    a call (each phase's call), plain time and bound, and the round's
    switch kernels against the flat round's tallies (KU and KV, KR and KS)
    on the same round's inputs (:func:`flat_tally_calls`). Yields one row
    a kernel, the phase-3 keys and each phase's numbers."""
    from consensus_tpu_torch import _build
    from consensus_tpu_torch.engines import pbft_sweep
    names = ("agg_round",) + PBFT_SWITCH_OWN
    errs = dict.fromkeys(names, 0.0)
    cases = dict.fromkeys(names, 0)
    base: dict = {}

    def hold(calls, where):
        for flat in PBFT_FLAT_ONLY:
            require(flat not in calls, f"{where}: {flat} called")
        for name in names:
            require(name in calls, f"{where}: no call of {name}")
        hold_calls(calls, where, errs, cases)
    for key in ("pbft-f128/switch", PBFT_SWITCH_MAIN, "pbft-100k-bcast/9b"):
        cfg = PBFT_SWITCH_CONFIGS[key]()
        for r in PBFT_SWITCH_ROUNDS:
            calls = capture_round_calls(cfg, r, True, dev)
            hold(calls, f"{key} round {r}")
            base[key] = calls
    for key, (make, rungs, _) in PBFT_SWITCH_LADDERS.items():
        rungs, cfg_pad = pbft_sweep._fsweep_static(make(), rungs)
        for r in PBFT_SWITCH_ROUNDS:
            hold(capture_ladder_calls(cfg_pad, rungs, r, dev),
                 f"{key} round {r}")
    for what, cfg in pbft_switch_built_cases():
        calls = capture_round_calls(cfg, 20, True, dev)
        check_pbft_built_case(what, cfg, calls)
        hold(calls, f"built: {what}")
    # The flat round's tallies on the switch round's own inputs.
    flat_ms = {}
    for key in ("pbft-f128/switch", PBFT_SWITCH_MAIN):
        flat_ms[key] = {name: graph_ms(getattr(kernel_module(name), name),
                                       args, reps_for(args))
                        for name, args in flat_tally_calls(
                            PBFT_SWITCH_CONFIGS[key](), base[key]).items()}
    rows = {}
    for key in ("pbft-f128/switch", PBFT_SWITCH_MAIN):
        for name in names:
            per_call = []
            for args in base[key][name]:
                mod = kernel_module(name)
                reps = reps_for(args)
                per_call.append(dict(
                    ms=graph_ms(getattr(mod, name), args, reps),
                    plain_ms=event_ms(getattr(mod, name + "_plain"), args,
                                      min(3, reps)),
                    bound=pbft_switch_bound(name, args)))
            rows[(key, name)] = per_call
    for key in ("pbft-f128/switch", PBFT_SWITCH_MAIN):
        switch_round = sum(c["ms"] for name in names
                           for c in rows[(key, name)])
        emit("pbft_switch_round", run=key, round=20,
             switch_kernels_ms=switch_round,
             flat_tallies_ms=sum(flat_ms[key].values()),
             flat_ms=flat_ms[key],
             per_call={name: [dict(c, bound_ms=c["bound"][0],
                                   bound_by=c["bound"][1])
                              for c in rows[(key, name)]]
                       for name in names})
    for name in PBFT_SWITCH_OWN:
        calls = rows[(PBFT_SWITCH_MAIN, name)]
        mean = lambda k: sum(c[k] for c in calls) / len(calls)  # noqa: E731
        bounds = [c["bound"] for c in calls]
        yield dict(name=name, route="cuda",
                   source=f"consensus_tpu_torch/csrc/{name}.cu",
                   replaces=PBFT_SWITCH_REPLACES[name],
                   max_abs_err=errs[name], cases=cases[name],
                   timed_on=f"{PBFT_SWITCH_MAIN} round 20, mean of its "
                            f"{len(calls)} calls (P4, P5, P6)",
                   ms=mean("ms"), plain_ms=mean("plain_ms"),
                   bound=(sum(b[0] for b in bounds) / len(bounds),
                          max(bounds, key=lambda b: b[0])[1]),
                   library_ms=None)
    kal = rows[(PBFT_SWITCH_MAIN, "agg_round")][0]
    yield dict(name="agg_round (pbft modes)", route="cuda",
               source="consensus_tpu_torch/csrc/agg_round.cu",
               replaces=SWITCH_REPLACES["agg_round"]
               + ", :313 uplink_bcast", max_abs_err=errs["agg_round"],
               cases=cases["agg_round"],
               timed_on=f"{PBFT_SWITCH_MAIN} round 20 (§6b uplink); "
                        "pbft-f128/switch's "
                        f"{rows[('pbft-f128/switch', 'agg_round')][0]['ms']}",
               ms=kal["ms"], plain_ms=kal["plain_ms"], bound=kal["bound"],
               library_ms=None)


def check_pbft_switch_runs(card: str, smi: str) -> dict[str, int]:
    """Phase 22's runs: ``simulator.run`` of each run PBFT_SWITCH_RUNS with
    telemetry, replayed as one CUDA graph and counted from 0: its digest,
    counter totals and flight recorder against the JAX anchors, from the
    replay and the eager loop, the oracle's digest where it was run, its
    path's kernels launched and no other (KU, KV, KAK, KR, KS not), KAM
    and KAN launched; no PBFT fork. The 100 000-node runs also profile a
    replay (wall, busy share, device ms by kernel). Then both ladders
    (:func:`anchored_ladder`'s checks, KAM and KAN launched). Returns KAM's
    and KAN's launches on PBFT_SWITCH_MAIN."""
    from consensus_tpu_torch.core import serialize
    from consensus_tpu_torch.engines import pbft_sweep
    from consensus_tpu_torch.network import runner, simulator
    own: dict = {}
    for key, (digest, nonzero, flight, oracle) in PBFT_SWITCH_RUNS.items():
        cfg = PBFT_SWITCH_CONFIGS[key]()
        eng = runner.engine(cfg)
        res, launches = counted(lambda: simulator.run(cfg, telemetry=True))
        tel, fl = res.extras["telemetry"], res.extras["flight"]
        stats: dict = {}
        eager = runner.run(cfg, graph=False, telemetry=True, stats=stats)
        eager_sha = eager_digest(cfg, res, eager)
        want = {k: nonzero.get(k, 0) for k in eng.telemetry_names}
        row = dict(
            digest=res.digest, digest_ok=res.digest == digest,
            eager_digest=eager_sha, oracle_digest=oracle,
            totals=tel["totals"], totals_ok=tel["totals"] == want,
            flight_sha256=flight_digest(fl),
            flight_ok=flight_digest(fl) == flight,
            eager_equal=flight_digest(stats["flight"]) == flight_digest(fl)
            and all(np.array_equal(stats["telemetry"][k], v)
                    for k, v in tel["per_sweep"].items()),
            steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
            launches=launches)
        if cfg.n_nodes >= 100_000:
            prof = profile_replay(cfg, telemetry=True)
            row.update({k: prof[k] for k in (
                "replay_wall_ms", "busy_share", "unprofiled_busy_share",
                "device_ms", "device_launches")},
                device_ops_per_round=prof["launches_per_round"],
                hand_kernel_ms={k: v for k, v in
                                prof["hand_kernel_ms"].items() if v})
        emit("pbft_switch_run", run=key, **row, card=card, power=smi)
        for check in ("digest_ok", "totals_ok", "flight_ok", "eager_equal"):
            require(row[check], f"{key}: {check} fails")
        require(eager_sha == digest,
                f"{key}: the eager loop's digest {eager_sha}")
        require(oracle is None or oracle == digest,
                f"{key}: the oracle's digest {oracle} != {digest}")
        for name in ("forked_qc", "conflict_commits", "safety_violations"):
            require(tel["totals"][name] == 0, f"{key}: {name} counted")
        require_launched(launches, pbft_switch_path(cfg), key)
        if key == PBFT_SWITCH_MAIN:
            own = {name: launches[name] for name in PBFT_SWITCH_OWN}
        runner.clear_graphs()
    for key, (make, rungs, digest) in PBFT_SWITCH_LADDERS.items():
        base = make()
        memory, launches = counted(lambda: memory_use(
            lambda: pbft_sweep.pbft_fsweep_timed(base, rungs, repeats=3)))
        out, first_s, best, real_steps = memory.pop("result")
        got = serialize.digest(pbft_sweep.fsweep_payload(out))
        eager = serialize.digest(pbft_sweep.fsweep_payload(
            pbft_sweep.pbft_fsweep_run(base, rungs, graph=False)))
        cfg_pad = pbft_sweep._fsweep_static(base, rungs)[1]
        emit("pbft_switch_ladder", run=key, digest=got,
             digest_ok=got == digest, eager_digest=eager,
             real_steps=real_steps, wall_s=best,
             real_steps_per_sec=real_steps / best, first_run_s=first_s,
             launches=launches, **memory, card=card, power=smi)
        require(got == digest and eager == digest,
                f"{key}: digests {got} (replay), {eager} (eager) != "
                f"{digest}")
        require_launched(launches, pbft_switch_path(cfg_pad, False), key)
        runner.clear_graphs()
    return own


# The script's start, for each line's elapsed time (emit).
T0 = time.perf_counter()


# --- phase 23: the knob batch (K23) on HotStuff and §6b PBFT ----------------

# The wrappers with KNOBS instances (no new source: a knob batch's lanes read
# their cutoffs from the view's table, core/knobs.py).
KNOB_INSTANCES = ("hotstuff_prologue", "hotstuff_propose", "hotstuff_vote",
                  "agg_round", "crash_transition", "bcast_view_preprepare")
KNOB_REPLACES = {
    "hotstuff_prologue (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/hotstuff.py:207 prologue under a KnobView",
    "hotstuff_propose (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/hotstuff.py:232 P0-P2 under a KnobView",
    "hotstuff_vote (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/hotstuff.py:300 P2-P4 under a KnobView",
    "hotstuff_vote (knobs, switch)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/hotstuff.py:340 votes §9 branch under a "
    "KnobView",
    "agg_round (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; ops/aggregate.py:93 agg_round under a KnobView",
    "crash_transition (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; ops/adversary.py:101 crash_transition under a "
    "KnobView",
    "bcast_view_preprepare (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/pbft_bcast.py:360 under a KnobView"}
# The row of each KNOBS instance: its wrapper, whether it is KAE's SWITCH
# instance, and the run whose round-20 call is timed and whose run counts
# its launches.
KNOB_TIMED = {
    "hotstuff_prologue (knobs)": ("hotstuff_prologue", False,
                                  "hotstuff-100k/knobs"),
    "hotstuff_propose (knobs)": ("hotstuff_propose", False,
                                 "hotstuff-100k/knobs"),
    "hotstuff_vote (knobs)": ("hotstuff_vote", False, "hotstuff-100k/knobs"),
    "hotstuff_vote (knobs, switch)": ("hotstuff_vote", True,
                                      "hotstuff-forked-qc-1k"),
    "agg_round (knobs)": ("agg_round", True, "hotstuff-forked-qc-1k"),
    "crash_transition (knobs)": ("crash_transition", False,
                                 "pbft-100k-bcast/knobs"),
    "bcast_view_preprepare (knobs)": ("bcast_view_preprepare", False,
                                      "pbft-100k-bcast/knobs")}
KNOB_ROUNDS = (3, 20)
# The bases of tools/advsearch/search.py's spaces hotstuff-forked-qc-1k and
# pbft-quorum-1k (lines 262-297, with _ADV: window 4, 96 rounds, seed 0), at
# the CLI's default population of 16 (tools/advsearch/__main__.py:318), and
# the knobs each space searches, in its order.
KNOB_POPULATION = 16
KNOB_SPACES = {
    "hotstuff-forked-qc-1k": (dict(
        protocol="hotstuff", f=341, n_nodes=1024, log_capacity=96,
        view_timeout=4, net_model="switch", n_aggregators=16, agg_byz=1,
        n_byzantine=341, byz_mode="equivocate", agg_poison_rate=0.3,
        byz_uplink_rate=0.2, drop_rate=0.1, telemetry_window=4, n_rounds=96,
        seed=0), ("agg_poison_rate", "byz_uplink_rate", "drop_rate")),
    "pbft-quorum-1k": (dict(
        protocol="pbft", f=341, n_nodes=1024, fault_model="bcast",
        log_capacity=96, drop_rate=0.3, partition_rate=0.1, churn_rate=0.02,
        crash_prob=0.1, recover_prob=0.3, max_crashed=64, max_delay_rounds=2,
        telemetry_window=4, n_rounds=96, seed=0),
        ("drop_rate", "partition_rate", "churn_rate", "crash_prob",
         "recover_prob")),
}
KNOB_SEARCH_SEED = 11
# Two lanes of each generation also run as production runs of their own
# configs.
KNOB_PRODUCTION_LANES = (0, 9)
# The two knob batches at full width: hotstuff-100k with partitions and the
# §B desync on (drop and churn are its own), and pbft-100k-bcast under phase
# 16's capped crash (CHURN_PARTITION), each with 8-round windows and 8
# lanes, each lane a row of its own: lane 0 the base's, lane 1 the base with
# the partition (a gated-on knob) zeroed.
KNOB_BATCHES = {
    "hotstuff-100k/knobs": (
        dict(HOTSTUFF_FLAGSHIP, partition_rate=0.05, desync_rate=0.1,
             max_skew_rounds=4, telemetry_window=WINDOW),
        ({}, dict(partition_rate=0.0), dict(drop_rate=0.05),
         dict(drop_rate=0.2, churn_rate=0.01),
         dict(partition_rate=0.3, desync_rate=0.3),
         dict(desync_rate=0.02, churn_rate=0.0),
         dict(drop_rate=0.35, partition_rate=0.15, desync_rate=0.2),
         dict(churn_rate=0.05, desync_rate=0.45))),
    "pbft-100k-bcast/knobs": (
        dict(BCAST_FLAGSHIP, **CHURN_PARTITION, telemetry_window=WINDOW),
        ({}, dict(partition_rate=0.0), dict(crash_prob=0.3,
                                            recover_prob=0.1),
         dict(drop_rate=0.2), dict(churn_rate=0.0, crash_prob=0.02),
         dict(partition_rate=0.5, recover_prob=0.9),
         dict(drop_rate=0.01, churn_rate=0.15),
         dict(crash_prob=0.6, recover_prob=0.6, drop_rate=0.1))),
}
KNOB_BATCH_SEEDS = (8, 0xFFFFFFFF, 3, 77, 1 << 31, 12345, 9, 2024)
# The three generations of each space: each lane's seed and knob values, in
# KNOB_SPACES' order, as tools/advsearch's run_search at KNOB_SEARCH_SEED
# gave them (search.eval_seed, search.next_population); and each lane's
# digest (knob_lane_digests) from the JAX package's run_knob_batch; then the
# two knob batches' lane digests, likewise. Made on the CPU by
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, json, numpy as np, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import runner, simulator
#   from tools.advsearch import search
#   gens = {}
#   for name, (base, fields) in chip_smoke.KNOB_SPACES.items():
#       space, got, pops = search.SPACES[name], [], []
#       real_pop, real_dispatch = search.next_population, search._dispatch
#       def pop(*a, **k):
#           pops.append(real_pop(*a, **k))
#           return pops[-1]
#       def dispatch(cfg, eng, seeds, kmat, **k):
#           out, flight = real_dispatch(cfg, eng, seeds, kmat, **k)
#           got.append((seeds.tolist(),
#                       chip_smoke.knob_lane_digests(out, flight)))
#           return out, flight
#       search.next_population, search._dispatch = pop, dispatch
#       search.run_search(space, search_seed=chip_smoke.KNOB_SEARCH_SEED,
#                         generations=3, population=16, confirm=False)
#       search.next_population, search._dispatch = real_pop, real_dispatch
#       gens[name] = [(s, [[p[f] for f in fields] for p in ps], d)
#                     for (s, d), ps in zip(got, pops)]
#   batches = {}
#   for key in chip_smoke.KNOB_BATCHES:
#       base, cfgs, seeds, kmat = chip_smoke.knob_batch(key)
#       jbase = Config(**dataclasses.asdict(base))
#       out, flight = runner.run_knob_batch(
#           jbase, simulator.engine_def(jbase), seeds, kmat)
#       batches[key] = chip_smoke.knob_lane_digests(out, flight)
#   print(json.dumps([gens, batches]))
#   EOF
#
# (the JAX package took 6 s and 109 s for the two spaces' three generations
# and 7 s and 238 s for the two batches, on 8 CPU cores.)
KNOB_GENERATIONS = {
 'hotstuff-forked-qc-1k': [((1679678445, 1534475689, 278192867, 2354117381,
                             3694801633, 2145619974, 4279672098, 3017178572,
                             3508595031, 3622200387, 3816601057, 886418844,
                             3209889851, 2172454415, 658177925, 3890115422),
                            ((0.4729, 0.9241, 0.3965),
                             (0.6478, 0.8193, 0.1525),
                             (0.0767, 0.2644, 0.1134), (0.7987, 0.589, 0.0011),
                             (0.3099, 0.2162, 0.2987),
                             (0.6419, 0.3845, 0.3159),
                             (0.1398, 0.8967, 0.1075),
                             (0.6643, 0.3077, 0.3969),
                             (0.6674, 0.4911, 0.1165),
                             (0.6013, 0.5136, 0.1372),
                             (0.5725, 0.7901, 0.1425),
                             (0.3793, 0.2035, 0.3928), (0.8547, 0.2926, 0.094),
                             (0.1983, 0.4136, 0.076), (0.0577, 0.48, 0.0644),
                             (0.3492, 0.5186, 0.0723)),
                            ('149f48e485a50d5f29d9d969',
                             'cb80b064813619619b55359a',
                             '2ce3f1bfb2ddb67d4fe0c71d',
                             '7830f68bcda9eeac4c02d99b',
                             'db5db62bea5778fbe22e101c',
                             'dccfd2c39c025a8cfbfb6d29',
                             '77c193cbb235894ff54461ba',
                             '9775e6ca1c1df47a9b40563b',
                             'e4cdd2a7617438406e3aeaf5',
                             '03e6d563b3651df368ce5396',
                             'fe23ffc956950f01580ad8b2',
                             'c592a6a7ed3738f63d5b7c95',
                             '5a3a6de7e4af81c1e4bcf83c',
                             'd254e1677d991ef1c3adec37',
                             '992c3640eb0a4a822de7aa9b',
                             'fb2b87ae42b0547389e5275c')),
                           ((1677358738, 640328353, 2651076246, 1109509310,
                             1159399247, 476842274, 2262828114, 622629121,
                             1677510738, 3621436798, 4171883027, 3288336079,
                             3911128341, 24712174, 2819732854, 1186635878),
                            ((0.3099, 0.2162, 0.2987),
                             (0.3793, 0.2035, 0.3928),
                             (0.6419, 0.3845, 0.3159),
                             (0.6643, 0.3077, 0.3969),
                             (0.4729, 0.9241, 0.3965),
                             (0.6478, 0.8193, 0.1525),
                             (0.5725, 0.7901, 0.1425),
                             (0.6643, 0.3077, 0.3988),
                             (0.6546, 0.8523, 0.0686),
                             (0.6419, 0.2748, 0.3159),
                             (0.7589, 0.3077, 0.3969),
                             (0.5776, 0.9241, 0.3965),
                             (0.4729, 0.9241, 0.3207), (0.9433, 0.9126, 0.265),
                             (0.7754, 0.399, 0.1958),
                             (0.1611, 0.4265, 0.3687)),
                            ('66065c244e9b1bd4d54428af',
                             '32ae9f60e2e0a0f9b6f00497',
                             '42f15d02f0e6ee8d2a0c0893',
                             '37350739841857486bc0810b',
                             '37fc868b1190fc32918d34f3',
                             '16439f5bbd6fa8a46820ecf3',
                             '6cabb6063db05d3da1837292',
                             'bfdc3215dd8bcec7b5d43b5b',
                             '4ffcae2a3f749ca217808228',
                             '8d04ea789944f51deb3d4e85',
                             '335cc7a56f7a832d4f834822',
                             '613387e50d6bda519eb6ab01',
                             '7ba6d10206d6fcdd64e8038b',
                             '249dfccfbb5839696c8dee49',
                             'd0e08a204d4854f2face6192',
                             'aff35fb5689537f375371dbe')),
                           ((430660201, 192764186, 599153662, 1963827441,
                             2079243083, 1794281481, 2766141373, 1029018697,
                             2633830214, 4249387551, 3527526455, 183813833,
                             1809896444, 2067659070, 589257308, 701979083),
                            ((0.3099, 0.2162, 0.2987),
                             (0.1611, 0.4265, 0.3687),
                             (0.3793, 0.2035, 0.3928), (0.7754, 0.399, 0.1958),
                             (0.6478, 0.8193, 0.1525),
                             (0.5346, 0.2162, 0.2987),
                             (0.3533, 0.4265, 0.3687),
                             (0.1611, 0.6089, 0.3687),
                             (0.3881, 0.2035, 0.3928), (0.3793, 0.2035, 0.292),
                             (0.5497, 0.2162, 0.2987),
                             (0.4944, 0.8193, 0.1525), (0.5082, 0.399, 0.1958),
                             (0.3793, 0.05, 0.3928), (0.1776, 0.1357, 0.1305),
                             (0.7754, 0.399, 0.1107)),
                            ('77abd0e22df39878d5cd4316',
                             '4a0730ef51704ad4bde81209',
                             '8cffcf37578a5d291288567c',
                             '2c760d4662f996791211cffd',
                             '689f2cb62ff63c6e3a3b1577',
                             'a38a6d72bc146531484ae594',
                             '0380b1957cf07accf89d0d6f',
                             '6cec6e807537433a713e7c02',
                             'a7c913b36a00e346b36f2157',
                             'd0f56cb2fe857adc93eaff7e',
                             '02c1fe3b11039b976fa35615',
                             'f16e0552e3a0426e30fbf27e',
                             '81351572ff34b9c0beeb8a30',
                             'bae09332b66875459b3b2ecf',
                             'ec7de9ca9f022e42df5bbf7f',
                             '9a06e6d120e611a0e396009f'))],
 'pbft-quorum-1k': [((1679678445, 1534475689, 278192867, 2354117381,
                      3694801633, 2145619974, 4279672098, 3017178572,
                      3508595031, 3622200387, 3816601057, 886418844,
                      3209889851, 2172454415, 658177925, 3890115422),
                     ((0.3085, 0.3885, 0.1487, 0.1453, 0.1959),
                      (0.4154, 0.3419, 0.0572, 0.2887, 0.131),
                      (0.0663, 0.0953, 0.0425, 0.1357, 0.2308),
                      (0.5076, 0.2395, 0.0004, 0.0856, 0.4032),
                      (0.2088, 0.0738, 0.112, 0.21, 0.2568),
                      (0.4117, 0.1487, 0.1185, 0.0517, 0.0868),
                      (0.1049, 0.3763, 0.0403, 0.0013, 0.2198),
                      (0.4254, 0.1145, 0.1489, 0.0805, 0.0833),
                      (0.4273, 0.196, 0.0437, 0.0369, 0.1776),
                      (0.3869, 0.206, 0.0515, 0.0213, 0.074),
                      (0.3693, 0.3289, 0.0534, 0.1448, 0.1145),
                      (0.2512, 0.0682, 0.1473, 0.0935, 0.0712),
                      (0.5418, 0.1078, 0.0352, 0.1221, 0.3129),
                      (0.1406, 0.1616, 0.0285, 0.1068, 0.2708),
                      (0.0547, 0.1911, 0.0242, 0.0022, 0.1726),
                      (0.2329, 0.2083, 0.0271, 0.1079, 0.1151)),
                     ('8c42a48e4c471d9e4ec1e37a', '73e2033739f9e9455f79e40e',
                      'a67ffc18a3c437add496d3aa', '274b103b6b75f04c9caa5f6a',
                      '9f0f9550b32a4e4d8eeb3aa3', '2f91b9f39b20b04d9015f2ea',
                      '451242e4222db9d16bc0d4ac', 'b44a1dd93245b8b8a00048f0',
                      '286c1d566da33fa5347bca8f', '58a1271bf88b482f7ed92753',
                      '784b8bd3bff296a57ca87903', 'a34141e934b7c9c4ed3fd375',
                      '3f26e8948d1f3df4b1e97baa', 'c3ab98546e5d6c6b60150436',
                      '84c3362a9f695a0acf024ab1',
                      'e618f29f4b75ba140895e7c3')),
                    ((1677358738, 640328353, 2651076246, 1109509310,
                      1159399247, 476842274, 2262828114, 622629121, 1677510738,
                      3621436798, 4171883027, 3288336079, 3911128341, 24712174,
                      2819732854, 1186635878),
                     ((0.5418, 0.1078, 0.0352, 0.1221, 0.3129),
                      (0.3085, 0.3885, 0.1487, 0.1453, 0.1959),
                      (0.2088, 0.0738, 0.112, 0.21, 0.2568),
                      (0.4117, 0.1487, 0.1185, 0.0517, 0.0868),
                      (0.4154, 0.3419, 0.0572, 0.2887, 0.131),
                      (0.4117, 0.1744, 0.1185, 0.0517, 0.0868),
                      (0.2088, 0.0738, 0.112, 0.21, 0.3009),
                      (0.2088, 0.0738, 0.112, 0.2804, 0.2568),
                      (0.4195, 0.3566, 0.0257, 0.2319, 0.4432),
                      (0.2088, 0.0738, 0.0962, 0.21, 0.2568),
                      (0.2088, 0.0972, 0.112, 0.21, 0.2568),
                      (0.2728, 0.0738, 0.112, 0.21, 0.2568),
                      (0.4117, 0.1487, 0.1185, 0.0827, 0.0868),
                      (0.5959, 0.3834, 0.0994, 0.2195, 0.1942),
                      (0.4933, 0.1551, 0.0734, 0.2728, 0.2205),
                      (0.1179, 0.1673, 0.1383, 0.0305, 0.1384)),
                     ('478254203e9d5e0d82fb69d9', '18ef61c926f008e1f060ce6a',
                      '2824b8b3217fc1ef13641c26', '7353eece78e0f7cc84db9672',
                      'a7721604954b19baa3c86735', '00c55fa4b9a5ac53e8b268b7',
                      'ea6b7bbc9a87958c6772e2ae', 'd64b89becd8997aa5ea22e5f',
                      'dc123f3a7208b4bc2aa02490', 'bd8c19f50d6666a9e1a781c8',
                      'e9b07fcaf8dd19c42d4ba5f1', 'bdaffdea5dccb96df35c4cf1',
                      '2bc54ba7b9b345ecf8fbbe22', '37beb21eadbf789019a58862',
                      '8aa7825a38d3204c56bf8bf9',
                      'ae8a81200564a7e5f2545c47')),
                    ((430660201, 192764186, 599153662, 1963827441, 2079243083,
                      1794281481, 2766141373, 1029018697, 2633830214,
                      4249387551, 3527526455, 183813833, 1809896444,
                      2067659070, 589257308, 701979083),
                     ((0.5959, 0.3834, 0.0994, 0.2195, 0.1942),
                      (0.4933, 0.1551, 0.0734, 0.2728, 0.2205),
                      (0.5418, 0.1078, 0.0352, 0.1221, 0.3129),
                      (0.4154, 0.3419, 0.0572, 0.2887, 0.131),
                      (0.5959, 0.3641, 0.0994, 0.2195, 0.1942),
                      (0.5959, 0.4, 0.0994, 0.2195, 0.1942),
                      (0.4933, 0.1353, 0.0734, 0.2728, 0.2205),
                      (0.4933, 0.1551, 0.1047, 0.2728, 0.2205),
                      (0.5418, 0.1928, 0.0352, 0.1221, 0.3129),
                      (0.5418, 0.1078, 0.0352, 0.1221, 0.2154),
                      (0.6, 0.3834, 0.0994, 0.2195, 0.1942),
                      (0.3216, 0.3419, 0.0572, 0.2887, 0.131),
                      (0.5418, 0.213, 0.0352, 0.1221, 0.3129),
                      (0.5418, 0.0, 0.0352, 0.1221, 0.3129),
                      (0.128, 0.0381, 0.0489, 0.138, 0.4748),
                      (0.4154, 0.3419, 0.0572, 0.2887, 0.2296)),
                     ('883e2296a6656bbd7d1626f9', '75dc8cea2a32baceccc99f11',
                      '327ca75088e3f5b3a4ce5caa', '79e72b9584a1261a7145f627',
                      'dc5648715aaafdfc59e32333', 'aab4297a668683c30800f345',
                      '916805d83dc06dec99ef72e9', '849a4539a4c17589c7693ba9',
                      'e031b9c0a12b2e96c4e1ba16', '3913cee654877cb0d83333ec',
                      '882e3579339208c548d60af9', '526e8fd345dfc0cee9ca85d1',
                      'aab04a1adf84fc5da5aca23b', '108492859737d5ed706d7e5b',
                      '4c609a27fb540406fe751383',
                      '4ca8e3dd4f179b9f8542c4ad'))]}
KNOB_BATCH_ANCHORS = {
    'hotstuff-100k/knobs': (
        '595d66fb1d39570993b90b8e',
        '9ec2aa899251f64bce868996',
        'fbcf3436094021b87f9575f6',
        '08425b570cf6fc39f8bfe370',
        'e5b3fe24892c5bee5d475dff',
        '141dbc028c81ff4b87ab12ab',
        '75703eece627ca6229ca9a99',
        '58b7a7b31e14da010d9aa79b',
    ),
    'pbft-100k-bcast/knobs': (
        '4b486a9dedf2d2fcb9f0bbaa',
        'ef4be30f7b6abdf2fde6eb64',
        '5499cb2b23da5addf395027a',
        '2584d1725dcb8a74ccc76698',
        '34bf4877845bccb90072be5a',
        '2cc031d604d2b9f365181acb',
        '6872a50b697869f4416bb0c9',
        'db4414c9ec65ea7c6ec4e4e9',
    ),
}


def knob_lane_digests(out, flight) -> list[str]:
    """Each lane's digest of a knob batch: the first 24 hex digits of the
    SHA-256 of its extract leaves (by sorted name, each its dtype's name
    and little-endian bytes) and its window and latency series (by name,
    as little-endian int64)."""
    digests = []
    lanes = len(next(iter(out.values())))
    for b in range(lanes):
        h = hashlib.sha256()
        for name in sorted(out):
            a = np.asarray(out[name])[b]
            h.update(name.encode())
            h.update(a.dtype.name.encode())
            h.update(np.ascontiguousarray(
                a, dtype=a.dtype.newbyteorder("<")).tobytes())
        for part in ("windows", "latency"):
            for name, a in flight[part].items():
                h.update(name.encode())
                h.update(np.ascontiguousarray(a[b], dtype="<i8").tobytes())
        digests.append(h.hexdigest()[:24])
    return digests


def differing(got, want) -> list[int]:
    """The lanes whose digests differ."""
    return [b for b, (x, y) in enumerate(zip(got, want)) if x != y]


def knob_rows(cfgs) -> np.ndarray:
    """The [C, 12] u32 knob matrix of the lanes' configs."""
    from consensus_tpu_torch.core import knobs
    return np.array([knobs.base_row(c) for c in cfgs], np.uint32)


def knob_generation(name: str, g: int):
    """Generation ``g`` of space ``name``: (base, the lanes' configs,
    seeds, kmat)."""
    from consensus_tpu_torch.core.config import Config
    base_kw, fields = KNOB_SPACES[name]
    base = Config(**base_kw, n_sweeps=KNOB_POPULATION)
    seeds, values, _ = KNOB_GENERATIONS[name][g]
    cfgs = [dataclasses.replace(base, **dict(zip(fields, v)))
            for v in values]
    return base, cfgs, np.array(seeds, np.uint32), knob_rows(cfgs)


def knob_batch(key: str):
    """The full-width knob batch ``key``: (base, the lanes' configs, seeds,
    kmat)."""
    from consensus_tpu_torch.core.config import Config
    base_kw, lanes = KNOB_BATCHES[key]
    base = Config(**base_kw)
    cfgs = [dataclasses.replace(base, **o) for o in lanes]
    return base, cfgs, np.array(KNOB_BATCH_SEEDS, np.uint32), knob_rows(cfgs)


def knob_run(key: str):
    """A run of phase 23's kernel checks: generation 0 of a space, or a
    full-width batch."""
    if key in KNOB_SPACES:
        return knob_generation(key, 0)
    return knob_batch(key)


def capture_knob_round_calls(base, seeds, kmat, r: int, device="cuda"):
    """{wrapper: [arguments]}: every kernel call of round ``r`` of the knob
    batch (``base``, ``seeds``, ``kmat``) run eagerly on ``device`` with
    telemetry and the recorder, cloned as it arrives."""
    from consensus_tpu_torch.core import knobs
    from consensus_tpu_torch.network import runner
    eng = runner.engine(base)
    lanes = {k: torch.from_numpy(v).to(device)
             for k, v in {**runner.lane_inputs(base), "seed": seeds}.items()}
    table = knobs.lane_table(kmat, device)
    out = runner._rounds(base, {**lanes, "knobs": table}, r, True)
    view = knobs.KnobView(base, table)
    rest = {k: v for k, v in lanes.items() if k != "seed"}
    statics = eng.statics(base, None) if eng.statics else {}
    got: dict = {}
    with recording_everywhere(got):
        eng.round(view, out.state, r, telem=out.telem,
                  flight=(out.win, out.lat), **rest, **statics)
    return got


def knob_instance(name: str, args) -> bool:
    """Whether this call of wrapper ``name`` runs its KNOBS instance: KAH's
    and KL's last argument is the table, KAM's decide phase reads no
    cutoff, the others' Config is a KnobView."""
    from consensus_tpu_torch.core import knobs
    from consensus_tpu_torch.ops import switch_tally
    if name == "crash_transition":
        return len(args) > 10 and args[10] is not None
    if name == "delivery":
        return len(args) > 8 and args[8] is not None
    if name == "switch_combine" and args[3] == switch_tally.DECIDE:
        return False
    return isinstance(args[0], knobs.KnobView)


def knob_flat(name: str, args, cfg):
    """``args`` of a KNOBS-instance call through the flat instance with
    ``cfg``'s cutoffs: for KAH its scalar cutoffs and no table, for KL its
    cutoffs, sticky target and attack cutoff and no table, for the others
    ``cfg`` in place of the view."""
    one = list(args)
    if name == "crash_transition":
        one[3], one[4], one[10] = cfg.crash_cutoff, cfg.recover_cutoff, None
    elif name == "delivery":
        one[3], one[4] = cfg.drop_cutoff, cfg.partition_cutoff
        if len(one) > 7 and one[7] is not None:
            one[7] = (one[7][0], cfg.attack_target, cfg.attack_cutoff)
        one = one[:8]
        while len(one) > 6 and one[-1] is None:
            one.pop()
    else:
        one[0] = cfg
    return tuple(one)


def lane_slice(a, b: int, lanes: int):
    """Lane ``b``'s slice of an argument: each tensor led by the lane axis,
    also inside tuples (KAL's tables, KAE's fork leaves)."""
    if isinstance(a, torch.Tensor):
        return a[b:b + 1] if a.dim() and a.shape[0] == lanes else a
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(lane_slice(x, b, lanes) for x in a))
    if type(a) in (list, tuple):
        return type(a)(lane_slice(x, b, lanes) for x in a)
    return a


def knob_flat_work(name: str, switch: bool, args) -> tuple[float, float]:
    """(bytes, operations) of the flat instance's work on a flat call
    ``args``: its phase's bound function (KAJ phase 17's, KAH and a KT
    call under a crash phase 16's, KAL and KAE's SWITCH instance phase
    21's, else phase 3's), with ``bound`` swapped for the pair."""
    global bound
    saved = bound
    bound = lambda nbytes, ops: (nbytes, ops)   # noqa: E731
    try:
        if name == "hotstuff_prologue":
            return desync_kernel_bound(name, args)
        if name == "crash_transition" or (
                name == "bcast_view_preprepare"
                and isinstance(args[-1], torch.Tensor)):
            return crash_kernel_bound(name, args)
        if switch:
            return switch_bound(name, args)
        return flat_work(name, args)
    finally:
        bound = saved


def knob_bound(name: str, switch: bool, args, cfgs) -> tuple[float, str]:
    """The least time of a KNOBS instance's work on ``args``: each lane's
    flat work on its slice with its own config (``cfgs``), which is what
    the lane's row makes it do, summed, plus the [B, 12] table read
    once."""
    nbytes = ops = 0.0
    for b, cfg in enumerate(cfgs):
        one = lane_slice(knob_flat(name, args, cfg), b, len(cfgs))
        nb, op = knob_flat_work(name, switch, one)
        nbytes, ops = nbytes + nb, ops + op
    return bound(nbytes + 8 * 12 * len(cfgs), ops)


def check_knob_kernels(dev):
    """Phase 23's kernel rows. Every kernel call of rounds 3 and 20 of the
    knob runs (generation 0 of hotstuff-forked-qc-1k, the two full-width
    batches; with telemetry and the recorder) and of round 20 of each run
    with every row the base's, against the plain versions, exact; there
    the KNOBS instance also equals the flat instance. Then each KNOBS
    instance's time on round 20 of its KNOB_TIMED run, its plain version's
    and its bound (:func:`knob_bound`), and on the all-base round its time,
    the flat instance's time and bound. One row an instance."""
    from consensus_tpu_torch.network import runner
    errs = dict.fromkeys(KNOB_INSTANCES, 0.0)
    cases = dict.fromkeys(KNOB_INSTANCES, 0)
    timed, on_base = {}, {}
    for key in dict.fromkeys(run for _, _, run in KNOB_TIMED.values()):
        base, cfgs, seeds, kmat = knob_run(key)
        for r in KNOB_ROUNDS:
            calls = capture_knob_round_calls(base, seeds, kmat, r, dev)
            hold_calls(calls, f"{key} round {r}", errs, cases)
            timed[key] = (calls, cfgs)
        flat_kmat = knob_rows([base] * len(seeds))
        calls = capture_knob_round_calls(base, seeds, flat_kmat, 20, dev)
        hold_calls(calls, f"{key} round 20, every row the base's", errs,
                   cases)
        on_base[key] = calls
    rows = []
    for row, (name, switch, key) in KNOB_TIMED.items():
        calls, cfgs = timed[key]
        mine = [a for a in calls[name] if knob_instance(name, a)
                and (name not in ("hotstuff_vote",)
                     or switch_instance(name, a) == switch)]
        require(bool(mine), f"{key}: no KNOBS-instance call of {name}")
        args = mine[0]
        same = [a for a in on_base[key][name] if knob_instance(name, a)
                and (name != "hotstuff_vote"
                     or switch_instance(name, a) == switch)][0]
        base = knob_run(key)[0]
        flat = knob_flat(name, same, base)
        require(max_abs_err(zip(
            run_wrapper(name, same, lambda a: knob_flat(name, a, base)),
            run_wrapper(name, flat))) == 0.0,
                f"{key}: {name}'s KNOBS instance with every row the base's "
                "disagrees with its flat instance")
        mod = kernel_module(name)
        reps = reps_for(args)
        rows.append(dict(
            name=row, route="cuda",
            source=f"consensus_tpu_torch/csrc/{name}.cu",
            replaces=KNOB_REPLACES[row], max_abs_err=errs[name],
            cases=cases[name], timed_on=f"{key} round 20",
            ms=graph_ms(getattr(mod, name), args, reps),
            plain_ms=event_ms(getattr(mod, name + "_plain"), args,
                              min(3, reps)),
            bound=knob_bound(name, switch, args, cfgs), library_ms=None,
            launches_from=key,
            knobs_on_base_ms=graph_ms(getattr(mod, name), same, reps),
            flat_instance_ms=graph_ms(getattr(mod, name), flat, reps),
            flat_instance_bound=bound(*knob_flat_work(name, switch, flat))))
    return rows


def run_wrapper(name: str, args, inputs=lambda a: a) -> list:
    """Kernel wrapper ``name`` on a clone of ``args``: its results and every
    tensor of ``inputs(arguments)`` afterwards (the arguments that a flat
    call also takes, for a KNOBS call)."""
    a = clone_args(args)
    got = getattr(kernel_module(name), name)(*a)
    if isinstance(got, torch.Tensor):
        got = (got,)
    return [*(got or ()), *tensors_of(inputs(a))]


def knob_path(cfg) -> tuple[str, ...]:
    """The kernels a knob batch of base ``cfg`` launches: its engine's
    telemetry path with KAH, KAJ and KAL where its gates call them
    (:func:`switch_path`'s and :func:`gate_path`'s)."""
    from consensus_tpu_torch.engines import hotstuff
    path = gate_path(cfg)
    if cfg.switch_on:
        path += SWITCH_OWN
    if cfg.protocol == "hotstuff" and hotstuff.gated(cfg):
        path += ("hotstuff_prologue",)
    return path


def zero_counts() -> None:
    """Every launch count of every wrapper set to 0."""
    from consensus_tpu_torch.network import runner
    for mod, name in runner.KERNELS:
        fn = getattr(mod, name)
        fn.launches = 0
        for attr in ("switch_launches", "knob_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def check_knob_generations(card: str, smi: str) -> dict[str, int]:
    """Phase 23's generations: three generations of each space of
    KNOB_SPACES as ``run_knob_batch`` replays, counted from 0: every lane's
    digest against the JAX anchor, one capture for the three, the path's
    kernels launched and no other and each KNOBS instance on it launched;
    then lanes KNOB_PRODUCTION_LANES of each generation as production runs
    (``runner.run`` of the lane's own config, one sweep at the lane's
    seed) against the lane's extract and flight recorder. Returns the
    KNOBS launches of hotstuff-forked-qc-1k's generations, by wrapper."""
    from consensus_tpu_torch.network import runner
    own: dict = {}
    for name in KNOB_SPACES:
        zero_counts()
        captured = runner.captures
        results, walls = [], []
        for g, (_, _, anchors) in enumerate(KNOB_GENERATIONS[name]):
            base, cfgs, seeds, kmat = knob_generation(name, g)
            t0 = time.perf_counter()
            out, flight = runner.run_knob_batch(base, seeds, kmat,
                                                generation=g)
            walls.append(time.perf_counter() - t0)
            digests = knob_lane_digests(out, flight)
            require(digests == list(anchors),
                    f"{name} generation {g}: lanes "
                    f"{differing(digests, anchors)} differ from the JAX "
                    "anchors")
            results.append((cfgs, seeds, out, flight))
        captures = runner.captures - captured
        launches = runner.launch_counts()
        knob = runner.knob_launch_counts()
        require(captures == 1,
                f"{name}: three generations took {captures} captures")
        require_launched(launches, knob_path(base), name)
        for kernel in KNOB_INSTANCES:
            require((knob[kernel] > 0) == (launches[kernel] > 0),
                    f"{name}: {kernel}'s KNOBS instance launched "
                    f"{knob[kernel]} of {launches[kernel]} times")
        production = []
        for g, (cfgs, seeds, out, flight) in enumerate(results):
            for lane in KNOB_PRODUCTION_LANES:
                cfg = dataclasses.replace(cfgs[lane], n_sweeps=1,
                                          seed=int(seeds[lane]))
                stats: dict = {}
                ref = runner.run(cfg, telemetry=True, stats=stats)
                same = all(np.array_equal(out[k][lane], v[0])
                           for k, v in ref.items()) and all(
                    np.array_equal(flight[part][k][lane], v[0])
                    for part in ("windows", "latency")
                    for k, v in stats["flight"][part].items())
                production.append(dict(generation=g, lane=lane,
                                       equal=same))
                require(same, f"{name} generation {g} lane {lane}: the "
                        "production run of its config differs")
        emit("knob_generations", space=name, population=KNOB_POPULATION,
             generations=len(results), wall_s=walls, captures=captures,
             launches=launches, knob_launches=knob, production=production,
             card=card, power=smi)
        for row, (kernel, _, run) in KNOB_TIMED.items():
            if run == name:
                own[row] = knob[kernel]
        runner.clear_graphs()
    return own


def check_knob_batches(card: str, smi: str) -> dict[str, int]:
    """Phase 23's full-width batches: each KNOB_BATCHES batch as one
    ``run_knob_batch`` replay, counted from 0: its lanes' digests against
    the JAX anchors, the path's kernels launched and no other and each
    KNOBS instance on it launched; node-round-steps per second, the
    replay's wall, busy share and device operations a round (one profiled
    replay). Returns each KNOBS instance's launches from its KNOB_TIMED
    batch."""
    from consensus_tpu_torch.network import runner
    own: dict = {}
    for key in KNOB_BATCHES:
        base, cfgs, seeds, kmat = knob_batch(key)
        zero_counts()
        t0 = time.perf_counter()
        out, flight = runner.run_knob_batch(base, seeds, kmat)
        wall = time.perf_counter() - t0
        launches = runner.launch_counts()
        knob = runner.knob_launch_counts()
        digests = knob_lane_digests(out, flight)
        prof = profile_replay(base, run=lambda: runner.knob_batch_device(
            base, seeds, kmat))
        steps = base.n_sweeps * base.n_nodes * base.n_rounds
        row = dict(
            digests=digests, digests_ok=digests == list(
                KNOB_BATCH_ANCHORS[key]),
            wall_s=wall, launches=launches, knob_launches=knob,
            steps_per_sec=steps / (min(prof["replay_wall_ms"]) / 1e3),
            **{k: prof[k] for k in (
                "replay_wall_ms", "busy_share", "unprofiled_busy_share",
                "device_ms", "device_launches")},
            device_ops_per_round=prof["launches_per_round"],
            hand_kernel_ms={k: v for k, v in prof["hand_kernel_ms"].items()
                            if v})
        emit("knob_batch", run=key, **row, card=card, power=smi)
        require(row["digests_ok"],
                f"{key}: lanes {differing(digests, KNOB_BATCH_ANCHORS[key])} "
                "differ from the JAX anchors")
        require_launched(launches, knob_path(base), key)
        for kernel in KNOB_INSTANCES:
            require((knob[kernel] > 0) == (launches[kernel] > 0),
                    f"{key}: {kernel}'s KNOBS instance launched "
                    f"{knob[kernel]} of {launches[kernel]} times")
        for row_name, (name, _, run) in KNOB_TIMED.items():
            if run == key:
                own[row_name] = knob[name]
        runner.clear_graphs()
    return own


# --- phase 24: the knob batch (K23) on the count engines -------------------

# The wrappers whose KNOBS instances this phase adds, and their sources.
KNOB_COUNT_INSTANCES = ("delivery", "pbft_view_preprepare", "switch_combine",
                        "switch_receive", "dense_elect", "paxos_promise",
                        "paxos_accept_learn", "dpos_round", "dpos_telemetry")
KNOB_COUNT_REPLACES = {
    "delivery (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; ops/adversary.py:61 delivery under a KnobView "
    "(engines/raft.py:232, pbft.py:158, paxos.py:103)",
    "delivery (knobs, sticky)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft.py:242-253 the sticky jam under a "
    "KnobView",
    "pbft_view_preprepare (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/pbft.py:170-207 P0-P3 under a KnobView",
    "switch_combine (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; ops/aggregate.py:132-178 uplink lies under a KnobView",
    "switch_receive (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; ops/aggregate.py:260-277 downlinks under a KnobView",
    "dense_elect (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft.py:232-330 P0-P2 under a KnobView",
    "dense_elect (knobs, attack)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft.py:242-253, 303-304 sticky under a "
    "KnobView",
    "paxos_promise (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/paxos.py:103-117 under a KnobView",
    "paxos_accept_learn (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/paxos.py:117 under a KnobView",
    "dpos_round (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/dpos.py:82-169 under a KnobView",
    "dpos_telemetry (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/dpos.py:183-198 under a KnobView"}
# The row of each KNOBS instance: its wrapper, whether it is the ATTACK
# instance (KM's, or KL's STICKY one, under the sticky attack), and the run
# whose round-20 call is timed and whose run counts its launches.
KNOB_COUNT_TIMED = {
    "delivery (knobs)": ("delivery", False, "raft-1kx1k/knobs"),
    "delivery (knobs, sticky)": ("delivery", True, "raft-1kx1k/sticky"),
    "pbft_view_preprepare (knobs)": ("pbft_view_preprepare", False,
                                     "pbft-f128/knobs"),
    "switch_combine (knobs)": ("switch_combine", False, "pbft-f128/switch"),
    "switch_receive (knobs)": ("switch_receive", False, "pbft-f128/switch"),
    "dense_elect (knobs)": ("dense_elect", False, "raft-1kx1k/knobs"),
    "dense_elect (knobs, attack)": ("dense_elect", True, "raft-1kx1k/sticky"),
    "paxos_promise (knobs)": ("paxos_promise", False, "paxos-10kx10k/knobs"),
    "paxos_accept_learn (knobs)": ("paxos_accept_learn", False,
                                   "paxos-10kx10k/knobs"),
    "dpos_round (knobs)": ("dpos_round", False, "dpos-100k/knobs"),
    "dpos_telemetry (knobs)": ("dpos_telemetry", False, "dpos-100k/knobs")}
# The bases of tools/advsearch/search.py's six spaces on these engines
# (lines 119-224 and 302-313, with _ADV: window 4, 96 rounds, seed 0) and
# the knobs each space searches, in its order.
KNOB_ADV = dict(telemetry_window=4, n_rounds=96, seed=0)
KNOB_COUNT_SPACES = {
    "dpos-delivery": (dict(
        protocol="dpos", n_nodes=24, log_capacity=96, n_candidates=12,
        n_producers=3, epoch_len=48, drop_rate=0.3, miss_rate=0.1,
        max_delay_rounds=4, churn_rate=0.01, suppress_rate=0.1,
        suppress_window=48, **KNOB_ADV),
        ("miss_rate", "drop_rate", "churn_rate", "suppress_rate")),
    "raft-elections": (dict(
        protocol="raft", n_nodes=7, log_capacity=128, max_entries=96,
        drop_rate=0.3, partition_rate=0.1, churn_rate=0.02, crash_prob=0.1,
        recover_prob=0.3, max_crashed=3, max_delay_rounds=4, **KNOB_ADV),
        ("drop_rate", "partition_rate", "churn_rate", "crash_prob",
         "recover_prob")),
    "pbft-quorum": (dict(
        protocol="pbft", f=2, n_nodes=7, log_capacity=96, drop_rate=0.3,
        partition_rate=0.1, churn_rate=0.02, crash_prob=0.1,
        recover_prob=0.3, max_crashed=2, max_delay_rounds=4, **KNOB_ADV),
        ("drop_rate", "partition_rate", "churn_rate", "crash_prob",
         "recover_prob")),
    "paxos-slots": (dict(
        protocol="paxos", n_nodes=9, log_capacity=96, drop_rate=0.3,
        partition_rate=0.1, churn_rate=0.02, crash_prob=0.1,
        recover_prob=0.3, max_crashed=3, max_delay_rounds=4, **KNOB_ADV),
        ("drop_rate", "partition_rate", "churn_rate", "crash_prob",
         "recover_prob")),
    "pbft-cert-poison": (dict(
        protocol="pbft", f=2, n_nodes=7, log_capacity=96,
        net_model="switch", n_aggregators=2, agg_byz=1, n_byzantine=2,
        byz_mode="equivocate", agg_poison_rate=0.3, byz_uplink_rate=0.2,
        drop_rate=0.1, **KNOB_ADV),
        ("agg_poison_rate", "byz_uplink_rate", "drop_rate")),
    "raft-attack-elect": (dict(
        protocol="raft", n_nodes=7, log_capacity=128, max_entries=96,
        drop_rate=0.05, attack="elect", attack_rate=0.9, **KNOB_ADV),
        ("attack_rate", "drop_rate")),
}
# The gates of raft-elections, pbft-quorum and paxos-slots (the same
# knobs) with a cap of 64 for the full-width shapes, and dpos-delivery's.
COUNT_GATES = dict(drop_rate=0.3, partition_rate=0.1, churn_rate=0.02,
                   crash_prob=0.1, recover_prob=0.3, max_crashed=64,
                   max_delay_rounds=4)
DPOS_DELIVERY_GATES = dict(drop_rate=0.3, miss_rate=0.1, max_delay_rounds=4,
                           churn_rate=0.01, suppress_rate=0.1,
                           suppress_window=48)
# pbft-cert-poison's §9b over phase 22's switch (K = 8), equivocators at f.
CERT_POISON_9B = dict(SWITCH_KNOBS, agg_byz=1, byz_mode="equivocate",
                      agg_poison_rate=0.3, byz_uplink_rate=0.2, drop_rate=0.1)
# The seven full-width knob batches: each base at its flagship's shape
# (raft-1kx1k cut to 128 rounds: PERF.md §4), and each lane's overrides,
# 8 distinct rows (paxos-10kx10k: 2): lane 0 the base's, lane 1 the base
# with a gated-on knob zeroed. The sticky batch's lanes also set their
# target column as it stands (KNOB_COUNT_TARGETS; N + 3 and 0xFFFFFFFD
# are out of range and jam nothing).
STICKY_BASE = dict(attack="sticky", attack_rate=0.9, attack_target=3)
KNOB_COUNT_BATCHES = {
    "raft-1kx1k/knobs": (
        dict(protocol="raft", log_capacity=L, max_entries=100,
             **DENSE_CONFIGS["raft-1kx1k"], **COUNT_GATES,
             telemetry_window=WINDOW) | dict(n_rounds=128),
        ({}, dict(partition_rate=0.0), dict(drop_rate=0.05),
         dict(crash_prob=0.3, recover_prob=0.1), dict(churn_rate=0.1),
         dict(drop_rate=0.5, partition_rate=0.3),
         dict(crash_prob=0.0, churn_rate=0.0),
         dict(recover_prob=0.9, drop_rate=0.15))),
    "raft-1kx1k/sticky": (
        dict(protocol="raft", log_capacity=L, max_entries=100,
             drop_rate=0.01, churn_rate=0.001,
             **DENSE_CONFIGS["raft-1kx1k"], **STICKY_BASE,
             telemetry_window=WINDOW) | dict(n_rounds=128),
        ({}, dict(attack_rate=0.0), dict(attack_rate=1.0),
         dict(attack_rate=0.5), dict(drop_rate=0.05), dict(churn_rate=0.01),
         dict(attack_rate=1.0), dict(attack_rate=0.7, drop_rate=0.02))),
    "pbft-f128/knobs": (
        dict(PBFT_ADV, f=128, n_nodes=385, **COUNT_GATES, n_sweeps=8,
             telemetry_window=WINDOW),
        ({}, dict(partition_rate=0.0), dict(drop_rate=0.05),
         dict(crash_prob=0.3, recover_prob=0.1), dict(churn_rate=0.1),
         dict(drop_rate=0.5, partition_rate=0.3),
         dict(crash_prob=0.0, churn_rate=0.0),
         dict(recover_prob=0.9, drop_rate=0.15))),
    "pbft-f128/switch": (
        dict(PBFT_ADV, f=128, n_nodes=385, **CERT_POISON_9B,
             n_byzantine=128, n_sweeps=8, telemetry_window=WINDOW),
        ({}, dict(agg_poison_rate=0.0), dict(byz_uplink_rate=0.0),
         dict(agg_poison_rate=0.9, byz_uplink_rate=0.7),
         dict(drop_rate=0.35), dict(drop_rate=0.0, agg_poison_rate=0.6),
         dict(byz_uplink_rate=0.95), dict(agg_poison_rate=0.05,
                                          drop_rate=0.2))),
    "pbft-quorum-1k/switch": (
        dict(protocol="pbft", f=341, n_nodes=1024, fault_model="bcast",
             log_capacity=96, **COUNT_GATES | dict(max_delay_rounds=2),
             net_model="switch", n_aggregators=16, agg_byz=1,
             n_byzantine=341, byz_mode="equivocate", agg_poison_rate=0.3,
             byz_uplink_rate=0.2, n_sweeps=8, **KNOB_ADV),
        ({}, dict(partition_rate=0.0), dict(agg_poison_rate=0.0),
         dict(byz_uplink_rate=0.9, drop_rate=0.1),
         dict(crash_prob=0.3, recover_prob=0.1),
         dict(churn_rate=0.1, agg_poison_rate=0.8),
         dict(drop_rate=0.5, partition_rate=0.3),
         dict(crash_prob=0.0, byz_uplink_rate=0.05))),
    "paxos-10kx10k/knobs": (
        dict(PAXOS_FLAGSHIP, **COUNT_GATES, n_sweeps=2,
             telemetry_window=WINDOW),
        ({}, dict(partition_rate=0.0))),
    "dpos-100k/knobs": (
        dict(DPOS_FLAGSHIP, **DPOS_DELIVERY_GATES, n_sweeps=8,
             telemetry_window=WINDOW),
        ({}, dict(miss_rate=0.0), dict(suppress_rate=0.0, suppress_window=16),
         dict(drop_rate=0.05, miss_rate=0.3), dict(churn_rate=0.05),
         dict(suppress_rate=0.5, drop_rate=0.5),
         dict(miss_rate=0.02, churn_rate=0.0),
         dict(drop_rate=0.15, suppress_rate=0.3))),
}
# The sticky batch's targets, by lane (the base's is 3).
KNOB_COUNT_TARGETS = {"raft-1kx1k/sticky": (3, 3, 5, 0, 1024 + 3, 0xFFFFFFFD,
                                            1023, 7)}
KNOB_COUNT_SEEDS = (8, 0xFFFFFFFF, 3, 77, 1 << 31, 12345, 9, 2024)
# Rounds checked beside 3 and 20: those of pbft-cert-poison's generation 0
# where an equivocating primary's offer misses a receiver (lanes 6 and 4),
# which KQ's equivocate instance once took as delivered.
KNOB_COUNT_EXTRA_ROUNDS = {"pbft-cert-poison": (54, 70)}
# The search seed of each space: 11, as phase 23's, but dpos-delivery's
# (the JAX package's search at 11 mutates a candidate to suppress_rate 0,
# which its Config rejects beside suppress_window 48).
KNOB_COUNT_SEARCH_SEEDS = {'dpos-delivery': 12, 'raft-elections': 11, 'pbft-quorum': 11, 'paxos-slots': 11, 'pbft-cert-poison': 11, 'raft-attack-elect': 11}
# The three generations of each space, as phase 23's KNOB_GENERATIONS
# (each lane's seed, its knob values in KNOB_COUNT_SPACES' order and its
# digest from the JAX package's run_knob_batch), and each full-width
# batch's lane digests: from the JAX package's run_knob_batch where a lane
# has no Config of its own (the sticky batch), else from each lane's plain
# JAX run, which equals the lane (the vmapped batch of a PBFT switch base
# at N = 385 compiled for over 20 min on the CPU). Made on the CPU by
# phase 23's recipe over KNOB_COUNT_SPACES at KNOB_COUNT_SEARCH_SEEDS (the
# spaces took 4-11 s each on 8 cores), and for the batches (39-148 s
# each, the two paxos-10kx10k lanes 1 322 s)
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, json, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import runner, simulator
#   batches = {}
#   for key in chip_smoke.KNOB_COUNT_BATCHES:
#       base, cfgs, seeds, kmat = chip_smoke.knob_count_batch(key)
#       jbase = Config(**dataclasses.asdict(base))
#       if None not in cfgs:
#           batches[key] = []
#           for b, cfg in enumerate(cfgs):
#               one = Config(**dataclasses.asdict(dataclasses.replace(
#                   cfg, n_sweeps=1, seed=int(seeds[b]))))
#               stats = {}
#               o = runner.run(one, simulator.engine_def(one), stats=stats,
#                              telemetry=True)
#               batches[key] += chip_smoke.knob_lane_digests(
#                   o, stats["flight"])
#       else:
#           o, flight = runner.run_knob_batch(
#               jbase, simulator.engine_def(jbase), seeds, kmat)
#           batches[key] = chip_smoke.knob_lane_digests(o, flight)
#   print(json.dumps(batches))
#   EOF
#
KNOB_COUNT_GENERATIONS = {'dpos-delivery': [((3843491933, 2369200544, 3574829531, 3977897957,
                     2591970087, 3584097430, 1481469059, 148777289,
                     3646914035, 821820368, 2202185592, 1374627298, 57939623,
                     1088739177, 194327849, 4267743359),
                    ((0.1466, 0.34, 0.0755, 0.4673),
                     (0.3978, 0.2111, 0.0692, 0.3766),
                     (0.1408, 0.5117, 0.0589, 0.1503),
                     (0.4592, 0.1998, 0.0147, 0.0669),
                     (0.1756, 0.1616, 0.052, 0.4901),
                     (0.21, 0.0863, 0.0033, 0.2588),
                     (0.3388, 0.3913, 0.0442, 0.5473),
                     (0.3477, 0.444, 0.0655, 0.0773),
                     (0.1208, 0.5059, 0.0736, 0.2798),
                     (0.3108, 0.1935, 0.0768, 0.1578),
                     (0.2012, 0.2082, 0.0459, 0.3246),
                     (0.3914, 0.1928, 0.0358, 0.1958),
                     (0.4926, 0.5344, 0.0296, 0.1526),
                     (0.4941, 0.4931, 0.027, 0.3402),
                     (0.4918, 0.3658, 0.0353, 0.3178),
                     (0.2741, 0.2714, 0.0502, 0.4133)),
                    ('842271376e23a9c21cff6065', '96fc9b1d2fee0e21b6edaea6',
                     '54208e31ffe6a8a997545e25', 'c909d1d7d4b06b00db5ccded',
                     '11d123987c4cf2aa70974f28', '00979f5f7f183a6249ca6082',
                     '83507c5c71ee3d4205c0d8f5', '06ba31818dd21b22d452852b',
                     'e08fdc2c1de922e8eccc1c81', 'bb4dcb9a387db7143de2a0cf',
                     '258db2136245ce32c075e158', '49ef5c60c84bd3d2527e6832',
                     'd63f9af97b05215f82d1c8ba', 'be1beef5296797464f30ae5e',
                     '9da32a2f52676335fa1e0acd',
                     '5c7f714c664960d8232c56e3')),
                   ((2459637998, 503090497, 2891285824, 781264411, 1289316517,
                     3685272579, 138108530, 2205056419, 3339321368, 97262511,
                     2492468729, 411429781, 3190225400, 2973966078,
                     3394793697, 2199952249),
                    ((0.1466, 0.34, 0.0755, 0.4673),
                     (0.3978, 0.2111, 0.0692, 0.3766),
                     (0.4918, 0.3658, 0.0353, 0.3178),
                     (0.1756, 0.1616, 0.052, 0.4901),
                     (0.1408, 0.5117, 0.0589, 0.1503),
                     (0.4592, 0.1998, 0.0147, 0.0669),
                     (0.3388, 0.3913, 0.0442, 0.5473),
                     (0.1208, 0.5059, 0.0736, 0.2798),
                     (0.0974, 0.0736, 0.0938, 0.4627),
                     (0.4918, 0.2576, 0.0353, 0.3178),
                     (0.4592, 0.1998, 0.0427, 0.0669),
                     (0.3855, 0.3913, 0.0442, 0.5473),
                     (0.3388, 0.3913, 0.0189, 0.5473),
                     (0.3084, 0.3655, 0.0721, 0.0515),
                     (0.4592, 0.1797, 0.0147, 0.0669),
                     (0.1208, 0.5059, 0.0736, 0.1162)),
                    ('480b867a3188f6168bf695d1', 'b406a2702bceabd449105738',
                     '6e3e14e87edf142d2e68d5ec', '328b3813eab38758c103f797',
                     '300368c64d797d4707b62b36', 'f0ba5f51c8b63ff6b512e90c',
                     'bb9fd231894ac8aa87ed53bf', 'efcdae389ce933ced2eac1d0',
                     '63348939d6d22435b6e43e19', '5488a713f79485ab8d3e7416',
                     'f9cc7edba152b5348aecc5e9', '5f5ce118b2dacad39189c77e',
                     '1e242668c3e93de4f6ccf891', 'a3acf5b6922c26921ec9f876',
                     '72787f589f3b5009724689ea',
                     'da7253d4da5ebe717f2741d2')),
                   ((2319601644, 4109850741, 1843753126, 3893014969,
                     1432102663, 914561973, 2720305378, 809345629, 1400160813,
                     3122274524, 2936318656, 2222509327, 938026839,
                     1269055843, 2292088751, 2488763026),
                    ((0.3388, 0.3913, 0.0442, 0.5473),
                     (0.1756, 0.1616, 0.052, 0.4901),
                     (0.0974, 0.0736, 0.0938, 0.4627),
                     (0.3855, 0.3913, 0.0442, 0.5473),
                     (0.4918, 0.2576, 0.0353, 0.3178),
                     (0.3388, 0.3913, 0.0442, 0.6),
                     (0.1756, 0.2666, 0.052, 0.4901),
                     (0.1756, 0.1616, 0.0294, 0.4901),
                     (0.0538, 0.3429, 0.086, 0.025),
                     (0.4918, 0.3653, 0.0353, 0.3178),
                     (0.3118, 0.5191, 0.0079, 0.175),
                     (0.0959, 0.0736, 0.0938, 0.4627),
                     (0.4146, 0.3913, 0.0442, 0.5473),
                     (0.0974, 0.2017, 0.0938, 0.4627),
                     (0.3388, 0.3913, 0.0254, 0.5473),
                     (0.1756, 0.1616, 0.052, 0.4912)),
                    ('a0f33dee02c2cc3ce9b48b13', '5f2421292a6b948b01675a58',
                     'b8400e422fb692932f7c5bab', '24da1c4a65c397624d9c32da',
                     '840e7627e615fbd497cfe5b0', '2c33749d5307f4e99da81c89',
                     '4932a5c2ae958296c5423356', '6feb28a89f7ef166fe1cf609',
                     '6ef407467d2261538955e466', 'd7476549ea7173e691ab8d7a',
                     '93371d8b03c1936d4885cf70', 'ab4526032a182c92b50ff5fd',
                     '12236cf1cca58a35cb34c992', '866a4e22072ab884992de1b8',
                     'c2ea07b4e7d705e883f414a4',
                     'bd9c7da59c5f4ffb7d6adeed'))],
 'paxos-slots': [((1679678445, 1534475689, 278192867, 2354117381, 3694801633,
                   2145619974, 4279672098, 3017178572, 3508595031, 3622200387,
                   3816601057, 886418844, 3209889851, 2172454415, 658177925,
                   3890115422),
                  ((0.3085, 0.3885, 0.1487, 0.1453, 0.1959),
                   (0.4154, 0.3419, 0.0572, 0.2887, 0.131),
                   (0.0663, 0.0953, 0.0425, 0.1357, 0.2308),
                   (0.5076, 0.2395, 0.0004, 0.0856, 0.4032),
                   (0.2088, 0.0738, 0.112, 0.21, 0.2568),
                   (0.4117, 0.1487, 0.1185, 0.0517, 0.0868),
                   (0.1049, 0.3763, 0.0403, 0.0013, 0.2198),
                   (0.4254, 0.1145, 0.1489, 0.0805, 0.0833),
                   (0.4273, 0.196, 0.0437, 0.0369, 0.1776),
                   (0.3869, 0.206, 0.0515, 0.0213, 0.074),
                   (0.3693, 0.3289, 0.0534, 0.1448, 0.1145),
                   (0.2512, 0.0682, 0.1473, 0.0935, 0.0712),
                   (0.5418, 0.1078, 0.0352, 0.1221, 0.3129),
                   (0.1406, 0.1616, 0.0285, 0.1068, 0.2708),
                   (0.0547, 0.1911, 0.0242, 0.0022, 0.1726),
                   (0.2329, 0.2083, 0.0271, 0.1079, 0.1151)),
                  ('6aaaf57214184f5509ea37aa', '6200e30adfaa6d89e64f7aa5',
                   '9fec481b7bf58fb3144015c1', '14988eb947a123b204407d2d',
                   'c166717f899c8880a2e8d19e', 'ad35ebe379001ecd12bef950',
                   '0a41fac62318d682224cc0b0', 'c9e2974dfd6129b95b3d689b',
                   '982d9acb366e7f5e32be4481', '9a058dcbf057fec9c783c1c5',
                   '6e640f2e4b62ae258f7c91de', '364c98381621c630d611e659',
                   '0077e2bf33b5b0a10089e1ed', 'dc186115a4c4bb9dde6a77bc',
                   '6ddfd0f826c837c122170d10', '0c287c0d61f554c4b04a256d')),
                 ((1677358738, 640328353, 2651076246, 1109509310, 1159399247,
                   476842274, 2262828114, 622629121, 1677510738, 3621436798,
                   4171883027, 3288336079, 3911128341, 24712174, 2819732854,
                   1186635878),
                  ((0.0547, 0.1911, 0.0242, 0.0022, 0.1726),
                   (0.4154, 0.3419, 0.0572, 0.2887, 0.131),
                   (0.1049, 0.3763, 0.0403, 0.0013, 0.2198),
                   (0.4117, 0.1487, 0.1185, 0.0517, 0.0868),
                   (0.3085, 0.3885, 0.1487, 0.1453, 0.1959),
                   (0.4117, 0.1744, 0.1185, 0.0517, 0.0868),
                   (0.1049, 0.3763, 0.0403, 0.0013, 0.2639),
                   (0.1049, 0.3763, 0.0403, 0.0717, 0.2198),
                   (0.4195, 0.3566, 0.0257, 0.2319, 0.4432),
                   (0.1049, 0.3763, 0.0245, 0.0013, 0.2198),
                   (0.1049, 0.3997, 0.0403, 0.0013, 0.2198),
                   (0.1689, 0.3763, 0.0403, 0.0013, 0.2198),
                   (0.4117, 0.1487, 0.1185, 0.0827, 0.0868),
                   (0.5959, 0.3834, 0.0994, 0.2195, 0.1942),
                   (0.4933, 0.1551, 0.0734, 0.2728, 0.2205),
                   (0.1179, 0.1673, 0.1383, 0.0305, 0.1384)),
                  ('e4417948fa00a7ae6f705b12', 'c3757f5a1e17a82a783a87e8',
                   '69a6a89cf40439c53aae71b2', '805b3c8831d30fbc5531dffb',
                   '72e7f430bb59aeb785b1c4d4', 'ab267bc6642b8b80173fcbe7',
                   '458d84a9fda054c3ff24c2b1', '76d8bbf44d0ab52697e1ccc6',
                   '92ffb68b71aacbc1efb78f72', '2df6cdd111e9dbd215a80264',
                   '99d1981cda50b2b5bedffca9', 'a414f5d299bb157926834536',
                   'f817506599aa402845181b46', '850b3a39822ac782b5a4cfda',
                   '5d87ec2bef56c9eb3999b844', '588b03a6f6e21527040e4eb6')),
                 ((430660201, 192764186, 599153662, 1963827441, 2079243083,
                   1794281481, 2766141373, 1029018697, 2633830214, 4249387551,
                   3527526455, 183813833, 1809896444, 2067659070, 589257308,
                   701979083),
                  ((0.0547, 0.1911, 0.0242, 0.0022, 0.1726),
                   (0.1049, 0.3997, 0.0403, 0.0013, 0.2198),
                   (0.1049, 0.3763, 0.0403, 0.0013, 0.2639),
                   (0.1049, 0.3763, 0.0403, 0.0013, 0.2198),
                   (0.0547, 0.1718, 0.0242, 0.0022, 0.1726),
                   (0.0547, 0.2559, 0.0242, 0.0022, 0.1726),
                   (0.1049, 0.3799, 0.0403, 0.0013, 0.2198),
                   (0.1049, 0.3997, 0.0716, 0.0013, 0.2198),
                   (0.1049, 0.4, 0.0403, 0.0013, 0.2639),
                   (0.1049, 0.3763, 0.0403, 0.0013, 0.1664),
                   (0.2012, 0.1911, 0.0242, 0.0022, 0.1726),
                   (0.05, 0.3763, 0.0403, 0.0013, 0.2198),
                   (0.1049, 0.4, 0.0403, 0.0013, 0.2639),
                   (0.1049, 0.2676, 0.0403, 0.0013, 0.2639),
                   (0.128, 0.0381, 0.0489, 0.138, 0.4748),
                   (0.1049, 0.3763, 0.0403, 0.0013, 0.3184)),
                  ('c707f0234486f21588493ef9', 'f2f7f6442c714911cadb25e2',
                   'f0477ebf7f7825242761ea1a', 'a6612b3e421050565c0afe3c',
                   '48b338fbbb7aa1ec60b0f89c', '1720ba4e35ed3494f7d24777',
                   'bdc6daef45ed8b789333d359', '41b5fba7ede3f977b70ce0ac',
                   '139c1100aa90b5d3bb6627c1', '4a0fc91848278ed1cde1dddf',
                   'a1116b41272fc5941d8f97e6', '0122aa6713eeccc3f9eefc6b',
                   '8eab9f569753f778ef209ab7', 'e54006d1cd3d28051fb2433a',
                   '3bf5fbbd0d421ebd1d6df052', '304a5d517d7f49211ea8f958'))],
 'pbft-cert-poison': [((1679678445, 1534475689, 278192867, 2354117381,
                        3694801633, 2145619974, 4279672098, 3017178572,
                        3508595031, 3622200387, 3816601057, 886418844,
                        3209889851, 2172454415, 658177925, 3890115422),
                       ((0.4729, 0.9241, 0.3965), (0.6478, 0.8193, 0.1525),
                        (0.0767, 0.2644, 0.1134), (0.7987, 0.589, 0.0011),
                        (0.3099, 0.2162, 0.2987), (0.6419, 0.3845, 0.3159),
                        (0.1398, 0.8967, 0.1075), (0.6643, 0.3077, 0.3969),
                        (0.6674, 0.4911, 0.1165), (0.6013, 0.5136, 0.1372),
                        (0.5725, 0.7901, 0.1425), (0.3793, 0.2035, 0.3928),
                        (0.8547, 0.2926, 0.094), (0.1983, 0.4136, 0.076),
                        (0.0577, 0.48, 0.0644), (0.3492, 0.5186, 0.0723)),
                       ('1c927b29cb2de0f3cd50a79a',
                        '739d8f06332fc2f16100e49c',
                        '8a166cc1b1a47dd594f5e314',
                        '2f151902c6a69a5bd0112a83',
                        '369b5a6dea206905ac68187f',
                        'f9c0d1f4a21024ca7cd7161c',
                        'aa9c67e53bde4728fc30c8cd',
                        '7ad18cd093d7896875dc2435',
                        '9db029ad41f2a9ffcfc5516c',
                        'fcf55879b08691a3e0c3e65d',
                        '7664a374dcdc8829515e793c',
                        '4322ccd8db8b12a83986d971',
                        'ba50c47f7ec9f9db67dd12b6',
                        '36b7d3beacedf97fa717585a',
                        '166b0d02efb3ee268f003abd',
                        '99ec8b4fee3eb132402a2046')),
                      ((1677358738, 640328353, 2651076246, 1109509310,
                        1159399247, 476842274, 2262828114, 622629121,
                        1677510738, 3621436798, 4171883027, 3288336079,
                        3911128341, 24712174, 2819732854, 1186635878),
                       ((0.1398, 0.8967, 0.1075), (0.3099, 0.2162, 0.2987),
                        (0.0577, 0.48, 0.0644), (0.0767, 0.2644, 0.1134),
                        (0.4729, 0.9241, 0.3965), (0.6478, 0.8193, 0.1525),
                        (0.7987, 0.589, 0.0011), (0.0767, 0.2644, 0.1153),
                        (0.6546, 0.8523, 0.0686), (0.0577, 0.3703, 0.0644),
                        (0.1713, 0.2644, 0.1134), (0.5776, 0.9241, 0.3965),
                        (0.4729, 0.9241, 0.3207), (0.9433, 0.9126, 0.265),
                        (0.7754, 0.399, 0.1958), (0.1611, 0.4265, 0.3687)),
                       ('e8ae47048b37d1dd0307f568',
                        '4c249199b6233010e061834d',
                        '3cc4caac47594644ba468b34',
                        '6517967f851ba1fc8b2bb123',
                        '8aee227a1504ce08474cd58c',
                        'dbab7ddc2371c2bb78b9209e',
                        '94ca2ea273787d6247aaa0ca',
                        '8514281f2a44d87fb7b70159',
                        'f3c16ba9faebc7ba456c29ef',
                        '8bd38ad9ea7541ea9ddde0cf',
                        'a9da54763367ac40b4719dda',
                        'c942083ec7e7ffd5982ddc6d',
                        '4493149d9b38df83dcff974a',
                        'dab67b462ca1894daa32fc54',
                        'a4977790e39fd063aba9148f',
                        'aa441e258e0c938c64ee2ab1')),
                      ((430660201, 192764186, 599153662, 1963827441,
                        2079243083, 1794281481, 2766141373, 1029018697,
                        2633830214, 4249387551, 3527526455, 183813833,
                        1809896444, 2067659070, 589257308, 701979083),
                       ((0.1611, 0.4265, 0.3687), (0.1398, 0.8967, 0.1075),
                        (0.3099, 0.2162, 0.2987), (0.0577, 0.48, 0.0644),
                        (0.3031, 0.4265, 0.3687), (0.3858, 0.4265, 0.3687),
                        (0.332, 0.8967, 0.1075), (0.1398, 0.95, 0.1075),
                        (0.3187, 0.2162, 0.2987), (0.3099, 0.2162, 0.1979),
                        (0.4009, 0.4265, 0.3687), (0.05, 0.48, 0.0644),
                        (0.05, 0.2162, 0.2987), (0.3099, 0.05, 0.2987),
                        (0.1776, 0.1357, 0.1305), (0.0577, 0.48, 0.0)),
                       ('94742123fabb38b7995faf44',
                        '27d26ca08ff490066b86d57a',
                        '5274df4714ddd8b8211b890a',
                        '5c0fe2cfc51c445e5feb418d',
                        'eccc81aa5d9c3e81c9fbbede',
                        'f835087f229a3d8efad572af',
                        '9a9ed95671c628b46a28c029',
                        '0877644b24a6977486f6b9a5',
                        '2cfb40fd4b40920fa48a06c3',
                        '429d78c023b44e9ebfcd217d',
                        'ba5601070385902a2ea832bb',
                        '4e86116e9799bda32151aec6',
                        'f6b026cf904ae661dbee2911',
                        '267380c9f5f7f1ab631cbea7',
                        '8a5c012bd045fe2bd4f152c7',
                        '8847b1ff323719fdf5d2fe79'))],
 'pbft-quorum': [((1679678445, 1534475689, 278192867, 2354117381, 3694801633,
                   2145619974, 4279672098, 3017178572, 3508595031, 3622200387,
                   3816601057, 886418844, 3209889851, 2172454415, 658177925,
                   3890115422),
                  ((0.3085, 0.3885, 0.1487, 0.1453, 0.1959),
                   (0.4154, 0.3419, 0.0572, 0.2887, 0.131),
                   (0.0663, 0.0953, 0.0425, 0.1357, 0.2308),
                   (0.5076, 0.2395, 0.0004, 0.0856, 0.4032),
                   (0.2088, 0.0738, 0.112, 0.21, 0.2568),
                   (0.4117, 0.1487, 0.1185, 0.0517, 0.0868),
                   (0.1049, 0.3763, 0.0403, 0.0013, 0.2198),
                   (0.4254, 0.1145, 0.1489, 0.0805, 0.0833),
                   (0.4273, 0.196, 0.0437, 0.0369, 0.1776),
                   (0.3869, 0.206, 0.0515, 0.0213, 0.074),
                   (0.3693, 0.3289, 0.0534, 0.1448, 0.1145),
                   (0.2512, 0.0682, 0.1473, 0.0935, 0.0712),
                   (0.5418, 0.1078, 0.0352, 0.1221, 0.3129),
                   (0.1406, 0.1616, 0.0285, 0.1068, 0.2708),
                   (0.0547, 0.1911, 0.0242, 0.0022, 0.1726),
                   (0.2329, 0.2083, 0.0271, 0.1079, 0.1151)),
                  ('faedb55cf2e5025b92a36747', '60ba9ad5a81a6f2254795ee5',
                   '8d8b0b82881be9ecbff12df1', 'b5bc318b18b2dce6a8fba3dd',
                   '64a3e479afe374d43ab7a5f2', 'cf30a681edb5a6fb12332702',
                   '9c6b1626e9e0e955ddf78950', 'fb482112f595dff756556cfd',
                   '500a43f8d6aa9d20bbc0db89', 'd6c31df9996a768f56e1a52e',
                   'cacb83e48e545383e132e545', '46c87b22ac067c59135831cb',
                   '887f1fb9133022ac2970dd8b', 'b77313ea7c60d0ac84e6a9ba',
                   '97d9f8f75ff0a1ca762b2e56', '78dfa24ea589fc31c6b5121c')),
                 ((1677358738, 640328353, 2651076246, 1109509310, 1159399247,
                   476842274, 2262828114, 622629121, 1677510738, 3621436798,
                   4171883027, 3288336079, 3911128341, 24712174, 2819732854,
                   1186635878),
                  ((0.4154, 0.3419, 0.0572, 0.2887, 0.131),
                   (0.2512, 0.0682, 0.1473, 0.0935, 0.0712),
                   (0.1406, 0.1616, 0.0285, 0.1068, 0.2708),
                   (0.4117, 0.1487, 0.1185, 0.0517, 0.0868),
                   (0.3085, 0.3885, 0.1487, 0.1453, 0.1959),
                   (0.0663, 0.0953, 0.0425, 0.1357, 0.2308),
                   (0.5076, 0.2395, 0.0004, 0.0856, 0.4032),
                   (0.4117, 0.1487, 0.1185, 0.1221, 0.0868),
                   (0.4195, 0.3566, 0.0257, 0.2319, 0.4432),
                   (0.1406, 0.1616, 0.0127, 0.1068, 0.2708),
                   (0.4117, 0.1721, 0.1185, 0.0517, 0.0868),
                   (0.3725, 0.3885, 0.1487, 0.1453, 0.1959),
                   (0.3085, 0.3885, 0.1487, 0.1763, 0.1959),
                   (0.5959, 0.3834, 0.0994, 0.2195, 0.1942),
                   (0.4933, 0.1551, 0.0734, 0.2728, 0.2205),
                   (0.1179, 0.1673, 0.1383, 0.0305, 0.1384)),
                  ('819b5a2a10d47e73ba564d52', '12479dac8c0cd3bbb8239278',
                   '8f5b784182815478fb57562c', '4c191a779bee0083902c648e',
                   '56911e953fd3eb041ee908cd', '74e0a5a79c00caf59be40028',
                   'ab8af6a38fbb16bbd4beb55a', '0d09f2380a0c99299cb7a842',
                   '445918bfcc5e880f7486722f', 'a233ba6de97b3f07ccf102ee',
                   '9b188a42ac76dd84f6146f08', 'e5be119acceb971ca3a6623e',
                   '88c61d869616c03a905f5e43', 'b6799875d00a1cb31197f387',
                   '616645e2ead8b0fce5932d1e', '98a5c12346c235d44dbf39e4')),
                 ((430660201, 192764186, 599153662, 1963827441, 2079243083,
                   1794281481, 2766141373, 1029018697, 2633830214, 4249387551,
                   3527526455, 183813833, 1809896444, 2067659070, 589257308,
                   701979083),
                  ((0.5959, 0.3834, 0.0994, 0.2195, 0.1942),
                   (0.0663, 0.0953, 0.0425, 0.1357, 0.2308),
                   (0.5076, 0.2395, 0.0004, 0.0856, 0.4032),
                   (0.1406, 0.1616, 0.0127, 0.1068, 0.2708),
                   (0.4154, 0.3419, 0.0572, 0.2887, 0.131),
                   (0.5959, 0.4, 0.0994, 0.2195, 0.1942),
                   (0.0663, 0.0755, 0.0425, 0.1357, 0.2308),
                   (0.0663, 0.0953, 0.0738, 0.1357, 0.2308),
                   (0.5076, 0.3245, 0.0004, 0.0856, 0.4032),
                   (0.5076, 0.2395, 0.0004, 0.0856, 0.3057),
                   (0.6, 0.3834, 0.0994, 0.2195, 0.1942),
                   (0.3216, 0.3419, 0.0572, 0.2887, 0.131),
                   (0.1406, 0.2668, 0.0127, 0.1068, 0.2708),
                   (0.5076, 0.1308, 0.0004, 0.0856, 0.4032),
                   (0.128, 0.0381, 0.0489, 0.138, 0.4748),
                   (0.1406, 0.1616, 0.0127, 0.1068, 0.3694)),
                  ('c9f1fc82eab79bd4c8e02a32', '9fc8d7fba64d4ee0bc4d4c51',
                   'c7cf0bfd8323e7c667b827a9', '94e9cb88d4238ce704090ce5',
                   '6f2890c44c067ffee7c8ce03', '09560180fab6cc48e99bf320',
                   'bde8ee78b1d75a2c88079ef3', '07e44ff7a88d3554cb435231',
                   'da5b90e7cd247d6299b1e129', '3a450506a44fa1947df9507d',
                   '7e600de693be0ac367ad7bf7', '131915ceedb25cd7ae199bea',
                   'bcb4a2730cef37cdd9edc8be', '76c43c35e0c23e4bf96d41e4',
                   '2a99dc0905a74fde84adda3a', 'e0b629152653d43a197dc4b6'))],
 'raft-attack-elect': [((1679678445, 1534475689, 278192867, 2354117381,
                         3694801633, 2145619974, 4279672098, 3017178572,
                         3508595031, 3622200387, 3816601057, 886418844,
                         3209889851, 2172454415, 658177925, 3890115422),
                        ((0.5759, 0.2914), (0.7314, 0.2564), (0.2238, 0.0715),
                         (0.8655, 0.1797), (0.431, 0.0554), (0.7262, 0.1115),
                         (0.2798, 0.2822), (0.7461, 0.0859), (0.7488, 0.147),
                         (0.69, 0.1545), (0.6645, 0.2467), (0.4927, 0.0512),
                         (0.9153, 0.0809), (0.3318, 0.1212), (0.2069, 0.1433),
                         (0.466, 0.1562)),
                        ('a6229bd4e3ecd0f8fd84865e',
                         '85261d627e5b94e93233edc7',
                         '1dcaa148b961fa4a8b4d1809',
                         '630155a43b9a7b40811e661a',
                         '12d2dafdb6138e816319a0ef',
                         '77f0288c9c7d26f5619b1c07',
                         '6f3e9137eabeb68fbfc891d3',
                         '0061c05ad069dba8e975b75b',
                         'bd09344a5bfdb2a174c108f3',
                         '7d1ac541696b4b94894affb1',
                         'b64e15f810cb9d3c72f11957',
                         'eb20fbca2355cd0d27698043',
                         '24b0f95294387d6a63df0968',
                         'cbf2f6ed9fc7cfcb9045daab',
                         '8ba9109944bed189b61971e0',
                         '2dc305e13f6de17e0a873c96')),
                       ((1677358738, 640328353, 2651076246, 1109509310,
                         1159399247, 476842274, 2262828114, 622629121,
                         1677510738, 3621436798, 4171883027, 3288336079,
                         3911128341, 24712174, 2819732854, 1186635878),
                        ((0.6645, 0.2467), (0.2238, 0.0715), (0.9153, 0.0809),
                         (0.2069, 0.1433), (0.5759, 0.2914), (0.7314, 0.2564),
                         (0.9153, 0.0552), (0.9153, 0.089), (0.7374, 0.2674),
                         (0.9153, 0.0443), (0.291, 0.1433), (0.2999, 0.1433),
                         (0.5759, 0.3), (0.994, 0.2875), (0.8448, 0.1163),
                         (0.2988, 0.1255)),
                        ('bfce4ffff32c852df3f841b1',
                         'fe8598f83066ca1b0dff2167',
                         'ec488d90a97b35fc5c1ee1e9',
                         '3e31722b48dfc26e53545069',
                         '896e208026dcf6871f629fd9',
                         '302bcbaa2e099189924c7609',
                         '4eca6838e8411be345d773e9',
                         '51fcc96246a5af0fcc74d7a6',
                         '5f13a6208187751c992fe82e',
                         '952fdf9fa462e999a964f2d9',
                         '9eae45534dd9e3a4ec9b36b2',
                         'e4f733f3a11a4a68c5a5f084',
                         'ebe13d823fc89b030d48f263',
                         '9ecbe4c3fa55b2bf35b4fd22',
                         'ea09e756cc192d02cd929e0c',
                         '63b3946850038adfec42a0d8')),
                       ((430660201, 192764186, 599153662, 1963827441,
                         2079243083, 1794281481, 2766141373, 1029018697,
                         2633830214, 4249387551, 3527526455, 183813833,
                         1809896444, 2067659070, 589257308, 701979083),
                        ((0.994, 0.2875), (0.7374, 0.2674), (0.2999, 0.1433),
                         (0.9153, 0.089), (1.0, 0.2875), (1.0, 0.2875),
                         (0.9082, 0.2674), (0.7374, 0.3), (0.3078, 0.1433),
                         (0.2999, 0.169), (1.0, 0.2875), (0.7789, 0.089),
                         (0.2, 0.1433), (0.2, 0.1433), (0.3134, 0.0286),
                         (0.9153, 0.0039)),
                        ('79b0e5ed68a70e63e5cef8fb',
                         'bd80950a4146147d30e78156',
                         'b7d45176449264daaad9402e',
                         '11ef069ca0da1f0fed39facb',
                         '787e5b27da0934ec7e8e5472',
                         '2021e84107e05a6088f552f7',
                         '74694e37d274b86ef1f80750',
                         '3445e1ec7b1bc9143f28fbe8',
                         '0eb004780a6ee30e2a00028c',
                         'dc58b23e17b4ddad6b8fc745',
                         '0b09f34824ba23ad8adafa36',
                         'ce7dbe056c8406f5192dd523',
                         '15911a138fcc1f04251a8648',
                         '77a714880cfd220345aa0fce',
                         '9db338921ea776ff17b6517f',
                         '055a358a809433b2e3f0934b'))],
 'raft-elections': [((1679678445, 1534475689, 278192867, 2354117381,
                      3694801633, 2145619974, 4279672098, 3017178572,
                      3508595031, 3622200387, 3816601057, 886418844,
                      3209889851, 2172454415, 658177925, 3890115422),
                     ((0.3085, 0.3885, 0.1487, 0.1453, 0.1959),
                      (0.4154, 0.3419, 0.0572, 0.2887, 0.131),
                      (0.0663, 0.0953, 0.0425, 0.1357, 0.2308),
                      (0.5076, 0.2395, 0.0004, 0.0856, 0.4032),
                      (0.2088, 0.0738, 0.112, 0.21, 0.2568),
                      (0.4117, 0.1487, 0.1185, 0.0517, 0.0868),
                      (0.1049, 0.3763, 0.0403, 0.0013, 0.2198),
                      (0.4254, 0.1145, 0.1489, 0.0805, 0.0833),
                      (0.4273, 0.196, 0.0437, 0.0369, 0.1776),
                      (0.3869, 0.206, 0.0515, 0.0213, 0.074),
                      (0.3693, 0.3289, 0.0534, 0.1448, 0.1145),
                      (0.2512, 0.0682, 0.1473, 0.0935, 0.0712),
                      (0.5418, 0.1078, 0.0352, 0.1221, 0.3129),
                      (0.1406, 0.1616, 0.0285, 0.1068, 0.2708),
                      (0.0547, 0.1911, 0.0242, 0.0022, 0.1726),
                      (0.2329, 0.2083, 0.0271, 0.1079, 0.1151)),
                     ('bdcc0ea89a87ea78de406524', '70ecc81850a6454394fb1db4',
                      'ab5a2b46b8771b75754c597f', '3f5df8080fefdc8ebccd3ee7',
                      '213b0c2ef5db67c6fa394269', '2df5524c8e2260a60eeccdd5',
                      '92f930272c34b3b464cddc37', '33c59038081c1e55eb4195f5',
                      '61df4564d981d2c2611acc80', 'db0281c2c1e172b7488fb92b',
                      'a72f7db9ea91286e8f2f9ec7', '4f549f753fb2a7440b7d97ac',
                      'b634a76c4cfb3c19b7fce30a', '3a8897f6fe149a583663948d',
                      '7a1ce03de1a67298fc63239a',
                      'f24502c41663d4cc1b285068')),
                    ((1677358738, 640328353, 2651076246, 1109509310,
                      1159399247, 476842274, 2262828114, 622629121,
                      1677510738, 3621436798, 4171883027, 3288336079,
                      3911128341, 24712174, 2819732854, 1186635878),
                     ((0.5418, 0.1078, 0.0352, 0.1221, 0.3129),
                      (0.2329, 0.2083, 0.0271, 0.1079, 0.1151),
                      (0.4254, 0.1145, 0.1489, 0.0805, 0.0833),
                      (0.2512, 0.0682, 0.1473, 0.0935, 0.0712),
                      (0.3085, 0.3885, 0.1487, 0.1453, 0.1959),
                      (0.4154, 0.3419, 0.0572, 0.2887, 0.131),
                      (0.0663, 0.0953, 0.0425, 0.1357, 0.2308),
                      (0.2088, 0.0738, 0.112, 0.21, 0.2568),
                      (0.4195, 0.3566, 0.0257, 0.2319, 0.4432),
                      (0.2512, 0.0682, 0.1315, 0.0935, 0.0712),
                      (0.3085, 0.4, 0.1487, 0.1453, 0.1959),
                      (0.3725, 0.3885, 0.1487, 0.1453, 0.1959),
                      (0.4154, 0.3419, 0.0572, 0.3, 0.131),
                      (0.5959, 0.3834, 0.0994, 0.2195, 0.1942),
                      (0.4933, 0.1551, 0.0734, 0.2728, 0.2205),
                      (0.1179, 0.1673, 0.1383, 0.0305, 0.1384)),
                     ('1c3528aadecb33abfb307e88', 'fa782430ef5decf3b470c838',
                      'faca19122e6209698a657a75', 'e5eb8ce300384c4486b14346',
                      'a5d46afd613069582a13ec22', 'f84f585a598df1f0afd5ab5f',
                      '169b7a00de0457dd85354e4a', 'b6f886e45aa224371f96bfca',
                      '41b477ab3fabfedf1c35ab42', 'f3b2783fe3a91b36c2c79307',
                      '0cc2a474cb3c2c96ffbe9809', '5391777beedfc756b92929f4',
                      'e541953986e397752eef08f4', '8c039a8a2f2b0d3771eb3da2',
                      'adc8b4de64c1943326d8adc5',
                      '42fec827079085050300cb63')),
                    ((430660201, 192764186, 599153662, 1963827441, 2079243083,
                      1794281481, 2766141373, 1029018697, 2633830214,
                      4249387551, 3527526455, 183813833, 1809896444,
                      2067659070, 589257308, 701979083),
                     ((0.4154, 0.3419, 0.0572, 0.2887, 0.131),
                      (0.2088, 0.0738, 0.112, 0.21, 0.2568),
                      (0.5959, 0.3834, 0.0994, 0.2195, 0.1942),
                      (0.4195, 0.3566, 0.0257, 0.2319, 0.4432),
                      (0.4154, 0.3226, 0.0572, 0.2887, 0.131),
                      (0.4154, 0.4, 0.0572, 0.2887, 0.131),
                      (0.2088, 0.054, 0.112, 0.21, 0.2568),
                      (0.2088, 0.0738, 0.1433, 0.21, 0.2568),
                      (0.5959, 0.4, 0.0994, 0.2195, 0.1942),
                      (0.5959, 0.3834, 0.0994, 0.2195, 0.0967),
                      (0.5619, 0.3419, 0.0572, 0.2887, 0.131),
                      (0.3257, 0.3566, 0.0257, 0.2319, 0.4432),
                      (0.5959, 0.4, 0.0994, 0.2195, 0.1942),
                      (0.5959, 0.2747, 0.0994, 0.2195, 0.1942),
                      (0.128, 0.0381, 0.0489, 0.138, 0.4748),
                      (0.4195, 0.3566, 0.0257, 0.2319, 0.5)),
                     ('2cdb47dd64bbdff0b1f197a9', '095c7074a6e14d218fce111a',
                      '3f071694bfa9216ddb4224af', 'e181317cb0ddd43d017bc256',
                      '5d8f3704af1774d1514385ac', 'f29dee45e2ac4326d14e692e',
                      'beb305d4c2dcac3e188b1397', 'd478d6f409fd839fb0853407',
                      'de474e0e212eb501e3b4f716', 'e5ce33ae93b92f5d0fa0cf99',
                      'ec3167d8323fbde06fc89a72', '236397e57d237494c0943986',
                      '2605b92935e35eaaafb9133b', '6618eafbb687e12968d92a8f',
                      '74367e0458892be428446849',
                      '72ad733235d74aea5e60c4d8'))]}

KNOB_COUNT_ANCHORS = {
    'raft-1kx1k/knobs': (
        '88359a2a797bf31eac196f84',
        '9c83af57f255334a01e51f7a',
        'a4b5b968d63a679a034c26b3',
        '3cc6c6f5582e974082c453cf',
        '8a42b91b16f3e29a68a002a1',
        '6adb55d1e5c816841e75f6a6',
        '2b43c55ac69c0b245c03a9c0',
        '91eefc5fb2bbfa6946a24327',
    ),
    'raft-1kx1k/sticky': (
        'f709e87421b7e9f275040df9',
        '9dacccf5cdb79b11370173d9',
        '1f1b29eace6613a6faa305ae',
        '51ed82af5a2e6d2c871c09f0',
        '568d4493398661a8e042436b',
        'aae9150da02ad9599e8e5191',
        'e0bd53ed3cd695c6db21b43f',
        '332a3fbada04632ca49ff284',
    ),
    'pbft-f128/knobs': (
        '67e43c1f80f37cc2846d089f',
        '89fe4be0f0ac8833033f0d42',
        'ab1c5cab4caca11a4dea0779',
        '21beba6790a02ea81f5ae1e6',
        '699c236a171150a5d28b0298',
        'ab865471f2ce31dcf8ec11ce',
        'e9fdd43d22f98a671f0df1f8',
        'c5824b2cb20d10ba48e2ade5',
    ),
    'pbft-f128/switch': (
        '2ceca99a95a714e3553896d2',
        'fa0cb0219ee065aae8f8b260',
        'e1aeb5304b141f3d6874e9c3',
        'ed843385807684be65802cb1',
        'b7a1435a61f98129c27fc96e',
        '750a30ee07a90245da4ffb3f',
        'ba09acf69eee2fa73af3759f',
        'b057b3633910451d212bee38',
    ),
    'pbft-quorum-1k/switch': (
        '2ad7c1705021e598f73db6ef',
        '6f15b9e297221fe3ba364314',
        '1eafb52b024be22aba49eafe',
        '3155ba0b2d14fb2b8261d228',
        'f9b8d0e17745e3674dd65d4b',
        '6d9296777f4decc532c3d2e5',
        '8cc5ac92a74b202fe4d749fe',
        'a39e0f0e41eb17b97d96cd68',
    ),
    'paxos-10kx10k/knobs': (
        'f949c81cb7adffb051877d0e',
        'd08026cc8a18d71867caa22b',
    ),
    'dpos-100k/knobs': (
        '59abd18e0715471d2f5ad97d',
        '2ceb020227ce3b535063f9f6',
        'ea90c0df72e4aacfe7f5150b',
        '94fa225fed097e6582b1228e',
        'bd5212b764e1f82fd967ddbe',
        'fe57baed8b5d0173473b2871',
        '101827b77772e8c2d3465568',
        'f39d3154c8d9230ee15eca3d',
    ),
}


def knob_count_batch(key: str):
    """The full-width batch ``key`` of phase 24: (base, the lanes' configs
    where a lane has one, else None, seeds, kmat)."""
    from consensus_tpu_torch.core import knobs
    from consensus_tpu_torch.core.config import Config
    base_kw, lanes = KNOB_COUNT_BATCHES[key]
    base = Config(**base_kw)
    cfgs = [dataclasses.replace(base, **o) for o in lanes]
    kmat = knob_rows(cfgs)
    for b, t in enumerate(KNOB_COUNT_TARGETS.get(key, ())):
        kmat[b, knobs.KNOB_COLUMNS.index("attack_target")] = t
        # No Config has an out-of-range target.
        cfgs[b] = dataclasses.replace(cfgs[b], attack_target=t) \
            if t < base.n_nodes else None
    return (base, cfgs, np.array(KNOB_COUNT_SEEDS[:len(lanes)], np.uint32),
            kmat)


def knob_count_generation(name: str, g: int):
    """Generation ``g`` of space ``name`` of phase 24: (base, the lanes'
    configs, seeds, kmat)."""
    from consensus_tpu_torch.core.config import Config
    base_kw, fields = KNOB_COUNT_SPACES[name]
    base = Config(**base_kw, n_sweeps=KNOB_POPULATION)
    seeds, values, _ = KNOB_COUNT_GENERATIONS[name][g]
    cfgs = [dataclasses.replace(base, **dict(zip(fields, v)))
            for v in values]
    return base, cfgs, np.array(seeds, np.uint32), knob_rows(cfgs)


def knob_count_run(key: str):
    """A run of phase 24's kernel checks: generation 0 of a space, or a
    full-width batch. Lanes without a Config of their own (out-of-range
    targets) take the base's where a lane's work is counted."""
    if key in KNOB_COUNT_SPACES:
        return knob_count_generation(key, 0)
    base, cfgs, seeds, kmat = knob_count_batch(key)
    return base, [c or base for c in cfgs], seeds, kmat


def knob_count_last(key: str) -> int:
    """The later of the two rounds phase 24 checks of run ``key``: 20, or
    the last round of a run that has fewer (paxos-10kx10k: 15)."""
    base = knob_count_run(key)[0]
    return min(KNOB_ROUNDS[-1], base.n_rounds - 1)


def count_flat_work(name: str, attack: bool, args) -> tuple[float, float]:
    """(bytes, operations) of the flat instance's work on a flat call
    ``args``: phase 22's bound of KAM and KAN, phase 20's of a gate or an
    attack instance (KX, KAB, KM's ATTACK and KL's STICKY instance), else
    phase 16's (a CRASH instance's or the flat one), with ``bound`` swapped
    for the pair."""
    global bound
    saved = bound
    bound = lambda nbytes, ops: (nbytes, ops)   # noqa: E731
    try:
        if name in PBFT_SWITCH_OWN:
            return pbft_switch_bound(name, args)
        sticky = name == "delivery" and len(args) == 8
        if attack or sticky or name in ("dpos_round", "dpos_telemetry"):
            return gate_bound(name, args)
        return crash_kernel_bound(name, args)
    finally:
        bound = saved


def count_knob_bound(name: str, attack: bool, args, cfgs):
    """The least time of a KNOBS instance's work on ``args``: each lane's
    flat work on its slice with its own config, summed, plus the [B, 12]
    table read once."""
    nbytes = ops = 0.0
    for b, cfg in enumerate(cfgs):
        one = lane_slice(knob_flat(name, args, cfg), b, len(cfgs))
        nb, op = count_flat_work(name, attack, one)
        nbytes, ops = nbytes + nb, ops + op
    return bound(nbytes + 8 * 12 * len(cfgs), ops)


def attack_call(name: str, args) -> bool:
    """Whether a KNOBS call runs an ATTACK (KM) or STICKY (KL) instance."""
    if name == "delivery":
        return args[7] is not None
    return name == "dense_elect" and bool(args[0].attack_mode)


def check_knob_count_kernels(dev):
    """Phase 24's kernel rows. Every kernel call of rounds 3 and 20 (or
    the last) of generation 0 of each space of KNOB_COUNT_SPACES and of
    each full-width batch (with telemetry and the recorder), and of that
    round with every row the base's, against the plain versions, exact;
    with every row the base's each KNOBS-instance call also through its
    flat instance, exact. Then each KNOB_COUNT_TIMED instance's time on
    its run's later round, its plain version's and its bound, and on the
    all-base round its time and its flat instance's time and bound."""
    errs = dict.fromkeys(KNOB_COUNT_INSTANCES, 0.0)
    cases = dict.fromkeys(KNOB_COUNT_INSTANCES, 0)
    flat_cases = dict.fromkeys(KNOB_COUNT_INSTANCES, 0)
    timed_keys = {run for _, _, run in KNOB_COUNT_TIMED.values()}
    timed, on_base = {}, {}
    for key in (*KNOB_COUNT_SPACES, *KNOB_COUNT_BATCHES):
        base, cfgs, seeds, kmat = knob_count_run(key)
        last = knob_count_last(key)
        for r in (KNOB_ROUNDS[0], last, *KNOB_COUNT_EXTRA_ROUNDS.get(key, ())):
            calls = capture_knob_round_calls(base, seeds, kmat, r, dev)
            hold_calls(calls, f"{key} round {r}", errs, cases)
            if r == last and key in timed_keys:
                timed[key] = (calls, cfgs)
        calls = capture_knob_round_calls(
            base, seeds, knob_rows([base] * len(seeds)), last, dev)
        hold_calls(calls, f"{key} round {last}, every row the base's", errs,
                   cases)
        for name in KNOB_COUNT_INSTANCES:
            for args in calls.get(name, ()):
                if not knob_instance(name, args):
                    continue
                flat = knob_flat(name, args, base)
                require(max_abs_err(zip(run_wrapper(
                    name, args, lambda a: knob_flat(name, a, base)),
                    run_wrapper(name, flat))) == 0.0,
                    f"{key}: {name}'s KNOBS instance with every row the "
                    "base's disagrees with its flat instance")
                flat_cases[name] += 1
        if key in timed_keys:
            on_base[key] = calls
        torch.cuda.empty_cache()
    for name in KNOB_COUNT_INSTANCES:
        require(cases[name] > 0 and flat_cases[name] > 0,
                f"{name}: no KNOBS-instance call checked")
    rows = []
    for row, (name, attack, key) in KNOB_COUNT_TIMED.items():
        calls, cfgs = timed[key]

        def mine(found, name=name, attack=attack):
            return [a for a in found.get(name, ())
                    if knob_instance(name, a)
                    and attack_call(name, a) == attack]
        got = mine(calls)
        require(bool(got), f"{key}: no KNOBS-instance call of {name}")
        args, same = got[0], mine(on_base[key])[0]
        base = knob_count_run(key)[0]
        flat = knob_flat(name, same, base)
        mod = kernel_module(name)
        reps = reps_for(args)
        rows.append(dict(
            name=row, route="cuda",
            source=f"consensus_tpu_torch/csrc/{name}.cu",
            replaces=KNOB_COUNT_REPLACES[row], max_abs_err=errs[name],
            cases=cases[name], flat_cases=flat_cases[name],
            timed_on=f"{key} round {knob_count_last(key)}",
            ms=graph_ms(getattr(mod, name), args, reps),
            plain_ms=event_ms(getattr(mod, name + "_plain"), args,
                              min(3, reps)),
            bound=count_knob_bound(name, attack, args, cfgs),
            library_ms=None, launches_from=key,
            knobs_on_base_ms=graph_ms(getattr(mod, name), same, reps),
            flat_instance_ms=graph_ms(getattr(mod, name), flat, reps),
            flat_instance_bound=bound(*count_flat_work(name, attack,
                                                       flat))))
    return rows


def knob_count_path(cfg) -> tuple[str, ...]:
    """The kernels a knob batch of base ``cfg`` on a count engine
    launches: a PBFT switch run's path (phase 22's), else its engine's
    telemetry path with KAH (and the PBFT freeze KAI) under a crash."""
    from consensus_tpu_torch.network import runner
    if cfg.protocol == "pbft" and cfg.switch_on:
        return pbft_switch_path(cfg)
    name = runner.engine(cfg).name
    path = crash_path(name, telemetry=True)
    if cfg.crash_on:
        return path
    return path[:-2] if name in ("pbft", "pbft-bcast") else path[:-1]


def require_knob_launches(launches: dict, knob: dict, where: str) -> None:
    """Every wrapper with a KNOBS instance that the run launched ran it,
    and none that it did not launch."""
    for kernel, n in knob.items():
        require((n > 0) == (launches[kernel] > 0),
                f"{where}: {kernel}'s KNOBS instance launched {n} of "
                f"{launches[kernel]} times")


def check_knob_count_generations(card: str, smi: str) -> dict[str, int]:
    """Phase 24's generations: three generations of each space of
    KNOB_COUNT_SPACES as ``run_knob_batch`` replays, counted from 0, as
    phase 23's (:func:`check_knob_generations`). Returns nothing the
    kernels line reads (its rows count the full-width batches)."""
    from consensus_tpu_torch.network import runner
    for name in KNOB_COUNT_SPACES:
        zero_counts()
        captured = runner.captures
        results, walls = [], []
        for g, (_, _, anchors) in enumerate(KNOB_COUNT_GENERATIONS[name]):
            base, cfgs, seeds, kmat = knob_count_generation(name, g)
            t0 = time.perf_counter()
            out, flight = runner.run_knob_batch(base, seeds, kmat,
                                                generation=g)
            walls.append(time.perf_counter() - t0)
            digests = knob_lane_digests(out, flight)
            require(digests == list(anchors),
                    f"{name} generation {g}: lanes "
                    f"{differing(digests, anchors)} differ from the JAX "
                    "anchors")
            results.append((cfgs, seeds, out, flight))
        captures = runner.captures - captured
        launches = runner.launch_counts()
        knob = runner.knob_launch_counts()
        require(captures == 1,
                f"{name}: three generations took {captures} captures")
        require_launched(launches, knob_count_path(base), name)
        require_knob_launches(launches, knob, name)
        production = []
        for g, (cfgs, seeds, out, flight) in enumerate(results):
            for lane in KNOB_PRODUCTION_LANES:
                cfg = dataclasses.replace(cfgs[lane], n_sweeps=1,
                                          seed=int(seeds[lane]))
                stats: dict = {}
                ref = runner.run(cfg, telemetry=True, stats=stats)
                same = all(np.array_equal(out[k][lane], v[0])
                           for k, v in ref.items()) and all(
                    np.array_equal(flight[part][k][lane], v[0])
                    for part in ("windows", "latency")
                    for k, v in stats["flight"][part].items())
                production.append(dict(generation=g, lane=lane,
                                       equal=same))
                require(same, f"{name} generation {g} lane {lane}: the "
                        "production run of its config differs")
        emit("knob_count_generations", space=name,
             population=KNOB_POPULATION, generations=len(results),
             wall_s=walls, captures=captures, launches=launches,
             knob_launches=knob, production=production, card=card,
             power=smi)
        runner.clear_graphs()


def check_knob_count_batches(card: str, smi: str) -> dict[str, int]:
    """Phase 24's full-width batches: each KNOB_COUNT_BATCHES batch as one
    ``run_knob_batch`` replay, counted from 0, as phase 23's
    (:func:`check_knob_batches`). Returns each KNOBS row's launches from
    its KNOB_COUNT_TIMED batch."""
    from consensus_tpu_torch.network import runner
    own: dict = {}
    for key in KNOB_COUNT_BATCHES:
        base, cfgs, seeds, kmat = knob_count_batch(key)
        zero_counts()
        t0 = time.perf_counter()
        out, flight = runner.run_knob_batch(base, seeds, kmat)
        wall = time.perf_counter() - t0
        launches = runner.launch_counts()
        knob = runner.knob_launch_counts()
        digests = knob_lane_digests(out, flight)
        prof = profile_replay(base, run=lambda: runner.knob_batch_device(
            base, seeds, kmat))
        steps = base.n_sweeps * base.n_nodes * base.n_rounds
        row = dict(
            digests=digests, digests_ok=digests == list(
                KNOB_COUNT_ANCHORS[key]),
            wall_s=wall, launches=launches, knob_launches=knob,
            steps_per_sec=steps / (min(prof["replay_wall_ms"]) / 1e3),
            **{k: prof[k] for k in (
                "replay_wall_ms", "busy_share", "unprofiled_busy_share",
                "device_ms", "device_launches")},
            device_ops_per_round=prof["launches_per_round"],
            hand_kernel_ms={k: v for k, v in prof["hand_kernel_ms"].items()
                            if v})
        emit("knob_count_batch", run=key, **row, card=card, power=smi)
        require(row["digests_ok"],
                f"{key}: lanes "
                f"{differing(digests, KNOB_COUNT_ANCHORS[key])} differ "
                "from the JAX anchors")
        require_launched(launches, knob_count_path(base), key)
        require_knob_launches(launches, knob, key)
        for row_name, (name, _, run) in KNOB_COUNT_TIMED.items():
            if run == key:
                own[row_name] = knob[name]
        runner.clear_graphs()
    return own


# --- phase 25: the knob batch (K23) on capped Raft, and on dense Raft and
# Paxos under the switch ---------------------------------------------------

# The wrappers whose KNOBS instances this phase adds, and their sources.
KNOB_CAPPED_INSTANCES = ("candidacy", "delivery_edges", "dense_elect",
                         "paxos_promise", "paxos_accept_learn")
KNOB_CAPPED_REPLACES = {
    "candidacy (knobs)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft_sparse.py:202, 236-253 P0-P1 under a "
    "KnobView",
    "candidacy (knobs, crash)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft_sparse.py:209-227 §6c P0-P1 under a "
    "KnobView",
    "candidacy (knobs, elect)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft_sparse.py:186, 268-276 the elect jam's "
    "word under a KnobView",
    "candidacy (knobs, sticky)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft_sparse.py:186-189, 238-239 the sticky "
    "activation under a KnobView",
    "delivery_edges (knobs, src)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft_sparse.py:191-192 dedge under a KnobView",
    "delivery_edges (knobs, dst)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft_sparse.py:191-192 dedge under a KnobView",
    "delivery_edges (knobs, delay, crash)": "consensus_tpu/network/"
    "runner.py:1019 _knob_batch_jit; engines/raft_sparse.py:191-195 dedge "
    "with §A.2 and §6c under a KnobView",
    "delivery_edges (knobs, attack)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft_sparse.py:197-199 the sticky jam under a "
    "KnobView",
    "delivery_edges (knobs, switch)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft_sparse.py:301-335 the switch's responses "
    "under a KnobView",
    "dense_elect (knobs, switch)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/raft.py:367-400 P2c over the switch under a "
    "KnobView",
    "paxos_promise (knobs, switch)": "consensus_tpu/network/runner.py:1019 "
    "_knob_batch_jit; engines/paxos.py:153-176 promises over the switch "
    "under a KnobView",
    "paxos_accept_learn (knobs, switch)": "consensus_tpu/network/"
    "runner.py:1019 _knob_batch_jit; engines/paxos.py:153-176 accepts over "
    "the switch under a KnobView"}
# The row of each KNOBS instance: its wrapper, the batch whose later round's
# call is timed and whose run counts its launches, and which of the round's
# calls (KB: a src, dst or switch call; the others have one).
KNOB_CAPPED_TIMED = {
    "candidacy (knobs)": ("candidacy", "raft-100k/base", "any"),
    "candidacy (knobs, crash)": ("candidacy", "raft-100k/elections", "any"),
    "candidacy (knobs, elect)": ("candidacy", "raft-100k/switch", "any"),
    "candidacy (knobs, sticky)": ("candidacy", "raft-100k/sticky", "any"),
    "delivery_edges (knobs, src)": ("delivery_edges", "raft-100k/base",
                                    "src"),
    "delivery_edges (knobs, dst)": ("delivery_edges", "raft-100k/base",
                                    "dst"),
    "delivery_edges (knobs, delay, crash)": ("delivery_edges",
                                             "raft-100k/elections", "src"),
    "delivery_edges (knobs, attack)": ("delivery_edges", "raft-100k/sticky",
                                       "src"),
    "delivery_edges (knobs, switch)": ("delivery_edges", "raft-100k/switch",
                                       "switch"),
    "dense_elect (knobs, switch)": ("dense_elect", "raft-1kx1k/switch",
                                    "switch"),
    "paxos_promise (knobs, switch)": ("paxos_promise",
                                      "paxos-10kx10k/switch", "switch"),
    "paxos_accept_learn (knobs, switch)": ("paxos_accept_learn",
                                           "paxos-10kx10k/switch", "switch")}
# The six batches: raft-100k's flagship as it stands (every row the base's,
# its own seeds: its lanes are the flagship's sweeps), under raft-elections'
# gates (COUNT_GATES), under the sticky attack on node 3 and, with the elect
# attack and partitions, under the switch (K = 8); raft-1kx1k under the
# switch and the sticky attack (cut to 128 rounds, as phase 24's); and
# paxos-10kx10k under the switch with COUNT_GATES at 2 lanes (phase 24's
# cut: 2 GB a lane). Each with 8-round windows and its lanes' overrides:
# lane 0 the base's, and 8 distinct rows but in the first batch.
KNOB_CAPPED_BATCHES = {
    "raft-100k/base": (
        dict(protocol="raft", n_nodes=N, n_rounds=64, n_sweeps=B,
             log_capacity=L, max_entries=100, max_active=A, seed=6,
             drop_rate=0.01, churn_rate=0.001, telemetry_window=WINDOW),
        ({},) * B),
    "raft-100k/elections": (
        dict(protocol="raft", n_nodes=N, n_rounds=64, n_sweeps=B,
             log_capacity=L, max_entries=100, max_active=A, seed=6,
             **COUNT_GATES, telemetry_window=WINDOW),
        ({}, dict(partition_rate=0.0), dict(drop_rate=0.05),
         dict(crash_prob=0.3, recover_prob=0.1), dict(churn_rate=0.1),
         dict(drop_rate=0.5, partition_rate=0.3),
         dict(crash_prob=0.0, churn_rate=0.0),
         dict(recover_prob=0.9, drop_rate=0.15))),
    "raft-100k/sticky": (
        dict(protocol="raft", n_nodes=N, n_rounds=64, n_sweeps=B,
             log_capacity=L, max_entries=100, max_active=A, seed=6,
             drop_rate=0.01, churn_rate=0.001, **STICKY_BASE,
             telemetry_window=WINDOW),
        ({}, dict(attack_rate=1.0), dict(attack_rate=0.5),
         dict(drop_rate=0.05), dict(churn_rate=0.01),
         dict(attack_rate=0.7, drop_rate=0.02), dict(attack_rate=0.0),
         dict(attack_rate=1.0, churn_rate=0.05))),
    "raft-100k/switch": (
        dict(protocol="raft", n_nodes=N, n_rounds=64, n_sweeps=B,
             log_capacity=L, max_entries=100, max_active=A, seed=6,
             drop_rate=0.01, churn_rate=0.001, partition_rate=0.05,
             attack="elect", attack_rate=0.3, **SWITCH_KNOBS,
             telemetry_window=WINDOW),
        ({}, dict(attack_rate=0.0), dict(drop_rate=0.1),
         dict(partition_rate=0.0), dict(attack_rate=0.9),
         dict(drop_rate=0.3, partition_rate=0.2),
         dict(attack_rate=0.05, drop_rate=0.02), dict(partition_rate=0.3))),
    "raft-1kx1k/switch": (
        dict(protocol="raft", log_capacity=L, max_entries=100,
             drop_rate=0.01, churn_rate=0.001,
             **DENSE_CONFIGS["raft-1kx1k"], **STICKY_BASE, **SWITCH_KNOBS,
             telemetry_window=WINDOW) | dict(n_rounds=128),
        ({}, dict(attack_rate=0.0), dict(attack_rate=1.0),
         dict(attack_rate=0.5), dict(drop_rate=0.05), dict(churn_rate=0.01),
         dict(attack_rate=1.0, drop_rate=0.1),
         dict(attack_rate=0.7, drop_rate=0.02))),
    "paxos-10kx10k/switch": (
        dict(PAXOS_FLAGSHIP, **COUNT_GATES, **SWITCH_KNOBS, n_sweeps=2,
             telemetry_window=WINDOW),
        ({}, dict(drop_rate=0.1, partition_rate=0.0))),
}
# The sticky batches' targets, by lane (the base's is 3): in range, N - 1,
# and N + 3, 0xFFFFFFFD and 0xFFFFFFFF out of range (no Config has them).
KNOB_CAPPED_TARGETS = {
    "raft-100k/sticky": (3, 0, N - 1, N + 3, 0xFFFFFFFD, 0xFFFFFFFF, 3, 0),
    "raft-1kx1k/switch": (3, 0, 1023, 1024 + 3, 0xFFFFFFFD, 0xFFFFFFFF, 5,
                          3)}
# The lanes' seeds: the flagship's own (make_seeds: 6 to 13) in the first
# batch, KNOB_COUNT_SEEDS in the others, but in the sticky batches, where
# the lanes whose target is node 3 or 0 take seeds under which that node
# draws the least initial timeout of its lane, and is the lowest id to, so
# that it stands first and wins (raft-1kx1k's lane 1 runs no attack).
KNOB_CAPPED_SEEDS = {"raft-100k/base": tuple(range(6, 6 + B)),
                     "raft-100k/sticky": (2, 8, 3, 77, 1 << 31, 12345, 15,
                                          9),
                     "raft-1kx1k/switch": (2, 8, 3, 77, 1 << 31, 12345, 9,
                                           15)}
# Each batch's lane digests (knob_lane_digests): raft-100k/base is held to
# the flagship's digest instead (FLAGSHIP_DIGEST, of the decided logs of
# all 8 lanes, as simulator.run packs them). The others from the JAX
# package's run_knob_batch, run one lane at a time (a one-lane base and the
# lane's seed and row: the lanes of a batch are independent, and one lane
# of the raft-100k shape holds 100 MB of logs where eight would hold 800),
# made on the CPU (6-17 s a raft-100k lane, 8-25 s a raft-1kx1k one, 2 456
# and 2 320 s the two paxos-10kx10k lanes, on 8 cores) by
#
#   JAX_PLATFORMS=cpu python3 - <<'EOF'
#   import dataclasses, json, chip_smoke
#   from consensus_tpu import Config
#   from consensus_tpu.network import runner, simulator
#   anchors = {}
#   for key in chip_smoke.KNOB_CAPPED_BATCHES:
#       if key == "raft-100k/base":
#           continue
#       base, _, seeds, kmat = chip_smoke.knob_capped_batch(key)
#       one = Config(**dataclasses.asdict(dataclasses.replace(
#           base, n_sweeps=1)))
#       anchors[key] = []
#       for b in range(len(seeds)):
#           out, flight = runner.run_knob_batch(
#               one, simulator.engine_def(one), seeds[b:b + 1],
#               kmat[b:b + 1])
#           anchors[key] += chip_smoke.knob_lane_digests(out, flight)
#   print(json.dumps(anchors))
#   EOF
#
KNOB_CAPPED_ANCHORS = {
    'raft-100k/elections': (
        'cb9e18caa7a40e29845d60cf',
        'c9f26e42fd512bf2ecd7f56d',
        '0a7f2272807c42f1e075e5fe',
        '16047e61a3a12d54b3f21ac5',
        'fae46d0b0264488674d6ff89',
        '12fa50edc82823297eafc2f7',
        'bd59ce799d3eee24b60f5117',
        '5e366562cb5e13d61bdfd903',
    ),
    'raft-100k/sticky': (
        '53e25821eaf138577c75cae4',
        'a392f66d0979a3d5a61f4b65',
        '08c0ef3da6a6111204dbeb0d',
        '070d0059bbdda581df028546',
        '978d0b71156414b6ae037205',
        'fc37eae33563953a31416e0f',
        'abb656a9c33042788f559ec3',
        '4076a56f09a057ebb56834b6',
    ),
    'raft-100k/switch': (
        'f2a958ad59c8b9d118259ed7',
        '301971c1fd28cb2b77904ca4',
        '4b235b4b7474b0beb78c13a8',
        'e3316fc7e98e1e4af2d8c85f',
        'e88c7a0cd180cbfae0e66649',
        '19811484db51cd6001b8356a',
        '187864c04f5689fc59e98712',
        'fff653f99b3e2b192710885c',
    ),
    'raft-1kx1k/switch': (
        '185f5a51eb7a0ac0bb525735',
        '4b1c54cfb7569f3020c2625f',
        '5fc54d71d000e7e50c374d09',
        '3dd7c5af48f337c0e690e3e0',
        '6d59d59f46f5cddb14827e44',
        'a226f0dec7a7796cf34a6183',
        'a62daa294bbf29a9bfb43718',
        'b04a4d54e070c0c04e410a4a',
    ),
    'paxos-10kx10k/switch': (
        '56759673829e2fc01ab9162b',
        'fdef88978124737ac9a99519',
    ),
}


def knob_capped_batch(key: str):
    """Phase 25's batch ``key``: (base, the lanes' configs where a lane has
    one, else None, seeds, kmat)."""
    from consensus_tpu_torch.core import knobs
    from consensus_tpu_torch.core.config import Config
    base_kw, lanes = KNOB_CAPPED_BATCHES[key]
    base = Config(**base_kw)
    cfgs = [dataclasses.replace(base, **o) for o in lanes]
    kmat = knob_rows(cfgs)
    for b, t in enumerate(KNOB_CAPPED_TARGETS.get(key, ())):
        kmat[b, knobs.KNOB_COLUMNS.index("attack_target")] = t
        # No Config has an out-of-range target.
        cfgs[b] = dataclasses.replace(cfgs[b], attack_target=t) \
            if t < base.n_nodes else None
    seeds = KNOB_CAPPED_SEEDS.get(key, KNOB_COUNT_SEEDS)[:len(lanes)]
    return base, cfgs, np.array(seeds, np.uint32), kmat


def knob_capped_last(key: str) -> int:
    """The later of the two rounds phase 25 checks of batch ``key``: 20,
    or the last round of a run that has fewer (paxos-10kx10k: 15)."""
    return min(KNOB_ROUNDS[-1], knob_capped_batch(key)[0].n_rounds - 1)


def capped_knob_instance(name: str, args) -> bool:
    """Whether this call of wrapper ``name`` runs its KNOBS instance: KB's
    12th argument is the table, the others' Config is a KnobView."""
    from consensus_tpu_torch.core import knobs
    if name == "delivery_edges":
        return len(args) > 11 and args[11] is not None
    return isinstance(args[0], knobs.KnobView)


def capped_flat(name: str, args, cfg):
    """``args`` of a KNOBS-instance call through the flat instance with
    ``cfg``'s cutoffs: for KB its drop and partition cutoffs, a sticky
    attack's target (an elect jam keeps its -1) and no table, for the
    others ``cfg`` in place of the view."""
    one = list(args)
    if name == "delivery_edges":
        one[4], one[5] = cfg.drop_cutoff, cfg.partition_cutoff
        if len(one) > 9 and one[9] is not None and one[9][1] >= 0:
            one[9] = (one[9][0], cfg.attack_target)
        one = one[:11]
        while len(one) > 8 and one[-1] is None:
            one.pop()
    else:
        one[0] = cfg
    return tuple(one)


def capped_pick(name: str, args, pick: str) -> bool:
    """Whether a call of wrapper ``name`` is the one a row times: KB's src,
    dst (not over the switch) or switch call, any other call."""
    if pick == "any":
        return True
    sw = name != "delivery_edges" or (len(args) > 10
                                      and args[10] is not None)
    if pick == "switch":
        return sw
    return not sw and bool(args[6]) == (pick == "src")


def candidacy_work(args) -> tuple[float, float]:
    """(bytes, operations) of KE on ``args``: phase 3's count (54 bytes and
    20 operations a node, and a Threefry draw for each node whose timer
    the round resets) on the call's own shape, plus the flag byte a node of
    a CRASH instance and, under an attack, each lane's activation draw and
    its word written."""
    from consensus_tpu_torch.engines import raft_sparse as rs
    cfg, term = args[0], args[3]
    b, n = term.shape
    moved = int(rs.candidacy_plain(*clone_args(args))[5].sum())
    flags = args[10] if len(args) > 10 else None
    attack = b if cfg.attack_mode else 0
    return (54 * b * n + (0 if flags is None else b * n) + 4 * attack,
            20 * b * n + THREEFRY_OPS * (moved + attack))


def capped_flat_work(name: str, args) -> tuple[float, float]:
    """(bytes, operations) of the flat instance's work on a flat call
    ``args``: KE's :func:`candidacy_work`; a SWITCH instance's phase-21
    bound (:func:`switch_bound`); KB's phase-3 count with the flag byte a
    node of a CRASH instance, the attack word of an ATTACK one and the
    draws of the §A.2 loop these inputs need; with ``bound`` swapped for
    the pair."""
    global bound
    if name == "candidacy":
        return candidacy_work(args)
    saved = bound
    bound = lambda nbytes, ops: (nbytes, ops)   # noqa: E731
    try:
        if name != "delivery_edges" or (len(args) > 10
                                        and args[10] is not None):
            return switch_bound(name, args)
        nbytes, ops = flat_work(name, args)
        if len(args) > 8 and args[8] is not None:
            nbytes += args[8].numel()
        if len(args) > 9 and args[9] is not None:
            nbytes += 4 * args[2].shape[0]
        if args[7]:
            ops += EDGE_OPS * delay_draws(name, args)
        return nbytes, ops
    finally:
        bound = saved


def capped_knob_bound(name: str, args, cfgs) -> tuple[float, str]:
    """The least time of a KNOBS instance's work on ``args``: each lane's
    flat work on its slice with its own config (``cfgs``; a lane without
    one, an out-of-range target's, takes the base's), summed, plus the
    [B, 12] table read once; for KE the KNOBS call's own count, whose
    plain version reads each lane's cutoffs."""
    if name == "candidacy":
        nbytes, ops = candidacy_work(args)
        return bound(nbytes + 8 * 12 * len(cfgs), ops)
    nbytes = ops = 0.0
    for b, cfg in enumerate(cfgs):
        one = lane_slice(capped_flat(name, args, cfg), b, len(cfgs))
        nb, op = capped_flat_work(name, one)
        nbytes, ops = nbytes + nb, ops + op
    return bound(nbytes + 8 * 12 * len(cfgs), ops)


def check_knob_capped_kernels(dev):
    """Phase 25's kernel rows. Every kernel call of rounds 3 and 20 (or
    the last) of each KNOB_CAPPED_BATCHES batch (with telemetry and the
    recorder), and of that round with every row the base's, against the
    plain versions, exact; with every row the base's each KNOBS-instance
    call also through its flat instance, exact. Then each
    KNOB_CAPPED_TIMED row's time on its batch's later round, its plain
    version's and its bound, and on the all-base round its time and its
    flat instance's time and bound."""
    errs = dict.fromkeys(KNOB_CAPPED_INSTANCES, 0.0)
    cases = dict.fromkeys(KNOB_CAPPED_INSTANCES, 0)
    flat_cases = dict.fromkeys(KNOB_CAPPED_INSTANCES, 0)
    rows = []
    for key in KNOB_CAPPED_BATCHES:
        base, cfgs, seeds, kmat = knob_capped_batch(key)
        cfgs = [c or base for c in cfgs]
        last = knob_capped_last(key)
        for r in (KNOB_ROUNDS[0], last):
            calls = capture_knob_round_calls(base, seeds, kmat, r, dev)
            hold_calls(calls, f"{key} round {r}", errs, cases)
        on_base = capture_knob_round_calls(
            base, seeds, knob_rows([base] * len(seeds)), last, dev)
        hold_calls(on_base, f"{key} round {last}, every row the base's",
                   errs, cases)
        for name in KNOB_CAPPED_INSTANCES:
            for args in on_base.get(name, ()):
                if not capped_knob_instance(name, args):
                    continue
                flat = capped_flat(name, args, base)
                require(max_abs_err(zip(run_wrapper(
                    name, args, lambda a: capped_flat(name, a, base)),
                    run_wrapper(name, flat))) == 0.0,
                    f"{key}: {name}'s KNOBS instance with every row the "
                    "base's disagrees with its flat instance")
                flat_cases[name] += 1
        for row, (name, run, pick) in KNOB_CAPPED_TIMED.items():
            if run != key:
                continue

            def mine(found, name=name, pick=pick):
                return [a for a in found.get(name, ())
                        if capped_knob_instance(name, a)
                        and capped_pick(name, a, pick)]
            got = mine(calls)
            require(bool(got), f"{key}: no KNOBS-instance call of {name} "
                    f"({pick})")
            args, same = got[0], mine(on_base)[0]
            flat = capped_flat(name, same, base)
            mod = kernel_module(name)
            reps = reps_for(args)
            rows.append(dict(
                name=row, route="cuda",
                source=f"consensus_tpu_torch/csrc/{name}.cu",
                replaces=KNOB_CAPPED_REPLACES[row], timed_on=f"{key} round "
                f"{last}", ms=graph_ms(getattr(mod, name), args, reps),
                plain_ms=event_ms(getattr(mod, name + "_plain"), args,
                                  min(3, reps)),
                bound=capped_knob_bound(name, args, cfgs), library_ms=None,
                launches_from=key,
                knobs_on_base_ms=graph_ms(getattr(mod, name), same, reps),
                flat_instance_ms=graph_ms(getattr(mod, name), flat, reps),
                flat_instance_bound=bound(*capped_flat_work(name, flat))))
        del calls, on_base
        torch.cuda.empty_cache()
    for name in KNOB_CAPPED_INSTANCES:
        require(cases[name] > 0 and flat_cases[name] > 0,
                f"{name}: no KNOBS-instance call checked")
    for k in rows:
        name = KNOB_CAPPED_TIMED[k["name"]][0]
        k.update(max_abs_err=errs[name], cases=cases[name],
                 flat_cases=flat_cases[name])
    return rows


def knob_capped_path(cfg) -> tuple[str, ...]:
    """The kernels a knob batch of base ``cfg`` launches: a switch run's
    path (phase 21's) with KAH under a crash, else phase 20's gate path
    (the capped engine's telemetry path, with KAH under a crash)."""
    path = gate_path(cfg)
    if cfg.switch_on:
        path += SWITCH_OWN
    return path


def check_knob_capped_batches(card: str, smi: str) -> dict[str, int]:
    """Phase 25's batches: each KNOB_CAPPED_BATCHES batch as one
    ``run_knob_batch`` replay, counted from 0: the first's decided logs
    against the flagship's digest, every other lane's digest against its
    JAX anchor, the path's kernels launched and each KNOBS instance on it;
    with each replay's wall, busy share and device operations a round
    (:func:`profile_replay`). Returns each KNOBS row's launches from its
    batch."""
    from consensus_tpu_torch.core import serialize
    from consensus_tpu_torch.network import runner, simulator
    own: dict = {}
    for key in KNOB_CAPPED_BATCHES:
        base, cfgs, seeds, kmat = knob_capped_batch(key)
        zero_counts()
        t0 = time.perf_counter()
        out, flight = runner.run_knob_batch(base, seeds, kmat)
        wall = time.perf_counter() - t0
        launches = runner.launch_counts()
        knob = runner.knob_launch_counts()
        digests = knob_lane_digests(out, flight)
        if key == "raft-100k/base":
            got = serialize.digest(simulator.decided_payload(base, out)[3])
            ok, want = got == FLAGSHIP_DIGEST, FLAGSHIP_DIGEST
        else:
            ok, want = digests == list(KNOB_CAPPED_ANCHORS[key]), None
        prof = profile_replay(base, run=lambda: runner.knob_batch_device(
            base, seeds, kmat))
        steps = base.n_sweeps * base.n_nodes * base.n_rounds
        row = dict(
            digests=digests, digests_ok=ok,
            **({} if want is None else dict(digest=got)),
            attack_rounds=flight["windows"]["attack_rounds"].sum(1).tolist()
            if "attack_rounds" in flight["windows"] else None,
            wall_s=wall, launches=launches, knob_launches=knob,
            steps_per_sec=steps / (min(prof["replay_wall_ms"]) / 1e3),
            **{k: prof[k] for k in (
                "replay_wall_ms", "busy_share", "unprofiled_busy_share",
                "device_ms", "device_launches")},
            device_ops_per_round=prof["launches_per_round"],
            hand_kernel_ms={k: v for k, v in prof["hand_kernel_ms"].items()
                            if v})
        emit("knob_capped_batch", run=key, **row, card=card, power=smi)
        require(ok, f"{key}: the flagship digest differs" if want else
                f"{key}: lanes "
                f"{differing(digests, KNOB_CAPPED_ANCHORS[key])} differ "
                "from the JAX anchors")
        require_launched(launches, knob_capped_path(base), key)
        require_knob_launches(launches, knob, key)
        for row_name, (name, run, _) in KNOB_CAPPED_TIMED.items():
            if run == key:
                own[row_name] = knob[name]
        runner.clear_graphs()
    return own


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # Keep CUPTI set up between profiler sessions: tearing it down and
    # setting it up again, with CUDA graphs in the process, loses device
    # records (PyTorch sets the same for its own CUDA-graph profiling).
    os.environ["TEARDOWN_CUPTI"] = "0"
    from consensus_tpu_torch import _build
    from consensus_tpu_torch.network import runner, simulator

    # 1. device
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", kind=card, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    seconds = _build.build()
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        print(f"--- nvcc {name}\n{log.read_text()}", file=sys.stderr)
    # KB's 48 instances make delivery_edges.cu one of the longest builds.
    emit("build", wall_s=time.perf_counter() - t0, seconds=seconds,
         delivery_edges_s=seconds["delivery_edges"],
         longest=max(seconds, key=seconds.get))

    # 3. kernels
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    cfg = flagship_config()
    telemetry_rows, flag_err = check_telemetry_kernels(dev, gen)
    kernels = [check_random_u32(dev, gen), check_delivery_edges(dev, gen),
               check_top_active(dev, gen),
               *check_phases(dev, gen, flagship_config(
                   telemetry_window=WINDOW)),
               *check_dense_kernels(dev, gen), *check_pbft_kernels(dev, gen),
               *check_bcast_kernels(dev, gen),
               *check_dpos_paxos_kernels(dev, gen), *telemetry_rows,
               *check_hotstuff_kernels(dev, gen)]
    torch.cuda.synchronize()
    # The §6c kernels (KAH, KAI) are phase 16's, KAJ phase 17's, KAK
    # phase 19's, KAL phase 21's, KAM and KAN phase 22's.
    require(sorted(k["name"] for k in kernels)
            == sorted(set(_build.SOURCES)
                      - set(CRASH_OWN + DESYNC_OWN + BYZ_BCAST_OWN
                            + SWITCH_OWN + PBFT_SWITCH_OWN)),
            "phase 3 does not check every kernel of csrc")
    # KQ, KT, KX, KY and KZ with their optional outputs, on the telemetry
    # runs' rounds.
    emit("kernel_flags", max_abs_err=flag_err)
    for k in kernels:
        if k["name"] in flag_err:
            k["max_abs_err"] = max(k["max_abs_err"], flag_err[k["name"]])
    for k in kernels:
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        emit("kernel", **k)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} disagrees with its plain version")

    # 4. flagship: the main path, counted from zero, replayed as a graph.
    for mod, name in runner.KERNELS:
        getattr(mod, name).launches = 0
    memory = memory_use(lambda: simulator.run(cfg))
    res = memory.pop("result")
    launches = runner.launch_counts()
    require(res.counts.shape == (B, N) and res.rec_a.shape == (B, N, L),
            "decided logs of the wrong shape")
    emit("flagship", digest=res.digest, digest_ok=res.digest == FLAGSHIP_DIGEST,
         steps_per_sec=res.steps_per_sec, wall_s=res.wall_s,
         max_commit=int(res.counts.max()), launches=launches, **memory,
         card=card, power=smi)
    require(res.digest == FLAGSHIP_DIGEST,
            f"flagship digest {res.digest} != {FLAGSHIP_DIGEST}")
    for name, n in launches.items():
        require((n > 0) == (name not in NOT_CAPPED + ("telemetry",)),
                f"kernel {name}: {n} launches on the main path")
    check_seed_sharing(cfg, FLAGSHIP_DIGEST)

    # 5. telemetry and the flight recorder.
    launches["telemetry"] = check_telemetry(card, smi)

    # 6. the dense engine: BASELINE configs raft-5node and raft-1kx1k.
    dense = check_dense_path(card, smi)
    launches.update({name: dense[name] for name in DENSE})
    launches["dense_telemetry"] = check_dense_telemetry(card, smi)

    # 7. bench.py's shape.
    bench_cfg = flagship_config(max_entries=L - 16, seed=42)
    memory = memory_use(lambda: simulator.run(bench_cfg))
    bench = memory.pop("result")
    emit("bench", steps_per_sec=bench.steps_per_sec, wall_s=bench.wall_s,
         max_commit=int(bench.counts.max()), digest=bench.digest, **memory,
         **profile_replay(bench_cfg), card=card, power=smi)
    require(int(bench.counts.max()) > 0, "bench shape committed nothing")

    # 8. where the flagship's device time goes, and what runs in each phase
    # of an eager capped round and an eager dense round.
    prof = profile_replay(cfg)
    by_phase = plain_ops_by_phase(flagship_config(telemetry_window=WINDOW),
                                  telemetry=True)
    dense_by_phase = plain_ops_by_phase(
        dense_config("raft-1kx1k", n_rounds=16, telemetry_window=WINDOW),
        telemetry=True)
    pbft_by_phase = plain_ops_by_phase(ladder_config(n_rounds=8),
                                       rungs=LADDER)
    bcast_by_phase = plain_ops_by_phase(bcast_config(n_rounds=4))
    dpos_by_phase = plain_ops_by_phase(protocol_config(DPOS_FLAGSHIP))
    paxos_by_phase = plain_ops_by_phase(protocol_config(PAXOS_FLAGSHIP,
                                                        n_rounds=4))
    hotstuff_by_phase = plain_ops_by_phase(protocol_config(
        HOTSTUFF_FLAGSHIP))
    # The same engines with telemetry and the flight recorder (KAA-KAC).
    telemetry_by_phase = {
        name: plain_ops_by_phase(cfg, telemetry=True) for name, cfg in (
            ("pbft-f128", pbft_config(128, telemetry_window=WINDOW)),
            ("pbft-100k-bcast", bcast_config(n_rounds=4,
                                             telemetry_window=WINDOW)),
            ("dpos-100k", protocol_config(DPOS_FLAGSHIP,
                                          telemetry_window=WINDOW)),
            ("paxos-10kx10k", protocol_config(
                PAXOS_FLAGSHIP, n_rounds=4, telemetry_window=WINDOW)),
            ("hotstuff-100k", protocol_config(HOTSTUFF_FLAGSHIP,
                                              telemetry_window=WINDOW)))}
    emit("profile", card=card, power=smi, **prof,
         plain_ops_by_phase=by_phase, dense_plain_ops_by_phase=dense_by_phase,
         pbft_plain_ops_by_phase=pbft_by_phase,
         bcast_plain_ops_by_phase=bcast_by_phase,
         dpos_plain_ops_by_phase=dpos_by_phase,
         paxos_plain_ops_by_phase=paxos_by_phase,
         hotstuff_plain_ops_by_phase=hotstuff_by_phase,
         telemetry_plain_ops_by_phase=telemetry_by_phase,
         profiler_sessions_redone=REDONE)
    for place, found in [*by_phase.items(), *dense_by_phase.items(),
                         *pbft_by_phase.items(), *bcast_by_phase.items(),
                         *dpos_by_phase.items(), *paxos_by_phase.items(),
                         *hotstuff_by_phase.items(),
                         *(item for ops in telemetry_by_phase.values()
                           for item in ops.items())]:
        require(place == "init" or set(found) <= set(ZEROING),
                f"PyTorch compute ops on the device in {place}: {found}")

    # 9. dense PBFT: the standalone rows and the f-ladder.
    pbft_launches = check_pbft_path(card, smi)
    launches.update({name: pbft_launches[name] for name in PBFT})

    # 10. the §6b broadcast engine: pbft-100k-bcast and two bcast ladders.
    bcast_launches = check_bcast_path(card, smi)
    launches.update({name: bcast_launches[name] for name in BCAST})

    # 11. DPoS: dpos-100k and a hostile run.
    dpos_launches = check_dpos_path(card, smi)
    launches.update({name: dpos_launches[name] for name in DPOS})

    # 12. Paxos: paxos-10kx10k and a hostile run.
    paxos_launches = check_paxos_path(card, smi)
    launches.update({name: paxos_launches[name] for name in PAXOS})

    # 13. Telemetry on dense and §6b PBFT, DPoS, Paxos and HotStuff.
    launches.update(check_bft_telemetry(card, smi))

    # 14. HotStuff: hotstuff-100k, hotstuff-1k and a hostile run.
    hotstuff_launches = check_hotstuff_path(card, smi)
    launches.update({name: hotstuff_launches[name] for name in HOTSTUFF_ALL})

    # 15. SPEC §A.2 delayed retransmission: the six kernels that draw
    # delivery against their plain versions, then the storm runs.
    for k in check_delay_kernels(dev, gen):
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        k["bound_delay_0_ms"], k["bound_delay_0_by"] = k.pop("bound_delay_0")
        emit("delay_kernel", **k, card=card, power=smi)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} with a delay disagrees with its plain version")
    check_storm_runs(card, smi)

    # 16. SPEC §6c crash-recover: KAH, KAI and the round-20 calls of every
    # kernel of the six engines' crash runs against their plain versions,
    # then the crash runs.
    for k in check_crash_kernels(dev, gen):
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        if k["name"] in CRASH_OWN:
            kernels.append(k)
            require(k["max_abs_err"] == 0.0,
                    f"{k['name']} disagrees with its plain version")
        emit("crash_kernel", **k, card=card, power=smi)
    launches.update(check_crash_runs(card, smi))

    # 17. SPEC §B view desync (dense and §6b PBFT, both ladders, HotStuff)
    # and SPEC §6c on HotStuff: every kernel call of rounds 3 and 20 of
    # the runs, the ladders' KQ and KT and built HotStuff states against
    # the plain versions, then the runs.
    for k in check_desync_kernels(dev):
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        if "flat_instance_bound" in k:
            (k["flat_instance_bound_ms"],
             k["flat_instance_bound_by"]) = k.pop("flat_instance_bound")
        if k["name"] in DESYNC_OWN:
            kernels.append(k)
        emit("desync_kernel", **k, card=card, power=smi)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} under desync or crash disagrees with its "
                "plain version")
    launches.update(check_desync_runs(card, smi))

    # 18. SPEC §3c/§7c byzantine nodes (both Raft engines, dense PBFT and
    # its ladder, HotStuff): every kernel call of rounds 3 and 20 of the
    # runs, the ladders' KQ-KS and built forked HotStuff lanes and PBFT
    # rounds against the plain versions, then the runs.
    for k in check_byz_kernels(dev):
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        (k["flat_instance_bound_ms"],
         k["flat_instance_bound_by"]) = k.pop("flat_instance_bound")
        emit("byz_kernel", **k, card=card, power=smi)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} with byzantine nodes disagrees with its plain "
                "version")
    check_byz_runs(card, smi)

    # 19. SPEC §3c/§7c byzantine nodes on the §6b engine and its bcast
    # ladders: every kernel call of rounds 3 and 20 of the runs and the
    # ladders and built inputs against the plain versions (KAK among
    # them), then the runs.
    for k in check_byz_bcast_kernels(dev, gen):
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        if "flat_instance_bound" in k:
            (k["flat_instance_bound_ms"],
             k["flat_instance_bound_by"]) = k.pop("flat_instance_bound")
        if k["name"] in BYZ_BCAST_OWN:
            kernels.append(k)
        emit("byz_bcast_kernel", **k, card=card, power=smi)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} with byzantine nodes on §6b disagrees with its "
                "plain version")
    launches.update(check_byz_bcast_runs(card, smi))

    # 20. SPEC §A.1 slot miss and §A.4 suppression on DPoS, SPEC §A.3
    # attacks on both Raft engines: every kernel call of rounds 3 and 20 of
    # the runs and built inputs against the plain versions (the gate
    # instances of KB, KE, KK, KL, KM, KP, KX and KAB among them), then
    # the runs.
    for k in check_gate_kernels(dev):
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        (k["flat_instance_bound_ms"],
         k["flat_instance_bound_by"]) = k.pop("flat_instance_bound")
        emit("gate_kernel", **k, card=card, power=smi)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} disagrees with its plain version")
    check_gate_runs(card, smi)

    # 21. SPEC §9 switch delivery on both Raft engines, Paxos and HotStuff,
    # and §9b on HotStuff: every kernel call of rounds 3 and 20 of the runs
    # and of built runs against the plain versions (KAL and the SWITCH
    # instances of KB, KM, KY, KZ and KAE among them), then the runs.
    switch_rows = []
    for k in check_switch_kernels(dev):
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        if "flat_instance_bound" in k:
            (k["flat_instance_bound_ms"],
             k["flat_instance_bound_by"]) = k.pop("flat_instance_bound")
        emit("switch_kernel", **k, card=card, power=smi)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} disagrees with its plain version")
        (kernels if k["name"] in SWITCH_OWN else switch_rows).append(k)
    switch_launches = check_switch_runs(card, smi)
    launches.update({name: switch_launches[name] for name in SWITCH_OWN})

    # 22. SPEC §9 switch tallies and §9b on PBFT (dense, §6b, both
    # ladders): every kernel call of rounds 3 and 20 of the runs, the
    # ladders and built runs against the plain versions (KAL's PBFT modes,
    # KAM and KAN among them), then the runs.
    for k in check_pbft_switch_kernels(dev):
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        emit("pbft_switch_kernel", **k, card=card, power=smi)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} disagrees with its plain version")
        if k["name"] in PBFT_SWITCH_OWN:
            kernels.append(k)
    launches.update(check_pbft_switch_runs(card, smi))
    require(sorted(k["name"] for k in kernels) == sorted(_build.SOURCES),
            "phases 3, 16, 17, 19, 21 and 22 do not check every kernel of "
            "csrc")

    # 23. The knob batch (K23) on HotStuff and §6b PBFT: every kernel call
    # of rounds 3 and 20 of the knob runs against the plain versions (the
    # KNOBS instances of KAJ, KAD, KAE, KAL, KAH and KT among them), then
    # three generations of each 1k space and the two full-width batches.
    knob_rows = []
    for k in check_knob_kernels(dev):
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        (k["flat_instance_bound_ms"],
         k["flat_instance_bound_by"]) = k.pop("flat_instance_bound")
        emit("knob_kernel", **k, card=card, power=smi)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} disagrees with its plain version")
        knob_rows.append(k)
    knob_launches = {**check_knob_generations(card, smi),
                     **check_knob_batches(card, smi)}

    # 24. The knob batch (K23) on the count engines (dense PBFT flat and
    # under the switch, §6b under the switch, dense Raft, Paxos, DPoS):
    # every kernel call of rounds 3 and 20 of the knob runs against the
    # plain versions (the KNOBS instances of KL, KQ, KAM, KAN, KM, KY, KZ,
    # KX and KAB among them), then three generations of each of the six
    # spaces and the seven full-width batches.
    for k in check_knob_count_kernels(dev):
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        (k["flat_instance_bound_ms"],
         k["flat_instance_bound_by"]) = k.pop("flat_instance_bound")
        emit("knob_count_kernel", **k, card=card, power=smi)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} disagrees with its plain version")
        knob_rows.append(k)
    check_knob_count_generations(card, smi)
    knob_launches.update(check_knob_count_batches(card, smi))

    # 25. The knob batch (K23) on capped Raft, and on dense Raft and Paxos
    # under the switch: every kernel call of rounds 3 and 20 of the six
    # batches against the plain versions (the KNOBS instances of KE, KB
    # and the SWITCH instances of KM, KY and KZ among them), then the
    # batches.
    for k in check_knob_capped_kernels(dev):
        k["bound_ms"], k["bound_by"] = k.pop("bound")
        (k["flat_instance_bound_ms"],
         k["flat_instance_bound_by"]) = k.pop("flat_instance_bound")
        emit("knob_capped_kernel", **k, card=card, power=smi)
        require(k["max_abs_err"] == 0.0,
                f"{k['name']} disagrees with its plain version")
        knob_rows.append(k)
    knob_launches.update(check_knob_capped_batches(card, smi))
    emit("wall")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    for k in switch_rows:
        k["launches"] = switch_launches[k["name"]]
        require(k["launches"] > 0, f"{k['name']}: no launch on its run")
    for k in knob_rows:
        k["launches"] = knob_launches[k["name"]]
        require(k["launches"] > 0, f"{k['name']}: no launch on its run")
    kernels += switch_rows + knob_rows

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
