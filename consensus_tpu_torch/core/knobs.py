"""Per-lane adversary knobs over a static base ``Config``: the port of
``consensus_tpu/core/knobs.py`` (``KNOB_COLUMNS``, ``KnobView``).

The engines read two kinds of facts off a ``Config``. The static ones
(shapes, the engine, the adversary gates ``crash_on``, ``desync_on``,
``no_partition``, ``agg_poison_on``, ``uplink_lies_on``, the
``max_delay_rounds`` loop depth) decide which kernels and which template
instances a round launches. The knob values, the u32 cutoffs of
:data:`KNOB_COLUMNS`, only feed compares ``draw < cutoff``, so each lane of
one run may carry its own. :class:`KnobView` is a ``Config`` stand-in whose
knob values are such per-lane values while every other attribute, the gates
among them, is the base's. ``network/runner.py`` ``run_knob_batch`` runs a
generation of adversary-search candidates so, as lanes of one CUDA graph,
on every engine of the port: the capped Raft one, and dense Raft and Paxos
under the SPEC §9 switch, among them.

On the CPU the plain versions read a knob as a [B, 1] int64 column of u32
values, which broadcasts against their [B, ...] draws (:func:`at` reshapes
it for a higher rank). On the card the kernels' KNOBS instances read each
lane's row of the view's [B, 12] int64 table (:func:`table_ptr`) in place
of their cutoff arguments, which then carry the base's values
(:func:`static`); the C entry points pick the KNOBS instance where the
table pointer is not null.

Soundness, as in the JAX package: a lane whose row equals a ``Config``'s
cutoffs draws and compares exactly as that config's run, and a gated-on
knob whose lane value is 0 never fires, so that lane equals the run of the
config with the knob off.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

# The knob columns, in order: a copy of consensus_tpu/core/knobs.py
# KNOB_COLUMNS (lines 38-52). All are u32 cutoffs but attack_target, a
# node id.
KNOB_COLUMNS = ("drop_cutoff", "partition_cutoff", "churn_cutoff",
                "crash_cutoff", "recover_cutoff", "miss_cutoff",
                "suppress_cutoff", "attack_cutoff", "attack_target",
                "agg_poison_cutoff", "byz_uplink_cutoff", "desync_cutoff")
N_KNOBS = len(KNOB_COLUMNS)

# The Config field each knob column derives from (the base's rate or id).
KNOB_FIELDS = {"drop_cutoff": "drop_rate",
               "partition_cutoff": "partition_rate",
               "churn_cutoff": "churn_rate", "crash_cutoff": "crash_prob",
               "recover_cutoff": "recover_prob", "miss_cutoff": "miss_rate",
               "suppress_cutoff": "suppress_rate",
               "attack_cutoff": "attack_rate",
               "attack_target": "attack_target",
               "agg_poison_cutoff": "agg_poison_rate",
               "byz_uplink_cutoff": "byz_uplink_rate",
               "desync_cutoff": "desync_rate"}


def gates(cfg) -> dict[str, bool]:
    """Whether ``cfg`` traces each knob column: the JAX package's
    ``run_knob_batch`` gate table (``consensus_tpu/network/runner.py:
    1098-1106``). A column it gates off must keep the base's value on every
    lane; the columns it leaves out are always read."""
    attack = cfg.attack != "none"
    return {"crash_cutoff": cfg.crash_on, "recover_cutoff": cfg.crash_on,
            "miss_cutoff": cfg.miss_on, "suppress_cutoff": cfg.suppress_on,
            "partition_cutoff": not cfg.no_partition,
            "attack_cutoff": attack, "attack_target": attack,
            "agg_poison_cutoff": cfg.agg_poison_on,
            "byz_uplink_cutoff": cfg.uplink_lies_on}


def base_row(cfg) -> list[int]:
    """``cfg``'s own knob row, in :data:`KNOB_COLUMNS` order."""
    return [int(getattr(cfg, name)) for name in KNOB_COLUMNS]


class KnobView:
    """A ``Config`` stand-in with per-lane knob values over a static base.

    ``base`` supplies every static fact, the gates included, so it must be
    gate-representative for the knobs a lane may vary. With ``table``, a
    [B, 12] int64 tensor of u32 values in :data:`KNOB_COLUMNS` order, each
    knob reads as its [B, 1] column and the kernels read the table; else
    ``traced`` maps column names to values (an int, or a [B, 1] tensor for
    the plain versions) and the unnamed knobs keep the base's values. Only
    a view with a table reaches a kernel."""

    def __init__(self, base, table: torch.Tensor | None = None,
                 **traced: Any):
        unknown = set(traced) - set(KNOB_COLUMNS)
        if unknown:
            raise ValueError(f"unknown traced knobs {sorted(unknown)} "
                             f"(tracable: {list(KNOB_COLUMNS)})")
        if table is not None:
            if traced:
                raise ValueError("a KnobView takes a knob table or traced "
                                 "knobs, not both")
            if table.dim() != 2 or table.shape[1] != N_KNOBS \
                    or table.dtype != torch.int64:
                raise ValueError(f"the knob table must be [B, {N_KNOBS}] "
                                 f"int64, got {tuple(table.shape)} "
                                 f"{table.dtype}")
        self._base = base
        self.table = table
        for i, name in enumerate(KNOB_COLUMNS):
            value = (table[:, i:i + 1] if table is not None
                     else traced.get(name, getattr(base, name)))
            setattr(self, name, value)

    def __getattr__(self, name: str) -> Any:
        # Only reached for names not set in __init__: the static side.
        return getattr(self._base, name)

    @property
    def base(self):
        return self._base


def static(cfg):
    """The static ``Config`` behind ``cfg``: its base for a view, else
    ``cfg`` itself. The kernel wrappers pass its cutoffs, which pick the
    instances and which a KNOBS instance replaces by its lane's row."""
    return cfg.base if isinstance(cfg, KnobView) else cfg


def table_of(cfg) -> torch.Tensor | None:
    """The [B, 12] table of a view, None for a ``Config``: what a wrapper
    whose cutoffs come as arguments (:func:`static`'s) takes as ``knobs``
    to run its KNOBS instance."""
    return cfg.table if isinstance(cfg, KnobView) else None


def table_ptr(cfg, device: torch.device, B: int):
    """The kernels' knob-table argument of ``cfg``: null for a ``Config``,
    else the view's [B, 12] int64 table on ``device``, checked. A view
    without a table raises (its values would not reach the card)."""
    if not isinstance(cfg, KnobView):
        return None
    t = cfg.table
    if t is None:
        raise ValueError("a KnobView reaches the kernels only with a knob "
                         "table (KnobView(base, table))")
    if t.device != device or tuple(t.shape) != (B, N_KNOBS) \
            or not t.is_contiguous():
        raise ValueError(f"the knob table must be a contiguous [{B}, "
                         f"{N_KNOBS}] int64 tensor on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def at(cut, rank: int):
    """A cutoff as a compare at ``rank`` takes it: an int unchanged, a
    per-lane [B, 1] column reshaped to [B, 1, ..., 1] of that rank."""
    if isinstance(cut, torch.Tensor):
        return cut.reshape((-1,) + (1,) * (rank - 1))
    return cut


def may_fire(cut) -> bool:
    """Whether a cutoff can fire in some lane: a nonzero int, or any
    per-lane column (whose zero lanes never fire, so computing their draws
    is exact). Functions that take no Config branch on this where the
    others test the gate."""
    return isinstance(cut, torch.Tensor) or cut != 0


def column(table: torch.Tensor, name: str) -> torch.Tensor:
    """Column ``name`` of a [B, 12] knob table: each lane's value, [B, 1]."""
    i = KNOB_COLUMNS.index(name)
    return table[:, i:i + 1]


def signed_target(t):
    """The SPEC §A.3 target as a lane compares it with node ids: an int as
    it is, a per-lane column of u32 values as int32 (the JAX package's
    ``astype(jnp.int32)`` of the column, ``consensus_tpu/network/runner.py:
    1029-1031``), so 0xFFFFFFFD is -3 and matches no node."""
    if isinstance(t, torch.Tensor):
        return torch.where(t >= 1 << 31, t - (1 << 32), t)
    return t


def target_role(role: torch.Tensor, t) -> torch.Tensor:
    """[B]: the role the SPEC §A.3 sticky attack reads of target ``t`` in
    each lane of ``role`` ([B, N]). An int in [0, N) is read as it is; a
    per-lane column (:func:`signed_target`'s) as the JAX package's gather
    reads a traced int32 index: a negative one counts from the end, then
    it is clamped to [0, N - 1] (target N + 3 reads node N - 1, -3 node
    N - 3), while the jam compares node ids with ``t`` as it is."""
    if not isinstance(t, torch.Tensor):
        return role[:, t]
    N = role.shape[1]
    i = torch.where(t < 0, t + N, t).clamp(0, N - 1)
    return role.gather(1, i.to(torch.int64))[:, 0]


def lane_table(kmat, device) -> torch.Tensor:
    """A [C, 12] numpy u32 knob matrix as the kernels' int64 table on
    ``device`` (every u32 value, 0xFFFFFFFF included, kept exactly)."""
    return torch.from_numpy(np.asarray(kmat, np.uint32).astype(np.int64)) \
        .to(device)
