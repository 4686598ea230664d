"""Failure-domain topology: zones, racks, and heterogeneous node SKUs
(own copy of ``repro.cluster.topology``).

A provider fleet is not a flat list of identical hosts. Nodes live in
**racks** inside **availability zones** — the units that fail together
when a PDU trips or a zone browns out — and come in heterogeneous
**SKUs**: a fast-clock machine finishes the same invocation sooner (and
bills fewer wall-clock ms), a discounted *spot* machine is cheaper per
billed ms but can be revoked en masse, and different generations boot
sandboxes at different speeds. This module is the declarative side of
that world; ``ClusterSim`` consumes it:

* :class:`NodeSKU` — the hardware/pricing profile of one machine class:
  ``clock`` (service-rate multiplier: 1.25 runs chunks 25% faster,
  0.8 runs them slower — implemented through the engine's
  ``interference_fn`` channel, so slow hardware and chaos ``degrade``
  events compose in one place), ``price_mult`` (billed-$ multiplier on
  the duration share of the AWS model — memory price per SKU),
  a cold-start profile override (``cold_base_ms``/``cold_per_gb_ms``),
  and the spot axis (``spot`` + ``spot_discount``: cheap capacity the
  ``revoke_spot`` chaos action takes away — the price *incentive* and
  the revocation *risk* are two sides of one knob).
* :class:`TopologySpec` — zones x racks x nodes-per-rack plus a cycled
  SKU pattern and the ``cross_zone_ms`` latency penalty a dispatch
  pays when it leaves the invocation's home zone.

Determinism: placement is a pure function of the spec (node *i* fills
racks in order), a task's home zone is ``func_id % n_zones`` (the
front-door gateway it enters through), and every derived multiplier is
plain float arithmetic — the topology adds no RNG draws anywhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union


@dataclass(frozen=True)
class NodeSKU:
    """One machine class: clock, price, cold-start profile, spot axis."""

    name: str = "std"
    clock: float = 1.0          # service-rate multiplier (>1 = faster)
    price_mult: float = 1.0     # billed-$ multiplier (duration share)
    cold_base_ms: Optional[float] = None    # cold-start profile override
    cold_per_gb_ms: Optional[float] = None
    spot: bool = False
    spot_discount: float = 0.0  # fraction off the duration bill

    def __post_init__(self):
        if self.clock <= 0.0:
            raise ValueError("SKU clock multiplier must be positive")
        if not 0.0 <= self.spot_discount < 1.0:
            raise ValueError("spot_discount must be in [0, 1)")
        if self.spot_discount and not self.spot:
            raise ValueError("spot_discount on a non-spot SKU")

    @property
    def effective_price_mult(self) -> float:
        """Duration-bill multiplier after the spot discount."""
        return self.price_mult * (1.0 - self.spot_discount) \
            if self.spot else self.price_mult


# The benchmark SKU palette. "value" trades clock for price; "turbo"
# the reverse; "spot" is std hardware at a deep discount that the
# revoke_spot chaos action can take away mid-run.
SKUS = {
    "std": NodeSKU(name="std"),
    "turbo": NodeSKU(name="turbo", clock=1.25, price_mult=1.3),
    "value": NodeSKU(name="value", clock=0.8, price_mult=0.7),
    "spot": NodeSKU(name="spot", spot=True, spot_discount=0.6),
}


def as_sku(obj: Union[str, NodeSKU]) -> NodeSKU:
    if isinstance(obj, NodeSKU):
        return obj
    if obj not in SKUS:
        raise KeyError(f"unknown SKU {obj!r}; have {sorted(SKUS)}")
    return SKUS[obj]


@dataclass(frozen=True)
class NodePlacement:
    """Where one node sits and what hardware it is."""

    zone: str
    rack: str
    sku: NodeSKU


@dataclass(frozen=True)
class TopologySpec:
    """Zones x racks x nodes-per-rack with a cycled SKU pattern.

    ``sku_pattern`` is cycled over nodes in placement order (names into
    :data:`SKUS` or explicit :class:`NodeSKU` instances). Healed nodes
    join ``heal_zone`` (default: the first zone) as ``heal_sku``.
    ``cross_zone_ms`` is the latency an invocation pays when dispatch
    routes it outside its home zone (``func_id % n_zones``).
    """

    zones: Sequence[str] = ("z0", "z1")
    racks_per_zone: int = 2
    nodes_per_rack: int = 1
    sku_pattern: Sequence[Union[str, NodeSKU]] = ("std",)
    cross_zone_ms: float = 30.0
    heal_zone: Optional[str] = None
    heal_sku: Union[str, NodeSKU] = "std"

    def __post_init__(self):
        object.__setattr__(self, "zones", tuple(self.zones))
        object.__setattr__(self, "sku_pattern", tuple(
            as_sku(s) for s in self.sku_pattern))
        if not self.zones:
            raise ValueError("a topology needs at least one zone")
        if self.racks_per_zone < 1 or self.nodes_per_rack < 1:
            raise ValueError("racks_per_zone/nodes_per_rack must be >= 1")
        if not self.sku_pattern:
            raise ValueError("sku_pattern must name at least one SKU")
        if self.cross_zone_ms < 0.0:
            raise ValueError("cross_zone_ms must be >= 0")

    @property
    def n_nodes(self) -> int:
        return len(self.zones) * self.racks_per_zone * self.nodes_per_rack

    def placement(self) -> list[NodePlacement]:
        """Per-node (zone, rack, SKU), node ids filling racks in order."""
        out = []
        per_zone = self.racks_per_zone * self.nodes_per_rack
        for i in range(self.n_nodes):
            zone = self.zones[i // per_zone]
            rack = f"{zone}-r{(i % per_zone) // self.nodes_per_rack}"
            out.append(NodePlacement(
                zone=zone, rack=rack,
                sku=self.sku_pattern[i % len(self.sku_pattern)]))
        return out

    def heal_placement(self) -> NodePlacement:
        """Where a chaos-healed replacement node joins."""
        zone = self.heal_zone if self.heal_zone is not None else self.zones[0]
        return NodePlacement(zone=zone, rack=f"{zone}-heal",
                             sku=as_sku(self.heal_sku))

    def home_zone(self, func_id: int) -> str:
        """The gateway zone an invocation of ``func_id`` enters through
        (deterministic; no RNG)."""
        return self.zones[func_id % len(self.zones)]


class SlowdownDial:
    """The engine-facing slowdown of one node, as an ``interference_fn``.

    The scheduler's interference channel models stolen CPU: chunks run
    at ``rate = 1 - fn(t)``. A SKU clock *c* and a chaos ``degrade``
    severity *d* compose into one dial: ``rate = clock x (1 - d)``, so
    ``fn(t) = 1 - clock x (1 - d)``. The dial is mutable — ``degrade``
    raises ``d`` mid-run, ``restore`` drops it back to zero — and pure
    arithmetic, so same schedule => same rates (no RNG, no wall clock).
    """

    __slots__ = ("clock", "degrade")

    def __init__(self, clock: float = 1.0, degrade: float = 0.0):
        self.clock = clock
        self.degrade = degrade

    def __call__(self, t: float) -> float:
        return 1.0 - self.clock * (1.0 - self.degrade)
