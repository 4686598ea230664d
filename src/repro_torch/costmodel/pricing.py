"""The pricing spec (own copy of ``repro.costmodel.pricing``): every
dollar the serving engine, the simulator and the cost model bill.

:data:`DEFAULT_PRICING`'s fields are exactly the JAX package's, and the
derived rates are the same float expressions, so both engines bill a
request identically.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Union


@dataclass(frozen=True)
class PricingSpec:
    """``price_per_gb_second`` / ``price_per_request`` are the AWS Lambda
    x86 rates (2024). ``warm_hold_divisor`` sets the provider-side idle
    warm-memory rate as a fraction of the user-facing rate.
    ``sku_price_mults`` / ``spot_discount`` are the heterogeneous-fleet
    duration multipliers of the cluster topology palette.
    """

    name: str = "default"
    price_per_gb_second: float = 1.66667e-5   # USD
    price_per_request: float = 2.0e-7         # USD ($0.20 / 1M requests)
    warm_hold_divisor: float = 8.0
    sku_price_mults: tuple = (("std", 1.0), ("turbo", 1.3),
                              ("value", 0.7), ("spot", 1.0))
    spot_discount: float = 0.6                # fraction off on spot SKUs

    def __post_init__(self):
        if self.price_per_gb_second < 0.0 or self.price_per_request < 0.0:
            raise ValueError("prices must be non-negative")
        if not self.warm_hold_divisor > 0.0:
            raise ValueError("warm_hold_divisor must be positive")
        if not 0.0 <= self.spot_discount < 1.0:
            raise ValueError("spot_discount must be in [0, 1)")

    @property
    def warm_hold_per_gb_second(self) -> float:
        """Provider-side $/GB-second of idle warm sandbox memory."""
        return self.price_per_gb_second / self.warm_hold_divisor

    def price_per_ms(self, mem_mb: float) -> float:
        """Billed $/ms for one invocation of the given memory size."""
        return (mem_mb / 1024.0) * self.price_per_gb_second / 1000.0

    def sku_mult(self, sku_name: str) -> float:
        for name, mult in self.sku_price_mults:
            if name == sku_name:
                return mult
        return 1.0

    def with_(self, **kw) -> "PricingSpec":
        return replace(self, **kw)


#: The JAX package's default pricing, field for field.
DEFAULT_PRICING = PricingSpec()

#: Named presets for the sweep/CLI ``--pricing`` axis. Additions are
#: cheap; renames are schema changes (rows key on the name).
PRICINGS = {
    "default": DEFAULT_PRICING,
    # Duration rate doubled: what the scheduler choice is worth when
    # compute is expensive relative to the request fee.
    "premium": PricingSpec(name="premium",
                           price_per_gb_second=2 * 1.66667e-5),
    # Request fee waived: pure duration billing — shedding becomes
    # literally free for the operator, which the roll-ups must show.
    "free_requests": PricingSpec(name="free_requests",
                                 price_per_request=0.0),
}


def make_pricing(pricing: Union[None, str, dict, PricingSpec],
                 ) -> PricingSpec:
    """Coerce ``None`` | preset name | kwargs dict | ``PricingSpec`` —
    the same accept-anything contract the container/admission specs
    give every other Scenario argument."""
    if pricing is None:
        return DEFAULT_PRICING
    if isinstance(pricing, PricingSpec):
        return pricing
    if isinstance(pricing, str):
        if pricing not in PRICINGS:
            raise KeyError(f"unknown pricing preset {pricing!r}; "
                           f"have {sorted(PRICINGS)}")
        return PRICINGS[pricing]
    if isinstance(pricing, dict):
        return PricingSpec(**pricing)
    raise TypeError(f"cannot build PricingSpec from {type(pricing)!r}")


def resolve_pricing(pricing: Union[None, str, dict, PricingSpec],
                    ) -> Optional[PricingSpec]:
    """Like :func:`make_pricing` but maps ``None`` to ``None`` — for
    call sites that must distinguish "caller said nothing" (keep the
    legacy constant path, bit-identically) from "caller asked for the
    default spec"."""
    return None if pricing is None else make_pricing(pricing)
