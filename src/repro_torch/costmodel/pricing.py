"""The pricing spec (own copy of ``repro.costmodel.pricing.PricingSpec``
and ``DEFAULT_PRICING``): every dollar the serving engine bills.

:data:`DEFAULT_PRICING`'s fields are exactly the JAX package's, and the
derived rates are the same float expressions, so both engines bill a
request identically.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


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
