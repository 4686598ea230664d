"""AWS Lambda pricing of a workload (own copy of ``repro.core.cost``).

AWS bills wall-clock execution duration per millisecond, at a
per-GB-second rate, plus a flat per-request fee. Rates come from the
port's :class:`~repro_torch.costmodel.pricing.PricingSpec`;
``pricing=None`` is ``DEFAULT_PRICING``. Sums are ``math.fsum`` (exactly
rounded), so a bill is bit-identical under any order of the invocations.
The legacy module constants (``PRICE_PER_GB_SECOND`` etc.) are served by
a module ``__getattr__`` with a DeprecationWarning.
"""
from __future__ import annotations

import math
import warnings
from typing import Iterable, Optional, Sequence

from ..costmodel.pricing import DEFAULT_PRICING, PricingSpec

# Legacy module-level constants, served by __getattr__ below with a
# DeprecationWarning; the values are DEFAULT_PRICING's.
_DEPRECATED_CONSTANTS = {
    "PRICE_PER_GB_SECOND": lambda: DEFAULT_PRICING.price_per_gb_second,
    "PRICE_PER_REQUEST": lambda: DEFAULT_PRICING.price_per_request,
    "WARM_HOLD_PER_GB_SECOND":
        lambda: DEFAULT_PRICING.warm_hold_per_gb_second,
}


def __getattr__(name: str):
    if name in _DEPRECATED_CONSTANTS:
        warnings.warn(
            f"repro_torch.core.cost.{name} is deprecated; use "
            "repro_torch.costmodel.PricingSpec / DEFAULT_PRICING instead",
            DeprecationWarning, stacklevel=2)
        return _DEPRECATED_CONSTANTS[name]()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# Fig. 1 / Fig. 20 memory ladder (MB).
MEMORY_LADDER_MB = (128, 256, 512, 1024, 2048, 4096, 10240)

# Azure '20: >90% of functions allocate < 400 MB. Discrete stand-in
# distribution used for Table I-style overall cost.
AZURE_MEMORY_DISTRIBUTION = (
    (128, 0.45),
    (192, 0.15),
    (256, 0.15),
    (384, 0.15),
    (512, 0.05),
    (1024, 0.03),
    (2048, 0.015),
    (4096, 0.005),
)


def price_per_ms(mem_mb: float,
                 pricing: Optional[PricingSpec] = None) -> float:
    p = pricing if pricing is not None else DEFAULT_PRICING
    return (mem_mb / 1024.0) * p.price_per_gb_second / 1000.0


def invocation_cost_usd(execution_ms: float, mem_mb: float,
                        price_mult: float = 1.0,
                        pricing: Optional[PricingSpec] = None) -> float:
    """One invocation's bill. ``price_mult`` scales the duration share
    only; the per-request fee is a front-door charge."""
    p = pricing if pricing is not None else DEFAULT_PRICING
    return execution_ms * price_per_ms(mem_mb, p) * price_mult \
        + p.price_per_request


def cold_start_cost_usd(init_ms: float, mem_mb: float,
                        pricing: Optional[PricingSpec] = None) -> float:
    """The share of one invocation's bill attributable to sandbox boot
    (no per-request fee: the request is billed once, in
    ``invocation_cost_usd``)."""
    return init_ms * price_per_ms(mem_mb, pricing)


def rejected_request_cost_usd(n_rejected: int,
                              pricing: Optional[PricingSpec] = None,
                              ) -> float:
    """Admission-shed invocations still pay the per-request fee. Reported
    apart from the execution bill, so shedding never shows as savings."""
    p = pricing if pricing is not None else DEFAULT_PRICING
    return n_rejected * p.price_per_request


def warm_pool_hold_cost_usd(warm_mb_ms: float,
                            pricing: Optional[PricingSpec] = None,
                            ) -> float:
    """Provider-side cost of the idle warm set: the integral of resident
    idle sandbox memory over time (MB x ms), as accumulated by
    ``ContainerPool.warm_mb_ms``."""
    p = pricing if pricing is not None else DEFAULT_PRICING
    return (warm_mb_ms / 1024.0 / 1000.0) * p.warm_hold_per_gb_second


def workload_cost_usd(execution_ms: Iterable[float],
                      mem_mb: Optional[Iterable[float]] = None,
                      fixed_mem_mb: Optional[float] = None,
                      price_mult: float = 1.0,
                      pricing: Optional[PricingSpec] = None) -> float:
    """Total user-facing cost of a workload: every invocation at
    ``fixed_mem_mb`` if given (Fig. 1 / Fig. 20 style), else at its own
    size."""
    if fixed_mem_mb is not None:
        return math.fsum(
            invocation_cost_usd(e, fixed_mem_mb, price_mult, pricing)
            for e in execution_ms)
    assert mem_mb is not None
    return math.fsum(invocation_cost_usd(e, m, price_mult, pricing)
                     for e, m in zip(execution_ms, mem_mb))


def duration_cost_usd(execution_ms: Iterable[float],
                      mem_mb: Iterable[float],
                      pricing: Optional[PricingSpec] = None) -> float:
    """The duration share of a workload's bill alone (no per-request
    fees), exactly rounded: the base that SKU price multipliers and spot
    discounts scale."""
    return math.fsum(e * price_per_ms(m, pricing)
                     for e, m in zip(execution_ms, mem_mb))


def cost_ladder(execution_ms: Sequence[float],
                pricing: Optional[PricingSpec] = None) -> dict[int, float]:
    """Cost for each memory size on the Fig. 1/20 ladder."""
    return {mb: workload_cost_usd(execution_ms, fixed_mem_mb=mb,
                                  pricing=pricing)
            for mb in MEMORY_LADDER_MB}


def sample_memory_sizes(n: int, rng) -> list[int]:
    """Draw n memory sizes from the Azure-like distribution."""
    sizes = [mb for mb, _ in AZURE_MEMORY_DISTRIBUTION]
    probs = [p for _, p in AZURE_MEMORY_DISTRIBUTION]
    idx = rng.choice(len(sizes), size=n, p=probs)
    return [sizes[i] for i in idx]
