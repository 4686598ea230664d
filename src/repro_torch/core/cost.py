"""AWS Lambda pricing of a workload (own copy of the parts of
``repro.core.cost`` that ``SimResult`` bills with).

AWS bills wall-clock execution duration per millisecond, at a
per-GB-second rate, plus a flat per-request fee. Rates come from the
port's :class:`~repro_torch.costmodel.pricing.PricingSpec`;
``pricing=None`` is ``DEFAULT_PRICING``. Sums are ``math.fsum`` (exactly
rounded), so a bill is bit-identical under any order of the invocations.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

from ..costmodel.pricing import DEFAULT_PRICING, PricingSpec

# Fig. 1 / Fig. 20 memory ladder (MB).
MEMORY_LADDER_MB = (128, 256, 512, 1024, 2048, 4096, 10240)


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


def cost_ladder(execution_ms: Sequence[float],
                pricing: Optional[PricingSpec] = None) -> dict[int, float]:
    """Cost for each memory size on the Fig. 1/20 ladder."""
    return {mb: workload_cost_usd(execution_ms, fixed_mem_mb=mb,
                                  pricing=pricing)
            for mb in MEMORY_LADDER_MB}
