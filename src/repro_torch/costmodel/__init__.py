"""Profiled, learned cost models (own copy of ``repro.costmodel``).

* :mod:`~repro_torch.costmodel.pricing`   — the frozen
  :class:`PricingSpec` every cost helper and consumer prices with;
* :mod:`~repro_torch.costmodel.features`  — per-op FLOP/byte rows of the
  port's kernels (read on the meta device) and the llm chunk shapes;
* :mod:`~repro_torch.costmodel.calibrate` — kernel timing on the card +
  ridge fit, persisted as a versioned JSON artifact;
* :mod:`~repro_torch.costmodel.online`    — the online estimators
  (ScalarRLS, EWMA rates);
* :mod:`~repro_torch.costmodel.forecast`  — the online pre-warm planner;
* :mod:`~repro_torch.costmodel.model`     — the :class:`CostModel`
  protocol (:class:`StaticCostModel` / :class:`LearnedCostModel`).
"""
from .calibrate import (calibrate, default_artifact_path, fit_ridge,
                        load_artifact, predict_ms, save_artifact)
from .model import (CostModel, LearnedCostModel, StaticCostModel,
                    make_cost_model)
from .online import EwmaRate, ScalarRLS
from .pricing import (DEFAULT_PRICING, PRICINGS, PricingSpec, make_pricing,
                      resolve_pricing)

__all__ = [
    "CostModel", "StaticCostModel", "LearnedCostModel", "make_cost_model",
    "PricingSpec", "DEFAULT_PRICING", "PRICINGS", "make_pricing",
    "resolve_pricing", "ScalarRLS", "EwmaRate",
    "calibrate", "fit_ridge", "predict_ms", "save_artifact",
    "load_artifact", "default_artifact_path",
]
