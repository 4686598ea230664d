"""The ``CostModel`` protocol and its two implementations (own copy of
``repro.costmodel.model``).

One substrate, four consumers (DESIGN.md Sec. 18):

1. **llm chunk pricing** — ``token_costs()`` returns calibrated
   (ms_per_ktoken_prefill, ms_per_token_decode) for the workload's
   model, or None to keep the spec constants;
2. **cost_aware dispatch** — ``queue_ms_per_load()`` seeds the
   dispatcher's RLS prior with the calibrated inflation coefficient
   (the online loop stays the dispatcher's, as the online half of the
   model);
3. **GCRA admission** — ``derive_max_load(budget_ms)`` turns the
   predicted load->inflation curve into the fleet load ceiling
   (``AdmissionConfig(max_load="auto")``);
4. **predictive pre-warm** — ``prewarm_forecast()`` names the planner
   (``"oracle"`` | ``"ewma"``) a config-shaped prewarm spec should use
   when it does not choose one itself.

:class:`StaticCostModel` is today's constants: every hook returns the
do-nothing answer, so ``cost_model="static"`` (or None) is bit-identical
to the pre-CostModel code by construction. :class:`LearnedCostModel`
answers from a calibration artifact (``costmodel.calibrate``) and keeps
a :class:`~repro_torch.costmodel.online.ScalarRLS` for completion feedback.
Both carry the run's :class:`~repro_torch.costmodel.pricing.PricingSpec`.
"""
from __future__ import annotations

from typing import Optional, Union

from .calibrate import load_artifact, predict_ms
from .online import ScalarRLS
from .pricing import DEFAULT_PRICING, PricingSpec, make_pricing

#: Fallback queueing prior — the cost_aware dispatcher's historical
#: default coefficient (ms of billed inflation per unit node load).
STATIC_QUEUE_MS_PER_LOAD = 1_000.0


class CostModel:
    """Protocol base. Subclasses override the hooks they calibrate."""

    kind = "base"

    def __init__(self, pricing: Optional[PricingSpec] = None):
        self.pricing = pricing if pricing is not None else DEFAULT_PRICING

    # -- consumer 1: llm chunk pricing ---------------------------------
    def token_costs(self, cfg, seq_len: int) -> Optional[tuple]:
        """(ms_per_ktoken_prefill, ms_per_token_decode) or None to keep
        the ModelConfig constants."""
        return None

    # -- consumer 2: cost_aware dispatch -------------------------------
    def queue_ms_per_load(self) -> float:
        """The load->billed-ms prior the dispatcher's RLS starts from."""
        return STATIC_QUEUE_MS_PER_LOAD

    # -- consumer 3: admission ceiling ---------------------------------
    def derive_max_load(self, budget_ms: float) -> float:
        """Load ceiling implied by the inflation curve: the load at
        which predicted queueing inflation exhausts ``budget_ms``."""
        coeff = self.queue_ms_per_load()
        if coeff <= 0.0:
            return float("inf")
        return max(1.0, budget_ms / coeff)

    # -- consumer 4: predictive pre-warm -------------------------------
    def prewarm_forecast(self) -> str:
        return "oracle"

    # -- per-op predictions (benchmarks / diagnostics) -----------------
    def predict_op_ms(self, row: dict) -> Optional[float]:
        return None

    def describe(self) -> dict:
        return {"kind": self.kind, "pricing": self.pricing.name}


class StaticCostModel(CostModel):
    """Today's constants. Every hook is the identity/do-nothing answer;
    a run with this model is bit-identical to one with no model."""

    kind = "static"


class LearnedCostModel(CostModel):
    """Predictions from a calibration artifact + online RLS updates.

    ``artifact`` is a loaded dict or a path; ``observe(load,
    inflation_ms)`` folds completion feedback into the online half (the
    cost_aware dispatcher shares this estimator when the scenario wires
    it in, so routing and the reported coefficient stay one value).
    """

    kind = "learned"

    def __init__(self, artifact: Union[dict, str, "object"],
                 pricing: Optional[PricingSpec] = None):
        super().__init__(pricing)
        if not isinstance(artifact, dict):
            artifact = load_artifact(artifact)
        self.artifact = artifact
        self.weights = [float(w) for w in artifact["weights"]]
        rls_cfg = artifact.get("rls", {})
        self.rls = ScalarRLS(
            prior_coeff=float(artifact["queue_ms_per_load"]),
            prior_weight=float(rls_cfg.get("prior_weight", 25.0)),
            lam=float(rls_cfg.get("lambda", 0.98)))

    # -- consumer hooks -------------------------------------------------
    def token_costs(self, cfg, seq_len: int) -> Optional[tuple]:
        tc = self.artifact.get("token_costs")
        if tc is None:
            return None
        if tc.get("model") == getattr(cfg, "name", None) \
                and tc.get("seq_len") == seq_len:
            # Calibrated for exactly this model/seq_len: the anchored
            # values (the reference spec constants) apply as-is.
            return (float(tc["ms_per_ktoken_prefill"]),
                    float(tc["ms_per_token_decode"]))
        # Different model or seq_len: transfer by the predictor's
        # RELATIVE cost ratio against the calibration reference. The
        # raw fit is in calibration-host units; the anchor pins the
        # accelerator scale, the ratio carries the model shape.
        ref_pre = float(tc.get("pred_ms_per_ktoken_prefill", 0.0))
        ref_dec = float(tc.get("pred_ms_per_token_decode", 0.0))
        if ref_pre <= 0.0 or ref_dec <= 0.0:
            return None
        from .features import llm_chunk_features
        pre_tokens = int(tc.get("prefill_tokens", 1024))
        rows = llm_chunk_features(cfg, seq_len=seq_len,
                                  prefill_tokens=pre_tokens)
        pre = predict_ms(self.weights, rows[0]) / (pre_tokens / 1000.0)
        dec = predict_ms(self.weights, rows[1])
        return (float(tc["ms_per_ktoken_prefill"]) * pre / ref_pre,
                float(tc["ms_per_token_decode"]) * dec / ref_dec)

    def queue_ms_per_load(self) -> float:
        return self.rls.coeff

    def prewarm_forecast(self) -> str:
        return "ewma"

    def predict_op_ms(self, row: dict) -> float:
        return predict_ms(self.weights, row)

    # -- online half ----------------------------------------------------
    def observe(self, load: float, inflation_ms: float) -> float:
        return self.rls.observe(load, inflation_ms)

    def describe(self) -> dict:
        out = super().describe()
        out.update({
            "mape": self.artifact.get("mape"),
            "coeff": self.rls.coeff,
            "n_observed": self.rls.n_observed,
        })
        return out


def make_cost_model(model: Union[None, str, dict, CostModel],
                    pricing: Union[None, str, dict, PricingSpec] = None,
                    ) -> CostModel:
    """Coerce ``None`` | ``"static"`` | ``"learned"`` | artifact-dict |
    ``CostModel`` — the Scenario contract.

    ``"learned"`` loads the default artifact path
    (``results/costmodel/calibration_v1.json``), falling back to a
    fresh in-memory synthetic calibration when no artifact has been
    written yet — so ``cost_model="learned"`` always works, and always
    deterministically.
    """
    p = make_pricing(pricing)
    if isinstance(model, CostModel):
        if pricing is not None:
            model.pricing = p
        return model
    if model is None or model == "static":
        return StaticCostModel(p)
    if isinstance(model, dict):
        return LearnedCostModel(model, p)
    if model == "learned":
        from .calibrate import calibrate, default_artifact_path
        path = default_artifact_path()
        artifact = load_artifact(path) if path.exists() \
            else calibrate(mode="synthetic")
        return LearnedCostModel(artifact, p)
    if isinstance(model, str):
        # Any other string is an artifact path.
        return LearnedCostModel(load_artifact(model), p)
    raise TypeError(f"cannot build a CostModel from {type(model)!r}")
