"""Online scalar estimators: the learning half of the cost model (own copy
of ``repro.costmodel.online``; the same floats in the same order).

Two deterministic, allocation-free estimators:

* :class:`ScalarRLS` — through-origin recursive least squares with
  forgetting, extracted VERBATIM (same state variables, same update
  order, same guard expressions) from ``cluster.dispatch``'s
  ``cost_aware`` policy so the refactor is bit-identical. The
  configured coefficient is a *prior* worth ``prior_weight``
  squared-x units of evidence: an unobserved estimator reports exactly
  the prior, and the estimate moves only as real evidence accumulates.
* :class:`EwmaRate` — exponentially weighted per-key rates, the online
  forecaster behind predictive pre-warming (``costmodel.forecast``).

Both expose their state for the summary schema (coefficient, count,
mean absolute prediction error) — model drift is a reportable quantity,
not a hidden internal.
"""
from __future__ import annotations


class ScalarRLS:
    """y ≈ coeff·x through the origin, tracked with forgetting.

    ``observe(x, y)`` returns the signed prediction error *before* the
    update (the residual a monitoring dashboard wants), and accumulates
    its absolute value so ``mean_abs_err`` reports realized model error
    over the run.
    """

    def __init__(self, prior_coeff: float, prior_weight: float = 25.0,
                 lam: float = 0.98, learn: bool = True):
        self.prior_coeff = prior_coeff
        self.lam = lam
        self.learn = learn
        # Through-origin RLS state: coeff = _sxy / _sxx. The prior is
        # pseudo-evidence at the configured coefficient.
        self._sxx = prior_weight
        self._sxy = prior_weight * prior_coeff
        self.n_observed = 0
        self._abs_err = 0.0

    @property
    def coeff(self) -> float:
        """Current slope estimate (the prior until evidence arrives)."""
        if not self.learn or self._sxx <= 0.0:
            return self.prior_coeff
        return max(0.0, self._sxy / self._sxx)

    @property
    def mean_abs_err(self) -> float:
        """Mean |y - coeff·x| over the observations, each measured
        against the estimate in force when it arrived."""
        return self._abs_err / self.n_observed if self.n_observed else 0.0

    def observe(self, x: float, y: float) -> float:
        err = y - self.coeff * x
        self._abs_err += abs(err)
        lam = self.lam
        self._sxx = lam * self._sxx + x * x
        self._sxy = lam * self._sxy + x * y
        self.n_observed += 1
        return err

    def snapshot(self) -> dict:
        return {
            "coeff": self.coeff,
            "n_observed": self.n_observed,
            "prior_coeff": self.prior_coeff,
            "mean_abs_err": self.mean_abs_err,
            "learn": self.learn,
        }


class EwmaRate:
    """Per-key exponentially weighted rates over fixed-width buckets.

    ``update(key, count)`` folds one bucket's observed count in;
    ``forecast(key)`` is the smoothed per-bucket rate. A key never seen
    forecasts 0.0 — the estimator predicts nothing it has no evidence
    for, which is exactly how it differs from the oracle planner."""

    def __init__(self, alpha: float = 0.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._rate: dict = {}
        self.n_updates = 0

    def update(self, key, count: float) -> float:
        prev = self._rate.get(key)
        rate = float(count) if prev is None \
            else self.alpha * count + (1.0 - self.alpha) * prev
        self._rate[key] = rate
        self.n_updates += 1
        return rate

    def forecast(self, key) -> float:
        return self._rate.get(key, 0.0)
