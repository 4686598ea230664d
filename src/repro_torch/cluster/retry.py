"""Retry semantics for chaos-lost work: backoff, budgets, breakers (own
copy of ``repro.cluster.retry``).

Without a policy, a chaos kill requeues every lost invocation at the
kill instant — an *instant synchronized retry storm* that slams the
survivors with a correlated burst exactly when the fleet is smallest
(still the default). A :class:`RetryPolicy` turns that
into the production shape:

* **capped exponential backoff** — attempt *n* waits
  ``min(cap_ms, base_ms x 2^(n-1))``, spreading the storm over time;
* **deterministic seeded jitter** — each wait is stretched by up to
  ``jitter_frac`` using a hash of (seed, tid, attempt), so retries
  decorrelate without any RNG state: the same fleet seed and schedule
  reproduce every delay bit-for-bit regardless of processing order;
* **retry budget** — an invocation is retried at most ``budget`` times;
  past that it is shed (priced like an admission reject — the fleet
  stops burning money on a lost cause);
* **per-function circuit breaker** — when ``breaker_threshold``
  failures of one function land within ``breaker_window_ms``, further
  retries of that function are shed through the admission accounting
  path until the window slides past: a poisoned function cannot keep
  the whole fleet in a retry loop.

:class:`RetryState` is the mutable per-run instance (budgets and
breaker windows are run state, like ``AdmissionControl``); the policy
dataclass is reusable across runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union


@dataclass(frozen=True)
class RetryPolicy:
    """Declarative retry semantics (see module docstring)."""

    base_ms: float = 250.0        # first-retry backoff
    cap_ms: float = 8_000.0       # backoff ceiling
    jitter_frac: float = 0.5      # waits stretch by up to this fraction
    budget: int = 5               # max retries per invocation
    breaker_threshold: int = 0    # failures tripping the breaker (0=off)
    breaker_window_ms: float = 10_000.0

    def __post_init__(self):
        if self.base_ms < 0.0 or self.cap_ms < self.base_ms:
            raise ValueError("need 0 <= base_ms <= cap_ms")
        if not 0.0 <= self.jitter_frac <= 1.0:
            raise ValueError("jitter_frac must be in [0, 1]")
        if self.budget < 0 or self.breaker_threshold < 0:
            raise ValueError("budget/breaker_threshold must be >= 0")

    def backoff_ms(self, attempt: int, tid: int, seed: int = 0) -> float:
        """Wait before retry ``attempt`` (1-based) of task ``tid``.
        Pure arithmetic: a splitmix-style integer hash of
        (seed, tid, attempt) supplies the jitter fraction, so the wait
        is a function of identity, not of execution order."""
        base = min(self.cap_ms, self.base_ms * (2.0 ** (attempt - 1)))
        if self.jitter_frac <= 0.0:
            return base
        h = (tid * 0x9E3779B97F4A7C15 + attempt * 0xBF58476D1CE4E5B9
             + seed * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
        h = (h * 0xD6E8FEB86659FD93) & 0xFFFFFFFFFFFFFFFF
        u = (h >> 11) / float(1 << 53)   # [0, 1)
        return base * (1.0 + self.jitter_frac * u)


class RetryState:
    """Per-run retry bookkeeping: budgets spent, breaker windows,
    roll-up counters. Decisions are pure functions of (policy, seed,
    task identity, failure history), so same seed + same chaos schedule
    reproduces every decision."""

    def __init__(self, policy: RetryPolicy, seed: int = 0):
        self.policy = policy
        self.seed = seed
        # func_id -> recent failure instants (pruned to the window).
        self._failures: dict[int, list[float]] = {}
        self.retries = 0            # retry dispatches scheduled
        self.retry_wait_ms = 0.0    # total backoff injected
        self.shed_budget = 0        # dropped: budget exhausted
        self.shed_breaker = 0       # dropped: circuit breaker open
        self.breaker_trips = 0

    def _breaker_open(self, func_id: int, t: float) -> bool:
        th = self.policy.breaker_threshold
        if th <= 0:
            return False
        window = self._failures.get(func_id)
        if not window:
            return False
        lo = t - self.policy.breaker_window_ms
        keep = [x for x in window if x > lo]
        if keep:
            self._failures[func_id] = keep
        else:
            del self._failures[func_id]
        return len(keep) >= th

    def on_failure(self, task, t: float) -> tuple[str, float]:
        """Decide the fate of one failed attempt of ``task`` at ``t``.

        Returns ``("retry", when)`` with the backoff-delayed re-dispatch
        instant, ``("shed", t)`` when the budget is exhausted or the
        function's breaker is open. Call BEFORE the task's retry
        counter is bumped for this attempt."""
        attempt = task.retries + 1
        if self.policy.breaker_threshold > 0:
            was_open = self._breaker_open(task.func_id, t)
            self._failures.setdefault(task.func_id, []).append(t)
            if not was_open and self._breaker_open(task.func_id, t):
                self.breaker_trips += 1
            if was_open:
                self.shed_breaker += 1
                return ("shed", t)
        if attempt > self.policy.budget:
            self.shed_budget += 1
            return ("shed", t)
        wait = self.policy.backoff_ms(attempt, task.tid, self.seed)
        self.retries += 1
        self.retry_wait_ms += wait
        return ("retry", t + wait)

    def stats(self) -> dict:
        return {
            "retries": self.retries,
            "retry_wait_ms": self.retry_wait_ms,
            "shed_budget": self.shed_budget,
            "shed_breaker": self.shed_breaker,
            "breaker_trips": self.breaker_trips,
        }


def make_retry(obj: Union[None, dict, RetryPolicy, RetryState],
               seed: int = 0) -> Optional[RetryState]:
    """Coerce any accepted ``retry=`` shape to a fresh per-run state."""
    if obj is None:
        return None
    if isinstance(obj, RetryState):
        return obj
    if isinstance(obj, dict):
        obj = RetryPolicy(**obj)
    if isinstance(obj, RetryPolicy):
        return RetryState(obj, seed=seed)
    raise TypeError(f"cannot build a RetryState from {type(obj).__name__}")
