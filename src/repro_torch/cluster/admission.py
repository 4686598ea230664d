"""Dispatcher-side admission control and per-function rate limits (own
copy of ``repro.cluster.admission``).

The fleet's front door decides — before any routing — whether an
invocation is *admitted* at all. Two independent guards, in order:

1. **Per-function token bucket** (GCRA form): each function may sustain
   ``rate_per_s`` invocations/second with ``burst`` of slack. A
   non-conforming invocation is shed or queued (held at the front end
   until its token matures) per ``rate_action``.
2. **Fleet load ceiling** (core-granular admission a la Kaffes et al.,
   "Practical Scheduling for Real-World Serverless Computing"): when
   even the least-loaded node is above ``max_load``
   (admitted-but-unfinished tasks per core), the invocation is shed,
   queued for ``queue_backoff_ms`` and retried, or *spilled* — admitted
   anyway but force-routed to the least-loaded node, overriding
   affinity-style dispatchers that would pile onto a hot ring owner.

Outcomes and their accounting (DESIGN.md Sec. 14):

``admit``  -- flows to the configured dispatcher as before.
``queue``  -- dispatch is DELAYED; the task's ``arrival`` keeps its true
              value, so front-door queueing shows up in turnaround and
              slowdown like any other queueing. Total front-door wait is
              bounded by ``max_queue_ms``; past it the task is shed.
``spill``  -- admitted to the least-loaded node; counted.
``shed``   -- rejected: the task is marked failed, never reaches a node,
              and is PRICED separately (the per-request fee is still
              incurred — ``core.cost.rejected_request_cost_usd``), so
              shedding load can never masquerade as a cost saving.

Every decision is deterministic: the bucket state is plain arithmetic
over arrival instants, and ties never depend on hash order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

_INF = float("inf")


@dataclass(frozen=True)
class AdmissionConfig:
    """Front-door admission knobs (picklable; carried by bench cells)."""

    # -- per-function token bucket (GCRA) -------------------------------
    rate_per_s: float = _INF        # sustained invocations/s per function
    burst: float = 10.0             # bucket depth (invocations)
    rate_action: str = "queue"      # "shed" | "queue"
    # -- fleet load ceiling ---------------------------------------------
    # A float, or the string "auto": derive the ceiling from the cost
    # model's predicted load->inflation curve (resolved by the Scenario
    # layer via CostModel.derive_max_load before the run starts).
    max_load: float = _INF          # admit while min node load <= this
    overload_action: str = "queue"  # "shed" | "queue" | "spill"
    queue_backoff_ms: float = 250.0  # overload retry interval
    # -- shared queue bound ---------------------------------------------
    max_queue_ms: float = 10_000.0  # total front-door wait before shed

    def __post_init__(self):
        if self.rate_action not in ("shed", "queue"):
            raise ValueError(f"bad rate_action {self.rate_action!r}")
        if self.overload_action not in ("shed", "queue", "spill"):
            raise ValueError(f"bad overload_action {self.overload_action!r}")
        if not self.rate_per_s > 0.0:
            raise ValueError(
                "rate_per_s must be positive (use max_load/shed to block "
                f"traffic outright), got {self.rate_per_s}")
        if not self.burst > 0.0:
            raise ValueError(f"burst must be positive, got {self.burst}")


class AdmissionControl:
    """Stateful front-door guard; one instance per ClusterSim run.

    ``decide(task, snaps, t, first)`` returns ``(outcome, when)``:
    outcome in {"admit", "spill", "shed", "queue"}, with ``when`` the
    dispatch instant for "queue" (>= t) and ``t`` otherwise. ``first``
    is False on a re-presentation of a queued task — its token is
    already reserved, so only the load ceiling is re-checked.
    """

    def __init__(self, config: Optional[AdmissionConfig] = None, **overrides):
        if config is None:
            config = AdmissionConfig(**overrides)
        elif overrides:
            raise TypeError("pass either a config or keyword overrides")
        if config.max_load == "auto":
            raise ValueError(
                "max_load='auto' must be resolved by a cost model — run "
                "the config through repro_torch.run(Scenario(...)) (any "
                "cost_model resolves it) or set a numeric ceiling")
        self.cfg = config
        # GCRA per function: theoretical arrival time of the NEXT
        # conforming invocation.
        self._tat: dict[int, float] = {}
        # first arrival instant of each queued task (bounds total wait)
        self._queued_since: dict[int, float] = {}
        # tasks holding a rate token (consumed on conformance or
        # reserved for a queued retry) that has not yet been SERVED by
        # a dispatch; if such a task is later shed by the load ceiling,
        # the token is refunded — bucket capacity is never spent on
        # work that never ran
        self._rate_charged: set[int] = set()
        self.admitted = 0
        self.shed = 0
        self.shed_rate = 0       # shed by the token bucket
        self.shed_overload = 0   # shed by the load ceiling
        self.queued = 0          # queue decisions (a task may queue twice)
        self.spilled = 0
        self.shed_no_capacity = 0  # fleet vanished under a queued task
        self.shed_retry = 0       # retry budget / circuit breaker sheds
        self.queue_wait_ms = 0.0  # total front-door delay actually served

    # -- token bucket ----------------------------------------------------
    def _bucket_wait_ms(self, task, t: float) -> Optional[float]:
        """GCRA conformance test at instant ``t``. Returns 0.0 for a
        conforming invocation (token consumed), a positive wait for one
        that conforms after a delay (token RESERVED at t + wait), or
        None when it should shed (no state consumed). Consumed and
        reserved tokens are tracked per task until served, so a later
        overload shed can refund them."""
        cfg = self.cfg
        if not math.isfinite(cfg.rate_per_s):
            return 0.0
        increment = 1_000.0 / cfg.rate_per_s          # ms per token
        tau = max(0.0, (cfg.burst - 1.0)) * increment  # burst tolerance
        tat = self._tat.get(task.func_id, -_INF)
        if tat <= t + tau:                            # conforming now
            self._tat[task.func_id] = max(t, tat) + increment
            self._rate_charged.add(task.tid)
            return 0.0
        wait = tat - tau - t                          # conforms then
        if self.cfg.rate_action == "shed" or wait > cfg.max_queue_ms:
            return None
        self._tat[task.func_id] = tat + increment     # reserve the slot
        self._rate_charged.add(task.tid)
        return wait

    # -- the decision ----------------------------------------------------
    def decide(self, task, snaps, t: float,
               first: bool = True) -> tuple[str, float]:
        cfg = self.cfg
        if first:
            wait = self._bucket_wait_ms(task, t)
            if wait is None:
                self.shed += 1
                self.shed_rate += 1
                return "shed", t
            if wait > 0.0:
                self.queued += 1
                self._queued_since[task.tid] = t
                return "queue", t + wait
        if math.isfinite(cfg.max_load) and snaps:
            lo = min(s["load"] for s in snaps)
            if lo > cfg.max_load:
                if cfg.overload_action == "spill":
                    self.spilled += 1
                    self._admitted_at(task, t)
                    return "spill", t
                since = self._queued_since.get(task.tid, t)
                waited = t - since
                if cfg.overload_action == "shed" or \
                        waited + cfg.queue_backoff_ms > cfg.max_queue_ms:
                    self.shed += 1
                    self.shed_overload += 1
                    self._queued_since.pop(task.tid, None)
                    self._refund_token(task)
                    return "shed", t
                self.queued += 1
                self._queued_since.setdefault(task.tid, t)
                return "queue", t + cfg.queue_backoff_ms
        self._admitted_at(task, t)
        return "admit", t

    def on_external_shed(self, task) -> None:
        """The fleet loop shed this task outside a decide() call (e.g.
        chaos emptied the fleet): keep the books consistent — count it,
        close its queue-wait record, and refund its rate token so
        capacity is never left spent on work that never ran."""
        self.shed += 1
        self.shed_no_capacity += 1
        self._queued_since.pop(task.tid, None)
        self._refund_token(task)

    def on_retry_shed(self, task) -> None:
        """A chaos-lost invocation ran out of retry budget (or its
        function's circuit breaker is open): the retry layer sheds it
        through THIS front door so the admission books stay the single
        source of shed accounting. The task was admitted and served
        once, so there is no token to refund — the count is the point."""
        self.shed += 1
        self.shed_retry += 1
        self._queued_since.pop(task.tid, None)
        self._refund_token(task)

    def _refund_token(self, task) -> None:
        """A task shed before dispatch gives its rate token (consumed
        or reserved) back: the work never ran, so later invocations of
        the function must not be throttled by it."""
        if task.tid in self._rate_charged:
            self._rate_charged.discard(task.tid)
            self._tat[task.func_id] -= 1_000.0 / self.cfg.rate_per_s

    def _admitted_at(self, task, t: float) -> None:
        self.admitted += 1
        self._rate_charged.discard(task.tid)    # token served
        since = self._queued_since.pop(task.tid, None)
        if since is not None:
            self.queue_wait_ms += t - since

    # -- roll-up ---------------------------------------------------------
    def stats(self) -> dict:
        return {
            "admitted": self.admitted,
            "shed": self.shed,
            "shed_rate": self.shed_rate,
            "shed_overload": self.shed_overload,
            "queued": self.queued,
            "spilled": self.spilled,
            "shed_no_capacity": self.shed_no_capacity,
            "shed_retry": self.shed_retry,
            "queue_wait_ms": self.queue_wait_ms,
        }


def make_admission(admission) -> Optional[AdmissionControl]:
    """Coerce None | kwargs dict | AdmissionConfig | AdmissionControl
    (ClusterSim / Scenario)."""
    if admission is None or isinstance(admission, AdmissionControl):
        return admission
    if isinstance(admission, dict):
        admission = AdmissionConfig(**admission)
    if isinstance(admission, AdmissionConfig):
        return AdmissionControl(admission)
    raise TypeError(f"cannot build admission control from {admission!r}")
