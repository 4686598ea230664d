"""``MonteCarlo``: one Scenario, a grid of (seeds x loads), one launch a
shape bucket (own copy of ``repro.mc.montecarlo``).

The Scenario-level front door of the batched engine: take a base
scenario, cross it with trace seeds and load scales, advance every
resulting cell on the card (``engine.run_scenarios``), and return
per-cell summary rows ready for the sweep and gate toolchain. Cells the
batched regime cannot reproduce bit for bit run on the scalar engine
(``meta["fallback"]`` counts them, ``rows`` names their reason).

    mc = MonteCarlo(scenario, seeds=range(32), loads=(0.5, 1.0, 2.0))
    rows = mc.run().rows          # 96 cells
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Optional, Sequence, Union

import torch

from ..traces.azure import TraceSpec
from .dispatch import reason_key, supported, tasks_supported

if TYPE_CHECKING:
    from ..scenario import Scenario, ScenarioResult


@dataclass
class MonteCarloResult:
    results: list["ScenarioResult"]
    seeds: tuple
    loads: tuple
    meta: dict = field(default_factory=dict)
    # Per-cell gate refusal keys, aligned with ``results``: None for
    # batched cells, a stable counter key (see ``dispatch.Refusal``) for
    # cells the gate demoted, "forced" under backend="python".
    reasons: tuple = ()

    @property
    def rows(self) -> list[dict]:
        """One row a cell, seed-major: ``seed``, ``load_scale``, the cell's
        ``backend`` and, for a gate demotion only, its ``fallback_reason``,
        then the summary. The summary's own ``backend`` /
        ``fallback_reason`` always read ``python`` / ``none``, so the
        cell's values are written again after it; JAX's rows keep the
        summary's (ROADMAP.md §3). A forced scalar baseline stays
        row-identical to its batched twin but for ``backend``."""
        out = []
        k = 0
        for seed in self.seeds:
            for load in self.loads:
                tag = {"backend": self.meta["backends"][k]}
                why = self.reasons[k] if self.reasons else None
                if why is not None and why != "forced":
                    tag["fallback_reason"] = why
                out.append({"seed": seed, "load_scale": load, **tag,
                            **self.results[k].summary(), **tag})
                k += 1
        return out


@dataclass
class MonteCarlo:
    """Expand ``scenario`` over ``seeds`` x ``loads`` and run the grid.

    ``seeds`` re-seed the workload's :class:`TraceSpec` (the workload
    must be trace-driven: ``azure`` / ``synthetic``); ``loads`` override
    ``WorkloadSpec.load_scale``. ``backend="torch"`` uses the batched
    engine on ``device`` (None: the card) wherever
    :func:`repro_torch.mc.dispatch.supported` allows and the scalar
    engine elsewhere; ``backend="python"`` forces the scalar engine
    everywhere (the equivalence baseline).
    """

    scenario: "Scenario"
    seeds: Sequence[int] = (0,)
    loads: Sequence[float] = (1.0,)
    backend: str = "torch"
    device: Optional[Union[str, torch.device]] = None

    def cells(self) -> list["Scenario"]:
        wl = self.scenario.workload
        if wl.kind not in ("azure", "synthetic"):
            raise ValueError("MonteCarlo needs a trace-driven workload "
                             "(kind='azure') to re-seed")
        base_trace = wl.trace or TraceSpec()
        out = []
        for seed in self.seeds:
            trace = replace(base_trace, seed=seed)
            for load in self.loads:
                out.append(replace(
                    self.scenario,
                    workload=replace(wl, trace=trace, load_scale=load)))
        return out

    def run(self) -> MonteCarloResult:
        from ..scenario import run as run_scalar
        from .engine import run_scenarios

        cells = self.cells()
        reasons: list[Optional[str]]
        if self.backend == "torch":
            reasons = []
            for sc in cells:
                why = supported(sc)
                reasons.append(None if why is None else reason_key(why))
        elif self.backend == "python":
            reasons = ["forced"] * len(cells)
        else:
            raise ValueError(f"unknown backend {self.backend!r}")

        batched = [k for k, why in enumerate(reasons) if why is None]
        # Build each batched cell's workload once; a caller-shaped task
        # stream can still demote it.
        prebuilt = []
        for k in batched:
            tasks_meta = cells[k].workload.build()
            why = tasks_supported(tasks_meta[0])
            if why is None:
                prebuilt.append(tasks_meta)
            else:
                reasons[k] = reason_key(why)
        batched = [k for k in batched if reasons[k] is None]

        results: list[Optional["ScenarioResult"]] = [None] * len(cells)
        if batched:
            for k, res in zip(batched,
                              run_scenarios([cells[k] for k in batched],
                                            prebuilt=prebuilt,
                                            device=self.device)):
                results[k] = res
        for k, sc in enumerate(cells):
            if results[k] is None:
                results[k] = run_scalar(sc)

        backends = ["torch" if why is None else "python" for why in reasons]
        counts: dict[str, int] = {}
        for why in reasons:
            if why is not None:
                counts[why] = counts.get(why, 0) + 1
        return MonteCarloResult(
            results=results, seeds=tuple(self.seeds),
            loads=tuple(self.loads),
            meta={"backends": backends,
                  "fallback": sum(b == "python" for b in backends),
                  "fallback_reasons": counts},
            reasons=tuple(reasons))
