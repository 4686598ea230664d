"""repro_torch.mc — the batched Monte-Carlo engine: a grid of the
paper's single-node scheduler cells in one launch on the card
(``kernels.run_grid``), bit-identical to the scalar engine; its
task-level batching layer (``engine.run_cells``); and its Scenario front
door: the regime gate ``supported``, ``run_scenarios`` (single nodes and
flat ``round_robin`` / ``random`` fleets) and :class:`MonteCarlo`
(seeds x loads grids)."""
from .dispatch import supported
from .engine import Cell, run_cells, run_scenarios
from .kernels import run_grid
from .montecarlo import MonteCarlo, MonteCarloResult

__all__ = ["Cell", "MonteCarlo", "MonteCarloResult", "run_cells",
           "run_grid", "run_scenarios", "supported"]
