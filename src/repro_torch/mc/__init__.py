"""repro_torch.mc — the batched Monte-Carlo engine: a grid of the
paper's single-node scheduler cells in one launch on the card
(``kernels.run_grid``), bit-identical to the scalar engine, and its
task-level batching layer (``engine.run_cells``)."""
from .engine import Cell, run_cells
from .kernels import run_grid

__all__ = ["Cell", "run_cells", "run_grid"]
