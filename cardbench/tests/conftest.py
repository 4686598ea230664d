"""CPU tests of the benchmark (``python -m pytest cardbench/tests``): the
harness runs its cells at the configurations' smoke sizes on the CPU,
through the program's plain kernels. The cells' own sizes run on the card
only, through ``cardbench/run.py`` and ``cardbench/control.py``."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def smoke_port(cell) -> dict:
    """The cell's ``port`` fields at the program's smoke widths."""
    from repro_torch.configs import get_smoke
    s = get_smoke(cell.config["port_arch"])
    return dict(cell.config["port"], n_layers=s.n_layers, d_model=s.d_model,
                n_heads=s.n_heads, n_kv_heads=s.n_kv_heads, d_ff=s.d_ff,
                vocab=s.vocab, head_dim=s.d_model // s.n_heads,
                n_experts=s.n_experts, top_k=s.top_k,
                capacity_factor=s.capacity_factor if s.n_experts else 1.25)
