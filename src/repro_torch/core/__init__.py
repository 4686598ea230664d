"""repro_torch.core — own copies of the simulator pieces the port runs:
the hybrid time-limit adapter, the regime arithmetic and ``Task``, the
cost roll-ups and ``SimResult``."""
