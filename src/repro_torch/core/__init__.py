"""repro_torch.core — own copy of the hybrid time-limit adapter."""
