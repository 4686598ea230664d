"""repro_torch.costmodel — own copy of the pricing spec."""
