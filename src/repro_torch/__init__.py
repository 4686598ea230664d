"""repro_torch — the PyTorch/CUDA port of the real-model serving path.

Runs on one NVIDIA Hopper card by default (``device="cpu"`` selects the
plain PyTorch versions of the kernels, as the tests do). The package
imports neither ``jax`` nor anything of ``repro``: the few framework-free
pieces it needs from the JAX package are kept here as own copies.

The simulator's front door is the Scenario API::

    import repro_torch
    sc = repro_torch.Scenario(...)
    res = repro_torch.run(sc)
    print(res.summary())

Scenario, Monte-Carlo and cost-model names are imported lazily, so that
``import repro_torch`` stays light.
"""
__version__ = "1.0.0"

_SCENARIO_EXPORTS = (
    "run", "Scenario", "ScenarioResult", "WorkloadSpec", "FleetSpec",
    "PolicySpec", "ServingSpec", "ResilienceSpec",
    "SCHEMA_VERSION", "SUMMARY_KEYS_V1",
)

# The batched Monte-Carlo front door.
_MC_EXPORTS = ("MonteCarlo", "MonteCarloResult")

# Cost-model substrate: pricing + learned models.
_COSTMODEL_EXPORTS = ("PricingSpec", "CostModel", "StaticCostModel",
                      "LearnedCostModel", "make_cost_model")

__all__ = ["__version__", *_SCENARIO_EXPORTS, *_MC_EXPORTS,
           *_COSTMODEL_EXPORTS]


def __getattr__(name):
    if name in _SCENARIO_EXPORTS:
        from . import scenario
        return getattr(scenario, name)
    if name in _MC_EXPORTS:
        from . import mc
        return getattr(mc, name)
    if name in _COSTMODEL_EXPORTS:
        from . import costmodel
        return getattr(costmodel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SCENARIO_EXPORTS)
                  | set(_MC_EXPORTS) | set(_COSTMODEL_EXPORTS))
