"""bark-jax: fully-Bayesian tree-kernel GPs and Bayesian optimization in JAX.

Built from scratch in JAX/XLA with the
capabilities of TobyBoyne/bark: BARK forest-MCMC surrogates, tree-agreement
GP regression, and Bayesian optimization over mixed
continuous/integer/categorical domains — plus SMC and parallel-tempering
samplers, mesh-sharded chains, and a massively parallel acquisition search.

Public entry points:
    from bark_jax import (
        Domain, ContinuousInput, IntegerInput, CategoricalInput,
        SamplerParams, BARKSurrogate, BARKPriorSurrogate, LeafGPSurrogate,
        TreeKernelStrategy, make_strategy, map_benchmark,
    )
"""

from bark_jax.domain import (
    CategoricalInput,
    ContinuousInput,
    ContinuousOutput,
    Domain,
    IntegerInput,
    Standardize,
    build_integer_input,
)
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.sampler import (
    BARKModel,
    run_bark_sampler,
    run_bark_sampler_with_trace,
)
from bark_jax.forest import Forest, create_empty_forest

__all__ = [
    "BARKModel",
    "CategoricalInput",
    "ContinuousInput",
    "ContinuousOutput",
    "Domain",
    "Forest",
    "IntegerInput",
    "SamplerParams",
    "Standardize",
    "build_integer_input",
    "create_empty_forest",
    "run_bark_sampler",
    "run_bark_sampler_with_trace",
]


def __getattr__(name):
    # heavier layers load lazily to keep `import bark_jax` light
    if name in ("BARKSurrogate", "BARKPriorSurrogate"):
        from bark_jax.models import surrogate

        return getattr(surrogate, name)
    if name == "LeafGPSurrogate":
        from bark_jax.models.leafgp import LeafGPSurrogate

        return LeafGPSurrogate
    if name == "LeafMOGPSurrogate":
        from bark_jax.models.mogp import LeafMOGPSurrogate

        return LeafMOGPSurrogate
    if name == "BARTSurrogate":
        from bark_jax.models.bart import BARTSurrogate

        return BARTSurrogate
    if name == "BARTParams":
        from bark_jax.fitting.bart import BARTParams

        return BARTParams
    if name in ("TreeKernelStrategy", "make_strategy", "RandomStrategy"):
        from bark_jax.strategies import tree_kernel

        return getattr(tree_kernel, name)
    if name in ("BENCHMARK_MAP", "map_benchmark"):
        from bark_jax import benchmarks

        return getattr(benchmarks, name)
    raise AttributeError(name)
