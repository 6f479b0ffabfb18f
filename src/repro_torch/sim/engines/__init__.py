"""Engine backends: protocol, registry, and the built-in engines.

See :mod:`repro_torch.sim.engines.base` for the :class:`EngineBackend`
protocol. The four simulator engines plus the serving engine register
here; the torch engine registers lazily (its module loads the GPU
kernels' wrappers) so ``import repro_torch.sim`` stays accelerator-free
until an ``engine="torch"`` run actually resolves it."""
from repro_torch.sim.engines.base import (ENGINE_BACKENDS,  # noqa: F401
                                          EngineBackend, LazyEntry,
                                          engine_matrix, engine_names,
                                          register_engine, resolve_engine,
                                          sim_engines, tenant_stream)
from repro_torch.sim.engines.numpy_backends import (BatchedBackend,  # noqa: F401
                                                    ScalarBackend,
                                                    VectorizedBackend)
from repro_torch.sim.engines.serving_backend import ServingBackend  # noqa: F401

register_engine(ScalarBackend())
register_engine(VectorizedBackend())
register_engine(BatchedBackend())
register_engine(LazyEntry(
    "torch", "repro_torch.sim.engines.torch_backend", "TORCH_BACKEND",
    contract="tolerance", rng_scheme="counter-threefry",
    when_to_use="mega-scale fleets (10^5+); hand-written GPU kernels"))
register_engine(ServingBackend())
