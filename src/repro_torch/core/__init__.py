"""repro_torch.core — the agent engine (port of ``repro.core``)."""

from .agents import AgentPool, DtypePolicy, make_pool, pool_from_channels
from .behaviors import (Behavior, BehaviorEffects, Chemotaxis, GrowDivide,
                        Infection, NeuriteGrowth, RandomDeath, RandomWalk,
                        Secretion)
from .diffusion import DiffusionSpec
from .engine import (EngineConfig, EngineState, Simulation, StepContext,
                     build_env, check_kernel_footprints, make_iteration_core,
                     make_neighbor_apply, realized_footprint,
                     registered_kernels, stage_pool)
from .forces import ForceParams
from .grid import (BuildResult, GridSpec, GridState, PairKernel,
                   PairListConfig, RebuildPolicy, make_builder)
from .health import HealthConfig
from .stats import StepStats

__all__ = ["AgentPool", "DtypePolicy", "make_pool", "pool_from_channels",
           "Behavior", "BehaviorEffects", "Chemotaxis", "GrowDivide",
           "Infection", "NeuriteGrowth", "RandomDeath", "RandomWalk",
           "Secretion", "DiffusionSpec", "EngineConfig", "EngineState",
           "PairListConfig", "RebuildPolicy", "Simulation", "StepContext",
           "build_env", "check_kernel_footprints", "make_iteration_core",
           "make_neighbor_apply", "realized_footprint", "registered_kernels",
           "stage_pool", "ForceParams", "BuildResult", "GridSpec",
           "GridState", "PairKernel", "make_builder", "HealthConfig",
           "StepStats"]
