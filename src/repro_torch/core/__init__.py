"""repro_torch.core — the engine's main-path slice (port of ``repro.core``)."""

from .agents import AgentPool, DtypePolicy, make_pool, pool_from_channels
from .behaviors import Behavior, BehaviorEffects, GrowDivide
from .engine import (EngineConfig, EngineState, Simulation, StepContext,
                     build_env, make_iteration_core, stage_pool)
from .forces import ForceParams
from .grid import (BuildResult, GridSpec, GridState, PairListConfig,
                   RebuildPolicy, make_builder)
from .health import HealthConfig
from .stats import StepStats

__all__ = ["AgentPool", "DtypePolicy", "make_pool", "pool_from_channels",
           "Behavior", "BehaviorEffects", "GrowDivide", "EngineConfig",
           "EngineState", "PairListConfig", "RebuildPolicy", "Simulation",
           "StepContext", "build_env", "make_iteration_core", "stage_pool",
           "ForceParams", "BuildResult", "GridSpec", "GridState",
           "make_builder", "HealthConfig", "StepStats"]
