"""repro_torch.core — the agent engine (port of ``repro.core``)."""

from .agents import AgentPool, DtypePolicy, make_pool, pool_from_channels
from .behaviors import (Behavior, BehaviorEffects, Chemotaxis, GrowDivide,
                        Infection, NeuriteGrowth, RandomDeath, RandomWalk,
                        Secretion)
from .compaction import grow_channels, grow_pool, repack_slabs
from .diffusion import DiffusionSpec
from .distributed import (DistConfig, DistributedCapacityLadder,
                          DistributedSimulation, DistState)
from .engine import (CapacityExhausted, CapacityLadder, EngineConfig,
                     EngineState, LadderConfig, ScenarioParams, Simulation,
                     StepContext, build_env, check_kernel_footprints,
                     make_iteration_core, make_neighbor_apply, next_rung,
                     realized_footprint, registered_kernels, stage_pool)
from .ensemble import (EnsembleCapacityLadder, EnsembleEngine, EnsembleState,
                       grow_stacked_pool, make_ensemble_core)
from .forces import ForceParams
from .grid import (BuildResult, GridBuilderDeprecationWarning, GridSpec,
                   GridState, PairKernel, PairList,
                   PairListConfig, RebuildPolicy, counting_sort_order,
                   make_builder)
from .health import HealthConfig, HealthFault
from .simcheck import (DegradationPolicy, RunReport, SimCheckpointer,
                       SupervisedRunner, restore_dist_state,
                       restore_ensemble_state, restore_state,
                       save_dist_state, save_ensemble_state, save_state)
from .stats import StepStats

__all__ = ["AgentPool", "DtypePolicy", "make_pool", "pool_from_channels",
           "Behavior", "BehaviorEffects", "Chemotaxis", "GrowDivide",
           "Infection", "NeuriteGrowth", "RandomDeath", "RandomWalk",
           "Secretion", "grow_channels", "grow_pool", "repack_slabs",
           "DiffusionSpec", "CapacityExhausted", "CapacityLadder",
           "EngineConfig", "EngineState", "LadderConfig", "PairListConfig",
           "RebuildPolicy", "Simulation", "StepContext", "build_env",
           "check_kernel_footprints", "make_iteration_core",
           "make_neighbor_apply", "next_rung", "realized_footprint",
           "registered_kernels", "stage_pool", "ForceParams", "BuildResult",
           "GridBuilderDeprecationWarning", "GridSpec", "GridState",
           "PairKernel", "PairList",
           "counting_sort_order", "make_builder", "HealthConfig",
           "HealthFault", "DegradationPolicy", "RunReport",
           "SimCheckpointer", "SupervisedRunner", "restore_dist_state",
           "restore_ensemble_state", "restore_state", "save_dist_state",
           "save_ensemble_state", "save_state", "StepStats",
           "ScenarioParams", "EnsembleCapacityLadder", "EnsembleEngine",
           "EnsembleState", "grow_stacked_pool", "make_ensemble_core",
           "DistConfig", "DistState", "DistributedSimulation",
           "DistributedCapacityLadder"]
