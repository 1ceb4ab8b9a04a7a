"""repro_torch.serve — paged KV pool (paper §4.3), continuous batching
(paper §3.2) and the simulation service over ensemble lanes, ports of
``repro.serve``."""
from .kv_cache import (PagedCacheSpec, PagedCacheState, admit_sequence,
                       append_token, gather_kv, init_cache, release_sequence)
from .batching import ContinuousBatcher, Finished, Request
from .sim_service import FinishedSim, SimRequest, SimService

__all__ = ["PagedCacheSpec", "PagedCacheState", "admit_sequence",
           "append_token", "gather_kv", "init_cache", "release_sequence",
           "ContinuousBatcher", "Finished", "Request", "FinishedSim",
           "SimRequest", "SimService"]
