"""repro_torch.serve — paged KV pool (paper §4.3) + continuous batching
(paper §3.2), ports of ``repro.serve``. The simulation service
(``sim_service``) is ROADMAP.md Queue 1 item 13."""
from .kv_cache import (PagedCacheSpec, PagedCacheState, admit_sequence,
                       append_token, gather_kv, init_cache, release_sequence)
from .batching import ContinuousBatcher, Finished, Request

__all__ = ["PagedCacheSpec", "PagedCacheState", "admit_sequence",
           "append_token", "gather_kv", "init_cache", "release_sequence",
           "ContinuousBatcher", "Finished", "Request"]
