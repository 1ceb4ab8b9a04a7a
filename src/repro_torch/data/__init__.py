"""repro_torch.data — the synthetic token pipeline (port of
``repro.data``)."""

from .pipeline import DataConfig, batch_at, iterate, rank_batch_at

__all__ = ["DataConfig", "batch_at", "iterate", "rank_batch_at"]
