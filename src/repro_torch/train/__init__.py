"""repro_torch.train — checkpoint/restore (port of ``repro.train``'s
checkpoint module; the optimizer, train step and data pipeline are
ROADMAP.md Queue 1 item 17b)."""
