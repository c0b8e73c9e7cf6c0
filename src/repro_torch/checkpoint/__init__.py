"""repro_torch.checkpoint — the round checkpoints of the out-of-core sort
(``store``: atomic, sha256-checked, zlib chunks, JSON path list)."""
