"""repro_torch.checkpoint — atomic, sha256-checked, zlib checkpoints of
nested trees (``store``): the out-of-core sort's round checkpoints and the
trainer's, with ``restore_checkpoint`` and ``AsyncCheckpointer``."""
from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          latest_steps, restore_blind,
                                          restore_checkpoint,
                                          save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_blind",
           "latest_step", "latest_steps", "AsyncCheckpointer"]
