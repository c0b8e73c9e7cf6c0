"""repro_torch.train — the fault-tolerant training loop (port of
``repro.train``)."""
from repro_torch.train.trainer import Trainer, TrainState, make_train_step

__all__ = ["Trainer", "TrainState", "make_train_step"]
