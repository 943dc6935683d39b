"""Training: AdamW, the train step with microbatches and gradient
compression, and the fault-tolerant controller.  A port of
``repro.train``."""
from . import compression, controller, optimizer, train_loop

__all__ = ["compression", "controller", "optimizer", "train_loop"]
