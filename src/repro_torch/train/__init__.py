"""LM training on the card (the twin of ``repro.train``): AdamW with
error-feedback compression (``optimizer``), atomic checkpoints
(``checkpoint``) and the restartable ``Trainer`` (``train_loop``)."""
from .optimizer import OptConfig
from .train_loop import SimulatedFailure, TrainConfig, Trainer

__all__ = ["OptConfig", "TrainConfig", "Trainer", "SimulatedFailure"]
