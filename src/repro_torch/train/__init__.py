"""The LM's training path (port of ``repro.train``): the train step and
the structure-aware expert rebalancer."""
from repro_torch.train.step import (TrainState, init_state, loss_fn,
                                    make_train_step)

__all__ = ["TrainState", "init_state", "loss_fn", "make_train_step"]
