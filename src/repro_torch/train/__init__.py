"""Training and serving step builders and the FPM-guided schedule
(counterpart of ``repro.train``)."""

from repro_torch.train.step import (TrainState, make_train_step, make_serve_step,
                                    init_train_state)
from repro_torch.train.fpm_schedule import choose_schedule, fpm_batch_partition

__all__ = ["TrainState", "make_train_step", "make_serve_step",
           "init_train_state", "choose_schedule", "fpm_batch_partition"]
