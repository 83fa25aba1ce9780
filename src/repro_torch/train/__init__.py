"""Training of the port: the train step on one device."""
from repro_torch.train.step import (  # noqa: F401
    TrainConfig, loss_fn, make_adapter_step, make_opt_state,
    make_train_step)
