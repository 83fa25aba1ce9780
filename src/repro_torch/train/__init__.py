"""Training of the port: the train step (one device or sharded over a
mesh), checkpoints and the fault-tolerance supervisor."""
from repro_torch.train.step import (  # noqa: F401
    TrainConfig, loss_fn, make_adapter_step, make_opt_state,
    make_train_step, place_train_state, train_specs)
