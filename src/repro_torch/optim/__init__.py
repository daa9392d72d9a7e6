"""The optimizer (twin of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, TrainState,
                                     abstract_train_state, adamw_init,
                                     adamw_update, make_train_state)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "TrainState",
           "make_train_state", "abstract_train_state"]
