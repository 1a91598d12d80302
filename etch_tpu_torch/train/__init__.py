from etch_tpu_torch.train.losses import compute_losses  # noqa: F401
from etch_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
    make_train_step_dynamic,
)
