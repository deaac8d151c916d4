"""The training substrate (port of :mod:`repro.training`): AdamW and its
schedules, int8 gradient compression, the train step, data pipelines and
checkpoints."""
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    wsd_schedule,
)
from repro_torch.training.train_step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_train_step,
)
