from repro_torch.train.step import (  # noqa: F401
    TrainState,
    build_train_step,
    make_train_state,
)
