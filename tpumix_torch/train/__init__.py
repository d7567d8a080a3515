from tpumix_torch.train.state import (  # noqa: F401
    TrainState,
    adam_with_l2,
    create_train_state,
    make_eval_step,
    make_feature_train_step,
    make_train_step,
)
from tpumix_torch.train.trainer import SyntheticTrainer, Trainer, TrainResult  # noqa: F401
