"""Training of the port: AdamW, gradient compression and the train step."""
from .trainer import TrainState, init_train_state, make_train_step  # noqa: F401
from .optimizer import adamw_init, adamw_update, cosine_schedule    # noqa: F401
