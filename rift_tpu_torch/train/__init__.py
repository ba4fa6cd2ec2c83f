"""Classification training of the PVCNN classifier (twin of `rift_tpu.train`)."""
from .config import ExperimentConfig, get_config  # noqa: F401
from .loop import build_model, evaluate_classification, train  # noqa: F401
from .steps import TrainState, create_state, eval_step, train_step  # noqa: F401
