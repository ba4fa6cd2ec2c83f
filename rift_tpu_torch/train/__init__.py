"""Classification training of the PVCNN classifier and registration
evaluation (twin of `rift_tpu.train`)."""
from .config import (EvalConfig, ExperimentConfig, apply_overrides, get_config,  # noqa: F401
                     presets)
from .loop import (build_model, evaluate_classification, evaluate_registration,  # noqa: F401
                   extractor_from_snapshot, load_trained_state, registration_probe,
                   resolve_extractor, train)
from .steps import TrainState, create_state, eval_step, train_step  # noqa: F401
