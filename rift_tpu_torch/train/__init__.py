"""Classification training of the PVCNN classifier and part segmentation
training of the ShapeNet PVCNN (one card or data-parallel), the
classification evaluation, and registration evaluation (twin of
`rift_tpu.train`)."""
from .config import (EvalConfig, ExperimentConfig, apply_overrides, get_config,  # noqa: F401
                     presets)
from .loop import (CORRUPTION_LEVELS, build_model, build_seg_model,  # noqa: F401
                   evaluate_classification, evaluate_classification_ckpt,
                   evaluate_registration, extractor_from_snapshot, hard_tier_dataset,
                   load_trained_state, make_distributed_step, registration_probe,
                   resolve_extractor, rotation_consistency, train,
                   train_segmentation)
from .steps import TrainState, create_state, eval_step, train_step  # noqa: F401
