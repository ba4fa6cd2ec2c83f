"""Classification training of the PVCNN classifier and part segmentation
training of the ShapeNet PVCNN (one card or data-parallel), the
classification evaluation, registration evaluation and its method sweep,
feature extraction and the multi-scan mapping, the meters and the
profiling helpers (twin of `rift_tpu.train`)."""
from .config import (EvalConfig, ExperimentConfig, ModelConfig, OptimConfig,  # noqa: F401
                     TrainConfig, apply_overrides, get_config, presets)
from .loop import (CORRUPTION_LEVELS, build_model, build_seg_model,  # noqa: F401
                   evaluate_classification, evaluate_classification_ckpt,
                   evaluate_registration, evaluate_registration_sweep,
                   extract_features, extract_features_flips, extractor_from_snapshot,
                   hard_tier_dataset, load_trained_state, make_distributed_step,
                   registration_probe, resolve_extractor, rotation_consistency,
                   run_map_sequence, train, train_segmentation)
from .meters import (MeterClassification, MeterReflection, MeterRegistration,  # noqa: F401
                     MeterRPMNet, MeterShapeNetIoU)
from .profiling import StepTimer, annotate, trace  # noqa: F401
from .steps import TrainState, create_state, eval_step, train_step  # noqa: F401
