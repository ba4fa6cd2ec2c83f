"""Registration: Kabsch, GNC-TLS, metrics and the batched pipeline."""
from .gnc import gnc_pose  # noqa: F401
from .kabsch import rotation_from_h, weighted_kabsch  # noqa: F401
from .metrics import pair_errors  # noqa: F401
from .pipeline import register_batch  # noqa: F401
