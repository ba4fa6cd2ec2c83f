"""Registration: Kabsch, GNC-TLS, the TEASER-style pose, flip-hypothesis
consensus matching, metrics and the batched pipelines."""
from .consensus import (choose_hypothesis, consensus_match, hypothesis_matches,  # noqa: F401
                        rigidity_score)
from .gnc import compatibility_core, gnc_pose, teaser_pose  # noqa: F401
from .kabsch import rotation_from_h, weighted_kabsch  # noqa: F401
from .metrics import pair_errors  # noqa: F401
from .pipeline import register_batch, register_pair, register_pair_from_matches  # noqa: F401
