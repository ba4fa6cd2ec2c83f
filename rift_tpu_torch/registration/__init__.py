"""Registration: Kabsch, GNC-TLS and FGR, the TEASER-style pose, RANSAC,
point-to-point and point-to-plane ICP, flip-hypothesis consensus matching,
metrics, the batched pipelines, and the multi-scan mapping (pose graph,
bundle adjustment, the sequence pipeline)."""
from .consensus import (choose_hypothesis, consensus_match, hypothesis_matches,  # noqa: F401
                        rigidity_score)
from .gnc import compatibility_core, fgr_pose, gnc_pose, teaser_pose  # noqa: F401
from .icp import icp_plane_pose, icp_pose  # noqa: F401
from .kabsch import rotation_from_h, weighted_kabsch  # noqa: F401
from .metrics import pair_errors, rpmnet_metrics  # noqa: F401
from .pipeline import (METHODS, register_batch, register_pair,  # noqa: F401
                       register_pair_from_matches)
from .ransac import ransac_from_samples, ransac_pose, ransac_samples  # noqa: F401
from .bundle_adjust import bundle_adjust  # noqa: F401
from .pose_graph import optimize_pose_graph, trajectory_ate  # noqa: F401
from .sequence import SequenceResult, build_edges, map_sequence, register_edges  # noqa: F401
