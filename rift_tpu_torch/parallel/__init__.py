"""Data-parallel training and sharded matching on torch.distributed (twin
of `rift_tpu.parallel`): process groups, batch shards, replicated state,
the sharded train step, the sharded mutual nearest neighbours and the
sequence's sharded pose-graph and bundle-adjustment solves."""
from .mesh import (broadcast_object, initialize_multihost, rank_and_world,  # noqa: F401
                   replicate, shard_batch)
from .sharded_ops import (bundle_adjust_sharded, make_sharded_train_step,  # noqa: F401
                          optimize_pose_graph_sharded, sharded_mutual_nn)
