"""Data-parallel training and sharded matching on torch.distributed (twin
of `rift_tpu.parallel`): process groups, batch shards, replicated state,
the sharded train step and the sharded mutual nearest neighbours."""
from .mesh import (broadcast_object, initialize_multihost, rank_and_world,  # noqa: F401
                   replicate, shard_batch)
from .sharded_ops import make_sharded_train_step, sharded_mutual_nn  # noqa: F401
