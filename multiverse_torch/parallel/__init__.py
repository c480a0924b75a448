"""Data and tensor parallelism over GPUs (``torch.distributed``, one
process a device): the port of ``multiverse_tpu/parallel``."""

from multiverse_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_mean,
    broadcast_params,
    gather_outputs,
    gather_rows,
    init_sharded_train_state,
    launch,
    map_tensors,
    make_mesh,
    make_mesh_for_batch,
    make_sharded_beam_step,
    make_sharded_eval_step,
    make_sharded_train_step,
    replicate,
    shard_batch,
    sharded_loss_and_grads,
)
from multiverse_torch.parallel.tensor import (  # noqa: F401
    Shard,
    gather_params,
    leaf_pspec,
    param_pspecs,
    shard_params,
)
