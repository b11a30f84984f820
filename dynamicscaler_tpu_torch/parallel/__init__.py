"""Process groups of the port: ``dist`` (rendezvous and barrier of several
processes, the batch eval's), ``mesh`` (the window batch of every DDIM step
split over several cards, one process a card, the panorama CLI's
``--data_parallel_devices``) and ``dryrun`` (the tiny i2v sampler over
several ranks)."""

from dynamicscaler_tpu_torch.parallel.dist import (
    add_distributed_flags,
    barrier,
    destroy_distributed,
    initialize_distributed,
    initialize_from_args,
    process_count,
    process_index,
)
from dynamicscaler_tpu_torch.parallel.mesh import constrain_window_batch, make_mesh, window_sharding

__all__ = ["add_distributed_flags", "barrier", "constrain_window_batch", "destroy_distributed",
           "initialize_distributed", "initialize_from_args", "make_mesh", "process_count", "process_index",
           "window_sharding"]
