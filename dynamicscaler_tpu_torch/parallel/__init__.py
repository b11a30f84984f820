"""Process groups of the port: ``dist`` (rendezvous and barrier of several
processes; the window data parallel of the JAX ``parallel/mesh.py`` is not
ported)."""

from dynamicscaler_tpu_torch.parallel.dist import (
    add_distributed_flags,
    barrier,
    destroy_distributed,
    initialize_distributed,
    initialize_from_args,
    process_count,
    process_index,
)

__all__ = ["add_distributed_flags", "barrier", "destroy_distributed", "initialize_distributed",
           "initialize_from_args", "process_count", "process_index"]
