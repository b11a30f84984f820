"""Initialisation of a group of cooperating processes.

Counterpart of ``dynamicscaler_tpu/parallel/dist.py`` (the reference's
``setup_dist``, utils/utils.py:99-106, and its DDP launcher,
scripts/evaluation/ddp_wrapper.py:8-12). It is opt-in: a single process
needs no coordination. Flag precedence: the flags, then the launcher's
environment (``DSCALER_COORDINATOR`` / ``DSCALER_NUM_PROCESSES`` /
``DSCALER_PROCESS_ID``), else nothing.

The group runs on gloo. Its users (the batch eval) need only a rendezvous
and barriers, which move no data; gloo does that on the CPU and for ranks
that share one card, where NCCL refuses two ranks on one GPU. Every
generation still runs on the rank's card.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def add_distributed_flags(parser) -> None:
    """The three flags of a multi-process run on an argparse parser."""
    parser.add_argument("--coordinator", type=str, default="",
                        help="host:port of process 0; its presence turns on the process group "
                        "(the reference's env:// init_method)")
    parser.add_argument("--num_processes", type=int, default=-1,
                        help="total process count (reference world_size)")
    parser.add_argument("--process_id", type=int, default=-1,
                        help="this process's rank (reference local rank)")


def initialize_distributed(coordinator: str = "", num_processes: int = -1, process_id: int = -1) -> bool:
    """Join the gloo group at ``tcp://coordinator`` when the flags or the
    environment name a coordinator. Returns True iff a group was joined."""
    coordinator = coordinator or os.environ.get("DSCALER_COORDINATOR", "")
    if not coordinator:
        return False
    if num_processes < 0:
        num_processes = int(os.environ.get("DSCALER_NUM_PROCESSES", "-1"))
    if process_id < 0:
        process_id = int(os.environ.get("DSCALER_PROCESS_ID", "-1"))
    if num_processes <= 0 or process_id < 0:
        raise ValueError("multi-process init needs --num_processes and --process_id along with --coordinator "
                         "(ddp_wrapper.py:8-12 reads the same trio from env)")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id)
    return True


def initialize_from_args(args) -> bool:
    return initialize_distributed(getattr(args, "coordinator", ""), getattr(args, "num_processes", -1),
                                  getattr(args, "process_id", -1))


def destroy_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank in the group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The group's size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(name: str = "dscaler") -> None:
    """Wait until every process of the group reaches a barrier. ``name``
    labels the call site, as in the JAX package; gloo's barrier takes
    none."""
    if process_count() > 1:
        dist.barrier()
