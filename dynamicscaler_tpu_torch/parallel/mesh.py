"""Window data parallel over several cards: one process a card.

Counterpart of ``dynamicscaler_tpu/parallel/mesh.py``, with its public names,
written in PyTorch's idiom rather than as a sharding annotation:

* every DDIM step's CFG-packed window batch is an independent set of UNet
  rows. Every rank holds the whole batch (the latent and the windows are
  replicated); rank 0's batch and contexts are broadcast, each rank runs
  one contiguous share of it through the UNet, and all ranks gather the eps
  with ``all_gather_into_tensor`` (:func:`apply_sharded`). The CFG combine,
  DDIM, the masks and the ordered scatter then run the same on every rank,
  so every rank holds rank 0's latent;
* the share rule (:func:`share_bounds`): where the batch holds at least as
  many UNet microbatches as ranks, a share is a run of whole microbatches, so
  each UNet call sees exactly the rows it sees on one card (stage 1's 88 rows
  in microbatches of 8 split 3/3/3/2 over 4 ranks). Where it holds fewer,
  the rows are cut into near-equal runs. Each share is padded with zero rows
  to the largest one for the gather, and the pad dropped after it;
* the latent stays whole on every rank: about 8 MB in fp32 at the CLI's
  2048x1024 panorama. So :func:`latent_sharding` and
  :func:`constrain_latent` set no layout. The JAX ``seq`` axis (the sphere
  sampler's W-slab ``shard_map`` with a ``psum``) is a TPU memory layout with
  no counterpart here: ``make_mesh(n_data, n_seq)`` still takes ``n_seq`` and
  splits the window batch over all ``n_data * n_seq`` ranks. The JAX mesh
  repeats the UNet work along ``seq``, so both give the same latents.

On the card each rank is one process on ``cuda:<rank>`` in an NCCL group; on
the CPU, where the caller asks for it (the tests, ``--dev_tiny``), the group
runs on gloo. :func:`launch` starts the ranks. Nothing falls back: a rank that
fails or an NCCL group that does not form fails the run.
"""

from __future__ import annotations

import dataclasses
import itertools
import socket
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """The ranks of one run: the process group, this rank, the group's size
    and this rank's device; ``n_data x n_seq`` the JAX mesh's shape. It keeps
    the time of the window batches' collectives (:meth:`take_gather_seconds`)."""

    group: object
    rank: int
    size: int
    device: torch.device
    n_data: int
    n_seq: int = 1
    _spans: list = dataclasses.field(default_factory=list, repr=False)
    _batches: int = dataclasses.field(default=0, repr=False)

    def _timed(self, op, t: torch.Tensor) -> None:
        """Run the collective ``op`` and keep its time, from when this
        rank's operands are ready to when the collective is done (so the
        wait for the slowest rank is in it): CUDA events on the current
        stream on the card, the host clock on the CPU (gloo returns when
        it is done)."""
        if t.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            op()
            end.record()
            self._spans.append((start, end))
        else:
            t0 = time.perf_counter()
            op()
            self._spans.append(time.perf_counter() - t0)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (contiguous) overwritten with rank 0's, in place; returned."""
        self._timed(lambda: dist.broadcast(t, src=0, group=self.group), t)
        return t

    def all_gather(self, out: torch.Tensor, x: torch.Tensor) -> None:
        """``out`` [size * n, ...] <- every rank's ``x`` [n, ...] in rank order."""
        self._timed(lambda: dist.all_gather_into_tensor(out, x, group=self.group), x)

    def take_gather_seconds(self) -> Tuple[int, float]:
        """(window batches, seconds in their collectives) since the last
        call; waits for the card."""
        spans, batches, self._spans, self._batches = self._spans, self._batches, [], 0
        if spans and not isinstance(spans[0], float):
            torch.cuda.synchronize(self.device)
            return batches, sum(s.elapsed_time(e) for s, e in spans) / 1e3
        return batches, float(sum(spans))

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world_size: int, port: int, device_type: str = "cuda") -> None:
    """Join this process to the default group at ``tcp://127.0.0.1:port``:
    on the card as rank ``rank`` on ``cuda:<rank>`` (set before anything
    else touches CUDA: the kernels' cached SM count and shared-memory
    attributes are per device) over NCCL; on the CPU over gloo with one
    torch thread a rank."""
    init = dict(init_method=f"tcp://127.0.0.1:{port}", world_size=world_size, rank=rank)
    if device_type == "cuda":
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs cuda:{rank}; this machine has {torch.cuda.device_count()} cards")
        torch.cuda.set_device(rank)
        # device_id binds the group to the card and forms the NCCL communicator now, not in the first gather
        dist.init_process_group("nccl", device_id=torch.device("cuda", rank), **init)
    elif device_type == "cpu":
        torch.set_num_threads(1)
        dist.init_process_group("gloo", **init)
    else:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")


def _rank_main(rank, fn, world_size, port, device_type, args):
    init_rank(rank, world_size, port, device_type)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n_ranks: int, args: Sequence = (), device_type: str = "cuda",
           timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``n_ranks`` spawned processes joined in one
    group (:func:`init_rank`; ``fn`` and ``args`` must pickle). Returns when
    every rank has returned. A rank that raises or dies fails the launch and
    the others are terminated; past ``timeout`` seconds every rank is killed
    and ``TimeoutError`` raised."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(fn, n_ranks, free_port(), device_type, tuple(args)),
                             nprocs=n_ranks, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(None if deadline is None else max(0.0, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{n_ranks} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1, devices=None) -> Mesh:
    """The mesh of this process's group (joined by :func:`launch` or
    :func:`init_rank`): ``n_data x n_seq`` must be the group's size (default
    ``n_data``: size // n_seq). ``devices`` gives each rank's device, in rank
    order (default ``cuda:<rank>`` on NCCL, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group of its ranks (parallel.mesh.launch or init_rank)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = size // n_seq
    if n_data * n_seq != size:
        raise ValueError(f"a {n_data} x {n_seq} mesh needs {n_data * n_seq} ranks; the group has {size}")
    if devices is None:
        cuda = dist.get_backend() == "nccl"
        devices = [torch.device("cuda", r) if cuda else torch.device("cpu") for r in range(size)]
    return Mesh(dist.group.WORLD, rank, size, torch.device(devices[rank]), n_data, n_seq)


def share_bounds(n_rows: int, n_ranks: int, microbatch: int = 0) -> List[Tuple[int, int]]:
    """Each rank's contiguous run of rows ``[start, stop)`` of an ``n_rows``
    window batch: whole microbatches of ``microbatch`` rows, the first ranks
    one more, where there are at least as many as ranks; else near-equal runs
    of rows (a rank may get none)."""
    n_mb = -(-n_rows // microbatch) if microbatch else 1
    unit, units = (microbatch, n_mb) if microbatch and n_mb >= n_ranks else (1, n_rows)
    base, extra = divmod(units, n_ranks)
    bounds, start = [], 0
    for r in range(n_ranks):
        stop = start + base + (r < extra)
        bounds.append((min(start * unit, n_rows), min(stop * unit, n_rows)))
        start = stop
    return bounds


def window_sharding(mesh: Optional[Mesh], n_rows: int, microbatch: int = 0) -> List[Tuple[int, int]]:
    """The window batch's layout on the mesh: every rank's share
    (:func:`share_bounds`); one share of every row without a mesh."""
    return share_bounds(n_rows, mesh.size if mesh is not None else 1, microbatch)


def latent_sharding(mesh: Optional[Mesh]) -> None:
    """The panorama latent's layout: whole on every rank, so none."""
    return None


def constrain_window_batch(x: torch.Tensor, mesh: Optional[Mesh], microbatch: int = 0) -> torch.Tensor:
    """This rank's share of the window batch ``x`` (``x`` without a mesh)."""
    if mesh is None:
        return x
    lo, hi = window_sharding(mesh, x.shape[0], microbatch)[mesh.rank]
    return x[lo:hi]


def constrain_latent(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The latent is whole on every rank: ``x`` itself."""
    return x


def apply_sharded(mesh: Mesh, fn: Callable, x: torch.Tensor, context: torch.Tensor, microbatch: int = 0,
                  out_channels: Optional[int] = None) -> torch.Tensor:
    """``fn(x_share, context_share)`` on this rank's share of the window
    batch ``x`` [N, ...] and its ``context`` rows, gathered from every rank
    into the whole [N, ..., out_channels] fp32 result, in row order. The
    shares are cut from rank 0's ``x`` and ``context`` (broadcast first):
    the ranks compute the batch each on its own, and on the card CLIP's
    image encode, under the contexts, does not give the same bits in every
    process (PERF.md), so each rank's own rows could feed the UNet
    different inputs and the ranks' latents drift apart."""
    mesh._batches += 1
    x = mesh.broadcast(x.contiguous().clone())
    context = mesh.broadcast(context.contiguous().clone())
    bounds = window_sharding(mesh, x.shape[0], microbatch)
    rows = max(hi - lo for lo, hi in bounds)
    lo, hi = bounds[mesh.rank]
    shape = tuple(x.shape[1:-1]) + (out_channels or x.shape[-1],)
    mine = fn(x[lo:hi], context[lo:hi]) if hi > lo else x.new_zeros((0,) + shape, dtype=torch.float32)
    if mine.shape[0] < rows:
        mine = torch.cat([mine, mine.new_zeros((rows - mine.shape[0],) + shape)])
    out = mine.new_empty((mesh.size * rows,) + shape)
    mesh.all_gather(out, mine.contiguous())
    if all(b - a == rows for a, b in bounds):
        return out
    return torch.cat([out[r * rows:r * rows + b - a] for r, (a, b) in enumerate(bounds)])


def replicate(model, mesh: Optional[Mesh]):
    """Broadcast every parameter and buffer from rank 0, so that the ranks
    hold the same weights whatever built them. ``model`` is a module or a
    bundle with ``components()``; returned."""
    if mesh is None:
        return model
    modules = [m for _, m in model.components()] if hasattr(model, "components") else [model]
    with torch.no_grad():
        for t in itertools.chain.from_iterable(itertools.chain(m.parameters(), m.buffers()) for m in modules):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return model
