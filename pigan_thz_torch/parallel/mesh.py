"""Ranks and their rows: the port of ``pigan_thz_tpu/parallel/mesh.py``.

The JAX package lays a (data, model) ``jax.sharding.Mesh`` over its devices
and lets XLA place the collectives of one global program.  Here every rank
is a process of a ``torch.distributed`` group with one device, and the
program says where it meets the others:

- ``initialize_distributed`` joins the group (``init_process_group`` over a
  TCP store at ``host:port``), ``make_mesh(data, model)`` lays a 2-D mesh
  over it (``Mesh``): rank r is at (r // model, r % model), the JAX
  package's device order; its data group holds the ranks of its model
  index, its model group the ranks of its data index (``dist.new_group``).
  The data axis splits the batch (``BatchShard``), the model axis the wide
  layers (``tensor.py``).
- ``replicated(mesh)`` places a tensor on every rank as rank 0 holds it (a
  broadcast in place); ``batch_sharding(mesh, B)`` is this rank's share of a
  global batch of B rows (``BatchShard``): its contiguous rows, the global
  shape of a draw whose local shape the step knows, the differentiable sum
  over ranks that BatchNorm's statistics take (``models/blocks.py``), and
  the mean over ranks that gradients and metric rows take.

The backend is named, not guessed: ``nccl`` for CUDA ranks on distinct
devices, ``gloo`` for CPU ranks and for CUDA ranks that share a device (NCCL
refuses two ranks on one device; ``initialize_distributed`` raises for such a
group rather than switching).  Every collective here takes the tensors on the
rank's device as they are, CUDA tensors included: gloo moves CUDA tensors
through the host itself.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the (data, model) mesh: ``size`` ranks in all,
    of which this is ``rank``, computing on ``device``; ``model`` ranks
    along ``MODEL_AXIS`` and ``size // model`` along ``DATA_AXIS``.
    ``group`` is this rank's data group (None: the default group, when the
    model axis is 1), ``model_group`` its model group (None when it is 1);
    ``min_shard_dim`` the least width of a leaf the model axis splits
    (``tensor.py``).
    ``barrier`` and the broadcasts span every rank; ``all_gather`` and
    ``mean`` the data group."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None
    model: int = 1
    model_group: object = None
    min_shard_dim: int = 512

    @property
    def data_size(self) -> int:
        return self.size // self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.model}

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def all_gather(self, tensor: torch.Tensor) -> list[torch.Tensor]:
        """Every data rank's ``tensor`` (equal shapes), in data-rank order."""
        if self.data_size == 1:
            return [tensor]
        out = [torch.empty_like(tensor) for _ in range(self.data_size)]
        dist.all_gather(out, tensor.contiguous(), group=self.group)
        return out

    def broadcast_(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s values into ``tensor`` on every rank, in place."""
        dist.broadcast(tensor, src=src)
        return tensor

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank (tensors in it on
        the CPU: they travel pickled)."""
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def mean(self, tensor: torch.Tensor) -> torch.Tensor:
        """The mean over the data ranks of ``tensor`` (a new tensor, no
        gradient); the result is the same bits on every rank."""
        out = tensor.detach().clone()
        if self.data_size == 1:
            return out
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out / self.data_size


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the gradient:
    ``torch.distributed.nn.functional.all_reduce``'s semantics (deprecated
    in this torch)."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _SumOverRanks.apply(grad, ctx.group), None


def sum_over_ranks(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the data ranks of ``tensor``, differentiable: the
    gradient that reaches each rank's ``tensor`` is the sum of every rank's
    gradient of the result."""
    if mesh.data_size == 1:
        return tensor
    return _SumOverRanks.apply(tensor, mesh.group)


@dataclass(frozen=True)
class BatchShard:
    """This rank's contiguous rows ``[start, stop)`` of a global batch of
    ``global_batch`` rows.  The training steps take it as ``shard=``
    (``train/steps.py``): they draw everything at the global shape and keep
    these rows, take their BatchNorm statistics over every rank's rows
    (``sum``), and average their gradients over the ranks (``mean``)."""

    mesh: Mesh
    global_batch: int

    def __post_init__(self):
        world = self.mesh.data_size
        if self.global_batch % world:
            raise ValueError(f"global batch {self.global_batch} is not divisible by the "
                             f"{world} ranks of the data axis: a mean of unequal shards' "
                             "means is not the global mean")
        if self.global_batch // world < 2:
            raise ValueError(f"global batch {self.global_batch} over {world} ranks leaves "
                             "fewer than 2 rows a rank")

    @property
    def world(self) -> int:
        return self.mesh.data_size

    @property
    def local(self) -> int:
        return self.global_batch // self.mesh.data_size

    @property
    def start(self) -> int:
        return self.mesh.data_rank * self.local

    @property
    def stop(self) -> int:
        return self.start + self.local

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x``, whose leading dimension is the global
        batch, or k global batches stacked (the D phase's [real; fake]: this
        rank's rows of each block, stacked in turn), or 1 (shared by every
        row: kept whole)."""
        n, g = x.shape[0], self.global_batch
        if n == 1:
            return x
        k, rest = divmod(n, g)
        if rest or not k:
            raise ValueError(f"{n} rows is not a whole number of global batches of {g}")
        if k == 1:
            return x[self.start:self.stop]
        return torch.cat([x[j * g + self.start:j * g + self.stop] for j in range(k)])

    def global_shape(self, shape: tuple) -> tuple:
        """The global shape of a draw of local ``shape``: its rows this
        rank's share of whole global batches, or 1 (shared)."""
        n = shape[0]
        if n == 1:
            return tuple(shape)
        k, rest = divmod(n, self.local)
        if rest:
            raise ValueError(f"{n} rows is not a whole number of local batches of {self.local}")
        return (k * self.global_batch, *shape[1:])

    def sum(self, tensor: torch.Tensor) -> torch.Tensor:
        return sum_over_ranks(tensor, self.mesh)

    def mean(self, tensor: torch.Tensor) -> torch.Tensor:
        return self.mesh.mean(tensor)


def _local_rank(process_id: int) -> int:
    return int(os.environ.get("LOCAL_RANK", process_id))


def _device_identity(device: torch.device) -> str:
    return f"{socket.gethostname()}:{torch.cuda.get_device_properties(device).uuid}"


_JOINED: dict = {}


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: torch.device | str = "cuda",
) -> None:
    """Join the data-parallel group: call once per process before
    ``make_mesh``.  ``coordinator_address`` is rank 0's ``host:port``
    (default ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size
    (default ``WORLD_SIZE``), ``process_id`` this rank (default ``RANK``).
    ``device`` is this rank's: "cuda" is ``cuda:<LOCAL_RANK>`` (default the
    rank), "cpu" the CPU.  ``backend`` None is ``nccl`` for a CUDA device
    and ``gloo`` for the CPU; ranks that share a CUDA device must pass
    ``backend="gloo"``: a NCCL group whose ranks share a device raises
    ``ValueError``.  On CUDA ranks rank 0 builds the kernels' library
    (``ops/_cuda_build.py``) before any rank goes on."""
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = int(os.environ["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(os.environ["RANK"] if process_id is None else process_id)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: device 'cuda' and no CUDA device "
                               "(pass device='cpu' for CPU ranks)")
        if device.index is None:
            device = torch.device("cuda", _local_rank(rank))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: use one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend 'nccl' needs CUDA ranks; CPU ranks take 'gloo'")
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0)
    if backend == "nccl":
        # NCCL refuses two ranks on one device at its first collective; say
        # so before the group exists
        store.set(f"pigan_device/{rank}", _device_identity(device))
        ids = [store.get(f"pigan_device/{r}").decode() for r in range(world)]
        if len(set(ids)) != world:
            raise ValueError(f"backend 'nccl' with ranks that share a device ({ids}): pass "
                             "backend='gloo' for ranks on one device")
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    _JOINED.update(device=device, backend=backend)
    if device.type == "cuda":
        # the kernels' library: rank 0 builds it, then every rank may load it
        # (a concurrent build is safe, but builds twice)
        from ..ops import _cuda_build

        if rank == 0:
            _cuda_build.build()
        if backend == "nccl":
            dist.barrier(device_ids=[device.index])
        else:
            dist.barrier()


def make_mesh(data: int | None = None, model: int = 1, min_shard_dim: int = 512) -> Mesh:
    """The group of ``initialize_distributed`` as a mesh of ``data`` x
    ``model`` ranks (``data`` default: all of them over ``model``).  Every
    rank builds every data and model group, in one order.  A state placed
    on the mesh splits its leaves of ``min_shard_dim`` and more (the JAX
    package's ``state_shardings`` default, 512)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call initialize_distributed first")
    n = dist.get_world_size()
    if model < 1:
        raise ValueError(f"make_mesh(model={model}): the model axis needs >= 1 rank")
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    rank, group, model_group = dist.get_rank(), None, None
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == rank // model:
                model_group = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == rank % model:
                group = g
    return Mesh(rank=rank, size=n, device=_JOINED["device"], backend=_JOINED["backend"],
                group=group, model=model, model_group=model_group,
                min_shard_dim=min_shard_dim)


def replicated(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """A placement that gives every rank the whole tensor as rank 0 holds
    it (in place)."""
    return mesh.broadcast_


def batch_sharding(mesh: Mesh, global_batch: int) -> BatchShard:
    """This rank's rows of a global batch of ``global_batch`` rows."""
    return BatchShard(mesh, global_batch)


def spawn_ranks(fn: Callable, world: int, *args) -> None:
    """Run ``fn(rank, world, coordinator_address, *args)`` in ``world``
    fresh processes (``torch.multiprocessing``, spawn) rendezvousing on a
    free localhost port, and wait for them.  A rank that fails raises here
    (``ProcessRaisedException`` / ``ProcessExitedException``) after the
    others are stopped."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))           # a free port for the rendezvous
        address = f"127.0.0.1:{s.getsockname()[1]}"
    mp.spawn(_rank_main, args=(fn, world, address, args), nprocs=world, join=True)


def _rank_main(rank: int, fn: Callable, world: int, address: str, args: tuple) -> None:
    try:
        fn(rank, world, address, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
