"""Data parallelism over ranks: the port of the data-parallel part of
``pigan_thz_tpu/parallel/sharding.py`` (:63-134).

The JAX package's parallel epoch is one global-batch program: the batch is
constrained to the mesh's data axis, the parameters are replicated, and XLA
inserts the gradient all-reduce, so BatchNorm's statistics are over the
whole global batch.  Here each rank runs that program's share:

- every rank holds the whole dataset on its device (``replicate_dataset``)
  and a replica of the state (``shard_state`` broadcasts rank 0's), and
  draws the same global batch indices and step seeds from its state's
  generator;
- each step (``train/steps.py`` with ``shard=``) trains on the rank's
  contiguous rows of the global batch, with everything it draws drawn at the
  global shape, BatchNorm over every rank's rows and each update's gradient
  averaged over the ranks before the optimiser, so the replicas stay equal;
- the epoch's metric rows are averaged over the ranks once a chunk, so every
  decision the host takes from them is the same on every rank.

With a model axis (``make_mesh(data, model)``, ``model`` > 1) the ranks of
one data index hold one replica between them: ``shard_state`` leaves each
its block of every leaf the placement rule splits (``tensor.py``:
``param_partition_spec``, ``state_shardings``, JAX :33-66) and the modules
compute split; the batch goes over the data axis alone.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..data.dataset import ThzDataset
from ..train.steps import make_multi_epoch_fn
from .mesh import Mesh, batch_sharding, replicated
from .tensor import param_partition_spec, shard_state_, state_shardings  # noqa: F401


def shard_state(state, mesh: Mesh, min_shard_dim: int | None = None):
    """Make every rank's ``state`` (a ``ForwardState`` or ``PiGanState``,
    whole) rank 0's, in place: its ``state_dict`` broadcast and loaded; then,
    on a model axis, this rank's part of it (``tensor.py:shard_state_``,
    leaves of ``min_shard_dim`` and more split, default the mesh's)."""
    payload = {k: v.cpu() if isinstance(v, torch.Tensor) else v
               for k, v in state.state_dict().items()}
    payload = mesh.broadcast_object(payload)
    if mesh.rank != 0:
        state.load_state_dict_(payload)
    if mesh.model > 1:
        shard_state_(state, mesh, mesh.min_shard_dim if min_shard_dim is None
                     else min_shard_dim)
    return state


def replicate_dataset(ds: ThzDataset, mesh: Mesh) -> ThzDataset:
    """Every rank holds the whole dataset, as rank 0 holds it, on its
    device; the tensors are overwritten in place."""
    if ds.spectra.device != mesh.device:
        raise ValueError(f"dataset on {ds.spectra.device}, this rank on {mesh.device}")
    place = replicated(mesh)
    for t in ds:
        place(t)
    return ds


def make_parallel_multi_epoch_fn(step_fn: Callable, batch_size: int, mesh: Mesh):
    """``train/steps.py:make_multi_epoch_fn`` over ranks:
    multi_epoch(state, ds, scales, indices=None, seeds=None, draws=None) ->
    (state, {key: (E,) per-epoch mean over the global batch}).  Each step
    gets the global batch and this rank's ``BatchShard`` of the data axis;
    the rows are averaged over the data ranks.  A global batch that the
    data axis does not divide raises ``ValueError``."""
    # one data rank (a model axis alone) trains on the whole batch
    shard = batch_sharding(mesh, batch_size) if mesh.data_size > 1 else None
    inner = make_multi_epoch_fn(step_fn, batch_size, shard=shard)

    def multi_epoch(state, ds: ThzDataset, scales: Sequence[float] | torch.Tensor,
                    indices: torch.Tensor | None = None, seeds: torch.Tensor | None = None,
                    draws=None):
        state, rows = inner(state, ds, scales, indices, seeds, draws)
        keys = list(rows)
        mean = mesh.mean(torch.stack([rows[k] for k in keys]))     # one collective
        return state, {k: mean[i] for i, k in enumerate(keys)}

    return multi_epoch


def make_parallel_epoch_fn(step_fn: Callable, batch_size: int, mesh: Mesh):
    """One epoch of ``make_parallel_multi_epoch_fn``: epoch(state, ds,
    scale=1.0, indices=None, seeds=None, draws=None) -> (state, {key: mean
    over the epoch's steps}); ``indices`` is (spe, B)."""
    multi = make_parallel_multi_epoch_fn(step_fn, batch_size, mesh)

    def epoch(state, ds: ThzDataset, scale: float = 1.0, indices: torch.Tensor | None = None,
              seeds: torch.Tensor | None = None, draws=None):
        state, rows = multi(state, ds, [scale], None if indices is None else indices[None],
                            seeds, draws)
        return state, {k: v[0] for k, v in rows.items()}

    return epoch
