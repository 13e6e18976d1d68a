"""Ensembles and data parallelism: the member-stacked state, initialisation
and scoring, the λ-ablation sweep with runtime loss weights, the functions
that train N seed members through the GAN-training kernels
(``ensemble_megakernel.py``), and data-parallel training over
``torch.distributed`` ranks (``mesh.py``, ``sharding.py``)."""

from .ensemble import (
    WEIGHT_NAMES,
    EnsembleSettings,
    evaluate_ensemble,
    evaluate_ensemble_mean,
    gather_ensemble,
    init_ensemble_states,
    make_ensemble_epoch_fn,
    make_ensemble_multi_epoch_fn,
    make_ensemble_pigan_step,
    member_generator,
    shard_ensemble,
    weight_vector,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    BatchShard,
    Mesh,
    batch_sharding,
    initialize_distributed,
    make_mesh,
    replicated,
)
from .sharding import (
    make_parallel_epoch_fn,
    make_parallel_multi_epoch_fn,
    replicate_dataset,
    shard_state,
)
from .state_utils import EnsembleState, tree_stack, tree_unstack

__all__ = [
    "DATA_AXIS",
    "BatchShard",
    "EnsembleSettings",
    "EnsembleState",
    "MODEL_AXIS",
    "Mesh",
    "WEIGHT_NAMES",
    "batch_sharding",
    "evaluate_ensemble",
    "evaluate_ensemble_mean",
    "gather_ensemble",
    "init_ensemble_states",
    "initialize_distributed",
    "make_ensemble_epoch_fn",
    "make_ensemble_multi_epoch_fn",
    "make_ensemble_pigan_step",
    "make_mesh",
    "make_parallel_epoch_fn",
    "make_parallel_multi_epoch_fn",
    "member_generator",
    "replicate_dataset",
    "replicated",
    "shard_ensemble",
    "shard_state",
    "tree_stack",
    "tree_unstack",
    "weight_vector",
]
