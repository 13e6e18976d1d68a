"""Seed ensembles: the member-stacked state, initialisation and scoring, and
the functions that train N members through the GAN-training kernels."""

from .ensemble import (
    evaluate_ensemble,
    evaluate_ensemble_mean,
    init_ensemble_states,
    member_generator,
)
from .state_utils import EnsembleState, tree_stack, tree_unstack

__all__ = [
    "EnsembleState",
    "evaluate_ensemble",
    "evaluate_ensemble_mean",
    "init_ensemble_states",
    "member_generator",
    "tree_stack",
    "tree_unstack",
]
