"""Determinism helpers: the port of ``pigan_thz_tpu/utils/seed.py``
(reference core/utils/set_seed.py:8-34).

``set_seed`` seeds what the JAX package's seeds (Python's ``random``,
numpy's global generator, ``PYTHONHASHSEED``) and torch's global generators
on the CPU and every CUDA device, and returns a CPU ``torch.Generator``
seeded with ``seed``: the port's root key, which the port threads through
its stochastic functions as the JAX package threads its key.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)          # the CPU generator and every CUDA device's
    return torch.Generator().manual_seed(seed)
