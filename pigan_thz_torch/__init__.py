"""pigan_thz_torch — the PyTorch / CUDA port of pigan_thz_tpu.

A second package beside the JAX one, for NVIDIA Hopper (H100).  It imports
``torch`` and numpy and never JAX: the JAX package stays the reference, and
the port's tests hold each module against it on the same inputs.

The port goes slice by slice (ROADMAP.md).  The slices that exist:

- the inverse-design serving cycle on the baseline MLP trio
  (``serve.make_inverse_design_fn``): generator and frozen forward
  surrogate, each run on the card by a hand-written CUDA kernel
  (``csrc/fused_mlp_chain.cu``, bound in ``ops/fused_kernels.py``);
- dataset generation, CSV I/O and CST conversion (``data/``), whose peak
  metrics run the dip-qualification kernel (``csrc/dip_qualification.cu``,
  bound in ``ops/peaks.py``);
- 1e6-candidate inverse-design screening (``design/screening.py``): the
  surrogate and the peak analysis per chunk;
- forward-surrogate pretraining (``train/trainer.py``), each chunk of
  epochs one launch of the forward-training kernel
  (``csrc/forward_train.cu``, bound in ``ops/forward_train.py``), or the
  eager autograd step (``train/steps.py``);
- the ``generate-data``, ``convert-cst`` and ``pretrain-forward`` commands
  (``cli.py``).
"""

from .config import (
    DataConfig,
    PiGanConfig,
    apply_overrides,
    default_config,
)

__version__ = "0.1.0"

__all__ = [
    "DataConfig",
    "PiGanConfig",
    "apply_overrides",
    "default_config",
    "__version__",
]
