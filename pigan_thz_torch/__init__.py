"""pigan_thz_torch — the PyTorch / CUDA port of pigan_thz_tpu.

A second package beside the JAX one, for NVIDIA Hopper (H100).  It imports
``torch`` and numpy and never JAX: the JAX package stays the reference, and
the port's tests hold each module against it on the same inputs.

The port goes slice by slice (ROADMAP.md).  The slices that exist:

- the inverse-design serving cycle (``serve.make_inverse_design_fn``):
  generator and frozen forward surrogate, the baseline models each run on
  the card by a hand-written CUDA kernel (``csrc/fused_mlp_chain.cu``,
  bound in ``ops/fused_kernels.py``), the enhanced ones through their
  modules; the bf16 and int8 cycles, ``torch.export`` artifacts, the
  ensemble designer and ``design/inverse.py:InverseDesigner``;
- dataset generation, CSV I/O, the native loader and ``.thzb`` cache, and
  CST conversion (``data/``), whose peak metrics run the dip-qualification
  kernel (``csrc/dip_qualification.cu``, bound in ``ops/peaks.py``);
- 1e6-candidate inverse-design screening (``design/screening.py``): the
  surrogate and the peak analysis per chunk, in fp32 or bf16;
- the model zoo (``models/``): the baseline MLP trio and the enhanced
  variants (residual and conv-attention generators; dual-encoder, conv and
  multi-scale discriminators with flax's spectral norm; branched, physics
  and uncertainty surrogates), with weights and state carried to and from
  the JAX package (``interop.py``);
- forward-surrogate pretraining (``train/trainer.py``), each chunk of
  epochs one launch of the forward-training kernel
  (``csrc/forward_train.cu``, bound in ``ops/forward_train.py``), or the
  eager autograd step (``train/steps.py``), which trains any surrogate of
  the zoo;
- PI-GAN training (``Trainer.train_pigan``), each chunk one launch of the
  GAN-training kernel (``csrc/gan_train.cu``, bound in ``ops/gan_train.py``:
  the fused D-then-G step with its second generator passes, cycle and
  stability, and its noise streams), the eager step for a trio with an
  enhanced model (no TPU kernel covers one), and seed ensembles, M members
  in one launch of the same kernel's member-packed entry (``parallel/``);
- ensembles and data parallelism (``parallel/``): the λ-ablation sweep,
  N members with loss weights of their own through the eager runtime-weights
  step (``make_ensemble_multi_epoch_fn``, ``examples/torch_ablation_sweep.py``);
  data-parallel training over ``torch.distributed`` ranks with BatchNorm
  over the global batch (``Trainer(mesh=...)``, ``make_parallel_multi_epoch_fn``);
  screening over ranks, each running the fused surrogate and peaks kernels
  on its own chunks (``screen_designs(mesh=...)``, ``screen --mesh-data N``);
  tensor parallelism over a model axis (``make_mesh(data, model)``,
  ``parallel/tensor.py``: the JAX package's placement rule, the wide layers'
  compute split with their leaves); the seed search through the
  member-packed kernel with held-out scores and best snapshots
  (``seed_search``, ``examples/torch_seed_search.py``);
- the cost model and the card's peaks (``ops/costs.py``), ``set_seed``
  (``utils/seed.py``);
- preemption-safe training: full-state checkpoints
  (``train/checkpoint.py:CheckpointManager``), ``Trainer.resume_from`` and
  the kernel engine's shadow replay;
- the metric-gated training programs (``train/programs.py``) over the
  evaluator (``evaluate/``: the four suites, the noise ceilings and the
  self-verifying report), and the config overlays of
  ``config_presets.py`` (``--preset optimized`` as typed);
- the ``generate-data``, ``convert-cst``, ``cache-data``,
  ``pretrain-forward``, ``train``, ``program``, ``evaluate``, ``screen``,
  ``design``, ``export``, ``doctor`` and ``profile`` commands (``cli.py``).
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
