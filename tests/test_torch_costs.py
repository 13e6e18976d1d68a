"""The port's cost model (``pigan_thz_torch/ops/costs.py``) and ``set_seed``
(``utils/seed.py``) against the JAX package's.

- ``model_flops`` and ``xla_hbm_bytes`` equal JAX's exactly, for every
  combination of the GAN loss, ``detach_forward``, the cycle and stability
  terms and instance noise, at full width and at a narrow one;
- ``state_bytes`` equals the bytes of a ``PiGanState``'s buffers as the
  GAN-training kernel takes them (``ops/gan_train.py:state_buffers``), with
  and without the EMA;
- the peaks by device name, and ``roofline`` on K2's count of an epoch
  through F (15 steps, B = 64) giving PERF.md's 0.1465 ms;
- ``compiled_fn_analysis`` on the baseline trio's forwards: exactly 2 x the
  MACs (FlopCounterMode counts the products alone), and within
  ANALYSIS_RTOL below XLA's count, which adds the elementwise ops;
- ``set_seed``: ``random``'s and numpy's draws and ``PYTHONHASHSEED`` equal
  JAX's ``set_seed``'s; torch's generators seeded.
"""

import dataclasses
import itertools
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.models import build_trio as t_build_trio
from pigan_thz_torch.ops import costs
from pigan_thz_torch.ops.gan_train import state_buffers
from pigan_thz_torch.train.state import init_pigan_state, make_optimizers
from pigan_thz_torch.train.steps import StepSettings
from pigan_thz_torch.utils import set_seed
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.models import build_trio as j_build_trio
from pigan_thz_tpu.ops import costs as j_costs
from pigan_thz_tpu.train.steps import StepSettings as JSettings
from pigan_thz_tpu.utils.seed import set_seed as j_set_seed

ANALYSIS_RTOL = 0.03      # XLA's elementwise ops: 0.6-1.2 % of the trio's products
K2_EPOCH_BOUND_MS = 0.1465
NARROW = dict(g=(48, 24), d=(40, 20), f=(16, 32, 48, 32, 16))

KNOBS = list(itertools.product(("bce", "wgan_gp"), (True, False), (0.0, 1.0), (0.0, 1.0),
                               (0.0, 0.05)))


def _narrow(cfg):
    return cfg.replace(
        generator=dataclasses.replace(cfg.generator, hidden_dims=NARROW["g"]),
        discriminator=dataclasses.replace(cfg.discriminator, hidden_dims=NARROW["d"]),
        forward_model=dataclasses.replace(cfg.forward_model, hidden_dims=NARROW["f"]))


@pytest.mark.parametrize("width", ["full", "narrow"])
@pytest.mark.parametrize("gan_loss,detach,cycle,stability,inoise", KNOBS)
def test_model_flops_and_xla_bytes_equal_jax(gan_loss, detach, cycle, stability, inoise,
                                             width):
    kw = dict(gan_loss=gan_loss, detach_forward=detach, cycle_w=cycle, stability_w=stability,
              instance_noise=inoise)
    tc, jc = t_default_config(), j_default_config()
    if width == "narrow":
        tc, jc = _narrow(tc), _narrow(jc)
    got = costs.pigan_step_costs(tc, StepSettings(**kw))
    want = j_costs.pigan_step_costs(jc, JSettings(**kw))
    assert got.model_flops == want.model_flops
    assert got.xla_hbm_bytes == want.xla_hbm_bytes
    # the kernel's own count moves with the knobs as the kernel's work does
    base = costs.pigan_step_costs(tc, StepSettings(gan_loss=gan_loss, detach_forward=detach))
    assert (got.padded_flops > base.padded_flops) == bool(cycle or stability)
    assert (got.stream_bytes > base.stream_bytes) == bool(stability or inoise)


@pytest.mark.parametrize("ema", [False, True])
def test_state_bytes_are_the_kernel_buffers(ema):
    cfg = t_default_config()
    g, d, f = t_build_trio(cfg, device="cpu")
    g_tx, d_tx, _ = make_optimizers(cfg, 15)
    st = init_pigan_state(g, d, f, g_tx, d_tx, 0, device="cpu", ema=ema)
    bufs = state_buffers(st)
    tensors = [t for t in bufs if isinstance(t, torch.Tensor)] + list(bufs.bn)
    want = sum(t.numel() * t.element_size() for t in tensors)
    got = costs.pigan_step_costs(cfg, StepSettings(ema_decay=0.999 if ema else 0.0))
    assert got.state_bytes == want


def test_peaks_by_device_name():
    assert costs.device_peak_flops("NVIDIA H100 80GB HBM3") == 67e12
    assert costs.device_peak_hbm("NVIDIA H100 80GB HBM3") == 3.35e12
    assert costs.device_peak_flops("NVIDIA H100 PCIe") == 51e12
    assert costs.device_peak_hbm("NVIDIA H100 PCIe") == 2.0e12
    assert costs.device_peak_flops("TPU v5 lite") is None
    assert costs.device_peak_hbm("NVIDIA A100-SXM4-80GB") is None


def test_roofline_of_k2s_epoch_is_perf_md_bound():
    """K2 through F, an epoch of 15 steps at B = 64: operations bound it at
    0.1465 ms (PERF.md §6)."""
    cfg = t_default_config()
    c = costs.pigan_step_costs(cfg, StepSettings(detach_forward=False))
    spe = cfg.data.num_samples // cfg.train.batch_size
    ms, by = costs.roofline(spe * c.padded_flops, spe * c.stream_bytes + c.state_bytes)
    assert by == "operations"
    assert round(ms, 4) == K2_EPOCH_BOUND_MS
    assert costs.design_bound_3xtf32(1e9, 0.0) == pytest.approx(3e9 / 495e12 * 1e3)


@pytest.mark.parametrize("role", ["generator", "discriminator", "forward_model"])
def test_compiled_fn_analysis_against_jax(role):
    b = 64
    g, d, f = t_build_trio(t_default_config(), device="cpu")
    jg, jd, jf = j_build_trio(j_default_config())
    module, jmod = {"generator": (g, jg), "discriminator": (d, jd),
                    "forward_model": (f, jf)}[role]
    t_args = {"generator": (torch.zeros(b, 250),),
              "discriminator": (torch.zeros(b, 250), torch.zeros(b, 4)),
              "forward_model": (torch.zeros(b, 4),)}[role]
    j_args = tuple(jnp.asarray(a.numpy()) for a in t_args)
    variables = jmod.init(jax.random.PRNGKey(0), *j_args)
    want = j_costs.compiled_fn_analysis(lambda v, *a: jmod.apply(v, *a), variables, *j_args)
    got = costs.compiled_fn_analysis(module.eval(), *t_args)
    macs = sum(p.numel() for n, p in module.named_parameters()
               if n.endswith("weight") and p.dim() == 2)
    assert got["flops"] == 2.0 * b * macs
    assert got["bytes_accessed"] == 0.0
    assert want["flops"] * (1 - ANALYSIS_RTOL) <= got["flops"] <= want["flops"]


def test_set_seed_equals_jax():
    key = j_set_seed(123)
    want = (random.random(), np.random.rand(3).tolist(), os.environ["PYTHONHASHSEED"])
    gen = set_seed(123)
    got = (random.random(), np.random.rand(3).tolist(), os.environ["PYTHONHASHSEED"])
    assert got == want
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 123
    assert torch.initial_seed() == 123
    assert np.asarray(key).shape == (2,)
    a = torch.rand(3)
    set_seed(123)
    assert torch.equal(torch.rand(3), a)
