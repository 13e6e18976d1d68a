"""The stage and step counts of ``benchmark/costs`` against hand counts at
the published widths, and against the program's own cost model."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.costs import peaks, pigan
from benchmark.reference import models as M

G_MACS = 250 * 512 + 512 * 256 + 256 * 4
D_MACS = 254 * 512 + 512 * 256 + 256 * 1
F_MACS = 4 * 256 + 256 * 512 + 512 * 1024 + 1024 * 512 + 512 * 256 + 256 * 258
RES_G_MACS = 250 * 512 + 3 * 2 * 512 * 512 + 512 * 256 + 256 * 128 + 128 * 4


@pytest.fixture(scope="module")
def base():
    return harness.cell("base-design-8192")["config"]


@pytest.fixture(scope="module")
def optimized():
    return harness.cell("optimized-design-8192")["config"]


def test_hand_counts(base, optimized):
    assert (G_MACS, D_MACS, F_MACS, RES_G_MACS) == (260096, 261376, 1377792, 1865216)
    assert pigan.layer_macs(M.generator_layers(base)) == G_MACS
    assert pigan.layer_macs(M.generator_layers(optimized)) == RES_G_MACS
    assert pigan.layer_macs(M.discriminator_layers(base)) == D_MACS
    assert pigan.layer_macs(M.forward_layers(base)) == F_MACS


def test_design_stages(base, optimized):
    c = pigan.stage_costs(base, 8192)
    assert c["fwd"][0] == 2 * F_MACS * 8192                 # 22.6 GFLOP a request
    assert c["gen"][0] == 2 * G_MACS * 8192
    n_f = M.num_params(M.forward_layers(base))
    assert n_f == F_MACS + 256 + 512 + 1024 + 512 + 256 + 258 + 2 * (256 + 512 + 1024 + 512 + 256)
    assert c["fwd"][1] == 4 * (8192 * (4 + 250 + 8) + n_f)
    assert pigan.stage_costs(optimized, 8192)["gen"][0] == 2 * RES_G_MACS * 8192
    # F's stage is bound by its operations, 45.6 us at 495 TFLOP/s
    assert peaks.bound_s(*c["fwd"]) == pytest.approx(2 * F_MACS * 8192 / 495e12)


def test_training_steps(base):
    cfg = harness.cell("base-train-full")["config"]
    assert pigan.forward_step_flops(cfg) == 6 * F_MACS * 64                  # 529 MFLOP
    assert pigan.gan_step_flops(cfg) == 2 * 64 * (3 * G_MACS + 8 * D_MACS + F_MACS)  # 544
    steps = 750
    assert pigan.gan_phase_bytes(cfg, steps, 4) > 4 * pigan.gan_phase_bytes(cfg, steps) - 4 * 4 * F_MACS * 2


def test_against_the_programs_model():
    from pigan_thz_torch.config import default_config
    from pigan_thz_torch.ops.costs import pigan_step_costs
    from pigan_thz_torch.train.steps import StepSettings

    pc = default_config()
    cfg = harness.cell("base-train-full")["config"]
    settings = StepSettings.from_config(pc, detach_forward=True)
    assert pigan.gan_step_flops(cfg) == pigan_step_costs(pc, settings).model_flops


def test_shares_never_clip():
    assert peaks.share(495e12, 0, 0.5) == pytest.approx(200.0)     # a time too short shows
    assert peaks.share(1.0, 0.0, 0.0) is None
