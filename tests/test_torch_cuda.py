"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Weights are full-width, seeded, with flax's initialisation and non-trivial
generator BatchNorm stats, so the folding is exercised.  The
dip-qualification kernel (K4) is held against both of its plain versions on
the spectra classes of tests/test_peaks.py.  The forward-training kernel
(K1) is held against its plain version and the eager step over 2 epochs of
a 1000-sample dataset, with the tolerances of ``chip_smoke.py``; so is the
GAN-training kernel (K2), for both ``detach_forward`` modes and a mix of its
knobs.  The member-packed kernel (K3) is held bit for bit against K2 on each
member alone, and against its plain version with K2's tolerances.
"""

import copy

import pytest
import torch

import dataclasses

from pigan_thz_torch import default_config
from pigan_thz_torch.data import (
    build_dataset,
    denormalize_params,
    sample_params,
    synthesize_spectra,
    synthetic_dataset,
)
from pigan_thz_torch.design import ScreeningConfig, screen_designs
from pigan_thz_torch.models import build_forward_model, build_generator, build_trio
from pigan_thz_torch.ops import forward_train as ft
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.ops import fused_kernels as fk
from pigan_thz_torch.ops import peaks as pk
from pigan_thz_torch.serve import make_inverse_design_fn
from pigan_thz_torch.train.schedules import make_schedule
from pigan_thz_torch.train.state import (
    init_forward_state,
    init_pigan_state,
    make_optimizers,
)
from pigan_thz_torch.train.steps import (
    ForwardStepSettings,
    StepSettings,
    make_forward_step,
    make_multi_epoch_fn,
    make_pigan_step,
)
from pigan_thz_torch.train.trainer import Trainer

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

BATCHES = [1, 77, 257, 8192]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def models():
    cfg = default_config()
    gen = torch.Generator().manual_seed(0)
    g = build_generator(cfg.generator, generator=gen, device="cpu")
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean += 0.1 * torch.randn(m.num_features, generator=gen) ** 2
                m.running_var += 0.1 * torch.randn(m.num_features, generator=gen) ** 2
    f = build_forward_model(cfg.forward_model, generator=gen, device="cpu")
    return g.eval(), f.eval()


@pytest.mark.parametrize("batch", BATCHES)
def test_forward_kernel_matches_plain(batch, dev, models):
    packed = fk.pack_forward_model(models[1], dev)
    x = torch.rand((batch, 4), device=dev) * 2 - 1
    before = fk.LAUNCHES["fused_mlp_forward"]
    got = fk.fused_mlp_forward(x, packed)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_mlp_forward"] == before + 1
    want = fk.fused_mlp_forward_plain(x, packed)
    assert got.shape == (batch, 258)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("batch", BATCHES)
def test_generator_kernel_matches_plain(batch, dev, models):
    packed = fk.pack_generator(models[0], dev)
    x = torch.randn((batch, 250), device=dev)
    before = fk.LAUNCHES["fused_dense_chain"]
    got = fk.fused_dense_chain(x, packed)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_dense_chain"] == before + 1
    want = fk.fused_dense_chain_plain(x, packed)
    assert got.shape == (batch, 4)
    assert float((got - want).abs().max()) <= 2e-5


def test_small_odd_chain_matches_plain(dev):
    """Widths that are no multiple of the tile or the block: 7 -> 33 -> 5."""
    gen = torch.Generator().manual_seed(1)
    layer = (torch.randn(7, 33, generator=gen), *torch.randn(3, 33, generator=gen))
    head = (torch.randn(33, 5, generator=gen), torch.randn(5, generator=gen))
    packed = fk.pack_chain([layer], head, dev)
    x = torch.randn(19, 7, device=dev)
    got = fk.fused_mlp_forward(x, packed)
    torch.cuda.synchronize()
    assert float((got - fk.fused_mlp_forward_plain(x, packed)).abs().max()) <= 1e-4


def test_empty_batch_launches_nothing(dev, models):
    packed = fk.pack_generator(models[0], dev)
    before = dict(fk.LAUNCHES)
    out = fk.fused_dense_chain(torch.empty((0, 250), device=dev), packed)
    assert out.shape == (0, 4) and fk.LAUNCHES == before


def test_weights_on_another_device_raise(dev, models):
    packed = fk.pack_forward_model(models[1])          # CPU weights
    with pytest.raises(ValueError):
        fk.fused_mlp_forward(torch.zeros((2, 4), device=dev), packed)


def test_cycle_matches_unfused_modules(dev, models):
    cfg = default_config()
    g, f = (copy.deepcopy(m).to(dev) for m in models)
    gen = torch.Generator(device=dev).manual_seed(2)
    p = sample_params(gen, 64, cfg.data, device=dev)
    spectra = synthesize_spectra(cfg.data.frequencies, p, gen, cfg.data.noise_level)
    ds = build_dataset(spectra, p, torch.full((64, 8), float("nan")), cfg.data,
                       device=dev)
    fn = make_inverse_design_fn(g, f, ds)
    before = dict(fk.LAUNCHES)
    got = fn(spectra)
    torch.cuda.synchronize()
    assert {k: fk.LAUNCHES[k] - before[k] for k in before} == {
        "fused_mlp_forward": 1, "fused_dense_chain": 1, "dip_qualification": 0,
        "forward_train": 0, "gan_train": 0,
        "gan_ensemble_train": 0}
    with torch.no_grad():
        pn = g(spectra)
        want = (denormalize_params(pn, ds.param_lo, ds.param_hi), *f(pn))
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4
    assert bool(((got[0] >= 2.2) & (got[0] <= 2.8)).all())


def _spectra(kind, b, n, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((b, n), generator=gen, device=dev)
    if kind == "random_walk":
        return torch.cumsum(0.8 * noise, dim=1).clamp(max=0.0)
    if kind == "white_noise":
        return (-1.0 + 0.6 * noise).clamp(max=0.0)
    if kind == "quantized":
        return torch.round((-2.0 + 1.5 * noise).clamp(max=0.0) * 2.0) / 2.0
    cfg = default_config().data
    freq = torch.linspace(cfg.freq_min, cfg.freq_max, n)
    p = sample_params(gen, b, cfg, device=dev)
    return synthesize_spectra(freq, p, gen, cfg.noise_level)


def _assert_k4_equal(got, want):
    assert torch.equal(got.qualified, want.qualified)
    assert torch.equal(got.is_peak, want.is_peak)
    pkm = want.is_peak
    torch.testing.assert_close(got.prominence[pkm], want.prominence[pkm],
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(got.width[pkm], want.width[pkm], rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [250, 199, 64, 300])
@pytest.mark.parametrize("kind", ["synthetic", "random_walk", "white_noise", "quantized"])
def test_dip_kernel_matches_both_plain_versions(kind, n, dev):
    """Ragged N (199, 64) and N above the block (300: a loop over i)."""
    t = _spectra(kind, 333, n, dev)
    before = fk.LAUNCHES["dip_qualification"]
    got = pk.batched_dip_qualification(t)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["dip_qualification"] == before + 1
    assert got.qualified.dtype == torch.bool and got.qualified.shape == (333, n)
    _assert_k4_equal(got, pk.dip_qualification(t))
    _assert_k4_equal(got, pk._dip_qualification_lifted(t))
    assert bool(got.qualified.any())


def test_dip_kernel_edges(dev):
    """N above the cap raises; an empty batch launches nothing; other
    thresholds reach the kernel."""
    with pytest.raises(ValueError, match="N"):
        pk.batched_dip_qualification(torch.zeros((2, pk.MAX_N + 1), device=dev))
    before = dict(fk.LAUNCHES)
    out = pk.batched_dip_qualification(torch.zeros((0, 250), device=dev))
    assert out.width.shape == (0, 250) and fk.LAUNCHES == before
    t = _spectra("white_noise", 64, 250, dev, seed=3)
    got = pk.batched_dip_qualification(t, min_prominence=0.5, min_width=2.0)
    _assert_k4_equal(got, pk.dip_qualification(t, 0.5, 2.0))


def test_card_metrics_match_cpu(dev):
    t = _spectra("synthetic", 512, 250, dev, seed=4)
    freq = default_config().data.frequencies
    got = pk.batched_peak_metrics(freq, t)
    want = pk.batched_peak_metrics(freq, t.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0, equal_nan=True)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "module"])
def test_screening_launches_per_chunk(use_pallas, dev, models):
    cfg = default_config()
    f = copy.deepcopy(models[1]).to(dev)
    lo = torch.full((4,), 2.2, device=dev)
    hi = torch.full((4,), 2.8, device=dev)
    sc = ScreeningConfig(num_candidates=20000, chunk_size=8192, top_k=16,
                         use_pallas=use_pallas)
    before = dict(fk.LAUNCHES)
    res = screen_designs(f, cfg.data.frequencies, lo, hi,
                         torch.Generator(device=dev).manual_seed(42), sc)
    torch.cuda.synchronize()
    assert {k: fk.LAUNCHES[k] - before[k] for k in before} == {
        "fused_mlp_forward": 3 if use_pallas else 0, "fused_dense_chain": 0,
        "dip_qualification": 3, "forward_train": 0, "gan_train": 0,
        "gan_ensemble_train": 0}
    v = res.valid
    assert bool(v.any()) and bool(torch.isfinite(res.scores[v]).all())
    assert bool((res.scores[:-1] >= res.scores[1:]).all())
    assert bool(((res.params >= 2.2) & (res.params <= 2.8)).all())


# -- K1: forward-surrogate pretraining ---------------------------------------
# Tolerances and their reasons: chip_smoke.py (K1_*).
K1_ROWS_RTOL, K1_PARAM_ATOL, K1_M_ATOL, K1_V_ATOL = 5e-4, 1e-3, 1e-5, 1e-8


@pytest.fixture(scope="module")
def train_ds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return synthetic_dataset(default_config().data, device=torch.device("cuda", 0))


def _k1_setup(ds, rate, epochs=2, seed=0):
    cfg = default_config()
    cfg = cfg.replace(forward_model=dataclasses.replace(cfg.forward_model,
                                                        dropout_rate=rate))
    _, _, ftx = make_optimizers(cfg, 15)
    state = init_forward_state(build_forward_model(cfg.forward_model, device="cpu"), ftx, seed,
                               device=ds.spectra.device)
    idx, seeds = ft.resolve_draws(torch.Generator().manual_seed(seed), ds.num_samples, 64,
                                  epochs)
    sched = make_schedule("cosine", 1e-3, 500, 15, schedule_alpha=0.0)
    streams = ft.build_streams(ds, idx, seeds, torch.ones(epochs), 0, sched)
    return cfg, state, ftx, idx, seeds, streams


def _assert_k1_close(rows, state, want_rows, want_state):
    assert float(((rows - want_rows).abs() / want_rows.abs()).max()) <= K1_ROWS_RTOL
    for a, b, tol in zip(state, want_state, (K1_PARAM_ATOL, K1_M_ATOL, K1_V_ATOL)):
        assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("settings", [ForwardStepSettings(),
                                      ForwardStepSettings(5.0, 2.0, 0.5, 0.5)],
                         ids=["mse", "weighted_smooth_l1"])
@pytest.mark.parametrize("rate", [0.2, 0.0])
def test_forward_train_kernel_matches_plain(rate, settings, dev, train_ds):
    cfg, state, _, _, seeds, streams = _k1_setup(train_ds, rate)
    spec = ft.forward_train_spec(cfg, settings)
    kern = [state.params.clone(), state.opt.m.clone(), state.opt.v.clone()]
    plain = [t.clone() for t in kern]
    work = torch.empty(ft.workspace_floats(spec, 64), device=dev)
    before = ft.LAUNCHES["forward_train"]
    rows = ft.forward_train(*kern, streams, spec, work=work)
    torch.cuda.synchronize()
    assert ft.LAUNCHES["forward_train"] == before + 1
    if rate:
        for l, mk in enumerate(ft.saved_dropout(work, spec, 64)):
            assert torch.equal(mk, ft.dropout_scale(int(seeds[-1]), l, 64, mk.shape[1],
                                                    rate, dev))
    want = ft.forward_train_plain(*plain, streams, spec)
    assert rows.shape == (30, 3) and bool(torch.isfinite(rows).all())
    _assert_k1_close(rows, kern, want, plain)


def test_forward_train_kernel_rerun_is_bit_identical(dev, train_ds):
    cfg, state, _, _, _, streams = _k1_setup(train_ds, 0.2, epochs=1)
    spec = ft.forward_train_spec(cfg, ForwardStepSettings())
    runs = []
    for _ in range(2):
        s = [state.params.clone(), state.opt.m.clone(), state.opt.v.clone()]
        runs.append((ft.forward_train(*s, streams, spec), s))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(map(torch.equal, runs[0][1], runs[1][1]))


def test_forward_train_kernel_matches_eager_step(dev, train_ds):
    cfg, state, ftx, idx, seeds, streams = _k1_setup(train_ds, 0.0)
    settings = ForwardStepSettings()
    spec = ft.forward_train_spec(cfg, settings)
    kern = [state.params.clone(), state.opt.m.clone(), state.opt.v.clone()]
    rows = ft.epoch_means(ft.forward_train(*kern, streams, spec), 2)
    eager = make_multi_epoch_fn(make_forward_step(ftx, settings), 64)
    state, ms = eager(state, train_ds, torch.ones(2), indices=idx, seeds=seeds)
    torch.cuda.synchronize()
    got = torch.stack([rows[k] for k in ft.METRIC_KEYS])
    want = torch.stack([ms[k] for k in ft.METRIC_KEYS])
    _assert_k1_close(got, kern, want, (state.params, state.opt.m, state.opt.v))


def test_forward_train_wrapper_refuses(dev, train_ds):
    cfg, state, _, _, _, streams = _k1_setup(train_ds, 0.2, epochs=1)
    spec = ft.forward_train_spec(cfg, ForwardStepSettings())
    s = [state.params, state.opt.m, state.opt.v]
    with pytest.raises(ValueError, match="work"):
        ft.forward_train(*s, streams, spec, work=torch.empty(16, device=dev))
    cpu_streams = streams._replace(spectra=streams.spectra.cpu())
    with pytest.raises(ValueError):
        ft.forward_train(*s, cpu_streams, spec)


def test_trainer_launches_the_kernel_once_per_chunk(dev, train_ds):
    trainer = Trainer(default_config(), ds=train_ds, epochs_per_call=2, device=dev)
    before = ft.LAUNCHES["forward_train"]
    hist = trainer.pretrain_forward(epochs=5)
    assert ft.LAUNCHES["forward_train"] == before + 3
    loss = hist["forward/loss"]
    assert len(loss) == 5 and all(x == x for x in loss) and loss[-1] < loss[0]


# -- K2: PI-GAN training -------------------------------------------------------
# Tolerances and their reasons: chip_smoke.py (K2_*).
K2_ROUNDING, K2_STEP_FLOOR = 8.0, {1: 1e-6, 3: 1e-2}
# the first steps with cycle on, by kind of tensor: chip_smoke.py
K2_CYCLE_STEP_FLOOR = {"m": 5e-3, "v": 5e-3, "p": 2e-2, "ema": 2e-2, "bn": 1e-6}
K2_PATHS_3_STEP_FLOOR = 5e-2      # three steps on the new paths: chip_smoke.py
K2_TODAY = ("through_f", "detached", "knob_mix")


def _k2_floor(case, settings, steps, key):
    if steps == 3 and case not in K2_TODAY:
        return K2_PATHS_3_STEP_FLOOR
    if settings.cycle_w and steps == 1:
        return K2_CYCLE_STEP_FLOOR[key.split("[")[0].split("_")[-1]]
    return K2_STEP_FLOOR[steps]
K2_ROWS_RTOL, K2_COUNT_ATOL = 5e-2, 2 / 64
K2_PART_RTOL = {"g": 0.25, "d": 0.25, "ema": 0.25, "bn": 2e-2, "v": 0.1, "m": 0.5}
K2_MIX = dict(detach_forward=False, d_update_every=2, constraint_w=0.7, window_w=0.3,
              sigmoid_squash=True, ema_decay=0.99)
K2_AUGMENT = dict(augment_noise=0.05, augment_shift=0.02, augment_scale=0.1)
# the second G passes and the noise streams, path by path, then all at once
K2_PATHS = {
    "through_f": dict(detach_forward=False),
    "detached": dict(detach_forward=True),
    "knob_mix": K2_MIX,
    "cycle_through_f": dict(detach_forward=False, cycle_w=1.0, adv_w=0.0, d_update_every=2),
    "cycle_detached": dict(detach_forward=True, cycle_w=1.0),
    "stability": dict(detach_forward=False, stability_w=1.0),
    "second_passes_mix": dict(detach_forward=False, stability_w=1.0, cycle_w=1.0,
                              sigmoid_squash=True, constraint_w=3.0),
    "instance_noise": dict(detach_forward=False, instance_noise=0.05),
    "augmentation": dict(detach_forward=False, **K2_AUGMENT),
    "all_four": dict(detach_forward=False, cycle_w=1.0, stability_w=1.0, instance_noise=0.05,
                     d_update_every=2, ema_decay=0.99, **K2_AUGMENT),
    # WGAN-GP: the critic loss, the penalty and its second-order backward
    "wgan_gp_through_f": dict(detach_forward=False, gan_loss="wgan_gp"),
    "wgan_gp_mix": dict(detach_forward=True, gan_loss="wgan_gp", d_update_every=2,
                        stability_w=1.0, instance_noise=0.05),
}
# bfloat16 operands: the kernel against its float32-accumulating plain
# version with the same rounding (chip_smoke.py: K2_BF16_*)
K2_BF16_PATHS = {
    "bf16_through_f": dict(detach_forward=False),
    "bf16_detached": dict(detach_forward=True),
    "bf16_wgan_gp_cycle_stability": dict(detach_forward=False, gan_loss="wgan_gp", cycle_w=1.0,
                                         stability_w=1.0, d_update_every=2),
}
K2_BF16_PART_RTOL = {"g": 0.4, "d": 0.4, "ema": 0.4, "bn": 3e-2, "v": 0.1, "m": 0.4}
K2_BF16_STEP_RTOL = {"lc_loss": 5e-3, "recon_metrics_loss": 1e-3, "maxwell_loss": 1e-3}
K2_BF16_STEP_FLOOR = 2e-4
K2_BF16_TENSOR_FLOOR = 5e-4
# WGAN-GP trajectories over their first steps only (chip_smoke.py: K2_WGAN_WINDOW)
K2_WGAN_WINDOW = 8


@pytest.fixture(scope="module")
def trained_f(train_ds):
    """F after 30 epochs through K1: losses of a realistic size."""
    trainer = Trainer(default_config(), ds=train_ds, device=train_ds.spectra.device)
    trainer.pretrain_forward(epochs=30)
    return trainer.forward_state.f


def _k2_setup(ds, f, epochs=2, seed=0, compute_dtype="float32", **knobs):
    cfg = default_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=compute_dtype))
    settings = StepSettings.from_config(cfg, **knobs)
    gtx, dtx, _ = make_optimizers(cfg, 15)
    g, d, _ = build_trio(cfg, device="cpu")
    state = init_pigan_state(g, d, f, gtx, dtx, seed, device=ds.spectra.device,
                             ema=settings.ema_decay > 0)
    idx, seeds = ft.resolve_draws(torch.Generator().manual_seed(seed), ds.num_samples, 64,
                                  epochs)
    return cfg, settings, state, gtx, dtx, idx, seeds


def _k2_streams(ds, cfg, settings, idx, seeds, scales, steps=None):
    """The chunk's streams from step 0, optionally its first ``steps`` only."""
    if steps is not None:
        idx, seeds = idx[:, :steps], seeds.reshape(idx.shape[0], -1)[:, :steps].reshape(-1)
    return gt.build_streams(ds, idx, scales, 0, 0, 0, settings.d_update_every,
                            _k2_schedule(cfg, "g"), _k2_schedule(cfg, "d"),
                            settings=settings, seeds=seeds)


def _row_errors(rows, want, keys, wgan):
    """|rows - want| relative to |want| (at least 1e-3); under WGAN-GP the
    critic loss, a difference of two means, relative to their size
    (|adv_loss| where that is the larger): chip_smoke.py ``row_errors``."""
    scale = want.abs().clamp(min=1e-3)
    if wgan:
        j, a = keys.index("d_loss"), keys.index("adv_loss")
        scale[:, j] = torch.maximum(scale[:, j], want[:, a].abs())
    return (rows - want).abs() / scale


def _k2_yardstick(state, streams, spec):
    """The float32 plain version's run of ``streams`` from ``state`` and how
    far it ends from the float64 run, by part (``state_diffs``)."""
    plain = state.clone()
    exact = gt.to_double(gt.state_buffers(state.clone()))
    want = gt.gan_train_plain(gt.state_buffers(plain), streams, spec)
    want64 = gt.gan_train_plain(exact, gt.to_double(streams), spec)
    yard = gt.state_diffs(gt.state_buffers(plain), exact, gt.state_buffers(state), spec)
    # and of its rows (per step), relative, the two counts left out
    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    floats = [j for j, k in enumerate(keys) if k not in ("d_accuracy", "violation_rate")]
    yard["rows"] = float(_row_errors(want, want64, keys, spec.wgan)[:, floats].max())
    return want, plain, yard


def _assert_k2_close(got_rows, got, want_rows, want, start, yard, spec, keys):
    """Rows are (T or E, len(keys)); each part of the state within its
    K2_PART_RTOL in L2 relative to what the steps changed (``yard``, the
    float32 plain version's own distance from float64, is printed beside)."""
    counts = [keys.index(k) for k in ("d_accuracy", "violation_rate")]
    floats = [j for j in range(len(keys)) if j not in counts]
    assert float((got_rows[:, counts] - want_rows[:, counts]).abs().max()) <= K2_COUNT_ATOL
    rel = _row_errors(got_rows, want_rows, keys, spec.wgan)[:, floats]
    diffs = gt.state_diffs(gt.state_buffers(got), gt.state_buffers(want),
                           gt.state_buffers(start), spec)
    worst = {keys[j]: f"{float(rel[:, i].max()):.2e}" for i, j in enumerate(floats)}
    print("K2 rows rel", float(rel.max()), worst,
          {k: f"{r:.3e} (yardstick {yard[k][1]:.3e})" for k, (_, r) in diffs.items()})
    # where float32 itself drifts further from float64 than K2_ROWS_RTOL, the
    # rows are held to four times that drift
    assert float(rel.max()) <= max(K2_ROWS_RTOL, 4.0 * yard["rows"]), yard["rows"]
    for k, (_, r) in diffs.items():
        assert r <= K2_PART_RTOL[k.split("_")[-1]], (k, diffs, yard)


@pytest.mark.parametrize("case", list(K2_PATHS))
def test_gan_train_kernel_matches_plain(case, dev, train_ds, trained_f):
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, **K2_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    if spec.wgan:
        streams = _k2_streams(train_ds, cfg, settings, idx[:1], seeds[:15], torch.ones(1),
                              K2_WGAN_WINDOW)
    else:
        streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.tensor([1.0, 0.5]))
    assert (streams.inoise is not None) == (settings.instance_noise > 0)
    assert (streams.stab is not None) == (settings.stability_w > 0)
    kern = state.clone()
    before = gt.LAUNCHES["gan_train"]
    rows = gt.gan_train(gt.state_buffers(kern), streams, spec)
    torch.cuda.synchronize()
    assert gt.LAUNCHES["gan_train"] == before + 1
    want, plain, yard = _k2_yardstick(state, streams, spec)
    assert gt.LAUNCHES["gan_train"] == before + 1
    assert rows.shape == (streams.spectra.shape[0], gt.ROW_WIDTH)
    assert bool(torch.isfinite(rows).all())
    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    exact = [keys.index(k) for k in ("d_accuracy", "violation_rate")]
    assert torch.equal(rows[0, exact], want[0, exact])
    _assert_k2_close(rows, kern, want, plain, state, yard, spec, keys)
    if settings.constraint_w:
        assert float(rows[:, -1].min()) > 0.0


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("case", list(K2_PATHS))
def test_gan_train_kernel_first_step_matches_plain(case, steps, dev, train_ds, trained_f):
    """The first step and the first three (bias corrections at counts above
    1; in the knob mix the second step's D update is gated off) from one
    state, with the plain version in float64 as the yardstick: the kernel's
    rows, and tensor by tensor outside the gauge leaves Adam's two moments,
    the parameter update, the EMA's update and the BatchNorm stats', are as
    close to it as the float32 plain version is, within K2_ROUNDING."""
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1,
                                                       **K2_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.tensor([0.5]), steps)
    start = gt.state_buffers(state)
    kern, plain = gt.state_buffers(state.clone()), gt.state_buffers(state.clone())
    exact = gt.to_double(gt.state_buffers(state.clone()))
    rows = gt.gan_train(kern, streams, spec)
    rows_p = gt.gan_train_plain(plain, streams, spec)
    rows64 = gt.gan_train_plain(exact, gt.to_double(streams), spec)
    counts = [gt.METRIC_KEYS.index(k) for k in ("d_accuracy", "violation_rate")]
    assert torch.equal(rows[:, counts].double(), rows64[:, counts])
    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    off_k = float(_row_errors(rows, rows64, keys, spec.wgan).max())
    off_p = float(_row_errors(rows_p, rows64, keys, spec.wgan).max())
    print(f"K2 first {steps} step(s) {case} rows: kernel {off_k:.3e}, plain fp32 {off_p:.3e}")
    assert off_k <= 1e-4
    e_k = gt.step_errors(kern, exact, start, spec)
    e_p = gt.step_errors(plain, exact, start, spec)
    # (under WGAN-GP the critic's head bias has gradient 0: no d_v[5])
    assert {"g_m[0]", "g_v[9]", "g_p[4]", "d_p[0]", "bn[3]"} <= set(e_k)
    assert ("d_v[5]" in e_k) != (settings.gan_loss == "wgan_gp")
    assert ("g_ema[0]" in e_k) == (settings.ema_decay > 0)
    for key, e in e_k.items():
        print(f"K2 first {steps} step(s) {key}: kernel {e:.3e}, plain fp32 {e_p[key]:.3e}")
        assert e <= max(K2_ROUNDING * e_p[key], _k2_floor(case, settings, steps, key)), (
            key, e, e_p[key])


# path -> the fault of the plain version that the first-step check must see
K2_FAULTS = {
    "cycle_through_f": ["cycle_seed_dropped", "second_pass_moves_running_stats"],
    "cycle_detached": ["drecon_c_when_detached"],
    "stability": ["stability_seed_dropped", "second_pass_moves_running_stats"],
    "instance_noise": ["noised_fake_rows"],
    "wgan_gp_through_f": ["wgan_gp_w1_second_term_dropped", "wgan_gp_seed_sign"],
}


@pytest.mark.parametrize("case,fault", [(c, f) for c, fs in K2_FAULTS.items() for f in fs])
def test_first_step_check_sees_a_faulty_plain_version(case, fault, dev, train_ds, trained_f):
    """The kernel against a float64 plain version that is wrong on purpose:
    some tensor must be outside what the first-step check allows, with the
    float32 plain version's distance from the right float64 run as the
    yardstick, as in the check."""
    knobs = dict(K2_PATHS[case])
    if "instance_noise" in knobs:
        # of the size of the spectra's own features, and detached: the
        # adversarial term then is most of G's gradient
        knobs.update(instance_noise=1.0, detach_forward=True)
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1, **knobs)
    spec = gt.gan_train_spec(cfg, settings)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.ones(1), 1)
    start = gt.state_buffers(state)
    kern = gt.state_buffers(state.clone())
    gt.gan_train(kern, streams, spec)
    plain = gt.state_buffers(state.clone())
    right = gt.to_double(gt.state_buffers(state.clone()))
    wrong = gt.to_double(gt.state_buffers(state.clone()))
    gt.gan_train_plain(plain, streams, spec)
    gt.gan_train_plain(right, gt.to_double(streams), spec)
    gt.gan_train_plain(wrong, gt.to_double(streams), spec, faults=[fault])
    e_p = gt.step_errors(plain, right, start, spec)
    e_off = gt.step_errors(kern, wrong, start, spec)
    beyond = {k: e for k, e in e_off.items()
              if e > max(K2_ROUNDING * e_p[k], _k2_floor(case, settings, 1, k))}
    print(f"K2 {case} against the plain version with {fault}: {len(beyond)} tensors "
          f"beyond their limit, worst {max(e_off.values()):.3e}")
    assert beyond


def test_augmented_stream_is_the_recon_target(dev, train_ds, trained_f):
    """Augmentation's fault lives in the streams: the kernel on the augmented
    spectra against the plain version on the clean ones must disagree."""
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1,
                                                       **K2_PATHS["augmentation"])
    spec = gt.gan_train_spec(cfg, settings)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.ones(1), 1)
    clean = streams._replace(spectra=train_ds.spectra[idx[0, :1].to(dev)].contiguous())
    assert not torch.equal(clean.spectra, streams.spectra)
    assert float(streams.spectra.max()) <= 0.0
    rows = gt.gan_train(gt.state_buffers(state.clone()), streams, spec)
    want = gt.gan_train_plain(gt.state_buffers(state.clone()), clean, spec)
    j = gt.METRIC_KEYS.index("recon_spec_loss")
    assert abs(float(rows[0, j]) - float(want[0, j])) > 1e-2 * float(want[0, j])


def _k2_schedule(cfg, which):
    from pigan_thz_torch.train.schedules import cosine_schedule, step_schedule

    if which == "g":
        return cosine_schedule(cfg.train.lr_g, cfg.train.num_epochs, 15, 0.01)
    return step_schedule(cfg.train.lr_d, cfg.train.num_epochs, 15, 0.5, 0.25)


@pytest.mark.parametrize("case", ["knob_mix", "all_four"])
def test_gan_train_kernel_rerun_is_bit_identical(case, dev, train_ds, trained_f):
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1,
                                                       **K2_PATHS[case])
    multi = gt.make_gan_epoch_fn(cfg, settings)
    runs = []
    for _ in range(2):
        s, rows = multi(state.clone(), train_ds, torch.ones(1), indices=idx[:1], seeds=seeds)
        runs.append((torch.stack(list(rows.values())), s))
    torch.cuda.synchronize()
    (ra, a), (rb, b) = runs
    assert torch.equal(ra, rb)
    for x, y in ((a.g_params, b.g_params), (a.d_params, b.d_params), (a.g_opt.m, b.g_opt.m),
                 (a.g_opt.v, b.g_opt.v), (a.d_opt.m, b.d_opt.m), (a.d_opt.v, b.d_opt.v),
                 (a.g_ema, b.g_ema)):
        assert torch.equal(x, y)
    for m, n in zip(a.batch_norms(), b.batch_norms()):
        assert torch.equal(m.running_mean, n.running_mean)
        assert torch.equal(m.running_var, n.running_var)


@pytest.mark.parametrize("case", ["through_f", "detached", "all_four"])
def test_gan_train_kernel_matches_eager_step(case, dev, train_ds, trained_f):
    cfg, settings, state, gtx, dtx, idx, seeds = _k2_setup(train_ds, trained_f,
                                                           **K2_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    kern, eager = state.clone(), state.clone()
    kern, rows = gt.make_gan_epoch_fn(cfg, settings)(kern, train_ds, torch.ones(2),
                                                     indices=idx, seeds=seeds)
    step = make_pigan_step(gtx, dtx, settings, train_ds.param_lo, train_ds.param_hi)
    eager, want = make_multi_epoch_fn(step, 64)(eager, train_ds, torch.ones(2), indices=idx,
                                                seeds=seeds)
    torch.cuda.synchronize()
    assert (kern.step, kern.g_opt.count, kern.d_opt.count) == (
        eager.step, eager.g_opt.count, eager.d_opt.count) == (
        30, 30, 30 // settings.d_update_every)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.ones(2))
    _, _, yard = _k2_yardstick(state, streams, spec)
    keys = list(gt.METRIC_KEYS)
    _assert_k2_close(torch.stack([rows[k] for k in keys], dim=-1), kern,
                     torch.stack([want[k] for k in keys], dim=-1), eager, state, yard, spec,
                     keys)


def _bf16_rows_rel(rows, want):
    """Per row key of a first step: |kernel - plain| / |plain| over that
    key's bfloat16 tolerance (a rounding flipped where two float32 upstreams
    differ by an ulp moves F's LC and metrics terms most)."""
    out = {}
    for j, k in enumerate(gt.METRIC_KEYS):
        if k in ("d_accuracy", "violation_rate"):
            continue
        err = abs(float(rows[0, j]) - float(want[0, j])) / max(abs(float(want[0, j])), 1e-6)
        out[k] = err / K2_BF16_STEP_RTOL.get(k, K2_BF16_STEP_FLOOR)
    return out


@pytest.mark.parametrize("case", list(K2_BF16_PATHS))
def test_gan_train_kernel_bf16_matches_plain(case, dev, train_ds, trained_f):
    """bfloat16 operands: the first step's rows against the float32 plain
    version with the same rounding, its state tensor by tensor against the
    float64-accumulating one (within K2_ROUNDING of the float32 plain
    version's distance or K2_BF16_TENSOR_FLOOR), each bfloat16 fault beyond
    (in the rows, or in the state for the fault of the backward); 30 steps
    (under WGAN-GP the first K2_WGAN_WINDOW) by part, relative to what they
    changed; one launch; a rerun bit-identical."""
    cfg, settings, state, _, _, idx, seeds = _k2_setup(
        train_ds, trained_f, compute_dtype="bfloat16", **K2_BF16_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    assert spec.bf16
    one = _k2_streams(train_ds, cfg, settings, idx[:1], seeds[:15], torch.ones(1), 1)
    start1 = gt.state_buffers(state)
    kern1 = gt.state_buffers(state.clone())
    rows1 = gt.gan_train(kern1, one, spec)
    plain1 = gt.state_buffers(state.clone())
    want1 = gt.gan_train_plain(plain1, one, spec)
    right = _bf16_rows_rel(rows1, want1)
    print(f"K2 {case} first step, rows over their bf16 limits: {right}")
    assert max(right.values()) <= 1.0, right
    exact1 = gt.to_double(gt.state_buffers(state.clone()))
    gt.gan_train_plain(exact1, gt.to_double(one), spec)
    e_k = gt.step_errors(kern1, exact1, start1, spec)
    e_p = gt.step_errors(plain1, exact1, start1, spec)
    floor = K2_BF16_TENSOR_FLOOR

    def beyond(e):
        return {k: (x, e_p[k]) for k, x in e.items() if not x <= max(K2_ROUNDING * e_p[k], floor)}

    print(f"K2 {case} first step by tensor: {({k: f'{x:.2e}' for k, x in e_k.items()})}")
    assert not beyond(e_k), beyond(e_k)
    if not spec.wgan:   # (under WGAN-GP D's seeds do not read G's head)
        for fault in ("bf16_head_rounded", "bf16_hidden_fp32", "bf16_backward_fp32"):
            off = gt.gan_train_plain(gt.state_buffers(state.clone()), one, spec, faults=[fault])
            wrong = gt.to_double(gt.state_buffers(state.clone()))
            gt.gan_train_plain(wrong, gt.to_double(one), spec, faults=[fault])
            seen = beyond(gt.step_errors(kern1, wrong, start1, spec))
            assert max(_bf16_rows_rel(rows1, off).values()) > 2.0 or seen, fault
    if spec.wgan:
        streams = _k2_streams(train_ds, cfg, settings, idx[:1], seeds[:15], torch.ones(1),
                              K2_WGAN_WINDOW)
    else:
        streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.tensor([1.0, 0.5]))
    kern, again = state.clone(), state.clone()
    before = gt.LAUNCHES["gan_train"]
    rows = gt.gan_train(gt.state_buffers(kern), streams, spec)
    rows2 = gt.gan_train(gt.state_buffers(again), streams, spec)
    torch.cuda.synchronize()
    assert gt.LAUNCHES["gan_train"] == before + 2
    assert torch.equal(rows, rows2) and torch.equal(kern.g_params, again.g_params)
    want, plain, yard = _k2_yardstick(state, streams, spec)
    diffs = gt.state_diffs(gt.state_buffers(kern), gt.state_buffers(plain),
                           gt.state_buffers(state), spec)
    print(f"K2 {case} {rows.shape[0]} steps:",
          {k: f"{r:.3e} (fp32 plain vs fp64: {yard[k][1]:.3e})" for k, (_, r) in diffs.items()})
    for k, (_, r) in diffs.items():
        assert r <= K2_BF16_PART_RTOL[k.split("_")[-1]], (k, diffs)


@pytest.mark.parametrize("knobs", [dict(gan_loss="wgan_gp")])
def test_gan_train_kernel_refuses_what_it_lacks(knobs, dev):
    """The kernel takes WGAN-GP and bfloat16 operands; bfloat16 Adam moments
    are refused, as by the JAX package's kernels."""
    cfg = default_config()
    assert gt.make_gan_epoch_fn(cfg, StepSettings.from_config(cfg, **knobs)) is not None
    moments = cfg.replace(train=dataclasses.replace(cfg.train, adam_state_dtype="bfloat16"))
    with pytest.raises(ValueError, match="adam_state_dtype"):
        gt.make_gan_epoch_fn(moments, StepSettings.from_config(moments, **knobs))


@pytest.mark.parametrize("knobs", [dict(gan_loss="wgan_gp")], ids=["wgan_gp"])
def test_trainer_on_the_card_runs_the_eager_step_only_when_asked(knobs, dev, train_ds):
    """bfloat16 Adam moments are the eager step's: "auto" raises and names
    the eager engine, which then trains (WGAN-GP on top)."""
    cfg = default_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, adam_state_dtype="bfloat16"))
    settings = StepSettings.from_config(cfg, **knobs)
    trainer = Trainer(cfg, ds=train_ds, epochs_per_call=1, device=dev)
    with pytest.raises(ValueError, match="adam_state_dtype") as err:
        trainer.train_pigan(epochs=1, settings=settings)
    assert "engine='eager'" in str(err.value)
    asked = Trainer(cfg, ds=train_ds, epochs_per_call=1, device=dev, engine="eager")
    before = dict(gt.LAUNCHES)
    hist = asked.train_pigan(epochs=1, settings=settings)
    assert gt.LAUNCHES == before
    assert len(hist["pigan/g_loss"]) == 1 and hist["pigan/g_loss"][0] == hist["pigan/g_loss"][0]


def test_trainer_launches_the_gan_kernel_once_per_chunk(dev, train_ds):
    trainer = Trainer(default_config(), ds=train_ds, epochs_per_call=2, device=dev)
    trainer.pretrain_forward(epochs=2)
    trainer.init_pigan()
    before = gt.LAUNCHES["gan_train"]
    hist = trainer.train_pigan(epochs=5)
    assert gt.LAUNCHES["gan_train"] == before + 3
    loss = hist["pigan/g_loss"]
    assert len(loss) == 5 and all(x == x for x in loss)


# -- K3: the member-packed GAN kernel --------------------------------------------
K3_MIX = {**K2_MIX, "ema_decay": 0.0}


def _k3_setup(ds, f, members, epochs=1, **knobs):
    """M members from seeds 0..M-1 (``_k2_setup``), stacked, with each
    member's own shuffles stacked to (M, E, spe, B) streams."""
    from pigan_thz_torch.parallel.state_utils import tree_stack

    setups = [_k2_setup(ds, f, epochs=epochs, seed=m, **knobs) for m in range(members)]
    cfg, settings = setups[0][:2]
    ens = tree_stack([s[2] for s in setups])
    idx = torch.stack([s[5] for s in setups])
    seeds = torch.stack([s[6] for s in setups])
    streams = gt.build_streams(ds, idx, torch.linspace(1.0, 0.5, epochs), 0, 0, 0,
                               settings.d_update_every, _k2_schedule(cfg, "g"),
                               _k2_schedule(cfg, "d"), settings=settings, seeds=seeds)
    return cfg, settings, ens, streams


def _ensemble_tensors(bufs):
    return [*bufs[:6], *bufs.bn]


K3_PATHS = {"through_f": dict(detach_forward=False), "detached": dict(detach_forward=True),
            "knob_mix": K3_MIX,
            "second_passes_and_noise": dict(detach_forward=False, cycle_w=1.0, stability_w=1.0,
                                            instance_noise=0.05),
            "all_four": {**K2_PATHS["all_four"], "ema_decay": 0.0},
            "cycle_detached": dict(detach_forward=True, cycle_w=1.0),
            "wgan_gp": dict(detach_forward=False, gan_loss="wgan_gp", d_update_every=2),
            "bf16": dict(detach_forward=False, compute_dtype="bfloat16"),
            "wgan_gp_bf16_cycle_stability": dict(
                detach_forward=False, gan_loss="wgan_gp", compute_dtype="bfloat16", cycle_w=1.0,
                stability_w=1.0)}


@pytest.mark.parametrize("knobs", list(K3_PATHS.values()), ids=list(K3_PATHS))
def test_ensemble_kernel_is_bit_identical_to_the_solo_kernel(knobs, dev, train_ds, trained_f):
    """M = 2, one epoch: member m's rows and whole state after one packed
    launch equal K2's on that member alone from the same state and streams."""
    cfg, settings, ens, streams = _k3_setup(train_ds, trained_f, 2, **knobs)
    spec = gt.gan_train_spec(cfg, settings)
    solo = [st.clone() for st in ens]
    before = dict(gt.LAUNCHES)
    rows = gt.gan_ensemble_train(gt.ensemble_buffers(ens), streams, spec)
    torch.cuda.synchronize()
    assert gt.LAUNCHES["gan_ensemble_train"] == before["gan_ensemble_train"] + 1
    assert gt.LAUNCHES["gan_train"] == before["gan_train"]
    assert rows.shape == (2, 15, gt.ROW_WIDTH) and bool(torch.isfinite(rows).all())
    assert not torch.equal(rows[0], rows[1])
    for m, st in enumerate(solo):
        bufs, own = gt._member(gt.ensemble_buffers(ens), streams, m)
        want = gt.gan_train(gt.state_buffers(st), own, spec)
        torch.cuda.synchronize()
        assert torch.equal(rows[m], want), m
        for a, b in zip(_ensemble_tensors(bufs), _ensemble_tensors(gt.state_buffers(st))):
            assert torch.equal(a, b), m


@pytest.mark.parametrize("case", ["through_f", "second_passes_and_noise"])
def test_ensemble_kernel_matches_plain_and_reruns_bit_identically(case, dev, train_ds,
                                                                  trained_f):
    cfg, settings, ens, streams = _k3_setup(train_ds, trained_f, 3, epochs=2,
                                            **K3_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    start, plain, again = ens.clone(), ens.clone(), ens.clone()
    rows = gt.gan_ensemble_train(gt.ensemble_buffers(ens), streams, spec)
    rows2 = gt.gan_ensemble_train(gt.ensemble_buffers(again), streams, spec)
    before = dict(gt.LAUNCHES)
    want = gt.gan_ensemble_train_plain(gt.ensemble_buffers(plain), streams, spec)
    torch.cuda.synchronize()
    assert gt.LAUNCHES == before          # the plain version launches nothing
    assert torch.equal(rows, rows2)
    for a, b in zip(_ensemble_tensors(gt.ensemble_buffers(ens)),
                    _ensemble_tensors(gt.ensemble_buffers(again))):
        assert torch.equal(a, b)
    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    for m in range(3):
        one = gt._member(gt.ensemble_buffers(start), streams, m)[1]
        _, _, yard = _k2_yardstick(start[m], one, spec)
        _assert_k2_close(rows[m], ens[m], want[m], plain[m], start[m], yard, spec, keys)


def test_ensemble_fn_on_the_card(dev, train_ds, trained_f):
    """``make_gan_ensemble_fn`` and ``train_seed_ensemble``: one launch per
    chunk whatever M is, packed equal to unpacked, counts advanced."""
    from pigan_thz_torch.parallel.ensemble_megakernel import train_seed_ensemble

    cfg = default_config()
    settings = StepSettings.from_config(cfg, detach_forward=False)
    before = dict(gt.LAUNCHES)
    packed, pm = train_seed_ensemble(cfg, train_ds, 3, settings=settings, epochs=3,
                                     epochs_per_call=2, forward_model=trained_f, packed=True)
    assert gt.LAUNCHES["gan_ensemble_train"] == before["gan_ensemble_train"] + 2
    assert gt.LAUNCHES["gan_train"] == before["gan_train"]
    solo, sm = train_seed_ensemble(cfg, train_ds, 3, settings=settings, epochs=3,
                                   epochs_per_call=2, forward_model=trained_f)
    assert gt.LAUNCHES["gan_train"] == before["gan_train"] + 6
    assert pm["g_loss"].shape == (3, 3)
    assert all((pm[k] == sm[k]).all() for k in pm)
    for a, b in zip(_ensemble_tensors(gt.ensemble_buffers(packed)),
                    _ensemble_tensors(gt.ensemble_buffers(solo))):
        assert torch.equal(a, b)
    assert [(st.step, st.g_opt.count, st.d_opt.count) for st in packed] == [(45, 45, 45)] * 3
    with pytest.raises(ValueError, match="ema_decay"):
        gt.make_gan_ensemble_fn(cfg, StepSettings.from_config(cfg, ema_decay=0.9), 2)


@pytest.mark.parametrize("case, per_step", [
    ("through_f", 69), ("detached", 58), ("cycle_detached", 58 + 17),
    ("stability", 69 + 17), ("instance_noise", 70),
    ("second_passes_mix", 69 + 19 + 16), ("wgan_gp_through_f", 69 + 14)])
def test_gan_kernel_enqueues_the_launches_a_step_it_says(case, per_step, dev, train_ds,
                                                         trained_f):
    """The C loop's own count of what it enqueued: today's settings stay 69
    launches a step (58 detached); a second pass adds 16 and the sum of the
    gradients 1, cycle through F 2 more, instance noise 1; K3 the same."""
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1,
                                                       **K2_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.ones(1))
    gt.gan_train(gt.state_buffers(state), streams, spec)
    assert gt.kernels_enqueued() == per_step * 15
    _, _, ens, estreams = _k3_setup(train_ds, trained_f, 3, **{
        **K2_PATHS[case], "ema_decay": 0.0})
    gt.gan_ensemble_train(gt.ensemble_buffers(ens), estreams, spec)
    assert gt.kernels_enqueued() == per_step * 15


def test_gan_train_leaves_its_intermediates_in_a_given_scratch(dev, train_ds, trained_f):
    cfg, settings, state, _, _, idx, _ = _k2_setup(train_ds, trained_f, epochs=1,
                                                   detach_forward=False)
    spec = gt.gan_train_spec(cfg, settings)
    streams = gt.build_streams(train_ds, idx[:, :1], torch.ones(1), 0, 0, 0, 1,
                               _k2_schedule(cfg, "g"), _k2_schedule(cfg, "d"))
    with pytest.raises(ValueError, match="work"):
        gt.gan_train(gt.state_buffers(state.clone()), streams, spec,
                     work=torch.empty(16, device=dev))
    work = torch.zeros(gt.workspace_floats(spec, 64), device=dev)
    own, given = state.clone(), state.clone()
    rows = gt.gan_train(gt.state_buffers(own), streams, spec)
    rows2 = gt.gan_train(gt.state_buffers(given), streams, spec, work=work)
    torch.cuda.synchronize()
    assert torch.equal(rows, rows2) and torch.equal(own.g_params, given.g_params)
    views = gt.workspace_views(work, spec, 64)
    state.g.train()
    with torch.no_grad():
        want = state.g(streams.spectra[0])
    # G's output through train-mode BatchNorm, fp32 on both sides (measured 1.4e-5)
    torch.testing.assert_close(views["tn"].view(64, 4), want, rtol=0, atol=1e-4)
    assert float(views["grad_g"].abs().max()) > 0 and float(views["dfin"].abs().max()) > 0
