"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Weights are full-width, seeded, with flax's initialisation and non-trivial
generator BatchNorm stats, so the folding is exercised.  The
dip-qualification kernel (K4) is held against both of its plain versions on
the spectra classes of tests/test_peaks.py.  The forward-training kernel
(K1) is held against its plain version and the eager step over 2 epochs of
a 1000-sample dataset, with the tolerances of ``chip_smoke.py``.
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
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.ops import forward_train as ft
from pigan_thz_torch.ops import fused_kernels as fk
from pigan_thz_torch.ops import peaks as pk
from pigan_thz_torch.serve import make_inverse_design_fn
from pigan_thz_torch.train.schedules import make_schedule
from pigan_thz_torch.train.state import init_forward_state, make_optimizers
from pigan_thz_torch.train.steps import (
    ForwardStepSettings,
    make_forward_step,
    make_multi_epoch_fn,
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
    g = build_generator(cfg.generator, generator=gen)
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean += 0.1 * torch.randn(m.num_features, generator=gen) ** 2
                m.running_var += 0.1 * torch.randn(m.num_features, generator=gen) ** 2
    f = build_forward_model(cfg.forward_model, generator=gen)
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
        "forward_train": 0}
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
        "dip_qualification": 3, "forward_train": 0}
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
    state = init_forward_state(build_forward_model(cfg.forward_model), ftx, seed,
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
