"""The port's inverse-design screening (design/screening.py) against the JAX
package, on the CPU: the chunk body on the same candidates with F carried
over by ``from_flax``, and the semantics tests of
tests/test_ensemble_screening.py on the port's own screen."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.design import (
    METRIC_INDEX,
    ScreeningConfig,
    screen_chunk,
    screen_designs,
    screening_throughput,
)
from pigan_thz_torch.design.screening import make_surrogate
from pigan_thz_torch.interop import from_flax
from pigan_thz_torch.models import build_forward_model
from pigan_thz_tpu.config import DataConfig as JDataConfig
from pigan_thz_tpu.design.screening import _score as j_score
from pigan_thz_tpu.models import build_trio
from pigan_thz_tpu.ops.peaks import batched_peak_metrics as j_batched_peak_metrics

torch.set_num_threads(1)

FREQ = np.array(JDataConfig().frequencies)
LO = torch.full((4,), 2.2)
HI = torch.full((4,), 2.8)
# Spectra of the two F's agree to ~1e-6 (fp32 products summed in another
# order); the FWHM interpolation divides by the spectra's local slope, which
# carries that into Q and FoM at up to ~1e-5 relative.
METRICS_RTOL = 1e-4


@pytest.fixture(scope="module")
def forward_models(cfg):
    """JAX's F with flax-initialised weights, and the same weights in the
    port's module."""
    f = build_trio(cfg)[2]
    k = jax.random.PRNGKey(0)
    fv = f.init({"params": k, "dropout": k}, jnp.zeros((2, 4)), train=False)
    tf = build_forward_model(t_default_config().forward_model, device="cpu")
    tf.load_state_dict(from_flax(jax.tree.map(np.asarray, fv), "forward_model"))
    return f, fv, tf.eval()


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "module"])
@pytest.mark.parametrize("objective", ["FoM1", "FoM1+FoM2", "Q2"])
def test_chunk_matches_jax(forward_models, use_pallas, objective):
    f, fv, tf = forward_models
    pn = np.random.default_rng(0).uniform(-1, 1, (512, 4)).astype(np.float32)
    sc = ScreeningConfig(objective=objective)
    spec_j = f.apply(fv, jnp.asarray(pn), train=False)[0]
    met_j = j_batched_peak_metrics(jnp.asarray(FREQ), spec_j, min_prominence=sc.min_prominence)
    scores_j = np.asarray(j_score(met_j, objective))
    scores_j = np.where(np.isnan(scores_j), -np.inf, scores_j)
    with torch.inference_mode():
        surrogate = make_surrogate(tf, use_pallas, torch.device("cpu"), 250)
        spec, met, scores = screen_chunk(surrogate, torch.from_numpy(pn),
                                         torch.from_numpy(FREQ), sc)
    np.testing.assert_allclose(spec.numpy(), np.asarray(spec_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(met.numpy(), np.asarray(met_j), rtol=METRICS_RTOL,
                               equal_nan=True)
    np.testing.assert_allclose(scores.numpy(), scores_j, rtol=METRICS_RTOL)
    assert np.isfinite(scores_j).sum() > 100 and not np.isnan(scores.numpy()).any()


def _screen(tf, seed, **kw):
    return screen_designs(tf, torch.from_numpy(FREQ), LO, HI,
                          torch.Generator().manual_seed(seed), ScreeningConfig(**kw))


def test_screening_returns_sorted_topk(forward_models):
    res = _screen(forward_models[2], 1, num_candidates=2048, chunk_size=1024,
                  top_k=16, objective="FoM1")
    scores = res.scores.numpy()
    assert res.params.shape == (16, 4) and res.metrics.shape == (16, 8)
    assert res.spectra.shape == (16, 250) and res.valid.all()
    assert all(scores[i] >= scores[i + 1] for i in range(len(scores) - 1))
    p = res.params.numpy()
    assert p.min() >= 2.2 - 1e-5 and p.max() <= 2.8 + 1e-5


def test_screening_objective_consistency(forward_models):
    """Winner scores equal the named metric column (where finite), and the
    winners' metrics are the chunk body's on their spectra."""
    res = _screen(forward_models[2], 2, num_candidates=2048, chunk_size=1024,
                  top_k=8, objective="Q1")
    finite = torch.isfinite(res.scores)
    assert finite.any()
    torch.testing.assert_close(res.scores[finite],
                               res.metrics[finite, METRIC_INDEX["Q1"]], rtol=1e-6, atol=0)
    _, met, _ = screen_chunk(lambda x: x, res.spectra, torch.from_numpy(FREQ),
                             ScreeningConfig(objective="Q1"))
    torch.testing.assert_close(met, res.metrics, equal_nan=True)


def test_screening_masks_ceil_divide_padding(forward_models):
    """The final chunk's rows past num_candidates are padding: with
    top_k > num_candidates they surface as valid=False filler rows."""
    tf = forward_models[2]
    kw = dict(num_candidates=10, chunk_size=16, objective="FoM1", min_prominence=0.0)
    res = _screen(tf, 3, top_k=12, **kw)
    valid, scores = res.valid.numpy(), res.scores.numpy()
    assert valid.sum() <= 10
    assert (scores[~valid] == -np.inf).all()
    res2 = _screen(tf, 3, top_k=10, **kw)
    n = int(valid.sum())
    np.testing.assert_array_equal(scores[:n], res2.scores.numpy()[:n])


def test_screening_filler_rows_when_nothing_qualifies(forward_models):
    res = _screen(forward_models[2], 4, num_candidates=64, chunk_size=32,
                  top_k=8, min_prominence=1e9)
    assert not res.valid.any() and (res.scores == -torch.inf).all()
    assert torch.isfinite(res.params).all()


def test_fused_and_module_surrogates_agree(forward_models):
    tf = forward_models[2]
    kw = dict(num_candidates=1500, chunk_size=512, top_k=10, objective="FoM1")
    fused = _screen(tf, 5, use_pallas=True, **kw)
    module = _screen(tf, 5, use_pallas=False, **kw)
    torch.testing.assert_close(fused.scores, module.scores, rtol=METRICS_RTOL, atol=0)
    torch.testing.assert_close(fused.params, module.params, rtol=1e-6, atol=0)


def test_screening_leaves_the_module_mode(forward_models):
    tf = forward_models[2]
    tf.train()
    try:
        a = _screen(tf, 6, num_candidates=256, chunk_size=128, top_k=4)
        assert tf.training
    finally:
        tf.eval()
    b = _screen(tf, 6, num_candidates=256, chunk_size=128, top_k=4)
    torch.testing.assert_close(a.scores, b.scores)   # no dropout in the screen


def test_unported_options_raise(forward_models):
    tf = forward_models[2]
    sc = ScreeningConfig(num_candidates=64, chunk_size=64, top_k=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 13"):
        screen_designs(tf, FREQ, LO, HI, torch.Generator(),
                       dataclasses.replace(sc, compute_dtype="bfloat16"))
    with pytest.raises(ValueError, match="compute_dtype"):
        screen_designs(tf, FREQ, LO, HI, torch.Generator(),
                       dataclasses.replace(sc, compute_dtype="float16"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 14"):
        screen_designs(tf, FREQ, LO, HI, torch.Generator(), sc, mesh=object())
    assert screening_throughput(1_000_000, 0.5) == 2_000_000.0


def test_config_matches_jax():
    from pigan_thz_tpu.design.screening import ScreeningConfig as JScreeningConfig

    assert dataclasses.asdict(ScreeningConfig()) == dataclasses.asdict(JScreeningConfig())
