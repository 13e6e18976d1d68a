"""The port's evaluation surface against the JAX package's, on the CPU:
``evaluate/ceilings.py`` (noise ceilings from the same draws, the clean
oracle on carried-over weights, within 1e-5), ``grading.py`` at every
threshold edge, the rubrics and the summary report string for string, the
figures' panel inventory, and the ``evaluate`` command (the JAX command's
JSON keys, each suite's rubric, the seven figures).

The JAX side's noise ceilings come from its own ``sample_params`` /
``synthesize_spectra`` under ``split(PRNGKey(0), 3)``, as
``pigan_thz_tpu/evaluate/ceilings.py`` draws them; the port takes those
arrays through its draw-taking function.  The port's own draws come from a
CPU generator and cannot equal JAX's threefry draws, so its
``noise_ceilings`` is held to the ranges of tests/test_eval_surface.py.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.cli import main as cli_main
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.evaluate import SUITE_RUBRICS as T_RUBRICS
from pigan_thz_torch.evaluate import ceilings as tc
from pigan_thz_torch.evaluate import generate_summary_report as t_report
from pigan_thz_torch.evaluate import grading as tg
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.data.dataset import metric_ranges_from_data as j_ranges
from pigan_thz_tpu.data.dataset import normalize_metrics as j_normalize
from pigan_thz_tpu.data.synthetic import dip_centers as j_centres
from pigan_thz_tpu.data.synthetic import sample_params as j_sample_params
from pigan_thz_tpu.data.synthetic import synthesize_spectra as j_synthesize
from pigan_thz_tpu.evaluate import SUITE_RUBRICS as J_RUBRICS
from pigan_thz_tpu.evaluate import generate_summary_report as j_report
from pigan_thz_tpu.evaluate import grading as jg
from pigan_thz_tpu.evaluate import noise_ceilings as j_noise_ceilings
from pigan_thz_tpu.evaluate import oracle_validation as j_oracle
from pigan_thz_tpu.ops.metrics import r2_score as j_r2
from pigan_thz_tpu.ops.peaks import batched_peak_metrics as j_peak_metrics
from pigan_thz_tpu.train.trainer import Trainer as JTrainer
from test_torch_evaluator import carry_over

torch.set_num_threads(1)

N, B = 128, 32
TOL = 1e-5
PEAK_RTOL = 1e-6
WIDTHS = {"generator.hidden_dims": "48,24", "discriminator.hidden_dims": "40,20",
          "forward_model.hidden_dims": "16,32,48,32,16"}
SUITE_KEYS = {"forward": "forward_network_evaluation", "pigan": "pigan_evaluation",
              "structural": "structural_prediction_evaluation",
              "validation": "model_validation"}
FIGURES = ("forward_network_evaluation.png", "pigan_evaluation.png",
           "structural_prediction_evaluation.png", "model_validation_evaluation.png",
           "evaluation_summary.png", "forward_predictions.png", "gan_comparison.png")


def _narrow(cfg):
    from pigan_thz_torch.config import apply_overrides as t_apply
    from pigan_thz_tpu.config import apply_overrides as j_apply

    sets = [f"data.num_samples={N}", f"train.batch_size={B}", "train.num_epochs=2",
            "train.fwd_pretrain_epochs=2", *(f"{k}={v}" for k, v in WIDTHS.items())]
    apply = t_apply if type(cfg).__module__.startswith("pigan_thz_torch") else j_apply
    return apply(cfg, sets)


@pytest.fixture(scope="module")
def pair():
    """A JAX trainer after a short run and the port's trainer carrying its
    weights, on one dataset; their evaluators and the JAX results."""
    tcfg, jcfg = _narrow(t_default_config()), _narrow(j_default_config())
    raw = synthetic_dataset(tcfg.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(),
                          jcfg.data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))
    jtr = JTrainer(jcfg, ds=jds, epochs_per_call=1, megakernel="off")
    jtr.train(mode="full", forward_epochs=2, gan_epochs=2)
    ttr = Trainer(tcfg, ds=tds, device="cpu")
    ttr.init_pigan()
    carry_over(jtr.pigan_state, ttr.pigan_state)
    return {"jtr": jtr, "ttr": ttr, "jds": jds, "tds": tds,
            "results": jtr.evaluate(jax.random.PRNGKey(0))}


# -- noise ceilings -----------------------------------------------------------


def _jax_draws(data_cfg):
    """noise_ceilings' own draws in the JAX package, and its arithmetic on
    them."""
    kp, k1, k2 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = j_sample_params(kp, data_cfg.num_samples, data_cfg)
    freq = data_cfg.frequencies
    c1, c2 = j_centres(params)
    spectra = [j_synthesize(freq, params, k, data_cfg.noise_level) for k in (k1, k2)]
    metrics = [j_peak_metrics(freq, s, fallback_f1=c1, fallback_f2=c2) for s in spectra]
    lo, hi = j_ranges(metrics[0])
    c_spec = float(j_r2(spectra[0], spectra[1]))
    c_met = float(j_r2(j_normalize(metrics[0], lo, hi), j_normalize(metrics[1], lo, hi)))
    arrays = [np.array(a, np.float32) for a in (freq, params, *spectra)]
    return arrays, [np.asarray(m) for m in metrics], (c_spec, c_met)


@pytest.mark.parametrize("noise_level", [0.1, 0.05])
def test_ceilings_from_the_jax_draws(noise_level):
    data = dataclasses.replace(j_default_config().data, num_samples=256,
                               noise_level=noise_level)
    want = j_noise_ceilings(data)
    arrays, j_metrics, (c_spec, c_met) = _jax_draws(data)
    # the draws above are the JAX function's own: its dict, exactly
    assert want["draw_to_draw_spectrum_r2"] == c_spec
    assert want["draw_to_draw_metrics_r2"] == c_met
    got, t_metrics = tc.ceilings_from_draws(*(torch.from_numpy(a) for a in arrays),
                                            noise_level)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)
    # the metrics: NaN pattern equal, values within tests/test_torch_peak_metrics.py's
    # rtol (the FWHM edges are interpolated in another order: a few values of
    # the 2048 differ in the last bits)
    for t, j in zip(t_metrics, j_metrics):
        t = t.numpy()
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
        np.testing.assert_allclose(t[~np.isnan(t)], j[~np.isnan(j)], rtol=PEAK_RTOL, atol=0)
    assert got["cycle_error_floor"] == pytest.approx(noise_level ** 2)


def test_port_ceilings_match_results_md():
    """At 1000 samples and the default noise level the ceilings sit near
    RESULTS.md's (~0.50 spectrum / ~0.78 metrics): the ranges of
    tests/test_eval_surface.py."""
    cfg = t_default_config()
    c = tc.noise_ceilings(cfg.data, device="cpu")
    assert 0.4 < c["spectrum_r2_ceiling"] < 0.6
    assert 0.6 < c["metrics_r2_ceiling"] < 0.95
    assert c["spectrum_r2_ceiling"] == pytest.approx((1 + c["draw_to_draw_spectrum_r2"]) / 2)
    assert c["spectrum_r2_ceiling"] < 0.9
    assert c["cycle_error_floor"] == pytest.approx(cfg.data.noise_level ** 2)
    assert c["cycle_error_floor"] > 0.005


def test_ceiling_draws_come_from_the_cpu_generator():
    data = _narrow(t_default_config()).data
    a = tc.ceiling_draws(data)
    b = tc.ceiling_draws(data, torch.Generator().manual_seed(0))
    other = tc.ceiling_draws(data, torch.Generator().manual_seed(1))
    assert all(t.device.type == "cpu" for t in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], other[1])
    assert a[1].shape == (N, 4) and a[2].shape == a[3].shape == (N, data.spectrum_dim)
    assert not torch.equal(a[2], a[3])          # two noise draws of the same cells
    assert tc.noise_ceilings(data, device="cpu") == tc.ceilings_from_draws(
        *a, data.noise_level)[0]


# -- the clean oracle ------------------------------------------------------------


def test_oracle_on_carried_over_weights(pair):
    want = j_oracle(pair["jtr"].evaluator(), pair["jds"])
    got = tc.oracle_validation(pair["ttr"].evaluator(), pair["tds"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
        assert isinstance(got[k], float)
    assert got["cycle_error_vs_truth"] > 0 and got["cycle_error_vs_noisy"] > 0


# -- grading, at every threshold edge ------------------------------------------


def _edges(t):
    return [float(np.nextafter(t, -np.inf)), float(t), float(np.nextafter(t, np.inf))]


def _cases(base, thresholds):
    """Each argument at each of its thresholds' edges with the others at
    ``base``, and every argument at one tier's edges at once."""
    cases = []
    for i, ts in enumerate(thresholds):
        for t in ts:
            for v in _edges(t):
                args = list(base)
                args[i] = v
                cases.append(tuple(args))
    for tier in range(len(thresholds[0])):
        for k in range(3):
            cases.append(tuple(_edges(ts[tier])[k] for ts in thresholds))
    return cases


GRADE_CASES = (
    [("grade_forward", a) for a in _cases((0.95, 0.95), [(0.9, 0.8, 0.6)] * 2)]
    + [("grade_pigan", a) for a in _cases((0.95, 0.95), [(0.8, 0.6, 0.4), (0.8, 0.7, 0.6)])]
    + [("grade_structural", a) for a in _cases(
        (0.0, 0.95, 0.0), [(0.05, 0.1, 0.2), (0.9, 0.8, 0.6), (0.01, 0.05, 0.1)])]
    + [("d_equilibrium", a) for a in _cases((0.9, 0.5), [(0.8,), (0.45, 0.6)])])


@pytest.mark.parametrize("fn, args", GRADE_CASES,
                         ids=[f"{f}-{'-'.join(f'{x:.9g}' for x in a)}" for f, a in GRADE_CASES])
def test_grades_at_every_threshold_edge(fn, args):
    assert getattr(tg, fn)(*args) == getattr(jg, fn)(*args)


SCALAR_CASES = [(key, reverse, v) for key, reverse in (("cycle", False), ("stability", False),
                                                       ("plausibility", True))
                for t in jg.VALIDATION_BOUNDS[key] for v in _edges(t)]


@pytest.mark.parametrize("key, reverse, value", SCALAR_CASES)
def test_scalar_grades_at_every_bound_edge(key, reverse, value):
    assert tg.VALIDATION_BOUNDS == jg.VALIDATION_BOUNDS and tg.GRADES == jg.GRADES
    got = tg.grade_scalar(value, tg.VALIDATION_BOUNDS[key], reverse=reverse)
    assert got == jg.grade_scalar(value, jg.VALIDATION_BOUNDS[key], reverse=reverse)


# -- rubrics and the report ----------------------------------------------------


def _tier_results(tier: int) -> dict:
    """A comprehensive results dict whose suites land at grade ``tier``
    (0 EXCELLENT ... 3 POOR) of the rubrics."""
    r2 = (0.95, 0.85, 0.7, 0.3)[tier]
    acc = (0.9, 0.75, 0.65, 0.5)[tier]
    reg = {"r2": r2, "mse": 0.01 * (tier + 1), "mae": 0.05, "rmse": 0.1, "pearson_r": r2,
           "mape": 3.0}
    return {
        "forward_network_evaluation": {"spectrum_prediction": reg, "metrics_prediction": reg},
        "pigan_evaluation": {
            "parameter_prediction": reg,
            "discriminator_performance": {
                "real_accuracy": acc, "fake_accuracy": acc, "overall_accuracy": acc,
                "real_score_mean": 0.6, "fake_score_mean": 0.4}},
        "structural_prediction_evaluation": {
            "param_range_violation_rate": (0.01, 0.08, 0.15, 0.5)[tier],
            "avg_param_violations": 0.2, "reconstruction_error_mean": (0.005, 0.03, 0.08, 0.3)[tier],
            "reconstruction_error_std": 0.01, "consistency_score_mean": (0.95, 0.85, 0.65, 0.4)[tier],
            "consistency_score_std": 0.02},
        "model_validation": {
            "cycle_consistency_error_mean": (0.0005, 0.005, 0.03, 0.2)[tier],
            "cycle_consistency_error_std": 0.001,
            "prediction_stability_mean": (0.0005, 0.005, 0.03, 0.2)[tier],
            "prediction_stability_std": 0.001,
            "physical_plausibility_mean": (0.95, 0.85, 0.7, 0.3)[tier],
            "physical_plausibility_std": 0.01},
        "total_samples": 1000,
    }


# RESULTS.md's self-verifying report (a 500 + 500 run): every verdict kind
RESULTS_MD = dict(_tier_results(0), evaluation_time=12.5)
RESULTS_MD["forward_network_evaluation"] = {
    "spectrum_prediction": dict(_tier_results(0)["forward_network_evaluation"][
        "spectrum_prediction"], r2=0.5013),
    "metrics_prediction": dict(_tier_results(0)["forward_network_evaluation"][
        "metrics_prediction"], r2=0.8084)}
RESULTS_MD["model_validation"] = dict(RESULTS_MD["model_validation"],
                                      cycle_consistency_error_mean=0.01043,
                                      prediction_stability_mean=0.0001267)
CEILINGS = {"draw_to_draw_spectrum_r2": -0.0044, "draw_to_draw_metrics_r2": 0.5758,
            "spectrum_r2_ceiling": 0.4978, "metrics_r2_ceiling": 0.7879,
            "cycle_error_floor": 0.01, "noise_level": 0.1}
ORACLE = {"surrogate_spectrum_r2_vs_truth": 0.9961, "surrogate_spectrum_r2_vs_noisy": 0.5,
          "cycle_error_vs_truth": 0.0009117, "cycle_error_vs_noisy": 0.01043}


@pytest.mark.parametrize("suite", list(SUITE_KEYS))
def test_rubric_equals_jax_on_the_evaluation(suite, pair):
    res = pair["results"][SUITE_KEYS[suite]]
    assert T_RUBRICS[suite](res) == J_RUBRICS[suite](res)


@pytest.mark.parametrize("tier", range(4))
@pytest.mark.parametrize("suite", list(SUITE_KEYS))
def test_rubric_equals_jax_at_each_grade(suite, tier):
    res = _tier_results(tier)[SUITE_KEYS[suite]]
    text = T_RUBRICS[suite](res)
    assert text == J_RUBRICS[suite](res)
    if suite != "validation":
        assert tg.GRADES[tier] in text


def _without_header_and_date(report: str) -> list:
    lines = report.splitlines()
    assert lines[1].startswith("PI-GAN UNIFIED EVALUATION REPORT (")
    assert lines[3].startswith("Evaluation Date: ")
    return lines[:1] + lines[2:3] + lines[4:]


@pytest.mark.parametrize("which", ["evaluation", "results_md"])
@pytest.mark.parametrize("ceilings, oracle", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_report_equals_jax_apart_from_header_and_date(which, ceilings, oracle, pair,
                                                      tmp_path):
    results = pair["results"] if which == "evaluation" else RESULTS_MD
    kw = dict(ceilings=CEILINGS if ceilings else None, oracle=ORACLE if oracle else None)
    path = tmp_path / "sub" / "report.txt"
    got = t_report(results, save_path=str(path), **kw)
    want = j_report(results, **kw)
    assert got.splitlines()[1] == "PI-GAN UNIFIED EVALUATION REPORT (pigan_thz_torch)"
    assert _without_header_and_date(got) == _without_header_and_date(want)
    assert path.read_text() == got
    if which == "results_md" and ceilings and oracle:
        assert ("CEILING-ADJUSTED RATING: EXCELLENT (7/7 targets met or at the "
                "statistical limit)") in got
        assert "AT CEILING" in got and "AT FLOOR" in got and "TARGET MET" in got


# -- figures: the panel inventory of the JAX package's figures ----------------------


def _spy(monkeypatch, module, captured):
    """Replace a figure module's _save: record each figure's axes count and
    titles (and suptitle), close it, write nothing."""
    def save(fig, path):
        import matplotlib.pyplot as plt

        captured[os.path.basename(path)] = (
            len(fig.axes), [ax.get_title() for ax in fig.axes],
            [t.get_text() for t in fig.texts])
        plt.close(fig)
        return path

    monkeypatch.setattr(module, "_save", save)


def test_figures_have_the_jax_panel_inventory(pair, monkeypatch):
    pytest.importorskip("matplotlib")
    from pigan_thz_torch.utils import eval_viz as t_ev
    from pigan_thz_torch.utils import viz as t_viz
    from pigan_thz_tpu.utils import eval_viz as j_ev
    from pigan_thz_tpu.utils import viz as j_viz

    got, want = {}, {}
    for module, box in ((t_ev, got), (t_viz, got), (j_ev, want), (j_viz, want)):
        _spy(monkeypatch, module, box)
    results = pair["results"]
    tev = pair["ttr"].evaluator()
    arrays = tev.sample_arrays(pair["tds"])
    history = {"pigan/d_loss": [1.0, 0.9, 0.8], "pigan/g_loss": [3.0, 2.0, 1.5],
               "forward/loss": [20.0, 1.0, 0.1]}
    for figures in (t_ev, j_ev):
        for suite, (fname, plot_fn) in figures.SUITE_FIGURES.items():
            kw = {"history": history} if suite == "pigan" else {}
            plot_fn(results[SUITE_KEYS[suite]], arrays, fname, **kw)
        figures.plot_comprehensive_summary(results, "evaluation_summary.png",
                                            ceilings=CEILINGS)
    for viz in (t_viz, j_viz):
        viz.plot_training_curves(history, "training_curves.png")
        viz.plot_evaluation_summary(results, "summary_radar.png")
    st, jst = pair["ttr"].pigan_state, pair["jtr"].pigan_state
    modes = (st.g.training, st.f.training)
    t_viz.plot_forward_predictions(pair["tds"], st.f, "forward_predictions.png")
    t_viz.plot_gan_comparison(pair["tds"], st.g, st.f, "gan_comparison.png")
    jtr = pair["jtr"]
    j_viz.plot_forward_predictions(pair["jds"], jtr.forward_model, jst.f.variables,
                                   "forward_predictions.png")
    j_viz.plot_gan_comparison(pair["jds"], jtr.generator, jst.g.variables,
                              jtr.forward_model, jst.f.variables, "gan_comparison.png")
    assert set(got) == set(want) and len(got) == 9
    for name in want:
        if name == "gan_comparison.png":
            # the titles print each cell's params to two decimals: the two
            # packages' float32 predictions may round apart
            assert got[name][0] == want[name][0] and got[name][2] == want[name][2]
            continue
        assert got[name] == want[name], name
    assert sum("pred vs true" in t for t in got["pigan_evaluation.png"][1]) == 4
    # the models are left in the mode they were in
    assert (st.g.training, st.f.training) == modes


# -- the evaluate command ------------------------------------------------------


def _sets():
    return ["--set", f"data.num_samples={N}"]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A tiny trio trained by the train command on the CPU."""
    root = tmp_path_factory.mktemp("eval_cli")
    widths = [a for k, v in WIDTHS.items() for a in ("--set", f"{k}={v}")]
    assert cli_main(["train", "--device", "cpu", "--epochs", "2", "--forward-epochs", "2",
                     "--fixed-physics", "--workdir", str(root), "--no-tensorboard",
                     *_sets(), "--set", f"train.batch_size={B}", *widths]) == 0
    return root / "saved_models"


def test_evaluate_json_has_the_jax_command_keys(saved, pair, tmp_path, capsys):
    out = tmp_path / "eval.json"
    assert cli_main(["evaluate", "--device", "cpu", "--models", str(saved), "--json",
                     str(out), *_sets()]) == 0
    said = capsys.readouterr().out
    got = json.loads(out.read_text())
    jtr, jds = pair["jtr"], pair["jds"]
    want = dict(pair["results"], noise_ceilings=j_noise_ceilings(jtr.cfg.data),
                oracle_validation=j_oracle(jtr.evaluator(), jds), evaluation_time=0.0)

    def keys(tree, prefix=""):
        out = set()
        for k, v in tree.items():
            out |= keys(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k}
        return out

    assert keys(got) == keys(want)
    assert got["total_samples"] == N and got["evaluation_time"] > 0
    assert "5. TARGETS vs ACHIEVABLE CEILINGS" in said and "CEILING-ADJUSTED RATING" in said
    report = (saved / "unified_evaluation_report.txt").read_text()
    assert report in said
    assert "kernel launches: " in said


@pytest.mark.parametrize("suite", list(SUITE_KEYS))
def test_evaluate_suite_prints_its_rubric(suite, saved, capsys, tmp_path):
    out = tmp_path / f"{suite}.json"
    assert cli_main(["evaluate", "--device", "cpu", "--models", str(saved), "--suite", suite,
                     "--json", str(out), *_sets()]) == 0
    said = capsys.readouterr().out
    cfg = t_default_config().replace(workdir=str(tmp_path))
    from pigan_thz_torch.cli import _overlay_model_config_dir
    from pigan_thz_torch.config import apply_overrides

    cfg = _overlay_model_config_dir(apply_overrides(cfg, [f"data.num_samples={N}"]),
                                    str(saved), [])
    trainer = Trainer(cfg, device="cpu")
    trainer.load_final(str(saved))
    res = json.loads(out.read_text())
    full = trainer.evaluator().run_comprehensive_evaluation(trainer.ds)
    assert res == full[SUITE_KEYS[suite]]
    assert said.startswith(T_RUBRICS[suite](res) + "\n")
    assert "TARGETS vs ACHIEVABLE" not in said


def test_evaluate_plot_writes_the_seven_figures(saved, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    assert cli_main(["evaluate", "--device", "cpu", "--models", str(saved), "--plot",
                     "--violation-window", "sane", *_sets()]) == 0
    said = capsys.readouterr().out
    for name in FIGURES:
        path = saved / name
        assert path.is_file() and path.stat().st_size > 10_000, name
    assert "Parameter Violation Rate: 0.0000" in said       # tanh outputs, [-1, 1]


def test_summary_json_writer_equals_jax(pair, tmp_path):
    from pigan_thz_torch.utils.viz import save_evaluation_summary_json as t_save
    from pigan_thz_tpu.utils.viz import save_evaluation_summary_json as j_save

    results = dict(pair["results"], noise_ceilings=CEILINGS, oracle_validation=ORACLE)
    got = t_save(results, str(tmp_path / "t" / "summary.json"))
    want = j_save(results, str(tmp_path / "j" / "summary.json"))
    with open(got) as a, open(want) as b:
        assert a.read() == b.read()
