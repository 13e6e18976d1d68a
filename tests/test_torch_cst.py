"""The port's CST export converter (data/cst.py) against the JAX package's,
on the CPU, on synthetic exports in the format of the reference's
``dataset/THZ.txt`` (multi-block, CRLF, comment noise), built as
tests/test_cst.py builds them.

The two packages' float32 frequency grids differ in the last bit on some
points (ROADMAP.md), so the resampled spectra agree to the interpolation's
slope times that bit (atol 1e-4 dB), and the converted metrics are held
against the JAX peak analysis on the port's own arrays, where they must
agree to rtol 1e-5."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch.config import DataConfig as TDataConfig
from pigan_thz_torch.data import cst as tcst
from pigan_thz_torch.data import load_csv as t_load_csv
from pigan_thz_tpu.config import DataConfig as JDataConfig
from pigan_thz_tpu.data import cst as jcst
from pigan_thz_tpu.data import load_csv as j_load_csv
from pigan_thz_tpu.data import synthesize_spectra
from pigan_thz_tpu.ops.peaks import batched_peak_metrics

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECTRA_ATOL = 1e-4   # grid points 1 float32 ulp apart times the dips' slope


def _write_cst(path, blocks, sep="\t", crlf=False, extra_params=""):
    """blocks: list of (params_dict, freq, values)."""
    nl = "\r\n" if crlf else "\n"
    with open(path, "w", newline="") as fh:
        for params, freq, vals in blocks:
            inner = "; ".join(f"{k}={v}" for k, v in params.items())
            if extra_params:
                inner += "; " + extra_params
            fh.write(f"#Parameters = {{{inner}}}{nl}")
            fh.write(f'#"Frequency / THz"{sep}"S2,1 (3) [Magnitude / dB]"{nl}')
            fh.write("#" + "-" * 45 + nl)
            for f, v in zip(freq, vals):
                fh.write(f"{f:.14f}{sep}{v:.13f}{nl}")


def _synthetic_blocks(n, n_points=400, seed=0):
    """CST-format blocks whose spectra come from the synthetic generator."""
    cfg = JDataConfig()
    params = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), (n, 4), minval=2.25, maxval=2.75))
    freq = np.linspace(cfg.freq_min, cfg.freq_max, n_points)
    spec = np.asarray(synthesize_spectra(
        jnp.asarray(freq, jnp.float32), jnp.asarray(params, jnp.float32),
        key=jax.random.PRNGKey(seed + 1)))
    return [
        ({"d": 500, "p": 50, "r1": params[i, 0], "r2": params[i, 1],
          "w": params[i, 2], "g": params[i, 3], "t": 0.2}, freq, spec[i])
        for i in range(n)
    ]


def _assert_blocks_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.params == b.params
        np.testing.assert_array_equal(a.freq, b.freq)
        np.testing.assert_array_equal(a.values, b.values)


@pytest.mark.parametrize("crlf", [False, True], ids=["lf", "crlf"])
def test_parse_matches_jax(tmp_path, crlf):
    p = str(tmp_path / "export.txt")
    _write_cst(p, _synthetic_blocks(3), crlf=crlf, extra_params="Mesh Pass=3; name=run_a")
    got = tcst.parse_cst_export(p)
    _assert_blocks_equal(got, jcst.parse_cst_export(p))
    assert "Mesh Pass" in got[0].params and "name" not in got[0].params


def test_parser_robust_to_junk_like_jax(tmp_path):
    rng = np.random.default_rng(13)
    clean = str(tmp_path / "clean.txt")
    _write_cst(clean, _synthetic_blocks(2, n_points=120, seed=5))
    junk = ["# a comment", "#---", '#"Frequency / THz" "S2,1"', "", "   ",
            "not a number at all", "only_one_col"]
    out = []
    for ln in open(clean).read().splitlines():
        out.append(ln)
        if rng.random() < 0.3:
            out.append(junk[rng.integers(len(junk))])
    noisy = tmp_path / "noisy.txt"
    noisy.write_text("\r\n".join(out))
    got = tcst.parse_cst_export(str(noisy))
    _assert_blocks_equal(got, jcst.parse_cst_export(str(noisy)))
    _assert_blocks_equal(got, tcst.parse_cst_export(clean))
    empty = tmp_path / "empty.txt"
    empty.write_text("# nothing here\n")
    with pytest.raises(ValueError, match="no CST data blocks"):
        tcst.parse_cst_export(str(empty))


def test_blocks_to_arrays_matches_jax(tmp_path):
    blocks = _synthetic_blocks(2, n_points=617)   # odd grid: real interpolation
    renamed = [({**{k: v for k, v in ps.items() if k != "g"}, "p": ps["g"]}, f, v)
               for ps, f, v in blocks]
    p = str(tmp_path / "export.txt")
    _write_cst(p, renamed)
    with pytest.raises(ValueError, match="structural parameter 'g'"):
        tcst.blocks_to_arrays(tcst.parse_cst_export(p), TDataConfig())
    got = tcst.blocks_to_arrays(tcst.parse_cst_export(p), TDataConfig(), param_map={"g": "p"})
    want = jcst.blocks_to_arrays(jcst.parse_cst_export(p), JDataConfig(), param_map={"g": "p"})
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=SPECTRA_ATOL, rtol=0)
    got_d = tcst.blocks_to_arrays(tcst.parse_cst_export(p), TDataConfig(),
                                  defaults={"g": 2.5})
    assert (got_d[0][:, 3] == 2.5).all()


def test_convert_matches_jax(tmp_path):
    raw = str(tmp_path / "export.txt")
    _write_cst(raw, _synthetic_blocks(24, seed=3))
    t_out, j_out = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    assert tcst.convert_cst_export(raw, t_out, device="cpu") == 24
    assert jcst.convert_cst_export(raw, j_out) == 24
    got, want = j_load_csv(t_out, JDataConfig()), j_load_csv(j_out, JDataConfig())
    np.testing.assert_array_equal(np.asarray(got.params), np.asarray(want.params))
    np.testing.assert_array_equal(np.asarray(got.frequencies), np.asarray(want.frequencies))
    np.testing.assert_allclose(np.asarray(got.spectra), np.asarray(want.spectra),
                               atol=SPECTRA_ATOL, rtol=0)
    np.testing.assert_array_equal(np.isnan(np.asarray(got.metrics)),
                                  np.isnan(np.asarray(want.metrics)))
    # the metrics are JAX's peak analysis of the port's resampled spectra
    grid = TDataConfig().frequencies.numpy()
    ref = batched_peak_metrics(jnp.asarray(grid), jnp.asarray(np.asarray(got.spectra)))
    np.testing.assert_allclose(np.asarray(got.metrics), np.asarray(ref), rtol=1e-5,
                               equal_nan=True)
    assert np.isfinite(np.asarray(got.metrics)[:, :2]).all()
    # and the port reads its own file back
    back = t_load_csv(t_out, TDataConfig(), device="cpu")
    np.testing.assert_array_equal(back.spectra.numpy(), np.asarray(got.spectra))


def test_sweep_coverage_and_fit_grid_match_jax(tmp_path):
    ps, f, v = _synthetic_blocks(1)[0]
    raw = str(tmp_path / "short.txt")
    _write_cst(raw, [(ps, f[:300], v[:300])])   # sweep stops before freq_max
    with pytest.raises(ValueError, match="does not cover"):
        tcst.blocks_to_arrays(tcst.parse_cst_export(raw), TDataConfig())
    t_out, j_out = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    kw = dict(fit_grid=True, defaults={"g": 2.5})
    assert tcst.convert_cst_export(raw, t_out, device="cpu", **kw) == 1
    jcst.convert_cst_export(raw, j_out, **kw)
    got, want = j_load_csv(t_out, JDataConfig()), j_load_csv(j_out, JDataConfig())
    np.testing.assert_array_equal(np.asarray(got.frequencies), np.asarray(want.frequencies))
    assert float(got.frequencies[-1]) <= float(f[299]) + 1e-6
    np.testing.assert_allclose(np.asarray(got.spectra), np.asarray(want.spectra),
                               atol=SPECTRA_ATOL, rtol=0)


def test_convert_cst_command(tmp_path):
    raw = str(tmp_path / "export.txt")
    blocks = _synthetic_blocks(4, seed=8)
    _write_cst(raw, [({k: v for k, v in ps.items() if k != "g"}, f, v)
                     for ps, f, v in blocks])
    out = str(tmp_path / "converted.csv")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "pigan_thz_torch", "convert-cst", raw, "--out", out,
         "--device", "cpu", "--default", "g=2.4"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert "converted 4 sample(s)" in proc.stdout
    ds = j_load_csv(out, JDataConfig())
    assert ds.num_samples == 4
    np.testing.assert_allclose(np.asarray(ds.params)[:, 3], 2.4, rtol=1e-6)
    bad = subprocess.run(
        [sys.executable, "-m", "pigan_thz_torch", "convert-cst", raw, "--out", out,
         "--device", "cpu", "--default", "g"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env,
    )
    assert bad.returncode != 0 and "expects key=value" in bad.stderr
