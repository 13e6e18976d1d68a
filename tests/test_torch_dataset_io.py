"""The port's CSV reader and writer (no pandas) against the JAX package's
pandas path, both ways, on the CPU; the metadata loader; load_or_synthesize;
and the port's ``generate-data`` command."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.config import DataConfig as TDataConfig
from pigan_thz_torch.data import dataset as tds
from pigan_thz_tpu.config import METRIC_NAMES, PARAM_NAMES
from pigan_thz_tpu.config import DataConfig as JDataConfig
from pigan_thz_tpu.data import dataset as jds

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("spectra", "params", "params_norm", "metrics", "metrics_norm",
          "param_lo", "param_hi", "metric_lo", "metric_hi", "frequencies")


def _arrays(seed=0, n=12, s=250):
    rng = np.random.default_rng(seed)
    params = rng.uniform(2.2, 2.8, (n, 4)).astype(np.float32)
    spectra = np.minimum(rng.normal(-3, 2, (n, s)), 0).astype(np.float32)
    spectra[0, :3] = (-0.0, 1e-8, -12.345678)
    metrics = rng.normal(3, 2, (n, 8)).astype(np.float32)
    metrics[rng.random((n, 8)) < 0.25] = np.nan
    metrics[:, 7] = np.nan                  # an all-NaN column
    return params, spectra, metrics


def _assert_datasets_equal(got, want):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_port_csv_reads_in_jax_and_is_byte_identical(tmp_path):
    """The port's writer formats every float as pandas does: the two files
    are the same bytes, and each package reads the other's."""
    params, spectra, metrics = _arrays()
    freq = np.array(JDataConfig().frequencies)
    tcfg, jcfg = t_default_config().data, JDataConfig()
    t_ds = tds.build_dataset(spectra, params, metrics, tcfg, frequencies=freq, device="cpu")
    j_ds = jds.build_dataset(jnp.asarray(spectra), jnp.asarray(params),
                             jnp.asarray(metrics), jcfg, frequencies=freq)
    t_path, j_path = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    tds.save_csv(t_ds, t_path)
    jds.save_csv(j_ds, j_path)
    assert open(t_path, "rb").read() == open(j_path, "rb").read()
    _assert_datasets_equal(tds.load_csv(j_path, tcfg, device="cpu"),
                           jds.load_csv(t_path, jcfg))
    back = tds.load_csv(t_path, tcfg, device="cpu")
    for name, want in (("params", params), ("spectra", spectra), ("metrics", metrics)):
        np.testing.assert_array_equal(getattr(back, name).numpy(), want, err_msg=name)


def _write(tmp_path, variant):
    """A reference-schema CSV written by hand, in one of the shapes real
    exports come in."""
    rng = np.random.default_rng(4)
    freqs = np.linspace(0.5, 3.0, 6)
    header = list(PARAM_NAMES) + [f"Freq_{f:.2f}" for f in freqs] + list(METRIC_NAMES)
    rows = rng.uniform(-9, 9, (7, len(header)))
    rows[2, -3] = rows[5, -1] = np.nan
    fmt = "{:.6e}" if variant == "scientific" else "{:.6f}"
    body = [",".join(fmt.format(v) for v in r) for r in rows]
    if variant == "shuffled":
        order = np.random.default_rng(3).permutation(len(header))
        header = [header[i] for i in order]
        body = [",".join(np.array(r.split(","))[order]) for r in body]
    if variant == "blank_lines":
        body.insert(3, "   ")
        body.append("")
    text = "\n".join([",".join(header)] + body) + "\n"
    text = text.replace("nan", {"na_spellings": "NaN", "blank_lines": "NA"}.get(variant, ""))
    if variant == "na_spellings":
        text = text.replace("NaN", "null", 1)
    if variant == "crlf":
        text = text.replace("\n", "\r\n")
    if variant == "bom_quoted":
        text = "\ufeff" + text.replace("Freq_0.50", '"Freq_0.50"')
    path = tmp_path / f"{variant}.csv"
    path.write_bytes(text.encode())
    return str(path)


@pytest.mark.parametrize("variant", ["plain", "crlf", "scientific", "shuffled",
                                     "blank_lines", "na_spellings", "bom_quoted"])
def test_load_csv_matches_jax(tmp_path, variant):
    path = _write(tmp_path, variant)
    got = tds.load_csv(path, t_default_config().data, device="cpu")
    want = jds.load_csv(path, JDataConfig())
    _assert_datasets_equal(got, want)
    assert got.num_samples == 7 and got.spectrum_dim == 6
    assert np.isnan(got.metrics.numpy()).sum() == 2


def test_load_csv_errors(tmp_path):
    cfg = t_default_config().data
    with pytest.raises(FileNotFoundError):
        tds.load_csv(str(tmp_path / "missing.csv"), cfg, device="cpu")
    path = tmp_path / "short.csv"
    path.write_text("r1,r2,w,g,Freq_0.50,f1,f2,Q1,FoM1,S1,Q2,FoM2\n1,2,3,4,5,6,7,8,9,10,11,12\n")
    with pytest.raises(ValueError, match="missing required"):
        tds.load_csv(str(path), cfg, device="cpu")
    path = tmp_path / "long.csv"
    header = ",".join([*PARAM_NAMES, "Freq_0.50", *METRIC_NAMES])
    path.write_text(header + "\n" + ",".join(["1"] * 14) + "\n")
    with pytest.raises(ValueError, match="fields"):
        tds.load_csv(str(path), cfg, device="cpu")


@pytest.mark.parametrize("variant", ["plain", "bom_quoted", "blank_lines"])
def test_load_metadata_matches_jax(tmp_path, variant):
    path = _write(tmp_path, variant)
    got = tds.load_metadata(t_default_config().data, path)
    want = jds.load_metadata(JDataConfig(), path)
    assert got._fields == want._fields
    np.testing.assert_array_equal(got.frequencies, want.frequencies)
    assert got[1:] == want[1:] and got.num_samples == 7
    cfg_only = tds.load_metadata(t_default_config().data)
    assert cfg_only.num_samples is None and cfg_only.spectrum_dim == 250
    assert cfg_only.frequencies.shape == (250,)
    with pytest.raises(FileNotFoundError):
        tds.load_metadata(t_default_config().data, str(tmp_path / "missing.csv"))


def test_load_or_synthesize(tmp_path):
    cfg = TDataConfig(num_samples=24)
    path = _write(tmp_path, "plain")
    _assert_datasets_equal(tds.load_or_synthesize(cfg, path, device="cpu"),
                           tds.load_csv(path, cfg, device="cpu"))
    ds = tds.load_or_synthesize(cfg, str(tmp_path / "absent.csv"), device="cpu")
    again = tds.synthetic_dataset(cfg, device="cpu")
    assert ds.num_samples == 24 and ds.spectrum_dim == 250
    for name in ("spectra", "params", "metrics"):
        assert torch.equal(getattr(ds, name).nan_to_num(7.0),
                           getattr(again, name).nan_to_num(7.0)), name


def test_generate_data_command_writes_a_csv_jax_reads(tmp_path):
    out = str(tmp_path / "gen.csv")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "pigan_thz_torch", "generate-data", "--device", "cpu",
         "--set", "data.num_samples=32", "--seed", "3", "--out", out],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert "wrote 32 samples" in proc.stdout
    ds = jds.load_csv(out, JDataConfig())
    assert ds.num_samples == 32 and ds.spectrum_dim == 250
    assert np.isfinite(np.asarray(ds.spectra)).all()
    p = np.asarray(ds.params)
    assert p.min() >= 2.2 and p.max() <= 2.8
