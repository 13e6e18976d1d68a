"""Guards on the port's boundaries: no JAX, flax, optax, orbax or pandas
inside it, no result from the chip smoke test without a card, no kernel
launch for a CPU tensor, no CPU fallback for a missing card."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from pigan_thz_torch import default_config
from pigan_thz_torch.design import ScreeningConfig, screen_designs
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.ops import forward_train as ft
from pigan_thz_torch.ops import fused_kernels as fk
from pigan_thz_torch.ops import peaks as pk
from pigan_thz_torch.train.state import init_forward_state, make_optimizers
from pigan_thz_torch.train.steps import ForwardStepSettings

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import pigan_thz_torch
names = [m.name for m in pkgutil.walk_packages(pigan_thz_torch.__path__, "pigan_thz_torch.")
         if not m.name.endswith(".__main__")]     # __main__ runs the CLI
for name in names:
    importlib.import_module(name)
assert len(names) >= 30, names
jax = sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "orbax")
             or m.startswith(("jax.", "jaxlib", "flax.", "optax.", "orbax.")))
assert not jax, jax
# the card's machine has no pandas
assert not any(m == "pandas" or m.startswith("pandas.") for m in sys.modules)
assert not any(m.startswith("pigan_thz_tpu") for m in sys.modules)
print("imported", len(names))
"""


def _env_without_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=_env_without_card(),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("imported")


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_without_cuda_fails_without_result(alone, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=_env_without_card(),
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "FAIL" in proc.stderr


def test_cpu_tensors_take_the_plain_path():
    cfg = default_config()
    gen = torch.Generator().manual_seed(0)
    g = fk.pack_generator(build_generator(cfg.generator, generator=gen).eval())
    f = fk.pack_forward_model(build_forward_model(cfg.forward_model, generator=gen).eval())
    x = torch.randn(5, 250, generator=gen)
    before = dict(fk.LAUNCHES)
    pn = fk.generator_fused(g, x)
    spec, met = fk.forward_surrogate_fused(f, pn)
    assert fk.LAUNCHES == before
    assert torch.equal(pn, fk.fused_dense_chain_plain(x, g))
    out = fk.fused_mlp_forward_plain(pn, f)
    assert torch.equal(spec, out[:, :250]) and torch.equal(met, out[:, 250:])


def test_cpu_peaks_and_screening_launch_nothing():
    gen = torch.Generator().manual_seed(1)
    t = torch.randn(6, 250, generator=gen).clamp(max=0.0)
    before = dict(fk.LAUNCHES)
    got = pk.batched_dip_qualification(t)
    assert fk.LAUNCHES == before
    want = pk._dip_qualification_lifted(t)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    f = build_forward_model(default_config().forward_model, generator=gen)
    for use_pallas in (True, False):
        screen_designs(f, default_config().data.frequencies, torch.full((4,), 2.2),
                       torch.full((4,), 2.8), gen,
                       ScreeningConfig(num_candidates=100, chunk_size=64, top_k=4,
                                       use_pallas=use_pallas))
    assert fk.LAUNCHES == before
    assert set(fk.LAUNCHES) == {"fused_mlp_forward", "fused_dense_chain",
                                "dip_qualification", "forward_train"}


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "rank_1", "meta"])
def test_dip_wrapper_refuses(bad):
    t = torch.zeros(4, 250)
    x, err = {
        "float64": (t.double(), TypeError),
        "non_contiguous": (torch.zeros(250, 4).T, ValueError),
        "rank_1": (torch.zeros(250), ValueError),
        "meta": (torch.zeros(4, 250, device="meta"), ValueError),
    }[bad]
    with pytest.raises(err):
        pk.batched_dip_qualification(x)


def test_generate_data_without_a_card_does_not_fall_back(tmp_path):
    out = tmp_path / "x.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "pigan_thz_torch", "generate-data",
         "--set", "data.num_samples=8", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=_env_without_card(),
    )
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not out.exists()


def test_cpu_forward_train_launches_nothing():
    cfg = default_config()
    _, _, ftx = make_optimizers(cfg, 1)
    st = init_forward_state(build_forward_model(cfg.forward_model), ftx, 0)
    spec = ft.forward_train_spec(cfg, ForwardStepSettings())
    gen = torch.Generator().manual_seed(0)
    streams = ft.Streams(torch.rand(2, 8, 4, generator=gen),
                         torch.rand(2, 8, 250, generator=gen),
                         torch.rand(2, 8, 8, generator=gen),
                         torch.tensor([[1e-3, 10.0, 1000.0], [1e-3, 5.3, 500.0]]),
                         torch.tensor([1, 2]))
    before = dict(ft.LAUNCHES)
    a = [st.params.clone(), st.opt.m.clone(), st.opt.v.clone()]
    b = [t.clone() for t in a]
    rows = ft.forward_train(*a, streams, spec)
    assert ft.LAUNCHES == before
    assert torch.equal(rows, ft.forward_train_plain(*b, streams, spec))
    assert all(map(torch.equal, a, b))
    with pytest.raises(ValueError, match="stream spectra"):
        ft.forward_train(*a, streams._replace(spectra=streams.spectra[:, :, :249]), spec)


def test_pretrain_forward_without_a_card_does_not_fall_back(tmp_path):
    out = tmp_path / "saved"
    proc = subprocess.run(
        [sys.executable, "-m", "pigan_thz_torch", "pretrain-forward", "--epochs", "1",
         "--set", "data.num_samples=8", "--workdir", str(tmp_path / "runs"),
         "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=_env_without_card(),
    )
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not out.exists() and not (tmp_path / "runs").exists()
