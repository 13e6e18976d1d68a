"""Guards on the port's boundaries: no JAX, flax, optax, orbax or pandas
inside it, no result from the chip smoke test without a card, no kernel
launch for a CPU tensor, no CPU fallback for a missing card, no function
whose ``device`` defaults to the CPU."""

import importlib
import inspect
import os
import pkgutil
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
assert len(names) >= 44, names
for new in ("ops.metrics", "parallel.state_utils", "parallel.ensemble",
            "parallel.ensemble_megakernel", "config_presets", "train.programs",
            "evaluate", "evaluate.evaluator", "evaluate.ceilings", "evaluate.grading",
            "evaluate.report", "evaluate.rubrics", "utils.viz", "utils.eval_viz",
            "ops.quantized", "design.inverse", "utils.profiling", "data.native_io"):
    assert "pigan_thz_torch." + new in names, new
# the seed-ensemble example: its imports run, its main() does not
import importlib.util
spec = importlib.util.spec_from_file_location("torch_seed_ensemble",
                                              "examples/torch_seed_ensemble.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
jax = sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "orbax")
             or m.startswith(("jax.", "jaxlib", "flax.", "optax.", "orbax.")))
assert not jax, jax
# the card's machine has no pandas; matplotlib is imported by the figures only
assert not any(m == "pandas" or m.startswith("pandas.") for m in sys.modules)
assert not any(m == "matplotlib" or m.startswith("matplotlib.") for m in sys.modules)
assert not any(m.startswith("pigan_thz_tpu") for m in sys.modules)
print("imported", len(names))
"""


def _public_callables():
    """(qualified name, callable) of every public function, class
    constructor and method defined in the port."""
    import pigan_thz_torch

    seen = {}
    for info in pkgutil.walk_packages(pigan_thz_torch.__path__, "pigan_thz_torch."):
        if info.name.endswith(".__main__"):
            continue
        module = importlib.import_module(info.name)
        for name, obj in vars(module).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != info.name:
                continue
            if inspect.isfunction(obj):
                seen[f"{info.name}.{name}"] = obj
            elif inspect.isclass(obj):
                for attr, fn in vars(obj).items():
                    if inspect.isfunction(fn) and (attr == "__init__" or attr[0] != "_"):
                        seen[f"{info.name}.{name}.{attr}"] = fn
    return seen


def test_no_public_function_defaults_its_device_to_the_cpu():
    """An entry point runs on the card unless the caller asks for the CPU:
    a ``device`` parameter is required, or defaults to CUDA or to "where the
    inputs are" (None), never to the CPU."""
    fns = _public_callables()
    assert len(fns) >= 150, len(fns)
    with_device, bad = [], []
    for name, fn in fns.items():
        for pname, p in inspect.signature(fn).parameters.items():
            if pname not in ("device", "dev"):
                continue
            with_device.append(name)
            default = p.default
            if default is not inspect.Parameter.empty and default is not None and (
                    torch.device(default).type == "cpu"):
                bad.append(name)
    assert not bad, bad
    assert {"pigan_thz_torch.models.registry.build_trio",
            "pigan_thz_torch.models.registry.build_generator",
            "pigan_thz_torch.data.synthetic.sample_params",
            "pigan_thz_torch.train.state.init_pigan_state"} <= set(with_device)
    sig = inspect.signature(fns["pigan_thz_torch.models.registry.build_trio"])
    assert sig.parameters["device"].default is inspect.Parameter.empty


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
    g = fk.pack_generator(build_generator(cfg.generator, generator=gen, device="cpu").eval())
    f = fk.pack_forward_model(build_forward_model(cfg.forward_model, generator=gen, device="cpu").eval())
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
    f = build_forward_model(default_config().forward_model, generator=gen, device="cpu")
    for use_pallas in (True, False):
        screen_designs(f, default_config().data.frequencies, torch.full((4,), 2.2),
                       torch.full((4,), 2.8), gen,
                       ScreeningConfig(num_candidates=100, chunk_size=64, top_k=4,
                                       use_pallas=use_pallas))
    assert fk.LAUNCHES == before
    assert set(fk.LAUNCHES) == {"fused_mlp_forward", "fused_dense_chain",
                                "dip_qualification", "forward_train", "gan_train",
                                "gan_ensemble_train"}


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
    st = init_forward_state(build_forward_model(cfg.forward_model, device="cpu"), ftx, 0)
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


def test_cpu_gan_train_launches_nothing():
    from pigan_thz_torch.models import build_trio
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.train.state import init_pigan_state
    from pigan_thz_torch.train.steps import StepSettings

    cfg = default_config()
    gtx, dtx, _ = make_optimizers(cfg, 1)
    st = init_pigan_state(*build_trio(cfg, device="cpu"), gtx, dtx, 0, device="cpu")
    spec = gt.gan_train_spec(cfg, StepSettings.from_config(cfg))
    gen = torch.Generator().manual_seed(0)
    sched = torch.stack([torch.full((2,), v) for v in (2e-4, 2e-4, 2.0, 1e3, 2.0, 1e3, 1.0,
                                                      1.0)], dim=1)
    streams = gt.GanStreams(-torch.rand(2, 8, 250, generator=gen),
                            2.2 + 0.6 * torch.rand(2, 8, 4, generator=gen),
                            torch.rand(2, 8, 8, generator=gen), sched,
                            torch.full((4,), 2.2), torch.full((4,), 2.8))
    before = dict(gt.LAUNCHES)
    rows = gt.gan_train(gt.state_buffers(st), streams, spec)
    assert gt.LAUNCHES == before
    assert rows.shape == (2, gt.ROW_WIDTH) and bool(torch.isfinite(rows).all())


def test_train_without_a_card_does_not_fall_back(tmp_path):
    cmd = [sys.executable, "-m", "pigan_thz_torch", "train", "--epochs", "1",
           "--forward-epochs", "1", "--set", "data.num_samples=64", "--workdir",
           str(tmp_path)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=_env_without_card())
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "saved_models").exists()


def _imported_roots(path):
    """Top-level names of every import statement in a source file, wherever
    it stands (module level or inside a function)."""
    import ast

    with open(path) as fh:
        tree = ast.parse(fh.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", [
    "pigan_thz_torch/ops/metrics.py", "pigan_thz_torch/ops/gan_train.py",
    "pigan_thz_torch/parallel/__init__.py", "pigan_thz_torch/parallel/state_utils.py",
    "pigan_thz_torch/parallel/ensemble.py", "pigan_thz_torch/parallel/ensemble_megakernel.py",
    "pigan_thz_torch/serve.py", "pigan_thz_torch/interop.py",
    "examples/torch_seed_ensemble.py", "examples/torch_gan_step_conditioning.py",
    "chip_smoke.py", "pigan_thz_torch/config_presets.py", "pigan_thz_torch/train/programs.py",
    "pigan_thz_torch/evaluate/__init__.py", "pigan_thz_torch/evaluate/evaluator.py",
    "pigan_thz_torch/train/checkpoint.py", "pigan_thz_torch/train/trainer.py",
    "pigan_thz_torch/cli.py", "examples/torch_gan_engines.py",
    "pigan_thz_torch/ops/fused_kernels.py", "examples/torch_serving_tiles.py",
    "examples/torch_serving_ablate.py", "examples/torch_serving_cycle.py",
    "examples/torch_gan_times.py", "examples/torch_brow_ablate.py",
    "pigan_thz_torch/ops/brow.py", "pigan_thz_torch/ops/forward_train.py",
    "examples/torch_forward_times.py", "pigan_thz_torch/evaluate/ceilings.py",
    "pigan_thz_torch/evaluate/grading.py", "pigan_thz_torch/evaluate/rubrics.py",
    "pigan_thz_torch/evaluate/report.py", "pigan_thz_torch/utils/viz.py",
    "pigan_thz_torch/utils/eval_viz.py", "pigan_thz_torch/ops/quantized.py",
    "pigan_thz_torch/design/inverse.py", "pigan_thz_torch/design/screening.py",
    "pigan_thz_torch/models/forward_model.py", "examples/torch_serving_bench.py",
    "pigan_thz_torch/train/state.py", "pigan_thz_torch/utils/profiling.py",
    "pigan_thz_torch/data/native_io.py", "examples/torch_full_pipeline.py"])
def test_source_imports_neither_jax_nor_the_jax_package(path):
    roots = _imported_roots(os.path.join(REPO, path))
    assert not roots & {"jax", "jaxlib", "flax", "optax", "orbax", "pigan_thz_tpu",
                                  "pandas"}, roots


def test_cpu_gan_ensemble_train_launches_nothing():
    """CPU tensors take the member-packed kernel's plain version: member m
    is what the one-member plain version makes of it."""
    from pigan_thz_torch.models import build_trio
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch.parallel.ensemble import init_ensemble_states, member_generator
    from pigan_thz_torch.train.steps import StepSettings

    cfg = default_config()
    gtx, dtx, _ = make_optimizers(cfg, 1)
    ens = init_ensemble_states(*build_trio(cfg, device="cpu"), gtx, dtx,
                               [member_generator(0, i) for i in range(2)], device="cpu")
    alone = ens.clone()
    spec = gt.gan_train_spec(cfg, StepSettings.from_config(cfg))
    gen = torch.Generator().manual_seed(0)
    sched = torch.stack([torch.full((2,), v) for v in (2e-4, 2e-4, 2.0, 1e3, 2.0, 1e3, 1.0,
                                                      1.0)], dim=1)
    streams = gt.GanStreams(-torch.rand(2, 2, 8, 250, generator=gen),
                            2.2 + 0.6 * torch.rand(2, 2, 8, 4, generator=gen),
                            torch.rand(2, 2, 8, 8, generator=gen), sched,
                            torch.full((4,), 2.2), torch.full((4,), 2.8))
    before = dict(gt.LAUNCHES)
    rows = gt.gan_ensemble_train(gt.ensemble_buffers(ens), streams, spec)
    assert gt.LAUNCHES == before
    assert rows.shape == (2, 2, gt.ROW_WIDTH) and bool(torch.isfinite(rows).all())
    for m in range(2):
        bufs, own = gt._member(gt.ensemble_buffers(alone), streams, m)
        assert torch.equal(rows[m], gt.gan_train_plain(bufs, own, spec))
        assert torch.equal(ens.g_params[m], alone.g_params[m])


def test_seed_ensemble_example_without_a_card_does_not_fall_back():
    cmd = [sys.executable, os.path.join("examples", "torch_seed_ensemble.py"), "--members",
           "2", "--epochs", "1", "--fwd-epochs", "1", "--set", "data.num_samples=64"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=_env_without_card())
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr and '"members"' not in proc.stdout


def test_seed_ensemble_example_on_the_cpu():
    cmd = [sys.executable, os.path.join("examples", "torch_seed_ensemble.py"), "--device",
           "cpu", "--members", "2", "--epochs", "2", "--fwd-epochs", "2", "--set",
           "data.num_samples=128", "--set", "train.batch_size=32"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=_env_without_card())
    assert proc.returncode == 0, proc.stderr
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["members"] == 2 and out["epochs"] == 2 and out["packed"] is True
    assert out["all_rows_finite"] and len(out["member_r2"]) == 2
    assert set(out["launches"].values()) == {0}        # CPU: the plain versions
    assert out["member_r2"][0] != out["member_r2"][1]
    for key in ("wall_s", "member_steps_per_s", "ensemble_mean_r2", "ensemble_mean_recon_mse",
                "member_spread"):
        assert out[key] == out[key]


def test_engines_example_runs_on_the_cpu():
    """``examples/torch_gan_engines.py`` at a tiny size: the plain version
    twice (there is no kernel here) and the eager step, from one state."""
    import json

    cmd = [sys.executable, os.path.join("examples", "torch_gan_engines.py"), "--device", "cpu",
           "--epochs", "2", "--fwd-epochs", "1", "--set", "data.num_samples=128", "--set",
           "train.batch_size=32"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    engines = out["engines"]
    assert set(engines) == {"kernel", "plain", "eager"} and out["steps"] == 8
    assert engines["kernel"] == {**engines["plain"], "wall_s": engines["kernel"]["wall_s"]}
    assert all(e["gan_train_launches"] == 0 and e["steps"] == 8 for e in engines.values())
    assert abs(engines["eager"]["final_g_loss"] - engines["plain"]["final_g_loss"]) <= 1e-3 * abs(
        engines["plain"]["final_g_loss"])
