"""``pigan_thz_torch/train/programs.py`` and the ``program`` command on the
CPU: the phase lists against the JAX package's, ``run_program`` against
the JAX ``run_program`` from carried-over weights with the gates forced each
way, and the command's artifacts."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pigan_thz_torch import default_config as t_default_config
from pigan_thz_torch.cli import main as cli_main
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.data.dataset import ThzDataset
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.train import programs as tp
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_tpu import default_config as j_default_config
from pigan_thz_tpu.data.dataset import build_dataset as j_build_dataset
from pigan_thz_tpu.train import programs as jp
from pigan_thz_tpu.train.trainer import Trainer as JTrainer
from test_torch_evaluator import _narrow, carry_over

torch.set_num_threads(1)

PIPELINES = [("standard_phases", ()), ("constraint_phase", ()), ("emergency_phases", ()),
            ("progressive_pipeline", ()), ("constraint_finetune_phase", ()),
            ("standard_phases", (7, 9)), ("emergency_phases", (3, 4, 5)),
            ("progressive_pipeline", (2, 3, 4, 5)), ("constraint_phase", (12,))]


def _as_dict(phase) -> dict:
    """A Phase's declarative content; the callables by what they return."""
    out = {}
    for f in dataclasses.fields(phase):
        v = getattr(phase, f.name)
        if dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        elif f.name == "constraint_schedule" and v is not None:
            v = [v(e) for e in (0, 1, 50, 99, 100, 1000)]
        elif f.name == "early_stop" and v is not None:
            v = [v({"violation_rate": x}) for x in (0.0, 0.09, 0.1, 0.5)]
        elif f.name == "gate" and v is not None:
            v = [v({"pigan_evaluation": {"parameter_prediction": {"r2": r2}},
                    "structural_prediction_evaluation": {"param_range_violation_rate": viol}})
                 for r2, viol in ((0.69, 0.21), (0.71, 0.19), (0.7, 0.2), (-3.0, 1.0))]
        out[f.name] = v
    return out


@pytest.mark.parametrize("name, args", PIPELINES)
def test_pipelines_equal_the_jax_package_s(name, args):
    t, j = getattr(tp, name)(*args), getattr(jp, name)(*args)
    t, j = (t if isinstance(t, list) else [t]), (j if isinstance(j, list) else [j])
    assert [p.name for p in t] == [p.name for p in j]
    for a, b in zip(t, j):
        assert _as_dict(a) == _as_dict(b), a.name


def test_phase_fields_and_anneal_match():
    t = {f.name: f.default for f in dataclasses.fields(tp.Phase) if f.name != "forward_settings"}
    j = {f.name: f.default for f in dataclasses.fields(jp.Phase) if f.name != "forward_settings"}
    assert t == j
    for args in ((), (0.5, 2.0, 10), (1.0, 0.0, 0)):
        assert [tp._anneal(*args)(e) for e in range(0, 200, 7)] == [
            jp._anneal(*args)(e) for e in range(0, 200, 7)]
    assert [f.name for f in dataclasses.fields(tp.ProgramResult)] == [
        f.name for f in dataclasses.fields(jp.ProgramResult)]


def test_the_emergency_phases_run_the_kernel_s_cycle_path():
    """What the shipped programs ask of the GAN-training kernel is inside its
    envelope: cycle with ``d_update_every`` 2 and the adversarial term off,
    the fine-tune's ``sigmoid_squash`` with the constraint term."""
    cfg = t_default_config()
    for phase in [*tp.progressive_pipeline(), tp.constraint_finetune_phase()]:
        if phase.kind == "gan":
            assert gt.supports_gan_kernel(cfg, phase.gan_settings) is None, phase.name
    warm = tp.emergency_phases()[1]
    spec = gt.gan_train_spec(cfg, warm.gan_settings)
    assert (spec.cycle_w, spec.adv_w, spec.detach_forward) == (1.0, 0.0, False)
    assert warm.gan_settings.d_update_every == 2


@pytest.fixture(scope="module")
def trainers():
    tc, jc = _narrow(t_default_config()), _narrow(j_default_config())
    raw = synthetic_dataset(tc.data, device="cpu")
    jds = j_build_dataset(raw.spectra.numpy(), raw.params.numpy(), raw.metrics.numpy(), jc.data)
    tds = ThzDataset(*(torch.from_numpy(np.array(x, np.float32)) for x in jds))

    def make():
        jtr = JTrainer(jc, ds=jds, epochs_per_call=1, megakernel="off")
        jtr.init_pigan()
        ttr = Trainer(tc, ds=tds, device="cpu", epochs_per_call=1)
        ttr.init_pigan()
        carry_over(jtr.pigan_state, ttr.pigan_state)
        return jtr, ttr

    return make


def _forced(mod, gates):
    """emergency_phases(1, 1, 1) and a constraint phase of one epoch, with
    gate i replaced by a constant where ``gates[i]`` is not None."""
    phases = [*mod.emergency_phases(1, 1, 1), mod.constraint_phase(1)]
    return [p if g is None else dataclasses.replace(p, gate=lambda ev, g=g: g)
            for p, g in zip(phases, gates)]


GATES = {
    "as_shipped": (None, None, None, None),
    "all_open": (True, True, True, True),
    "all_shut": (False, False, False, False),
    "mixed": (False, True, False, True),
}


@pytest.mark.parametrize("case", list(GATES))
def test_run_program_runs_and_skips_what_the_jax_one_does(case, trainers):
    """From the same weights (a fresh G: param R² far below 0.7, violation
    rate above 0.2 on the [0, 1] box) the same phases run and the same are
    skipped, with the shipped gates and with each gate forced either way."""
    jtr, ttr = trainers()
    jev, tev = jtr.evaluate(), ttr.evaluate()
    r2 = tev["pigan_evaluation"]["parameter_prediction"]["r2"]
    viol = tev["structural_prediction_evaluation"]["param_range_violation_rate"]
    assert abs(r2 - jev["pigan_evaluation"]["parameter_prediction"]["r2"]) <= 1e-4 * abs(r2)
    assert r2 < 0.7 and viol > 0.2
    want = jp.run_program(jtr, _forced(jp, GATES[case]))
    got = tp.run_program(ttr, _forced(tp, GATES[case]))
    assert got.phases_run == want.phases_run
    assert got.phases_skipped == want.phases_skipped
    assert sorted(got.phases_run + got.phases_skipped) == sorted(
        ["emergency_forward", "emergency_warmup", "emergency_balanced_gan",
         "constraint_focused"])
    if case == "all_shut":
        assert got.phases_run == [] and ttr.pigan_state.step == 0
    if case in ("as_shipped", "all_open"):
        assert got.phases_skipped == []
        # the forward phase's plateau column and the GAN phases' rows were recorded
        assert "forward/lr_scale" in ttr.train_history
        assert len(ttr.train_history["pigan/g_loss"]) == 3
        assert ttr.pigan_state.d_opt.count < ttr.pigan_state.g_opt.count   # D every 2nd step
    flat = lambda d: {k for k, v in d.items()} | {  # noqa: E731
        f"{k}/{k2}" for k, v in d.items() if isinstance(v, dict) for k2 in v}
    assert flat(got.final_eval) == flat(want.final_eval)


def test_gates_reuse_one_evaluation_until_a_phase_runs(trainers, monkeypatch):
    _, ttr = trainers()
    calls = []
    real = Trainer.evaluate
    monkeypatch.setattr(Trainer, "evaluate", lambda self, *a, **kw: calls.append(1) or real(
        self, *a, **kw))
    res = tp.run_program(ttr, _forced(tp, (False, False, True, False)))
    # one evaluation serves gates 1-3, one after the phase that ran, one at the end
    assert res.phases_run == ["emergency_balanced_gan"] and len(calls) == 3
    with pytest.raises(ValueError, match="unknown phase kind"):
        tp.run_program(ttr, [tp.Phase(name="x", kind="other", epochs=1)])


def test_a_gated_phase_without_a_state_is_skipped_and_forward_refreshes_f():
    tc = _narrow(t_default_config())
    tr = Trainer(tc, device="cpu", epochs_per_call=1)
    res = tp.run_program(tr, [tp.constraint_phase(1)])
    assert res.phases_skipped == ["constraint_focused"] and res.final_eval == {}
    res = tp.run_program(tr, [dataclasses.replace(p, epochs=1) for p in tp.standard_phases()]
                         + [tp.Phase(name="again", kind="forward", epochs=1)])
    assert res.phases_run == ["forward_pretrain", "gan_standard", "again"]
    # the last forward phase re-froze the newest F into the GAN state
    assert torch.equal(tr.pigan_state.f_params, tr.forward_state.params)
    assert res.final_eval["total_samples"] == tc.data.num_samples


@pytest.mark.parametrize("name", ["finetune", "emergency", "progressive"])
def test_program_command(name, tmp_path, monkeypatch, capsys):
    """The command as typed, at one epoch a phase: the run directory's
    ``final_eval.json``, the finals and their ``_<name>`` copies."""
    import glob

    def short(phases):
        return [dataclasses.replace(p, epochs=1, constraint_schedule=None) for p in phases]

    for fn in ("progressive_pipeline", "standard_phases", "emergency_phases"):
        real = getattr(tp, fn)
        monkeypatch.setattr(tp, fn, lambda *a, real=real, **kw: short(real(*a, **kw)))
    real_ft = tp.constraint_finetune_phase
    monkeypatch.setattr(tp, "constraint_finetune_phase", lambda *a, **kw: short([real_ft()])[0])
    rc = cli_main(["program", name, "--device", "cpu", "--engine", "kernel", "--set",
                   "data.num_samples=128", "--set", "train.batch_size=32", "--workdir",
                   str(tmp_path), "--no-tensorboard"])
    assert rc == 0
    said = capsys.readouterr().out
    assert "phases run: [" in said and "kernel launches" in said
    out = tmp_path / "saved_models"
    for stem in ("generator", "discriminator", "forward_model"):
        assert (out / f"{stem}_final.pth").is_file() and (out / f"{stem}_{name}.pth").is_file()
    (path,) = glob.glob(str(tmp_path / f"program_{name}_*" / "final_eval.json"))
    ev = json.loads(open(path).read())
    assert ev["total_samples"] == 128
    assert np.isfinite(ev["pigan_evaluation"]["parameter_prediction"]["r2"])
    if name == "finetune":
        assert "['constraint_finetune']" in said
    else:
        assert "emergency_warmup" in said and "GAN-training kernel (its plain version)" in said


def test_program_command_refuses_an_unknown_name(tmp_path):
    with pytest.raises(SystemExit):
        cli_main(["program", "everything", "--device", "cpu", "--workdir", str(tmp_path)])
