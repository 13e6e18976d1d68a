"""Each cell's check refuses its control and every fault the cell can have.

The control is the reference put in the program's place and computed with
TF32 products, the precision below the float32 the configurations state.
The faults are planted in the program's timed path underneath a run (set-up,
a short window, the check; the harness's look for a card skipped): a step
that returns its state unchanged, half of the batch left out with the mean
over the rest, an answer altered where it is produced.  On the CPU at a
tiny size here; the same stand-ins at each cell's own size on the card in
``test_control_at_the_cells_size`` (marked ``cuda``) and in
``benchmark/calibrate.py``."""

from __future__ import annotations

import contextlib

import pytest
import torch

from benchmark import harness
from benchmark.reference import compare

SEED = 2**41 + 5
TRAINING = ("base-train-full", "base-ensemble4")
DESIGN = ("base-design-8192", "optimized-design-8192")


def _run(cell, device="cpu", seed=SEED):
    drv = harness.driver(cell["traffic"])(cell["config"], cell["traffic"], seed, device)
    drv.setup()
    drv.window(0.2, False)
    drv.release()
    return drv


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*map(_clone, x)) if hasattr(x, "_fields") else tuple(map(_clone, x))
    return x


def _halve(streams, axis):
    """The streams with each batch cut to its first half."""
    def cut(t):
        if not isinstance(t, torch.Tensor) or t.dim() <= axis + 1:
            return t
        return t.narrow(axis, 0, t.shape[axis] // 2).contiguous()
    return type(streams)(*(cut(t) if name not in ("sched", "seeds", "param_lo", "param_hi")
                           else t for name, t in zip(streams._fields, streams)))


@contextlib.contextmanager
def planted(monkeypatch, fault: str):
    """The fault in the program's kernels (their plain versions here)."""
    from pigan_thz_torch.ops import forward_train as ft
    from pigan_thz_torch.ops import gan_train as gt
    from pigan_thz_torch import serve

    if fault == "answer_altered":
        def altered(pn, lo, hi, _orig=serve.denormalize_params):
            out = _orig(pn, lo, hi).clone()
            out[0, 0] += 0.01 * float(hi[0] - lo[0])
            return out
        monkeypatch.setattr(serve, "denormalize_params", altered)
    for mod, name, axis in ((ft, "forward_train", 1), (gt, "gan_train", 1),
                            (gt, "gan_ensemble_train", 2)):
        orig = getattr(mod, name)

        def broken(*args, _orig=orig, _axis=axis, **kw):
            if fault == "state_unchanged":
                if _orig.__name__ == "forward_train":      # params, m, v, streams, spec
                    return _orig(*map(_clone, args[:3]), *args[3:], **kw)
                return _orig(_clone(args[0]), *args[1:], **kw)
            if fault == "half_batch":
                streams_at = 3 if _orig.__name__ == "forward_train" else 1
                args = list(args)
                args[streams_at] = _halve(args[streams_at], _axis)
                return _orig(*args, **kw)
            rows = _orig(*args, **kw)
            if fault == "answer_altered":
                rows = rows.clone()
                rows[..., 0, 0] *= 1.01          # the call's first step's (d_)loss
                if rows.shape[-1] > 3:
                    rows[..., 0, 1] *= 1.01      # and its g_loss
            return rows
        monkeypatch.setattr(mod, name, broken)
    yield


@pytest.mark.parametrize("name", TRAINING + DESIGN)
def test_control_fails(tiny, name):
    cell = tiny(name)
    drv = _run(cell)
    assert compare.verdict(drv.check(), cell["limits"])[0]
    if name in DESIGN:
        numbers = drv.check(lambda x: drv.answers_of_reference(x, "tf32"))
    else:
        numbers = drv.check(drv.reference_readings("tf32"))
    assert not compare.verdict(numbers, cell["limits"])[0], numbers


@pytest.mark.parametrize("name,fault", [(n, f) for n in TRAINING for f in (
    "state_unchanged", "half_batch", "answer_altered")] + [(n, "answer_altered") for n in DESIGN])
def test_planted_fault_fails(tiny, monkeypatch, name, fault):
    cell = tiny(name)
    with planted(monkeypatch, fault):
        drv = _run(cell)
        numbers = drv.check()
    correct, rows = compare.verdict(numbers, cell["limits"])
    assert not correct, rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAINING + DESIGN)
def test_control_at_the_cells_size(card, name):
    """On the card at the cell's own size: the program passes, the control
    fails."""
    from benchmark.reference.models import fp32_only

    cell = harness.cell(name)
    drv = _run(cell, device=card, seed=SEED + 1)
    fp32_only()
    assert compare.verdict(drv.check(), cell["limits"])[0]
    if name in DESIGN:
        numbers = drv.check(lambda x: drv.answers_of_reference(x, "tf32"))
    else:
        numbers = drv.check(drv.reference_readings("tf32"))
    assert not compare.verdict(numbers, cell["limits"])[0], numbers
