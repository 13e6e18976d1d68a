"""Seed ensembles through the GAN-training kernels: the port of
``pigan_thz_tpu/parallel/ensemble_megakernel.py``.

N members with one (cfg, settings) and different seeds are independent:
they share nothing but the pretrained frozen F and the schedules.
``train_seed_ensemble`` trains them either as N one-member programs
(``make_gan_epoch_fn``, one launch per member and chunk), member i on
``devices[i % D]``, or, with ``packed=True``, as one member-packed launch per
device group and chunk (``make_gan_ensemble_fn``: every kernel of the step
carries the member on a grid axis).  Both give bit for bit the same members,
and member i is the member a solo run from the same (``seed``, i) trains:
its initial weights and its shuffles come from ``member_generator(seed, i)``
alone, the port's ``fold_in(key, i)``.

``train_settings_sweep`` is the controlled A/B counterpart: one arm per
``StepSettings``, every arm from the same initial state on the same batches.

``devices=[...]`` with more than one card is coded and tested on the CPU
(``devices=["cpu", "cpu"]``) but untried on two cards: the machine that runs
the port's card checks has one H100.

On CPU tensors the kernels' plain versions run (the port's analogue of the
JAX package's ``interpret=True``); there is no such argument here.  Not
ported, because they guard limits of the TPU compiler that this card does not
have: ``clamp_epochs_per_call`` (the Mosaic grid cap) and ``force_large_m``
(the Mosaic compile time past four members).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..config import PiGanConfig
from ..data.dataset import ThzDataset
from ..models.registry import build_trio
from ..ops.gan_train import make_gan_ensemble_fn, make_gan_epoch_fn
from ..train.state import init_pigan_state, make_optimizers
from ..train.steps import StepSettings
from .ensemble import init_ensemble_states, member_generator
from .state_utils import tree_stack


def _chunk_sizes(epochs: int, epochs_per_call: int) -> list[int]:
    """Uniform chunks of epochs_per_call plus one remainder chunk."""
    full, rem = divmod(epochs, epochs_per_call)
    return [epochs_per_call] * full + ([rem] if rem else [])


def _resolve_devices(devices, ds: ThzDataset) -> list[torch.device]:
    """The device list: the one given, else every visible CUDA device.  A
    dataset on the CPU needs the list spelled out: nothing falls back to the
    CPU on its own."""
    if devices is None:
        if ds.spectra.device.type != "cuda":
            raise ValueError(
                "devices=None takes every visible CUDA device and the dataset is on "
                f"{ds.spectra.device}: pass devices=[...] explicitly (['cpu'] runs the "
                "kernels' plain versions)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("devices must name at least one device")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devices]


def _common(cfg, ds, epochs, scales, epochs_per_call, devices):
    """What both training functions set up alike: (epochs, scales (epochs,) on the CPU,
    chunk sizes, devices, the CPU templates of the trio, G's and D's
    optimisers)."""
    epochs = cfg.train.num_epochs if epochs is None else int(epochs)
    if epochs < 1:
        raise ValueError("epochs must be >= 1")
    if scales is None:
        scales = torch.ones(epochs)
    scales = torch.as_tensor(scales, dtype=torch.float32).reshape(-1).cpu()
    if scales.numel() != epochs:
        raise ValueError(f"scales must have shape ({epochs},)")
    spe = max(1, ds.num_samples // cfg.train.batch_size)
    chunks = _chunk_sizes(epochs, max(1, int(epochs_per_call)))
    g, d, f = build_trio(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(cfg.train.seed))
    g_tx, d_tx, _ = make_optimizers(cfg, spe)
    return epochs, scales, chunks, _resolve_devices(devices, ds), (g, d, f), (g_tx, d_tx)


def _datasets(ds: ThzDataset, devices) -> dict:
    return {dev: ds if ds.spectra.device == dev else ThzDataset(*(t.to(dev) for t in ds))
            for dev in dict.fromkeys(devices)}


def _check_finite(chunk_rows: Sequence[dict], states, epoch: int) -> None:
    """One chunk's rows of every member and the states they left, as the
    Trainer checks its chunks."""
    rows = torch.cat([torch.stack(list(m.values())).reshape(-1).cpu() for m in chunk_rows])
    if not bool(torch.isfinite(rows).all()) or not all(st.is_finite() for st in states):
        raise FloatingPointError(
            f"non-finite metric rows or state after the chunk at epoch {epoch}: "
            "training diverged")


def _gather(member_metrics: Sequence[Sequence[dict]]) -> list[dict]:
    """Per member, each metric's chunks joined to one (epochs,) numpy array."""
    return [{k: torch.cat([m[k] for m in chunks]).cpu().numpy() for k in chunks[0]}
            for chunks in member_metrics]


def train_seed_ensemble(
    cfg: PiGanConfig,
    ds: ThzDataset,
    num_members: int,
    *,
    settings: StepSettings | None = None,
    epochs: int | None = None,
    seed: int = 0,
    devices=None,
    epochs_per_call: int = 25,
    scales=None,
    forward_model: nn.Module | None = None,
    packed: bool = False,
):
    """Train ``num_members`` independent GAN members through the
    GAN-training kernel; returns ``(states, metrics)``: the member-stacked
    ``EnsembleState`` (on the first device; feed it to
    ``parallel.ensemble.evaluate_ensemble`` / ``evaluate_ensemble_mean`` or
    to ``serve.make_ensemble_inverse_design_fn``) and ``{metric: (N, epochs)}``
    numpy arrays.

    Member i lives on ``devices[i % D]`` (default: every visible CUDA device;
    a dataset on the CPU needs ``devices`` given).  Without ``packed`` each
    member is one solo program, one launch per member and chunk of
    ``epochs_per_call`` epochs, dispatched chunk-major so that all devices
    work at once.  ``packed=True`` trains each device's group of members in
    ONE launch per chunk; it needs the shared pretrained ``forward_model``
    (the launch carries one frozen F) and refuses the EMA.  The two give bit
    for bit the same members, and either gives member i as a solo run from
    ``member_generator(seed, i)`` would.

    ``forward_model`` is the frozen F every member copies (without it each
    member draws a fresh one, unpacked only); ``scales`` the optional
    (epochs,) constraint multipliers, default ones.  The schedules span
    ``cfg.train.num_epochs``: set it to the budget.  Settings outside the
    kernel's envelope raise as ``make_gan_epoch_fn`` does; a non-finite chunk
    raises ``FloatingPointError``.

    What bounds the members per device is memory, not the kernel: a packed
    chunk's streams are ``epochs_per_call`` x steps x batch x 262 floats per
    member (25 MB at 25 epochs of 15 steps, batch 64; with instance noise and
    stability on 3 x batch x 250 floats a step more, 72 MB there) beside
    ~13 MB of state and scratch per member."""
    if settings is None:
        settings = StepSettings.from_config(cfg)
    if num_members < 1:
        raise ValueError("num_members must be >= 1")
    epochs, scales, chunks, devices, (g, d, f), (g_tx, d_tx) = _common(
        cfg, ds, epochs, scales, epochs_per_call, devices)
    used = [devices[i % len(devices)] for i in range(num_members)]
    groups = {dev: [i for i in range(num_members) if used[i] == dev]
              for dev in dict.fromkeys(used)}
    ds_by_dev = _datasets(ds, used)
    ema = float(settings.ema_decay) > 0.0
    if packed:
        if forward_model is None:
            raise ValueError("packed=True needs a shared forward_model (the packed launch "
                             "carries ONE frozen F for its member group)")
        if ema:
            raise ValueError("packed=True: ema_decay > 0 unsupported")
        fns = {n: make_gan_ensemble_fn(cfg, settings, n)
               for n in {len(members) for members in groups.values()}}
        by_dev = {dev: init_ensemble_states(
            g, d, forward_model, g_tx, d_tx, [member_generator(seed, i) for i in members],
            device=dev) for dev, members in groups.items()}
    else:
        fn = make_gan_epoch_fn(cfg, settings)
        solo = [init_pigan_state(g, d, forward_model if forward_model is not None else f,
                                 g_tx, d_tx, member_generator(seed, i), device=dev,
                                 fresh_forward=forward_model is None, ema=ema)
                for i, dev in enumerate(used)]

    member_metrics: list[list[dict]] = [[] for _ in range(num_members)]
    off = 0
    for n_epochs in chunks:
        part = scales[off:off + n_epochs]
        if packed:
            for dev, members in groups.items():
                by_dev[dev], rows = fns[len(members)](by_dev[dev], ds_by_dev[dev], part)
                for i, m in zip(members, rows):
                    member_metrics[i].append(m)
            states = list(by_dev.values())
        else:
            for i, dev in enumerate(used):
                solo[i], m = fn(solo[i], ds_by_dev[dev], part)
                member_metrics[i].append(m)
            states = solo
        _check_finite([mm[-1] for mm in member_metrics], states, off)
        off += n_epochs

    if packed and len(by_dev) == 1:
        stacked = next(iter(by_dev.values()))
    else:
        if packed:
            solo = [None] * num_members
            for dev, members in groups.items():
                for i, st in zip(members, by_dev[dev]):
                    solo[i] = st
        stacked = tree_stack(solo, device=devices[0])
    per_member = _gather(member_metrics)
    return stacked, {k: np.stack([m[k] for m in per_member]) for k in per_member[0]}


def train_settings_sweep(
    cfg: PiGanConfig,
    ds: ThzDataset,
    settings_list,
    *,
    epochs: int | None = None,
    seed: int = 0,
    devices=None,
    epochs_per_call: int = 25,
    scales=None,
    forward_model: nn.Module | None = None,
):
    """A controlled A/B sweep over ``StepSettings`` through the kernel, arm i
    on ``devices[i % D]``: every arm starts from the SAME initial state (its
    own deep copy: a chunk updates its state in place) and sees the SAME
    shuffles, both drawn from ``seed``, so that what differs in the outcome
    is caused by the settings alone.

    Arms must agree on ``ema_decay > 0`` (the EMA track is part of the state
    and stacked arms must match).  Returns ``(states, metrics_list)``: the
    arm-stacked ``EnsembleState`` and one ``{metric: (epochs,)}`` dict of
    numpy arrays per arm (``constraint_loss`` only where ``constraint_w`` >
    0)."""
    settings_list = list(settings_list)
    if not settings_list:
        raise ValueError("settings_list must be non-empty")
    emas = {float(s.ema_decay) > 0.0 for s in settings_list}
    if len(emas) > 1:
        raise ValueError("all sweep arms must agree on ema_decay > 0 (the EMA track changes "
                         "the state structure; stacked arms must match)")
    epochs, scales, chunks, devices, (g, d, f), (g_tx, d_tx) = _common(
        cfg, ds, epochs, scales, epochs_per_call, devices)
    fns = [make_gan_epoch_fn(cfg, s) for s in settings_list]
    used = [devices[i % len(devices)] for i in range(len(settings_list))]
    ds_by_dev = _datasets(ds, used)
    base = init_pigan_state(g, d, forward_model if forward_model is not None else f, g_tx,
                            d_tx, member_generator(seed, 0), device=used[0],
                            fresh_forward=forward_model is None, ema=emas.pop())
    # the copy carries the generator's state too: one shuffle sequence for all
    states = [base.clone() for _ in used]
    for i, dev in enumerate(used):
        if dev != used[0]:
            states[i] = tree_stack([states[i]], device=dev)[0]

    member_metrics: list[list[dict]] = [[] for _ in used]
    off = 0
    for n_epochs in chunks:
        for i, dev in enumerate(used):
            states[i], m = fns[i](states[i], ds_by_dev[dev], scales[off:off + n_epochs])
            member_metrics[i].append(m)
        _check_finite([mm[-1] for mm in member_metrics], states, off)
        off += n_epochs
    return tree_stack(states, device=devices[0]), _gather(member_metrics)
