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

``seed_search`` is the loop of ``examples/seed_search.py`` (the JAX
package's best-quality recipe): N members from ``member_generator(seed, i)``
on the same batches and step seeds, with gradients through the shared
frozen F and the default loss weights, scored every ``eval_every`` epochs,
the best member or ensemble mean kept.  Its ``kernel`` engine is K3, its
``eager`` engine the JAX program's literal counterpart, the λ-ensemble step
with ``weight_vector()`` for every member.

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

import os
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..config import PiGanConfig
from ..data.dataset import ThzDataset
from ..models.registry import build_trio
from ..ops.forward_train import resolve_draws
from ..ops.gan_train import make_gan_ensemble_fn, make_gan_epoch_fn
from ..train.state import init_pigan_state, make_optimizers
from ..train.steps import StepSettings
from ..utils.profiling import HOST_SYNCS, count, span
from .ensemble import (EnsembleSettings, evaluate_ensemble, evaluate_ensemble_mean,
                       init_ensemble_states, make_ensemble_multi_epoch_fn,
                       make_ensemble_pigan_step, member_generator, weight_vector)
from .state_utils import EnsembleState, tree_stack


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
    Trainer checks its chunks: one transfer a member, then the check."""
    with span("pigan.train.transfer"):
        host = []
        for m in chunk_rows:
            host.append(torch.stack(list(m.values())).reshape(-1).cpu())
            count(HOST_SYNCS)
        rows = torch.cat(host)
    with span("pigan.train.check"):
        finite = bool(torch.isfinite(rows).all()) and all(st.is_finite() for st in states)
    if not finite:
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
        with span("pigan.train.chunk", what="ensemble", epochs=n_epochs, at=off):
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


# ---------------------------------------------------------------------------
# The seed search (examples/seed_search.py)
# ---------------------------------------------------------------------------

SEARCH_ENGINES = ("kernel", "eager")
SEARCH_EPOCHS_PER_CALL = 25
SEARCH_DRAW_SEED = 11     # the JAX script's PRNGKey(11), as the port's generator seed
ENSEMBLE_BEST = "ensemble_best.pt"


def search_settings() -> StepSettings:
    """The search's step: the JAX program's ``EnsembleSettings(
    detach_forward=False)`` with the runtime vector ``weight_vector()``,
    whose seven weights are ``StepSettings``' defaults.  Not
    ``StepSettings.from_config``: the config's constraint and label knobs
    may differ from the ensemble step's."""
    return StepSettings(detach_forward=False)


def pick_best(member_r2: Sequence[float], mean_r2: float):
    """(score, who) of one evaluation: the best of the members' and the
    ensemble mean's param R², ``who`` the member's index or
    ``"ensemble_mean"``; the earlier one on a tie (the members before the
    mean), as the JAX script's ``max`` does."""
    r2s = [float(x) for x in member_r2] + [float(mean_r2)]
    i = max(range(len(r2s)), key=lambda j: r2s[j])
    return r2s[i], (i if i < len(member_r2) else "ensemble_mean")


@dataclass
class SearchBest:
    """The best evaluation so far: its param R², epoch and winner (a member
    index or ``"ensemble_mean"``), and a copy of the stacked state then when
    the search keeps snapshots."""

    r2: float = -float("inf")
    epoch: int = 0
    member: int | str = -1
    snapshot: EnsembleState | None = field(default=None, repr=False)

    def offer(self, score: float, who, epoch: int, states: EnsembleState | None) -> bool:
        """Take (score, who, epoch) if it beats the best strictly (the JAX
        script's ``>``: a tie keeps the earlier), with a copy of ``states``
        when given.  True when taken."""
        if not score > self.r2:
            return False
        self.r2, self.epoch, self.member = score, epoch, who
        if states is not None:
            self.snapshot = states.clone()
        return True


def search_chunk_fn(cfg: PiGanConfig, ds: ThzDataset, engine: str, num_members: int):
    """chunk(states, indices (E, spe, B), seeds (E·spe,)) -> (states,
    [per-member {key: (E,) rows}]): one call of the search's ``engine`` with
    the same shuffles and step seeds for every member, as the JAX program's
    one key per chunk gives its vmapped members."""
    batch = cfg.train.batch_size
    if engine == "kernel":
        fn = make_gan_ensemble_fn(cfg, search_settings(), num_members)

        def chunk(states, indices, seeds):
            return fn(states, ds, torch.ones(indices.shape[0]),
                      indices.expand(num_members, *indices.shape), seeds=seeds)

        return chunk
    if engine != "eager":
        raise ValueError(f"engine {engine!r}: use one of {SEARCH_ENGINES}")
    g_tx, d_tx, _ = make_optimizers(cfg, max(1, ds.num_samples // batch))
    step = make_ensemble_pigan_step(g_tx, d_tx, EnsembleSettings(detach_forward=False),
                                    ds.param_lo, ds.param_hi)
    multi = make_ensemble_multi_epoch_fn(step, batch)
    weights = torch.stack([weight_vector()] * num_members)

    def chunk(states, indices, seeds):
        states, rows = multi(states, ds, torch.Generator(), weights, indices.shape[0],
                             indices, seeds)
        return states, [{k: v[:, m] for k, v in rows.items()} for m in range(num_members)]

    return chunk


def search_states(cfg: PiGanConfig, ds: ThzDataset, num_members: int,
                  forward_model: nn.Module, seed: int = 7) -> EnsembleState:
    """The search's members at the start, stacked on the dataset's device:
    member i from ``member_generator(seed, i)``, every member's F a copy of
    ``forward_model``."""
    g, d, _ = build_trio(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(cfg.train.seed))
    g_tx, d_tx, _ = make_optimizers(cfg, max(1, ds.num_samples // cfg.train.batch_size))
    return init_ensemble_states(g, d, forward_model, g_tx, d_tx,
                                [member_generator(seed, i) for i in range(num_members)],
                                device=ds.spectra.device)


def seed_search(
    cfg: PiGanConfig,
    ds: ThzDataset,
    num_members: int,
    *,
    forward_model: nn.Module,
    epochs: int | None = None,
    eval_every: int = 2000,
    heldout: ThzDataset | None = None,
    engine: str = "kernel",
    seed: int = 7,
    keep_snapshot: bool = False,
    on_row: Callable[[dict], None] | None = None,
):
    """The seed search: ``num_members`` members trained on ``ds`` against
    the shared frozen ``forward_model`` for ``epochs`` (default
    ``cfg.train.num_epochs``, which should be the budget: the schedules
    span it), scored every ``eval_every`` epochs and at the end.  Returns
    ``(states, best, rows)``: the member-stacked state, the ``SearchBest``
    and the evaluation rows.

    Members start from ``member_generator(seed, i)``.  Every call of
    ``SEARCH_EPOCHS_PER_CALL`` epochs draws one set of shuffles and step
    seeds from a generator seeded ``SEARCH_DRAW_SEED`` and gives it to every
    member.  ``engine`` "kernel" is one
    K3 launch a call with ``search_settings()``; "eager" the λ-ensemble
    step with ``weight_vector()`` for each member, the same function on the
    same draws.  A non-finite call raises ``FloatingPointError``.

    An evaluation scores each member's param R² on ``ds`` (``train_r2``)
    and, with ``heldout``, on it (``heldout_r2``), and the ensemble mean on
    the scored split (``heldout`` if given, else ``ds``); its row (the JAX
    script's keys, rounded as it rounds them, without ``wall_s``) goes to
    ``on_row``.  The best of the scored split's members and mean is kept
    (``pick_best``, ``SearchBest.offer``), with a snapshot of the state
    under ``keep_snapshot``."""
    if num_members < 1:
        raise ValueError("num_members must be >= 1")
    epochs = cfg.train.num_epochs if epochs is None else int(epochs)
    states = search_states(cfg, ds, num_members, forward_model, seed)
    chunk = search_chunk_fn(cfg, ds, engine, num_members)
    generator = torch.Generator().manual_seed(SEARCH_DRAW_SEED)
    batch = cfg.train.batch_size
    best, rows = SearchBest(), []
    e = 0
    while e < epochs:
        stop = min(epochs, (e // eval_every + 1) * eval_every)
        while e < stop:
            n = min(SEARCH_EPOCHS_PER_CALL, stop - e)
            states, member_rows = chunk(states, *resolve_draws(generator, ds.num_samples,
                                                               batch, n))
            _check_finite(member_rows, [states], e)
            e += n
        train_ev = evaluate_ensemble(states, ds)
        row = {"epoch": e, "train_r2": [round(float(x), 4) for x in train_ev["param_r2"]]}
        scored = heldout if heldout is not None else ds
        ev = evaluate_ensemble(states, heldout) if heldout is not None else train_ev
        mean_r2 = float(evaluate_ensemble_mean(states, scored)["param_r2"])
        row["ensemble_mean_r2"] = round(mean_r2, 4)
        if heldout is not None:
            row["heldout_r2"] = [round(float(x), 4) for x in ev["param_r2"]]
        score, who = pick_best(ev["param_r2"].tolist(), mean_r2)
        best.offer(score, who, e, states if keep_snapshot else None)
        rows.append(row)
        if on_row is not None:
            on_row(row)
    return states, best, rows


def save_ensemble_best(directory: str, states: EnsembleState) -> str:
    """Write the stacked state to ``<directory>/ensemble_best.pt`` in the
    layout ``cli.py``'s ``export --artifact ensemble`` reads: the members'
    G (M, Pg), D, moments and BatchNorm stats, and the shared F."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, ENSEMBLE_BEST)
    torch.save({"g": states.g_params.cpu(), "d": states.d_params.cpu(),
                "bn": [t.cpu() for t in states.bn], "f": states.f_params.cpu(),
                "g_m": states.g_m.cpu(), "g_v": states.g_v.cpu(),
                "d_m": states.d_m.cpu(), "d_v": states.d_v.cpu()}, path)
    return path
