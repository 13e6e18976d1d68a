"""Command-line interface of the port: ``python -m pigan_thz_torch <command>``.

The port of ``pigan_thz_tpu/cli.py``, command by command, with the same
flags.  Every command accepts repeated ``--set a.b.c=value`` overrides and a
``--device`` (default ``cuda``; the CPU runs only when ``--device cpu`` is
given, never as a fallback).

Commands:
  generate-data     synthesize a reference-schema CSV dataset
  convert-cst       raw CST Studio export -> reference-schema CSV
  pretrain-forward  train the forward surrogate           (pretrain_fwd_model.py)
  train             forward_only | pigan_only | full      (unified_trainer.py)
  program           progressive | emergency | finetune    (metric-gated pipelines)
  evaluate          the four suites + the target report   (unified_evaluator.py)
  screen            batched inverse-design screening      (1e6 candidates, top-k)
  design            inverse design for target spectra     (G + refinement + F check)
  export            torch.export serving artifacts        (.pt2, weights baked in)
  cache-data        dataset -> binary .thzb cache         (native/thzio.cpp)
  profile           torch.profiler trace of the GAN training chunk + report
  doctor            environment health report             (exits 1 on a failed check)

``pretrain-forward`` writes ``forward_model_pretrained.pth`` (F's torch
state_dict) and ``model_config.json`` under ``--out``; ``train`` writes the
final trio (``generator_final.pth``, ``discriminator_final.pth``,
``forward_model_final.pth``, with ``--ema-decay`` also
``generator_ema.pth``), ``training_history.json`` and ``model_config.json``.
``train --preset optimized|scaled`` lays ``config_presets.py`` over the
config before ``--set`` (the optimized overlay names the residual generator
and the dual-encoder discriminator, which the registry refuses by name until
they are ported: ``--set generator.name=mlp --set discriminator.name=mlp``
trains the baseline trio under its loss mix).  ``program`` runs one of the
metric-gated pipelines of ``train/programs.py`` from a fresh trainer and
writes the finals (with ``generator_<name>.pth`` etc. beside them) and
``final_eval.json`` in the run directory.  The training commands take
``--engine auto|eager|kernel`` (the Trainer's engine rule: on the card
``auto`` is the training kernels or an error, never the eager step).
``train --checkpoint-dir DIR`` saves the full training state every
``train.save_interval`` epochs (``forward_only`` F's, ``full`` and
``pigan_only`` the GAN stage's) for ``Trainer.resume_from``.
``train --holdout FRAC --holdout-seed N`` trains on the (1 - FRAC)
split and writes ``holdout_eval.json`` (train vs held-out rows) in the run
directory; ``evaluate --holdout`` with the same pair scores the same held-out
cells.  The split is the port's own (``torch.randperm`` from a CPU generator
seeded with N): the same pair reproduces it within the port, not the JAX
package's split for that seed.

``evaluate --models DIR`` rebuilds the saved architectures from
``model_config.json``, loads the final trio and prints the unified report;
on synthetic data (no ``--csv``) it adds the noise ceilings and the
clean-oracle scores (``evaluate/ceilings.py``) and the ceiling-adjusted
rating, and writes ``unified_evaluation_report.txt`` beside the models.
``--suite X`` runs one suite and prints its rubric; ``--json`` writes the
results; ``--plot`` (and ``train --plot``) writes the figures and needs
matplotlib.

The serving commands read the saved models with the same overlay.
``screen --models DIR`` screens ``--candidates`` random designs with F
(``forward_model_pretrained.pth`` if it is there, else
``forward_model_final.pth``) and writes ``screening_results.json``
(``--pallas``: the fused surrogate kernel; ``--dtype bfloat16``: F's bf16
twin; not both).  ``design --models DIR`` designs for dataset rows
(``--target-index``, repeatable) or a ``.npy`` / CSV file of spectra
(``--target-file``), with ``--refine-steps`` of surrogate-gradient
refinement and ``--uncertainty`` (MC dropout).  ``export --models DIR``
writes ``torch.export`` programs (``.pt2``, loaded by
``serve.load_exported``): the designer, the generator and the surrogate in
fp32, bf16 or int8, ``--pallas`` for the fused-kernel designer and
surrogate, or ``--artifact ensemble`` from the ``ensemble_best.pt`` that
``examples/torch_seed_ensemble.py --save`` writes.

``cache-data`` writes the dataset (``--csv`` or synthetic) as a ``.thzb``
cache that either package loads (``data/native_io.py``) and checks the
round trip.  ``profile`` runs the PI-GAN multi-epoch function the engine
rule picks (on the card the GAN-training kernel): one warm-up call, then
``--repeats`` calls of ``--epochs`` epochs under ``torch.profiler``, and
prints a JSON report (calls/s, train steps/s, device memory, kernel
launches) with a Chrome trace in ``--trace-dir``.  ``doctor`` reports the
versions, the card, nvcc, the kernel library's build, the native IO
extension, the kernels' verdicts for the config and a device round trip,
the last two in killable subprocesses.  The JAX package's ``bench`` is not
ported: a benchmark of the port is its own change.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List

import torch

from .config import PiGanConfig, apply_overrides, default_config


def _base_parser(sub: argparse.ArgumentParser) -> None:
    sub.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                     help="config override, e.g. --set data.num_samples=512")
    sub.add_argument("--config", default=None, metavar="YAML",
                     help="YAML config file (applied before --set overrides)")
    sub.add_argument("--csv", default=None, help="dataset CSV path (else synthetic)")
    sub.add_argument("--workdir", default="runs", help="output directory")
    sub.add_argument("--seed", type=int, default=None)
    sub.add_argument("--device", default="cuda",
                     help="torch device to run on (default cuda; cpu only when asked)")


def _engine_flag(sub: argparse.ArgumentParser) -> None:
    sub.add_argument("--engine", choices=["auto", "eager", "kernel"], default="auto",
                     help="auto: on cuda the training kernels, raising where they do not "
                          "take the configuration, on the cpu the eager step; eager: the "
                          "eager PyTorch step; kernel: the kernels (on the cpu their "
                          "plain versions)")


def _make_cfg(args) -> PiGanConfig:
    cfg = default_config()
    if args.config:
        from .config import from_yaml

        cfg = from_yaml(args.config, cfg)
    preset = getattr(args, "preset", None)
    if preset == "optimized":
        # the reference's OptimizedTrainer overlay; before --set, so that
        # explicit overrides still win
        from .config_presets import apply_optimization_config

        cfg = apply_optimization_config(cfg)
    elif preset == "scaled":
        from .config_presets import apply_scaled_batch_config

        cfg = apply_scaled_batch_config(cfg)
    if args.seed is not None:
        cfg = apply_overrides(cfg, [f"train.seed={args.seed}", f"data.seed={args.seed}"])
    cfg = apply_overrides(cfg, args.set)
    return cfg.replace(workdir=args.workdir)


def _overlay_model_config_dir(
    cfg: PiGanConfig, directory: str, user_set: List[str]
) -> PiGanConfig:
    """Merge <directory>/model_config.json (written by the save paths) into
    cfg so consumers rebuild the saved run's architectures; explicit user
    --set overrides for model sections still win."""
    from .config import dict_to_overrides
    from .train import checkpoint as ckpt

    saved = ckpt.load_model_config(directory)
    if saved is None:
        return cfg
    prefixes = tuple(f"{s}." for s in saved)
    user = [o for o in user_set if o.partition("=")[0].strip().startswith(prefixes)]
    return apply_overrides(cfg, dict_to_overrides(saved) + user)


def _split_holdout(cfg: PiGanConfig, csv_path, frac: float, seed: int, device):
    """Shuffled (train, held-out) split of the configured dataset, the
    honest protocol of examples/holdout_eval.py.  The same (frac, seed) at
    train and evaluate time reproduces the identical split."""
    from .data.dataset import load_or_synthesize, split_dataset

    full = load_or_synthesize(cfg.data, csv_path, device=device)
    return split_dataset(full, val_frac=frac, generator=torch.Generator().manual_seed(seed))


def _holdout_row(ev: dict) -> dict:
    return {
        "param_r2": round(ev["pigan_evaluation"]["parameter_prediction"]["r2"], 4),
        "spectrum_r2": round(
            ev["forward_network_evaluation"]["spectrum_prediction"]["r2"], 4),
        "metrics_r2": round(
            ev["forward_network_evaluation"]["metrics_prediction"]["r2"], 4),
        "cycle": round(ev["model_validation"]["cycle_consistency_error_mean"], 6),
        "violation_rate": round(
            ev["structural_prediction_evaluation"]["param_range_violation_rate"], 4),
    }


def _check_plot(args) -> None:
    """``--plot`` needs matplotlib: say so before any work, not after it."""
    if getattr(args, "plot", False):
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("--plot needs matplotlib, which does not import here")


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device here (pass --device cpu "
            "to run on the CPU)"
        )
    return device


def cmd_generate_data(args) -> int:
    cfg = _make_cfg(args)
    device = _device(args)
    from .data import save_csv, synthetic_dataset

    ds = synthetic_dataset(cfg.data, device=device)
    save_csv(ds, args.out)
    print(f"wrote {ds.num_samples} samples to {args.out}")
    return 0


def cmd_convert_cst(args) -> int:
    """Raw CST Studio export (dataset/THZ.txt format) -> Freq_* CSV."""
    cfg = _make_cfg(args)
    device = _device(args)
    from .data.cst import convert_cst_export

    def _kv(items, cast):
        out = {}
        flag = "--default" if cast is float else "--param-map"
        for it in items or []:
            k, sep, v = it.partition("=")
            if not sep:
                raise SystemExit(f"{flag} expects key=value, got {it!r}")
            try:
                out[k.strip()] = cast(v.strip())
            except ValueError:
                raise SystemExit(
                    f"{flag} {it!r}: {v.strip()!r} is not a valid {cast.__name__}"
                )
        return out

    n = convert_cst_export(
        args.raw, args.out, cfg=cfg.data,
        param_map=_kv(args.param_map, str),
        defaults=_kv(args.default, float),
        fit_grid=args.fit_grid,
        device=device,
    )
    print(f"converted {n} sample(s) from {args.raw} -> {args.out}")
    return 0


def cmd_pretrain_forward(args) -> int:
    cfg = _make_cfg(args)
    device = _device(args)
    if args.epochs is not None:
        # keep the cosine horizon tied to the actual run length, like the
        # reference's CosineAnnealingLR(T_max=num_epochs)
        cfg = apply_overrides(cfg, [f"train.fwd_pretrain_epochs={args.epochs}"])
    from .ops._cuda_build import launch_counts
    from .train import checkpoint as ckpt
    from .train.trainer import Trainer
    from .utils.logging import RunLogger

    logger = RunLogger(cfg.workdir, name="fwd_pretrain", use_tensorboard=args.tensorboard,
                       use_wandb=args.wandb)
    try:
        trainer = Trainer(cfg, logger=logger, csv_path=args.csv, device=device,
                          engine=args.engine)
        trainer.pretrain_forward(epochs=args.epochs, lr=args.lr)
        out = args.out or os.path.join(cfg.workdir, "saved_models")
        ckpt.save_model(out, ckpt.FORWARD_MODEL_PRETRAINED, trainer.forward_state.f)
        ckpt.save_model_config(out, cfg)
        logger.info(f"kernel launches: {launch_counts()}")
        logger.info(f"saved pretrained forward model under {out}")
    finally:
        logger.close()
    return 0


def _load_pretrained_forward(trainer, path: str) -> None:
    """Start the trainer's forward state from ``<dir>/<name>[.pth]``."""
    from .train import checkpoint as ckpt

    directory, name = os.path.split(os.path.abspath(path))
    name = name[:-4] if name.endswith(".pth") else name
    trainer.pretrain_forward(epochs=0)                  # the state, untrained
    ckpt.load_model(directory, name, trainer.forward_state.f)   # in place


def cmd_train(args) -> int:
    if args.backup_tag in ("final", "ema", "pretrained"):
        # fail before training, not at the final save
        raise SystemExit(f"--backup-tag {args.backup_tag!r} collides with a canonical "
                         "artifact name; pick another tag")
    _check_plot(args)
    cfg = _make_cfg(args)
    device = _device(args)
    # Tie the schedules' horizons to the requested run lengths (the reference
    # passes the actual num_epochs as CosineAnnealingLR T_max,
    # train_pigan.py:61)
    horizon_overrides = []
    if args.epochs is not None:
        key = ("train.fwd_pretrain_epochs" if args.mode == "forward_only"
               else "train.num_epochs")
        horizon_overrides.append(f"{key}={args.epochs}")
    if args.forward_epochs is not None:
        horizon_overrides.append(f"train.fwd_pretrain_epochs={args.forward_epochs}")
    if horizon_overrides:
        cfg = apply_overrides(cfg, horizon_overrides)
    if args.mode == "pigan_only" and args.forward_model:
        # rebuild the pretrained surrogate's architecture from the
        # model_config.json saved next to it
        cfg = _overlay_model_config_dir(
            cfg, os.path.dirname(os.path.abspath(args.forward_model)), args.set)
    from .ops._cuda_build import launch_counts
    from .train import checkpoint as ckpt
    from .train.steps import StepSettings
    from .train.trainer import Trainer
    from .utils.logging import RunLogger

    train_ds = holdout_ds = None
    if args.holdout:
        train_ds, holdout_ds = _split_holdout(cfg, args.csv, args.holdout,
                                              args.holdout_seed, device)
    logger = RunLogger(cfg.workdir, name=f"train_{args.mode}",
                       use_tensorboard=args.tensorboard, use_wandb=args.wandb)
    try:
        trainer = Trainer(cfg, ds=train_ds, logger=logger, csv_path=args.csv,
                          device=device, engine=args.engine)
        gan_kw = {}
        if args.preset == "optimized":
            # OptimizedTrainer's GAN-phase loss mix (constraint, window and
            # stability on, physics through F), read from the config after
            # --set; the overlay's own detach_forward=False wins over
            # --fixed-physics
            from .config_presets import step_settings_from_optimized_config

            settings = dataclasses.replace(step_settings_from_optimized_config(cfg),
                                           ema_decay=args.ema_decay)
        elif args.preset == "scaled":
            # the recipe needs gradients through F: a conflicting flag is an
            # error, not dropped in silence
            if args.fixed_physics:
                raise SystemExit(
                    "--fixed-physics conflicts with --preset scaled: the recipe already "
                    "sends gradients through F.  To detach anyway: --set "
                    "train.detach_forward=true without --fixed-physics.")
            from .config_presets import SCALED_BATCH_SCHEDULE

            settings = StepSettings.from_config(cfg, ema_decay=args.ema_decay)
            # the warmup rides as a per-phase override of both schedules; the
            # learning rates are the config's, which the overlay scaled
            gan_kw = dict(schedule_g=SCALED_BATCH_SCHEDULE, schedule_d=SCALED_BATCH_SCHEDULE)
        else:
            settings = StepSettings.from_config(
                cfg, detach_forward=not args.fixed_physics, ema_decay=args.ema_decay)
        mgr = None
        if args.checkpoint_dir:
            mgr = ckpt.CheckpointManager(args.checkpoint_dir,
                                         save_interval=cfg.train.save_interval)
        out = args.out or os.path.join(cfg.workdir, "saved_models")
        if args.mode == "forward_only":
            trainer.pretrain_forward(epochs=args.epochs, checkpoint_manager=mgr)
            ckpt.save_model(out, ckpt.FORWARD_MODEL_PRETRAINED, trainer.forward_state.f)
            ckpt.save_model_config(out, cfg)
            logger.info(f"saved pretrained forward model under {out}")
        else:
            if args.mode == "pigan_only":
                if args.forward_model:
                    _load_pretrained_forward(trainer, args.forward_model)
            else:
                # one manager holds one kind of state: full mode checkpoints
                # the GAN stage
                trainer.pretrain_forward(epochs=args.forward_epochs)
            trainer.init_pigan()
            trainer.train_pigan(epochs=args.epochs, settings=settings,
                                checkpoint_manager=mgr, **gan_kw)
            trainer.save_final(out, backup_tag=args.backup_tag)
            logger.info(f"saved final models under {out}")
            if holdout_ds is not None:
                ev = trainer.evaluator()
                summary = {
                    "holdout_frac": args.holdout,
                    "holdout_seed": args.holdout_seed,
                    "train": _holdout_row(ev.run_comprehensive_evaluation(trainer.ds)),
                    "heldout": _holdout_row(ev.run_comprehensive_evaluation(holdout_ds)),
                }
                logger.info("held-out evaluation: " + json.dumps(summary))
                with open(os.path.join(logger.run_dir, "holdout_eval.json"), "w") as fh:
                    json.dump(summary, fh, indent=2)
                print(json.dumps(summary, indent=2))
        if args.plot:
            from .utils.viz import plot_training_curves

            plot_training_curves(trainer.train_history,
                                 os.path.join(logger.run_dir, "training_curves.png"))
        if mgr is not None:
            mgr.close()
            logger.info(f"checkpoints kept under {mgr.directory}: epochs "
                        f"{mgr.all_epochs()}")
        logger.info(f"kernel launches: {launch_counts()}")
    finally:
        logger.close()
    return 0


PROGRAMS = ("progressive", "emergency", "finetune")


def cmd_program(args) -> int:
    """One of the metric-gated pipelines from a fresh trainer; the finals,
    ``generator_<name>.pth`` etc. beside them, and ``final_eval.json``."""
    cfg = _make_cfg(args)
    device = _device(args)
    from .ops._cuda_build import launch_counts
    from .train import programs as P
    from .train.trainer import Trainer
    from .utils.logging import RunLogger

    if args.name == "progressive":
        phases = P.progressive_pipeline()
    elif args.name == "emergency":
        phases = [*P.standard_phases(50, 50), *P.emergency_phases()]
    else:
        phases = [P.constraint_finetune_phase()]
    logger = RunLogger(cfg.workdir, name=f"program_{args.name}",
                       use_tensorboard=args.tensorboard, use_wandb=args.wandb)
    try:
        trainer = Trainer(cfg, logger=logger, csv_path=args.csv, device=device,
                          engine=args.engine)
        result = P.run_program(trainer, phases)
        logger.info(f"phases run: {result.phases_run}; skipped: {result.phases_skipped}")
        out = args.out or os.path.join(cfg.workdir, "saved_models")
        # per-mode backup copies beside the finals (the reference's versioned
        # *_unified / *_emergency.pth artifacts)
        trainer.save_final(out, backup_tag=args.name)
        with open(os.path.join(logger.run_dir, "final_eval.json"), "w") as fh:
            json.dump(result.final_eval, fh, indent=2)
        logger.info(f"kernel launches: {launch_counts()}")
        logger.info(f"saved final models under {out}")
    finally:
        logger.close()
    return 0


def cmd_evaluate(args) -> int:
    """The four suites on the saved trio (or one suite with its rubric),
    the noise ceilings and the clean oracle on synthetic data, the report,
    the held-out comparison, the JSON and the figures."""
    import time

    _check_plot(args)
    cfg = _make_cfg(args)
    cfg = _overlay_model_config_dir(cfg, args.models, args.set)
    device = _device(args)
    from .evaluate import (
        SUITE_RUBRICS,
        generate_summary_report,
        noise_ceilings,
        oracle_validation,
    )
    from .evaluate.evaluator import to_floats
    from .ops._cuda_build import launch_counts
    from .train.trainer import Trainer

    holdout = args.holdout
    if holdout:
        # honest protocol: evaluate on cells the model never trained on (the
        # same frac and seed as `train --holdout` reproduce its split)
        train_split, val_split = _split_holdout(cfg, args.csv, holdout, args.holdout_seed,
                                                device)
        trainer = Trainer(cfg, ds=val_split, csv_path=args.csv, device=device)
    else:
        train_split = None
        trainer = Trainer(cfg, csv_path=args.csv, device=device)
    trainer.load_final(args.models)
    if args.use_ema and trainer.pigan_state.g_ema is None:
        raise SystemExit(f"--use-ema: no generator_ema artifact in {args.models}")
    window = (-1.0, 1.0) if args.violation_window == "sane" else (0.0, 1.0)
    synthetic_data = args.csv is None  # the oracle and the ceilings need it
    ds = trainer.ds
    ev = trainer.evaluator(violation_window=window, use_ema=args.use_ema)
    if args.suite != "all":
        # per-suite frontends (the reference's four evaluation CLI wrappers):
        # graded console rubric and the suite's figure
        suite_fns = {
            "forward": lambda: ev.forward_network(ds),
            "pigan": lambda: ev.pigan(ds),
            "structural": lambda: ev.structural_prediction(ds),
            "validation": lambda: ev.model_validation(ds),
        }
        res = to_floats(suite_fns[args.suite]())
        print(SUITE_RUBRICS[args.suite](res))
        if args.json:
            with open(args.json, "w") as fh:
                json.dump(res, fh, indent=2)
        if args.plot:
            from .utils import eval_viz

            fname, plot_fn = eval_viz.SUITE_FIGURES[args.suite]
            path = plot_fn(res, ev.sample_arrays(ds), os.path.join(args.models, fname))
            print(f"\nfigure saved: {path}")
        print(f"kernel launches: {launch_counts()}")
        return 0
    t0 = time.time()
    results = ev.run_comprehensive_evaluation(ds)
    ceilings = oracle = None
    if synthetic_data:
        ceilings = noise_ceilings(trainer.cfg.data, device=device)
        oracle = oracle_validation(ev, ds)
        results["noise_ceilings"] = ceilings
        results["oracle_validation"] = oracle
    results["evaluation_time"] = time.time() - t0
    report = generate_summary_report(
        results,
        save_path=os.path.join(args.models, "unified_evaluation_report.txt"),
        ceilings=ceilings,
        oracle=oracle,
    )
    print(report)
    if holdout:
        comparison = {
            "holdout_frac": holdout,
            "holdout_seed": args.holdout_seed,
            "heldout": _holdout_row(results),
            "train": _holdout_row(ev.run_comprehensive_evaluation(train_split)),
        }
        results["holdout_comparison"] = comparison
        print("\nholdout comparison (train split vs held-out split):")
        print(json.dumps(comparison, indent=2))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(results, fh, indent=2)
    if args.plot:
        from .utils import eval_viz
        from .utils.viz import plot_forward_predictions, plot_gan_comparison

        arrays = ev.sample_arrays(ds)
        suite_results = {
            "forward": results["forward_network_evaluation"],
            "pigan": results["pigan_evaluation"],
            "structural": results["structural_prediction_evaluation"],
            "validation": results["model_validation"],
        }
        for suite, (fname, plot_fn) in eval_viz.SUITE_FIGURES.items():
            kw = ({"history": trainer.train_history}
                  if suite == "pigan" and trainer.train_history else {})
            plot_fn(suite_results[suite], arrays, os.path.join(args.models, fname), **kw)
        eval_viz.plot_comprehensive_summary(
            results, os.path.join(args.models, "evaluation_summary.png"), ceilings=ceilings)
        # plot_utils-parity sample grids (plot_utils.py:37-161)
        st = trainer.pigan_state
        plot_forward_predictions(ds, st.f, os.path.join(args.models, "forward_predictions.png"))
        plot_gan_comparison(ds, st.g, st.f, os.path.join(args.models, "gan_comparison.png"))
        print(f"figures saved under {args.models}")
    print(f"kernel launches: {launch_counts()}")
    return 0


def _load_forward_model(cfg: PiGanConfig, models: str, device):
    """F from ``models``: ``forward_model_pretrained`` if it is there, else
    ``forward_model_final``; eval mode, on ``device``."""
    from .models.registry import build_forward_model
    from .train import checkpoint as ckpt

    d = cfg.data
    f = build_forward_model(cfg.forward_model, d.spectrum_dim, d.metrics_dim, d.param_dim,
                            device="cpu")
    name = (ckpt.FORWARD_MODEL_PRETRAINED
            if ckpt.exists(models, ckpt.FORWARD_MODEL_PRETRAINED) else ckpt.FORWARD_MODEL_FINAL)
    ckpt.load_model(models, name, f)
    return f.to(device).eval()


ENSEMBLE_FILE = "ensemble_best.pt"


def _load_ensemble(cfg: PiGanConfig, models: str, members: int, device):
    """The members' generators and the shared F from ``<models>/ensemble_best.pt``,
    the stacked state ``examples/torch_seed_ensemble.py --save`` writes."""
    from .models.registry import build_forward_model, build_generator

    path = os.path.join(models, ENSEMBLE_FILE)
    if not os.path.isfile(path):
        raise SystemExit(f"--artifact ensemble: no {ENSEMBLE_FILE} in {models} "
                         "(examples/torch_seed_ensemble.py --save writes one)")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if saved["g"].shape[0] != members:
        raise SystemExit(f"--ensemble-members {members}: {path} holds "
                         f"{saved['g'].shape[0]} members")
    d = cfg.data
    gens = []
    with torch.no_grad():
        for m in range(members):
            g = build_generator(cfg.generator, d.spectrum_dim, d.param_dim, device="cpu")
            torch.nn.utils.vector_to_parameters(saved["g"][m], g.parameters())
            norms = [mod for mod in g.modules() if isinstance(mod, torch.nn.BatchNorm1d)]
            for j, bn in enumerate(norms):
                bn.running_mean.copy_(saved["bn"][2 * j][m])
                bn.running_var.copy_(saved["bn"][2 * j + 1][m])
            gens.append(g.to(device).eval())
        f = build_forward_model(cfg.forward_model, d.spectrum_dim, d.metrics_dim, d.param_dim,
                                device="cpu")
        torch.nn.utils.vector_to_parameters(saved["f"], f.parameters())
    return gens, f.to(device).eval()


def cmd_screen(args) -> int:
    """Screen ``--candidates`` random designs with the saved F; the top-k
    to ``screening_results.json``."""
    if args.pallas and args.dtype == "bfloat16":
        # before any model load or device work
        raise SystemExit("--pallas supports float32 only; drop --dtype")
    if args.mesh_data > 1:
        raise NotImplementedError("--mesh-data > 1 is not ported yet: screening over ranks "
                                  "waits for ROADMAP.md queue 1, item 14")
    import time

    cfg = _make_cfg(args)
    cfg = _overlay_model_config_dir(cfg, args.models, args.set)
    device = _device(args)
    from .data.dataset import load_or_synthesize
    from .design import ScreeningConfig, screen_designs
    from .ops._cuda_build import launch_counts

    ds = load_or_synthesize(cfg.data, args.csv, device=device)
    f = _load_forward_model(cfg, args.models, device)
    sc = ScreeningConfig(
        num_candidates=args.candidates, top_k=args.top_k, objective=args.objective,
        chunk_size=args.chunk_size, use_pallas=args.pallas, compute_dtype=args.dtype,
    )
    t0 = time.perf_counter()
    res = screen_designs(f, ds.frequencies, ds.param_lo, ds.param_hi,
                         torch.Generator(device=device).manual_seed(cfg.train.seed), sc)
    valid = res.valid.tolist()             # waits for the screen
    wall = time.perf_counter() - t0
    scores, params = res.scores.tolist(), res.params.tolist()
    rows = [{"rank": i + 1, "score": scores[i],
             **dict(zip(("r1", "r2", "w", "g"), params[i]))}
            for i in range(args.top_k) if valid[i]]    # the rest: filler rows
    out = args.out or "screening_results.json"
    with open(out, "w") as fh:
        json.dump({"objective": args.objective, "designs": rows}, fh, indent=2)
    print(f"screened {args.candidates} candidates in {wall:.3f} s; top-{args.top_k} -> {out}")
    print(json.dumps(rows[:3], indent=2))
    print(f"kernel launches: {launch_counts()}")
    return 0


def cmd_design(args) -> int:
    """Inverse design for specific target spectra: G's prediction and the
    surrogate's check, optional gradient refinement and MC-dropout
    uncertainty."""
    cfg = _make_cfg(args)
    cfg = _overlay_model_config_dir(cfg, args.models, args.set)
    device = _device(args)
    import numpy as np

    from .design import InverseDesigner
    from .ops._cuda_build import launch_counts
    from .train.trainer import Trainer

    trainer = Trainer(cfg, csv_path=args.csv, device=device)
    trainer.load_final(args.models)
    st = trainer.pigan_state
    designer = InverseDesigner(st.g, st.f, trainer.ds)
    if args.target_file:
        raw = (np.load(args.target_file) if args.target_file.endswith(".npy")
               else np.loadtxt(args.target_file, delimiter=","))
        spectra = torch.as_tensor(np.asarray(raw, np.float32), device=device).reshape(
            -1, trainer.ds.spectrum_dim)
    else:
        spectra = trainer.ds.spectra[torch.as_tensor(args.target_index or [0], device=device)]

    res = designer.design(spectra, refine_steps=args.refine_steps)
    params, mse = res.params.tolist(), res.spectrum_mse.tolist()
    rows = [{**dict(zip(("r1", "r2", "w", "g"), params[i])), "spectrum_mse": mse[i]}
            for i in range(spectra.shape[0])]
    if args.uncertainty:
        _, spec_std, _, met_std = designer.uncertainty(
            spectra, torch.Generator(device=device).manual_seed(cfg.train.seed),
            params_norm=res.params_norm)
        for row, s_std, m_std in zip(rows, spec_std.mean(dim=-1).tolist(),
                                     met_std.mean(dim=-1).tolist()):
            row["spectrum_std_mean"] = s_std
            row["metrics_std_mean"] = m_std
    out = {"refine_steps": args.refine_steps, "designs": rows}
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
    print(f"kernel launches: {launch_counts()}")
    return 0


def cmd_export(args) -> int:
    """Serialize trained models as ``torch.export`` serving artifacts
    (``serve.py``; ``.pt2``, loaded by ``serve.load_exported``)."""
    if args.pallas and args.dtype != "float32":
        raise SystemExit("--pallas and --dtype are mutually exclusive "
                         "(the fused kernels run fp32)")
    if args.artifact == "ensemble":
        if not args.ensemble_members or args.ensemble_members < 1:
            raise SystemExit("--artifact ensemble needs --ensemble-members N (>= 1)")
        if args.dtype == "int8":
            raise SystemExit("int8 covers the single-model designer only")
        if args.use_ema or args.pallas:
            raise SystemExit("--use-ema / --pallas are single-model options; the ensemble "
                             "artifact serves the members' saved weights on the portable path")
    cfg = _make_cfg(args)
    cfg = _overlay_model_config_dir(cfg, args.models, args.set)
    device = _device(args)
    from . import serve
    from .train import checkpoint as ckpt

    dtype = {"bfloat16": torch.bfloat16, "int8": "int8"}.get(args.dtype)
    os.makedirs(args.out, exist_ok=True)
    written = []
    if args.artifact == "ensemble":
        from .data.dataset import load_or_synthesize

        ds = load_or_synthesize(cfg.data, args.csv, device=device)
        gens, f = _load_ensemble(cfg, args.models, args.ensemble_members, device)
        written.append(serve.export_ensemble_inverse_design(
            gens, f, ds, os.path.join(args.out, "ensemble_designer.pt2"),
            batch_size=args.batch_size, compute_dtype=dtype))
    else:
        from .train.trainer import Trainer

        trainer = Trainer(cfg, csv_path=args.csv, device=device)
        trainer.load_final(args.models)
        st = trainer.pigan_state
        g = st.g
        if args.use_ema:
            if st.g_ema is None:
                raise SystemExit(f"--use-ema: no 'generator_ema' artifact in {args.models}")
            g = ckpt.ema_generator(st)
        ds = trainer.ds
        if args.artifact in ("designer", "all"):
            written.append(serve.export_inverse_design(
                g, st.f, ds, os.path.join(args.out, "designer.pt2"),
                batch_size=args.batch_size, use_pallas=args.pallas, compute_dtype=dtype))
        if args.artifact in ("generator", "all"):
            # int8 covers the designer and the surrogate; bf16 every artifact
            written.append(serve.export_generator(
                g, ds, os.path.join(args.out, "generator.pt2"), batch_size=args.batch_size,
                compute_dtype=None if args.dtype == "int8" else dtype))
        if args.artifact in ("surrogate", "all"):
            written.append(serve.export_forward_surrogate(
                st.f, ds, os.path.join(args.out, "surrogate.pt2"),
                batch_size=args.batch_size, use_pallas=args.pallas, compute_dtype=dtype))
    for path in written:
        print(f"exported {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    return 0


def cmd_cache_data(args) -> int:
    """The dataset (``--csv`` or synthetic) -> a binary ``.thzb`` cache, read
    back and checked against the arrays it was written from."""
    cfg = _make_cfg(args)
    device = _device(args)
    from .data import load_or_synthesize
    from .data.native_io import cache_dataset, load_cached, native_available

    ds = load_or_synthesize(cfg.data, args.csv, device=device)
    cache_dataset(ds, args.out)
    reloaded = load_cached(args.out, dataclasses.replace(cfg.data, spectrum_dim=ds.spectrum_dim),
                           device=device)
    for name in ("spectra", "params", "metrics"):
        if not torch.equal(getattr(reloaded, name), getattr(ds, name)):
            raise SystemExit(f"cache-data: the cache's {name} differ from the dataset's")
    where = args.out if native_available() else args.out + ".npy (no C++ extension here)"
    print(f"cached {ds.num_samples} samples -> {where}")
    return 0


def cmd_profile(args) -> int:
    """A ``torch.profiler`` trace of the PI-GAN multi-epoch function the
    engine rule picks, and a warm-up-aware throughput and memory report."""
    cfg = _make_cfg(args)
    device = _device(args)
    from .ops._cuda_build import launch_counts
    from .train.steps import StepSettings
    from .train.trainer import Trainer
    from .utils.profiling import TRACE_FILE, StepTimer, device_memory_stats, trace

    trainer = Trainer(cfg, csv_path=args.csv, device=device, engine=args.engine)
    state = trainer.init_pigan()
    multi, _ = trainer._gan_epoch_fn(StepSettings.from_config(cfg), trainer.g_tx,
                                     trainer.d_tx, {}, args.epochs)
    ones = torch.ones(args.epochs)
    # the build and the first call's set-up outside the trace
    state, m = multi(state, trainer.ds, ones)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    timer = StepTimer(warmup=1)
    trace_dir = args.trace_dir or os.path.join(cfg.workdir, "trace")
    before = launch_counts()
    with trace(trace_dir):
        for _ in range(args.repeats):
            state, m = multi(state, trainer.ds, ones)
            timer.tick(m)
    launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    spe = trainer.steps_per_epoch
    report = {
        "trace_dir": trace_dir,
        "epochs_per_call": args.epochs,
        "calls_per_sec": round(timer.steps_per_sec(), 3),
        "train_steps_per_sec": round(timer.steps_per_sec() * args.epochs * spe, 1),
        "device_memory": device_memory_stats(),
        "launches": launches,
    }
    print(json.dumps(report, indent=2))
    print(f"open {os.path.join(trace_dir, TRACE_FILE)} in a Chrome-trace viewer (Perfetto)")
    return 0


_PROBE = """
import time, torch
t0 = time.time()
x = torch.ones((8, 8), device="cuda")
torch.cuda.synchronize()
t1 = time.time()
v = float((x @ x).sum())
rtt = time.time() - t1
print(f"{torch.cuda.device_count()} {time.time() - t0:.2f} {rtt * 1000:.2f} {v}")
"""

_BUILD_PROBE = """
import time
from pigan_thz_torch.ops import _cuda_build
t0 = time.time()
path = _cuda_build.build()
_cuda_build.load_library()
print(f"{path} {time.time() - t0:.1f}")
"""


def cmd_doctor(args) -> int:
    """Environment health report: versions, the card (name and power
    limit), nvcc, the kernel library (built in a killable subprocess), the
    native IO extension, the kernels' verdicts for the config, and a device
    round trip in a killable subprocess.  Exits 1 when a check fails."""
    import platform
    import shutil
    import subprocess
    import sys
    import time

    checks = []

    def add(name, ok, detail=""):
        checks.append({"check": name, "ok": bool(ok), "detail": detail})
        print(f"[{'ok ' if ok else 'FAIL'}] {name}{': ' + detail if detail else ''}")

    def run(cmd, timeout):
        """(returncode, stdout, stderr) of a subprocess, killed at ``timeout``."""
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                                 cwd=root)
            return out.returncode, out.stdout.strip(), out.stderr.strip()
        except subprocess.TimeoutExpired:
            return None, "", f"no answer within {timeout} s (killed)"
        except OSError as e:
            return None, "", f"{type(e).__name__}: {e}"

    t0 = time.time()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(f"python {platform.python_version()} on {platform.platform()}")
    add("torch", True, f"{torch.__version__}, built for CUDA {torch.version.cuda}")
    cuda = torch.cuda.is_available()
    add("CUDA device", cuda,
        f"{torch.cuda.device_count()}x {torch.cuda.get_device_name(0)}, capability "
        f"{torch.cuda.get_device_capability(0)}" if cuda else
        "torch.cuda.is_available() is False: no card, or a CPU-only torch")
    if shutil.which("nvidia-smi"):
        rc, out, err = run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], args.timeout)
        add("card", rc == 0 and bool(out), out.replace("\n", "; ") if rc == 0 else err[-200:])
    else:
        add("card", False, "nvidia-smi not found")
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if nvcc and os.path.exists(nvcc):
        rc, out, err = run([nvcc, "--version"], args.timeout)
        add("nvcc", rc == 0, f"{nvcc}: {out.splitlines()[-1] if out else err[-200:]}")
    else:
        add("nvcc", False, "not found (set CUDA_HOME or put nvcc on PATH)")
    if cuda and nvcc:
        rc, out, err = run([sys.executable, "-c", _BUILD_PROBE], args.timeout)
        add("kernel library", rc == 0,
            f"{out.split()[0]} ready in {out.split()[-1]} s" if rc == 0 and out
            else err[-300:])
    else:
        add("kernel library", False, "not built: it needs a card and nvcc")
    try:
        from .data.native_io import build_error, native_available

        ok = native_available()
        add("native IO extension", ok,
            "C++ CSV parser and .thzb cache built" if ok
            else f"unavailable, the Python fallback runs: {build_error()}")
    except Exception as e:  # noqa: BLE001 (a report, not a crash)
        add("native IO extension", False, f"{type(e).__name__}: {e}")
    try:
        from .ops.forward_train import supports_forward_kernel
        from .ops.gan_train import supports_gan_kernel
        from .train.steps import StepSettings

        cfg = _make_cfg(args)
        r_fwd = supports_forward_kernel(cfg)
        r_gan = supports_gan_kernel(cfg, StepSettings.from_config(cfg))
        # verdicts, not failures: a config outside a kernel runs --engine eager
        add("forward-training kernel", True,
            "takes this config" if r_fwd is None else f"eager step only: {r_fwd}")
        add("GAN-training kernel", True,
            "takes this config" if r_gan is None else f"eager step only: {r_gan}")
    except Exception as e:  # noqa: BLE001
        add("kernel verdicts", False, f"{type(e).__name__}: {e}")
    if cuda:
        rc, out, err = run([sys.executable, "-c", _PROBE], args.timeout)
        try:
            n, init_s, rtt_ms, v = out.splitlines()[-1].split()
            add("device round trip", rc == 0 and float(v) == 512.0,
                f"{n} card(s), first tensor {init_s} s, round trip {rtt_ms} ms")
        except (ValueError, IndexError):
            add("device round trip", False, f"probe rc={rc}: {(err or out)[-300:]}")
    else:
        add("device round trip", False, "no CUDA device to probe")
    print(f"doctor finished in {time.time() - t0:.1f} s")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(checks, fh, indent=2)
    return 0 if all(c["ok"] for c in checks) else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pigan_thz_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate-data", help="synthesize a CSV dataset")
    _base_parser(g)
    g.add_argument("--out", default="dataset/THz_Metamaterial_Spectra_With_Metrics.csv")
    g.set_defaults(fn=cmd_generate_data)

    g = sub.add_parser(
        "convert-cst",
        help="convert a raw CST export (THZ.txt format) to the Freq_* CSV",
    )
    _base_parser(g)
    g.add_argument("raw", help="raw CST text export path")
    g.add_argument("--out", default="dataset/converted.csv")
    g.add_argument("--param-map", action="append", metavar="NAME=KEY",
                   help="dataset column -> export parameter key (e.g. g=p)")
    g.add_argument("--default", action="append", metavar="NAME=VALUE",
                   help="value for a structural parameter the export lacks")
    g.add_argument("--fit-grid", action="store_true",
                   help="derive the frequency grid from the export's sweep "
                        "instead of requiring it to cover data.freq_min/max")
    g.set_defaults(fn=cmd_convert_cst)

    g = sub.add_parser("pretrain-forward", help="pretrain the forward surrogate")
    _base_parser(g)
    g.add_argument("--epochs", type=int, default=None)
    g.add_argument("--lr", type=float, default=None)
    _engine_flag(g)
    g.add_argument("--out", default=None,
                   help="directory for the artifacts (default <workdir>/saved_models)")
    g.add_argument("--tensorboard", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="write tfevents scalars under <run_dir>/tb (on by default)")
    g.add_argument("--wandb", action="store_true",
                   help="also log scalars to Weights & Biases (needs the wandb package)")
    g.set_defaults(fn=cmd_pretrain_forward)

    g = sub.add_parser("train", help="train models")
    _base_parser(g)
    g.add_argument("--mode", choices=["forward_only", "pigan_only", "full"], default="full")
    g.add_argument("--epochs", type=int, default=None)
    g.add_argument("--forward-epochs", type=int, default=None)
    _engine_flag(g)
    g.add_argument("--forward-model", default=None,
                   help="path to a pretrained forward model (dir/name[.pth])")
    g.add_argument("--ema-decay", type=float, default=0.0,
                   help="EMA decay for the generator track (0 = off); the EMA "
                        "generator is saved as 'generator_ema'")
    g.add_argument("--fixed-physics", action="store_true",
                   help="let physics-loss gradients flow through frozen F "
                        "(recommended; default reproduces the reference's "
                        "no_grad behaviour)")
    g.add_argument("--holdout", type=float, default=0.0, metavar="FRAC",
                   help="train on a (1-FRAC) split and report train vs held-out "
                        "metrics in holdout_eval.json (the honest protocol)")
    g.add_argument("--holdout-seed", type=int, default=9,
                   help="split shuffle seed; reuse at evaluate time to reproduce "
                        "the identical split")
    g.add_argument("--preset", default=None, choices=["optimized", "scaled"],
                   help="config overlay applied before --set: 'optimized' = the "
                        "reference's OptimizedTrainer config (residual generator, "
                        "dual-encoder discriminator, constraint/window/stability "
                        "losses); 'scaled' = the large-batch recipe (batch 512, lr "
                        "x2, warmup, gradients through F)")
    g.add_argument("--backup-tag", default=None, metavar="TAG",
                   help="also write versioned backup artifacts generator_<TAG>/... "
                        "next to the finals (reference *_unified.pth parity)")
    g.add_argument("--out", default=None,
                   help="directory for the artifacts (default <workdir>/saved_models)")
    g.add_argument("--plot", action="store_true",
                   help="write training_curves.png in the run directory (needs matplotlib)")
    g.add_argument("--checkpoint-dir", default=None,
                   help="save the full training state every train.save_interval epochs "
                        "here (the GAN stage in full mode), for Trainer.resume_from")
    g.add_argument("--tensorboard", action=argparse.BooleanOptionalAction, default=True,
                   help="write tfevents scalars under <run_dir>/tb (on by default)")
    g.add_argument("--wandb", action="store_true",
                   help="also log scalars to Weights & Biases (needs the wandb package)")
    g.set_defaults(fn=cmd_train)

    g = sub.add_parser("program", help="run a metric-gated training program")
    _base_parser(g)
    g.add_argument("name", choices=list(PROGRAMS))
    _engine_flag(g)
    g.add_argument("--out", default=None,
                   help="directory for the artifacts (default <workdir>/saved_models)")
    g.add_argument("--tensorboard", action=argparse.BooleanOptionalAction, default=True,
                   help="write tfevents scalars under <run_dir>/tb (on by default)")
    g.add_argument("--wandb", action="store_true",
                   help="also log scalars to Weights & Biases (needs the wandb package)")
    g.set_defaults(fn=cmd_program)

    g = sub.add_parser("evaluate", help="run the four evaluation suites")
    _base_parser(g)
    g.add_argument("--models", required=True, help="saved_models directory")
    g.add_argument("--suite", default="all",
                   choices=["all", "forward", "pigan", "structural", "validation"],
                   help="run one suite only (parity with the per-suite CLIs)")
    g.add_argument("--use-ema", action="store_true",
                   help="evaluate the EMA generator track (requires a "
                        "'generator_ema' artifact in --models)")
    g.add_argument("--violation-window", default="parity", choices=["parity", "sane"],
                   help="parity: reference's [0,1] window on tanh outputs; "
                        "sane: [-1,1] convention-consistent window")
    g.add_argument("--holdout", type=float, default=0.0, metavar="FRAC",
                   help="evaluate on the held-out FRAC split (the same frac and seed "
                        "as `train --holdout` reproduce that run's split); the report "
                        "then scores unseen cells, with a train-vs-heldout comparison")
    g.add_argument("--holdout-seed", type=int, default=9)
    g.add_argument("--json", default=None, help="also dump results JSON")
    g.add_argument("--plot", action="store_true",
                   help="write the suites' figures beside the models (needs matplotlib)")
    g.set_defaults(fn=cmd_evaluate)

    g = sub.add_parser("screen", help="batched inverse-design screening")
    _base_parser(g)
    g.add_argument("--models", required=True, help="saved_models directory (F)")
    g.add_argument("--candidates", type=int, default=1_000_000)
    g.add_argument("--top-k", type=int, default=100)
    g.add_argument("--chunk-size", type=int, default=8192)
    g.add_argument("--objective", default="FoM1")
    g.add_argument("--pallas", action="store_true",
                   help="the surrogate through the fused forward kernel (K5)")
    g.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="surrogate forward-pass dtype; bfloat16 runs F's bf16 twin "
                        "(rankings may differ near ties)")
    g.add_argument("--mesh-data", type=int, default=1,
                   help="shard candidate batches over N devices (not ported yet)")
    g.add_argument("--out", default=None, help="results JSON (default screening_results.json)")
    g.set_defaults(fn=cmd_screen)

    g = sub.add_parser("design", help="inverse design for target spectra")
    _base_parser(g)
    g.add_argument("--models", required=True, help="saved_models directory")
    g.add_argument("--target-index", type=int, action="append", default=None,
                   help="dataset row(s) to use as targets (repeatable)")
    g.add_argument("--target-file", default=None,
                   help=".npy or CSV file of target spectra (rows of S points)")
    g.add_argument("--refine-steps", type=int, default=0,
                   help="surrogate-gradient refinement steps (0 = G only)")
    g.add_argument("--uncertainty", action="store_true",
                   help="MC-dropout spread of the surrogate verification")
    g.add_argument("--out", default=None, help="also write results JSON here")
    g.set_defaults(fn=cmd_design)

    g = sub.add_parser("export", help="torch.export serving artifacts (.pt2)")
    _base_parser(g)
    g.add_argument("--models", required=True, help="saved_models directory")
    g.add_argument("--artifact", default="all",
                   choices=["all", "designer", "generator", "surrogate", "ensemble"])
    g.add_argument("--ensemble-members", type=int, default=None,
                   help=f"--artifact ensemble: member count of {ENSEMBLE_FILE} in --models "
                        "(examples/torch_seed_ensemble.py --save)")
    g.add_argument("--out", default="exported")
    g.add_argument("--batch-size", type=int, default=8192)
    g.add_argument("--use-ema", action="store_true",
                   help="export the EMA generator track (requires a 'generator_ema' "
                        "artifact in --models)")
    g.add_argument("--dtype", default="float32", choices=["float32", "bfloat16", "int8"],
                   help="bfloat16: the models' bf16 twins in every artifact; int8: the "
                        "post-training-quantized designer and surrogate (baseline trio)")
    g.add_argument("--pallas", action="store_true",
                   help="the designer and surrogate through the fused kernels, as custom "
                        "ops (runs where pigan_thz_torch is imported; baseline trio only)")
    g.set_defaults(fn=cmd_export)

    g = sub.add_parser("cache-data", help="dataset -> binary .thzb cache")
    _base_parser(g)
    g.add_argument("--out", default="dataset/thz.thzb")
    g.set_defaults(fn=cmd_cache_data)

    g = sub.add_parser("profile", help="torch.profiler trace of the GAN training chunk")
    _base_parser(g)
    g.add_argument("--epochs", type=int, default=10, help="epochs per traced call")
    g.add_argument("--repeats", type=int, default=3,
                   help="traced calls (the first anchors the timer)")
    g.add_argument("--trace-dir", default=None,
                   help="where trace.json goes (default <workdir>/trace)")
    _engine_flag(g)
    g.set_defaults(fn=cmd_profile)

    g = sub.add_parser("doctor", help="environment health report")
    _base_parser(g)   # --set / --config: the kernels' verdicts for that config
    g.add_argument("--timeout", type=int, default=300,
                   help="seconds for each subprocess (the build, the device probe); "
                        "a subprocess past it is killed and its check fails")
    g.add_argument("--json", default=None, help="also write the checks as JSON")
    g.set_defaults(fn=cmd_doctor)
    return p


def main(argv: List[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
