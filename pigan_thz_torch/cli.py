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
``auto`` is the training kernels or an error, never the eager step).  Of
``train``'s flags, ``--holdout``, ``--checkpoint-dir`` and ``--plot`` raise
until what they need is ported.  The other commands of the JAX package are
not ported yet (ROADMAP.md queue 1, item 11).
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
    from .ops._cuda_build import LAUNCHES
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
        logger.info(f"kernel launches: {dict(LAUNCHES)}")
        logger.info(f"saved pretrained forward model under {out}")
    finally:
        logger.close()
    return 0


# train's flags that wait for a module: flag -> (its "off" value, what it waits for)
_TRAIN_NOT_PORTED = {
    "holdout": (0.0, "the evaluator's held-out report (ROADMAP.md queue 1, item 8)"),
    "checkpoint_dir": (None, "CheckpointManager and resume (ROADMAP.md queue 1, item 7)"),
    "plot": (False, "utils/viz.py (ROADMAP.md queue 1, item 16)"),
}


def _load_pretrained_forward(trainer, path: str) -> None:
    """Start the trainer's forward state from ``<dir>/<name>[.pth]``."""
    from .train import checkpoint as ckpt

    directory, name = os.path.split(os.path.abspath(path))
    name = name[:-4] if name.endswith(".pth") else name
    trainer.pretrain_forward(epochs=0)                  # the state, untrained
    ckpt.load_model(directory, name, trainer.forward_state.f)   # in place


def cmd_train(args) -> int:
    for flag, (off, waits_for) in _TRAIN_NOT_PORTED.items():
        if getattr(args, flag) != off:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet: it waits for {waits_for}")
    if args.backup_tag in ("final", "ema", "pretrained"):
        # fail before training, not at the final save
        raise SystemExit(f"--backup-tag {args.backup_tag!r} collides with a canonical "
                         "artifact name; pick another tag")
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
    from .ops._cuda_build import LAUNCHES
    from .train import checkpoint as ckpt
    from .train.steps import StepSettings
    from .train.trainer import Trainer
    from .utils.logging import RunLogger

    logger = RunLogger(cfg.workdir, name=f"train_{args.mode}",
                       use_tensorboard=args.tensorboard, use_wandb=args.wandb)
    try:
        trainer = Trainer(cfg, logger=logger, csv_path=args.csv, device=device,
                          engine=args.engine)
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
        out = args.out or os.path.join(cfg.workdir, "saved_models")
        if args.mode == "forward_only":
            trainer.pretrain_forward(epochs=args.epochs)
            ckpt.save_model(out, ckpt.FORWARD_MODEL_PRETRAINED, trainer.forward_state.f)
            ckpt.save_model_config(out, cfg)
            logger.info(f"saved pretrained forward model under {out}")
        else:
            if args.mode == "pigan_only":
                if args.forward_model:
                    _load_pretrained_forward(trainer, args.forward_model)
            else:
                trainer.pretrain_forward(epochs=args.forward_epochs)
            trainer.init_pigan()
            trainer.train_pigan(epochs=args.epochs, settings=settings, **gan_kw)
            trainer.save_final(out, backup_tag=args.backup_tag)
            logger.info(f"saved final models under {out}")
        logger.info(f"kernel launches: {dict(LAUNCHES)}")
    finally:
        logger.close()
    return 0


PROGRAMS = ("progressive", "emergency", "finetune")


def cmd_program(args) -> int:
    """One of the metric-gated pipelines from a fresh trainer; the finals,
    ``generator_<name>.pth`` etc. beside them, and ``final_eval.json``."""
    cfg = _make_cfg(args)
    device = _device(args)
    from .ops._cuda_build import LAUNCHES
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
        logger.info(f"kernel launches: {dict(LAUNCHES)}")
        logger.info(f"saved final models under {out}")
    finally:
        logger.close()
    return 0


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
                   help="not ported yet (the held-out report)")
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
    g.add_argument("--plot", action="store_true", help="not ported yet (needs utils/viz.py)")
    g.add_argument("--checkpoint-dir", default=None,
                   help="not ported yet (needs CheckpointManager)")
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
    return p


def main(argv: List[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
