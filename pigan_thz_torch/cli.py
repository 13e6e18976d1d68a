"""Command-line interface of the port: ``python -m pigan_thz_torch <command>``.

The port of ``pigan_thz_tpu/cli.py``, command by command, with the same
flags.  Every command accepts repeated ``--set a.b.c=value`` overrides and a
``--device`` (default ``cuda``; the CPU runs only when ``--device cpu`` is
given, never as a fallback).

Commands:
  generate-data     synthesize a reference-schema CSV dataset
  convert-cst       raw CST Studio export -> reference-schema CSV
  pretrain-forward  train the forward surrogate           (pretrain_fwd_model.py)

``pretrain-forward`` writes ``forward_model_pretrained.pth`` (F's torch
state_dict) and ``model_config.json`` under ``--out``.  The other commands
of the JAX package are not ported yet (ROADMAP.md queue 1, item 11);
``screen`` waits for the checkpoints of item 7.
"""

from __future__ import annotations

import argparse
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


def _make_cfg(args) -> PiGanConfig:
    cfg = default_config()
    if args.config:
        from .config import from_yaml

        cfg = from_yaml(args.config, cfg)
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
        trainer = Trainer(cfg, logger=logger, csv_path=args.csv, device=device)
        trainer.pretrain_forward(epochs=args.epochs, lr=args.lr)
        out = args.out or os.path.join(cfg.workdir, "saved_models")
        ckpt.save_model(out, ckpt.FORWARD_MODEL_PRETRAINED, trainer.forward_state.f)
        ckpt.save_model_config(out, cfg)
        logger.info(f"kernel launches: {dict(LAUNCHES)}")
        logger.info(f"saved pretrained forward model under {out}")
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
    g.add_argument("--out", default=None,
                   help="directory for the artifacts (default <workdir>/saved_models)")
    g.add_argument("--tensorboard", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="write tfevents scalars under <run_dir>/tb (on by default)")
    g.add_argument("--wandb", action="store_true",
                   help="also log scalars to Weights & Biases (needs the wandb package)")
    g.set_defaults(fn=cmd_pretrain_forward)
    return p


def main(argv: List[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
