"""Where a float32 GAN-training run leaves the float64 one, and why
(pigan_thz_torch, on the card or, with ``--device cpu``, the plain version).

``chip_smoke.py`` holds the GAN-training kernel against its plain version in
float64: the first steps tensor by tensor, a few more by part of the state.
How long the float64 run stays a yardstick depends on the path.  This script
prints, for one of the script's paths and each step count n up to
``--steps``, how far the kernel and the float32 plain version have moved
from the float64 run by part (``gan_train.state_diffs``, relative to what
the n steps changed) and how many activation masks the float32 plain version
has on the other side of zero from float64's, by the line of the plain
version that reads them.  A LeakyReLU's or a ReLU's backward is a step
function of its pre-activation: where that lies within rounding of zero, two
float32 runs take either side, and a whole row's gradient path changes.

``--witness n`` then sizes one such flip against the kernel's distance from
float64 in one tensor after n steps (``--tensor``, default the worst): it
reruns float64 with each of the ``--candidates`` pre-activations nearest to
zero (relative to their tensor's root mean square) on the other side, one at
a time, and prints how far each flip alone moves that tensor and how far the
kernel then is from the flipped run.

    python examples/torch_gan_drift.py --path "WGAN-GP through F" --steps 30
    python examples/torch_gan_drift.py \\
        --path "WGAN-GP detached, D every 2nd step, stability, instance noise" \\
        --steps 3 --witness 3 --tensor "g_m[0]"
"""

from __future__ import annotations

import argparse
import bisect
import json
import linecache
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch

import chip_smoke as cs
from pigan_thz_torch import default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.train.trainer import Trainer


class MaskTap:
    """While active, the plain version's two mask functions record each
    call's input (a LeakyReLU's pre-activation, a BatchNorm output before
    its ReLU) with the line that reads it, and take the other side of zero
    at the given {call number: flat index}."""

    def __init__(self, flips: dict | None = None):
        self.flips = flips or {}
        self.calls: list[tuple[str, torch.Tensor]] = []

    def __enter__(self):
        self._mask, self._bn = gt._leaky_mask, gt._bn_backward
        gt._leaky_mask = lambda x: self._mask(self._tap(x))
        gt._bn_backward = lambda da, y, *rest: self._bn(da, self._tap(y), *rest)
        return self

    def __exit__(self, *exc):
        gt._leaky_mask, gt._bn_backward = self._mask, self._bn

    def _tap(self, x):
        frame = sys._getframe(2)      # _tap <- lambda <- the plain version
        line = linecache.getline(frame.f_code.co_filename, frame.f_lineno).strip()
        n = len(self.calls)
        self.calls.append((line, x.detach().clone()))
        if n in self.flips:
            x = x.clone()
            flat = x.view(-1)
            i = self.flips[n]
            flat[i] = -flat[i] if float(flat[i]) != 0.0 else -1e-30
        return x


def one_step(streams, t: int):
    cut = slice(t, t + 1)

    def first(x):
        return None if x is None else x[cut].contiguous()

    return streams._replace(spectra=first(streams.spectra), params=first(streams.params),
                            metrics_norm=first(streams.metrics_norm), sched=streams.sched[cut],
                            inoise=first(streams.inoise), stab=first(streams.stab),
                            eps=first(streams.eps))


def by_part(a, b, start, spec) -> dict:
    return {k: r for k, (_, r) in gt.state_diffs(a, b, start, spec).items()}


def main() -> int:
    paths = {**dict(cs.K2_PATHS), **dict(cs.K2_WGAN_PATHS),
             **{f"{k} (bf16)": v for k, v in cs.K2_BF16_PATHS}}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", default="WGAN-GP through F", choices=sorted(paths))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--witness", type=int, default=0)
    ap.add_argument("--tensor", default="",
                    help="a key of gan_train.step_errors, e.g. g_m[0]; default the worst")
    ap.add_argument("--candidates", type=int, default=24)
    ap.add_argument("--fwd-epochs", type=int, default=cs.K2_F_EPOCHS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device (use --device cpu for the plain version)", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    dev = torch.device(args.device)
    cfg = default_config()
    if args.path.endswith("(bf16)"):
        cfg = cs.bf16_config(cfg)
    ds = synthetic_dataset(cfg.data, device=dev)
    trainer = Trainer(cfg, ds=ds, device=dev, engine="kernel")
    trainer.pretrain_forward(epochs=args.fwd_epochs, log_every=10**9)
    state, _, _, spec, _, _, _, streams = cs.k2_setup(
        cfg, dev, ds, trainer.forward_state.f, cs.K2_EPOCHS, paths[args.path])
    start = gt.state_buffers(state)
    run = gt.gan_train if args.device == "cuda" else gt.gan_train_plain

    # the curve: the kernel from the start for n steps; float32 and float64
    # plain versions step by step, their masks compared
    plain = gt.state_buffers(state.clone())
    exact = gt.to_double(gt.state_buffers(state.clone()))
    s64 = gt.to_double(streams)
    for t in range(args.steps):
        with MaskTap() as tap32:
            gt.gan_train_plain(plain, one_step(streams, t), spec)
        with MaskTap() as tap64:
            gt.gan_train_plain(exact, one_step(s64, t), spec)
        flips: dict[str, int] = {}
        for (line, a), (_, b) in zip(tap32.calls, tap64.calls):
            n = int(((a > 0) != (b > 0)).sum())
            if n:
                flips[line] = flips.get(line, 0) + n
        kern = gt.state_buffers(state.clone())
        run(kern, cs.first_steps(streams, t + 1), spec)
        print(json.dumps({
            "path": args.path, "steps": t + 1, "d_update": bool(streams.sched[t, 6] > 0),
            "kernel_vs_f64": by_part(kern, exact, start, spec),
            "plain_vs_f64": by_part(plain, exact, start, spec),
            "kernel_vs_plain": by_part(kern, plain, start, spec),
            "masks_float32_plain_vs_f64": flips}), flush=True)

    if not args.witness:
        return 0
    n = args.witness
    few = cs.first_steps(streams, n)
    kern = gt.state_buffers(state.clone())
    run(kern, few, spec)
    plain = gt.state_buffers(state.clone())
    gt.gan_train_plain(plain, few, spec)

    def float64_run(flips=None):
        """n float64 steps, step by step under one tap: (state, tap, the
        first call number of each step)."""
        out = gt.to_double(gt.state_buffers(state.clone()))
        firsts = []
        with MaskTap(flips) as tap:
            for t in range(n):
                firsts.append(len(tap.calls))
                gt.gan_train_plain(out, one_step(s64, t), spec)
        return out, tap, firsts

    exact, tap, firsts = float64_run()
    err = gt.step_errors(kern, exact, start, spec)
    key = args.tensor or max(err, key=err.get)
    # the pre-activations nearest to zero, relative to their tensor's rms
    near = []
    for call, (line, x) in enumerate(tap.calls):
        margin = x.abs().view(-1) / x.pow(2).mean().sqrt().clamp(min=1e-300)
        vals, idx = torch.topk(margin, min(args.candidates, margin.numel()), largest=False)
        near += [(float(v), call, int(i), line) for v, i in zip(vals, idx)]
    near.sort()
    tried = []
    for margin, call, i, line in near[:args.candidates]:
        flipped, _, _ = float64_run({call: i})
        tried.append({"kernel_vs_f64_flipped": gt.step_errors(kern, flipped, start, spec)[key],
                      "f64_flipped_vs_f64": gt.step_errors(flipped, exact, start, spec)[key],
                      "margin": margin, "step": bisect.bisect_right(firsts, call),
                      "line": line, "index": i})
    best = min(tried, key=lambda r: r["kernel_vs_f64_flipped"])
    moves = sorted(r["f64_flipped_vs_f64"] for r in tried)
    print(json.dumps({
        "path": args.path, "witness_steps": n, "tensor": key, "kernel_vs_f64": err[key],
        "float32_plain_vs_f64": gt.step_errors(plain, exact, start, spec)[key],
        "one_flip_moves_f64_median": moves[len(moves) // 2], "one_flip_moves_f64_max": moves[-1],
        "closest_flip": best, "tried": tried}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
