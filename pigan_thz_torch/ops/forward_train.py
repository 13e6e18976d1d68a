"""Forward-surrogate pretraining in one launch per chunk: the port of the
forward half of ``pigan_thz_tpu/ops/megakernel.py`` (:2480-3030).

The TPU kernel ``_make_forward_kernel`` (K1) runs E epochs of F pretraining
in one Pallas launch with F's parameters and Adam moments resident in VMEM.
Its counterpart here is ``csrc/forward_train.cu``: one C call per chunk of
T steps, which enqueues every step's kernels on the current stream (hand-
written fp32 products, LayerNorm, loss, clip and Adam) over the state's flat
buffers in place.  Per step, for F = 4 -> 256 -> 512 -> 1024 -> 512 -> 256 ->
(S + 8), with ``settings`` weights:

- forward: 5 x [Dense -> LayerNorm (flax's one-pass variance clamped at 0,
  eps 1e-6) -> LeakyReLU 0.2 -> dropout], then the linear head;
- loss: w_spec·MSE(spectrum) + w_met·MSE(metrics) [+ w_smooth·mean squared
  second difference] [+ w_l1·(MAE + MAE)], each divided by its true count;
- backward: hand-derived, LayerNorm included; global-norm clip (scale by
  clip/‖g‖ when ‖g‖ ≥ clip), then Adam (b1 0.9) with precomputed
  per-step lr·scale and bias corrections;
- ``compute_dtype="bfloat16"`` (megakernel.py:2644-2663): the operands of the
  products the TPU kernel writes as ``mm`` / ``dotT0`` / ``dotT1`` are rounded
  to bfloat16 and accumulate in float32: the hidden layers 1-4 (forward, dW,
  dx) and the spectrum columns of the head (forward, dW, dx).  The input
  layer 4→256 (forward and dW) and the 8 metrics columns of the head run on
  the TPU's VPU in float32 and stay float32 here: the head is then two
  products, the metrics part added after the spectrum part.

Everything the kernel reads besides the state is built outside it, as the
TPU kernel's prologue ``_streams`` builds it: the gathered batches of every
step of the chunk, the per-step learning rate (times the epoch's scale),
inv1 = 1/(1 - 0.9^(t+1)), inv2 = 1/(1 - 0.999^(t+1)) in float32, and a
dropout seed per step.

Dropout masks come from a counter-based hash keyed by (step seed, layer,
row, column): keep when the 32-bit hash is below round(keep · 2^32), scale
1/keep.  The TPU kernel drew its bits from the TPU's hardware generator,
which agrees with the JAX XLA path only in distribution; here the kernel,
its plain version and the eager step (``train/steps.py``) compute the same
bits, so they can be compared at any dropout rate.

``forward_train`` is the wrapper: for CUDA tensors it launches the kernel or
raises, for CPU tensors it runs ``forward_train_plain`` (the kernel's math in
torch ops, no autograd), the port's analogue of Pallas interpret mode.
``LAUNCHES["forward_train"]`` counts launches, one per chunk.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch

from ..config import PiGanConfig
from ..data.dataset import ThzDataset, epoch_indices
from ._cuda_build import LAUNCHES, check_capability, launch

BASELINE_HIDDEN = (256, 512, 1024, 512, 256)
METRIC_KEYS = ("loss", "spectrum_loss", "metrics_loss")
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_SLOPE, _LN_EPS = 0.2, 1e-6
_NORM_PARTS = 256   # blocks of the kernel's first gradient-norm pass
_SEED_HIGH = 2**31 - 1


def supports_forward_kernel(cfg: PiGanConfig) -> str | None:
    """None when the kernel trains this configuration exactly, else the
    reason it does not (the envelope of ``supports_forward_megakernel``
    without the TPU's batch % 8 tiling)."""
    if cfg.forward_model.name != "mlp" or tuple(cfg.forward_model.hidden_dims) != (
        BASELINE_HIDDEN
    ):
        return "forward model is not the baseline MLP"
    if cfg.train.compute_dtype not in ("float32", "bfloat16"):
        return f"compute_dtype {cfg.train.compute_dtype!r} unsupported"
    if cfg.train.adam_state_dtype != "float32":
        return ("adam_state_dtype != float32 (bfloat16 Adam moments are the eager "
                "step's, as in the JAX package)")
    if cfg.data.param_dim != 4 or cfg.data.metrics_dim != 8:
        return "non-default param/metrics dims"
    if cfg.forward_model.leaky_slope != _SLOPE:
        return "non-default leaky_slope (the kernel hardcodes 0.2)"
    if cfg.train.grad_clip <= 0:
        return "grad_clip <= 0 (the kernel assumes the clip stage exists)"
    if cfg.data.spectrum_dim < 3:
        return "spectrum_dim < 3"
    return None


# ---------------------------------------------------------------------------
# Dropout: a counter-based hash, the same bits in CUDA and in torch
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_C1, _C2 = 0x7FEB352D, 0x846CA68B   # lowbias32 multipliers


def _mix32_int(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * _C1) & _M32
    x ^= x >> 15
    x = (x * _C2) & _M32
    x ^= x >> 16
    return x


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), exact: the product is
    taken in 16-bit halves so that no partial product leaves int64."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def dropout_bits(seed: int, layer: int, rows: int, cols: int,
                 device: torch.device | str) -> torch.Tensor:
    """(rows, cols) int64 tensor of 32-bit hashes of (seed, layer, row,
    column): mix(mix(mix(mix(seed) ^ layer) ^ row) ^ column), mix being
    lowbias32.  ``csrc/forward_train.cu`` computes the same bits."""
    h = _mix32_int(_mix32_int(seed) ^ layer)
    r = _mix32(torch.arange(rows, dtype=torch.int64, device=device) ^ h)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    return _mix32(r[:, None] ^ c[None, :])


def keep_threshold(rate: float) -> int:
    """Keep an entry when its hash is below this (round(keep · 2^32))."""
    return min(2**32 - 1, int(round((1.0 - float(rate)) * 2**32)))


def dropout_scale(seed: int, layer: int, rows: int, cols: int, rate: float,
                  device: torch.device | str) -> torch.Tensor:
    """(rows, cols) float32 dropout factors: 1/keep where kept, else 0."""
    keep = dropout_bits(seed, layer, rows, cols, device) < keep_threshold(rate)
    return torch.where(keep, 1.0 / (1.0 - float(rate)), 0.0).to(torch.float32)


# ---------------------------------------------------------------------------
# Draws and streams (built outside the kernel, as the TPU prologue does)
# ---------------------------------------------------------------------------


def resolve_draws(generator: torch.Generator, num_samples: int, batch_size: int,
                  epochs: int, indices: torch.Tensor | None = None,
                  seeds: torch.Tensor | None = None):
    """(indices (E, spe, B), seeds (E·spe,)) of one chunk.  What is not
    given is drawn from ``generator``: each epoch's shuffle in turn, then
    the chunk's dropout seeds.  The eager path and the kernel path both
    draw here, so one generator state gives both the same batches and
    masks."""
    spe = max(1, num_samples // batch_size)
    if indices is None:
        indices = torch.stack([
            epoch_indices(generator, num_samples, batch_size) for _ in range(epochs)
        ])
    if tuple(indices.shape) != (epochs, spe, batch_size):
        raise ValueError(
            f"indices {tuple(indices.shape)}, expected {(epochs, spe, batch_size)}"
        )
    if seeds is None:
        seeds = torch.randint(0, _SEED_HIGH, (epochs * spe,), generator=generator)
    seeds = torch.as_tensor(seeds, dtype=torch.int64).reshape(-1).cpu()
    if seeds.numel() != epochs * spe:
        raise ValueError(f"{seeds.numel()} seeds for {epochs * spe} steps")
    return indices.to(torch.int64), seeds


class Streams(NamedTuple):
    """One chunk's inputs, T = E · spe steps."""

    params_norm: torch.Tensor   # (T, B, 4) on the state's device
    spectra: torch.Tensor       # (T, B, S)
    metrics_norm: torch.Tensor  # (T, B, 8)
    sched: torch.Tensor         # (T, 3) float32 on the CPU: lr·scale, inv1, inv2
    seeds: torch.Tensor         # (T,) int64 on the CPU


def build_streams(ds: ThzDataset, indices: torch.Tensor, seeds: torch.Tensor,
                  scales: torch.Tensor, t0: int, schedule_fn) -> Streams:
    """Gather every step's batch and precompute the per-step schedule lanes
    for a chunk starting at optimiser count ``t0``: lr(t)·scale(epoch),
    1/(1 - 0.9^(t+1)) and 1/(1 - 0.999^(t+1)), all float32."""
    epochs, spe, batch = indices.shape
    steps = epochs * spe
    idx = indices.reshape(steps, batch).to(ds.spectra.device)
    t = t0 + torch.arange(steps, dtype=torch.int64)
    tf = (t + 1).to(torch.float32)
    lr_scale = torch.repeat_interleave(
        torch.as_tensor(scales, dtype=torch.float32).cpu(), spe)
    sched = torch.stack([
        schedule_fn(t).to(torch.float32) * lr_scale,
        1.0 / (1.0 - torch.pow(torch.tensor(_B1, dtype=torch.float32), tf)),
        1.0 / (1.0 - torch.pow(torch.tensor(_B2, dtype=torch.float32), tf)),
    ], dim=1)
    return Streams(
        ds.params_norm[idx].contiguous(),
        ds.spectra[idx].contiguous(),
        ds.metrics_norm[idx].contiguous(),
        sched.contiguous(),
        seeds,
    )


# ---------------------------------------------------------------------------
# Network description and the plain version
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ForwardTrainSpec:
    """What the kernel computes: F's widths, the loss weights, dropout, the
    clip, Adam's constants."""

    dims: tuple[int, ...] = (4, *BASELINE_HIDDEN, 258)
    spectrum_dim: int = 250
    spectrum_w: float = 1.0
    metrics_w: float = 1.0
    smoothness_w: float = 0.0
    l1_w: float = 0.0
    dropout_rate: float = 0.2
    clip: float = 1.0
    b1: float = _B1
    b2: float = _B2
    eps: float = _EPS
    slope: float = _SLOPE
    ln_eps: float = _LN_EPS
    bf16: bool = False         # bfloat16 operands of the TPU kernel's MXU products

    @property
    def n_hidden(self) -> int:
        return len(self.dims) - 2

    @property
    def offsets(self) -> tuple[tuple[int, int, int, int], ...]:
        """Float offsets of each layer's (W, b, LayerNorm weight, LayerNorm
        bias) in the flat buffer, -1 where the head has none.  The buffer
        follows ``ForwardMLP.named_parameters()``: W is (out, in)."""
        out, pos = [], 0
        for l in range(len(self.dims) - 1):
            din, dout = self.dims[l], self.dims[l + 1]
            w, b = pos, pos + din * dout
            pos = b + dout
            if l < self.n_hidden:
                out.append((w, b, pos, pos + dout))
                pos += 2 * dout
            else:
                out.append((w, b, -1, -1))
        return tuple(out)

    @property
    def num_params(self) -> int:
        w, b, _, _ = self.offsets[-1]
        return b + self.dims[-1]

    def views(self, flat: torch.Tensor, l: int) -> list[torch.Tensor]:
        """Layer l's tensors as views into ``flat``: W (out, in), b, and for
        hidden layers the LayerNorm weight and bias."""
        din, dout = self.dims[l], self.dims[l + 1]
        shapes = ((dout, din), (dout,), (dout,), (dout,))
        return [flat[o: o + math.prod(s)].view(s)
                for o, s in zip(self.offsets[l], shapes) if o >= 0]


def forward_train_spec(cfg: PiGanConfig, settings) -> ForwardTrainSpec:
    if settings.nll_w:
        raise ValueError(
            "ForwardStepSettings.nll_w > 0 needs the uncertainty forward model, "
            "which is not ported (ROADMAP.md queue 1, item 15)"
        )
    d = cfg.data
    return ForwardTrainSpec(
        dims=(d.param_dim, *cfg.forward_model.hidden_dims, d.spectrum_dim + d.metrics_dim),
        spectrum_dim=d.spectrum_dim,
        spectrum_w=float(settings.spectrum_w),
        metrics_w=float(settings.metrics_w),
        smoothness_w=float(settings.smoothness_w),
        l1_w=float(settings.l1_w),
        dropout_rate=float(cfg.forward_model.dropout_rate),
        clip=float(cfg.train.grad_clip),
        slope=float(cfg.forward_model.leaky_slope),
        bf16=cfg.train.compute_dtype == "bfloat16",
    )


def bf16_rounder(bf16: bool):
    """The operand rounding of the TPU kernels' MXU products, in both
    training kernels' plain versions: to bfloat16 (round to nearest even) and
    back, in the tensor's own type; the identity in float32 mode."""
    if not bf16:
        return lambda x: x
    return lambda x: x.to(torch.bfloat16).to(x.dtype)


# Deliberately wrong variants of the plain version's bfloat16 path, for
# checks of checks (``forward_train_plain(..., faults=)``).
FAULTS = (
    "bf16_head_rounded",     # the head's 8 metrics columns rounded to bfloat16
    "bf16_hidden_fp32",      # hidden layer 2's products (512 -> 1024) left in float32
)


@torch.no_grad()
def forward_train_plain(params: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                        streams: Streams, spec: ForwardTrainSpec,
                        faults: Sequence[str] = ()) -> torch.Tensor:
    """The kernel's math in torch ops, with its hand-derived backward and no
    autograd: T steps over the flat ``params``, ``m``, ``v`` in place.
    Returns the (T, 3) per-step (loss, spectrum_loss, metrics_loss).  With
    ``spec.bf16`` the operands of the TPU kernel's MXU products are rounded
    to bfloat16 before each product; with float64 buffers the same steps
    run in double, the rounded operands included.  ``faults`` (names of
    ``FAULTS``) makes it wrong on purpose."""
    unknown = set(faults) - set(FAULTS)
    if unknown:
        raise ValueError(f"unknown faults {sorted(unknown)}: use {FAULTS}")
    rb = bf16_rounder(spec.bf16)
    ident = lambda x: x                                             # noqa: E731
    rb_met = rb if "bf16_head_rounded" in faults else ident

    def rb_l(l):
        """The rounding of hidden layer l's products: none at the input layer."""
        return ident if l == 0 or (l == 2 and "bf16_hidden_fp32" in faults) else rb

    steps, batch, _ = streams.params_norm.shape
    S = spec.spectrum_dim
    n_out = spec.dims[-1] - S
    dev = params.device
    grads = torch.empty_like(params)
    rows = torch.empty((steps, 3), dtype=params.dtype, device=dev)
    use_drop = spec.dropout_rate > 0.0
    c_spec = spec.spectrum_w * 2.0
    c_met = spec.metrics_w * 2.0
    c_smooth = spec.smoothness_w * 2.0 / (batch * (S - 2))
    sched = streams.sched.to(device=dev, dtype=params.dtype)
    for t in range(steps):
        seed = int(streams.seeds[t])
        a = streams.params_norm[t].to(params.dtype)
        saved = []
        for l in range(spec.n_hidden):
            W, b, gamma, beta = spec.views(params, l)
            r = rb_l(l)
            z = r(a) @ r(W).T + b
            mu = z.mean(dim=-1, keepdim=True)
            var = torch.clamp((z * z).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
            ivar = torch.rsqrt(var + spec.ln_eps)
            tc = z - mu
            ln = tc * ivar * gamma + beta
            act = torch.where(ln >= 0.0, ln, spec.slope * ln)
            sc = None
            if use_drop:
                sc = dropout_scale(seed, l, batch, ln.shape[1], spec.dropout_rate,
                                   dev).to(params.dtype)
                act = act * sc
            saved.append((a, tc, ivar, ln, sc))
            a = act
        Wh, bh = spec.views(params, spec.n_hidden)
        if spec.bf16:
            pred = torch.cat([rb(a) @ rb(Wh[:S]).T + bh[:S],
                              rb_met(a) @ rb_met(Wh[S:]).T + bh[S:]], dim=1)
        else:
            pred = a @ Wh.T + bh
        ds_spec = pred[:, :S] - streams.spectra[t].to(params.dtype)
        ds_met = pred[:, S:] - streams.metrics_norm[t].to(params.dtype)
        spec_l = torch.sum(ds_spec * ds_spec) / (batch * S)
        met_l = torch.sum(ds_met * ds_met) / (batch * n_out)
        loss = spec.spectrum_w * spec_l + spec.metrics_w * met_l
        drecon = c_spec * ds_spec / (batch * S)
        dmet = c_met * ds_met / (batch * n_out)
        if spec.smoothness_w:
            p = pred[:, :S]
            d2 = (p[:, 2:] - p[:, 1:-1]) - (p[:, 1:-1] - p[:, :-2])
            loss = loss + spec.smoothness_w * torch.sum(d2 * d2) / (batch * (S - 2))
            d2p = torch.nn.functional.pad(d2, (0, 2))
            sh1 = torch.nn.functional.pad(d2p[:, :-1], (1, 0))
            sh2 = torch.nn.functional.pad(d2p[:, :-2], (2, 0))
            drecon = drecon + c_smooth * (d2p - 2.0 * sh1 + sh2)
        if spec.l1_w:
            loss = loss + spec.l1_w * (
                torch.sum(ds_spec.abs()) / (batch * S)
                + torch.sum(ds_met.abs()) / (batch * n_out))
            drecon = drecon + spec.l1_w * torch.sign(ds_spec) / (batch * S)
            dmet = dmet + spec.l1_w * torch.sign(ds_met) / (batch * n_out)
        rows[t, 0], rows[t, 1], rows[t, 2] = loss, spec_l, met_l

        dpred = torch.cat([drecon, dmet], dim=1)
        gWh, gbh = spec.views(grads, spec.n_hidden)
        if spec.bf16:
            gWh[:S].copy_(rb(drecon).T @ rb(a))
            gWh[S:].copy_(rb_met(dmet).T @ rb_met(a))
            da = rb(drecon) @ rb(Wh[:S]) + rb_met(dmet) @ rb_met(Wh[S:])
        else:
            gWh.copy_(dpred.T @ a)
            da = dpred @ Wh
        gbh.copy_(dpred.sum(dim=0))
        for l in range(spec.n_hidden - 1, -1, -1):
            W, _, gamma, _ = spec.views(params, l)
            gW, gb, ggamma, gbeta = spec.views(grads, l)
            a_in, tc, ivar, ln, sc = saved[l]
            if sc is not None:
                da = da * sc
            dln = da * torch.where(ln >= 0.0, torch.ones_like(ln), torch.full_like(ln, spec.slope))
            ggamma.copy_(torch.sum(dln * (tc * ivar), dim=0))
            gbeta.copy_(torch.sum(dln, dim=0))
            dxh = dln * gamma
            dvar = torch.sum(dxh * tc, dim=-1, keepdim=True) * (-0.5) * ivar * ivar * ivar
            dt = dxh * ivar
            dt = dt - dt.mean(dim=-1, keepdim=True) + dvar * 2.0 * tc / tc.shape[1]
            r = rb_l(l)
            gW.copy_(r(dt).T @ r(a_in))
            gb.copy_(dt.sum(dim=0))
            if l > 0:
                da = r(dt) @ r(W)

        lr, inv1, inv2 = sched[t]
        norm = torch.sqrt(torch.sum(grads * grads))
        g = grads * torch.where(norm < spec.clip, 1.0, spec.clip / norm)
        m.copy_(spec.b1 * m + (1.0 - spec.b1) * g)
        v.copy_(spec.b2 * v + (1.0 - spec.b2) * g * g)
        params.sub_(lr * (m * inv1) / (torch.sqrt(v * inv2) + spec.eps))
    return rows


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def workspace_floats(spec: ForwardTrainSpec, batch: int) -> int:
    """Scratch the kernel needs, in floats (``csrc/forward_train.cu``
    computes the same layout and refuses a smaller buffer): per hidden layer
    four (B, C) buffers and B inverse deviations, the head's prediction and
    its gradient, three (B, max C) gradient buffers, the flat gradient and
    the norm partials."""
    hidden = spec.dims[1:-1]
    return (sum(4 * batch * c + batch for c in hidden) + 2 * batch * spec.dims[-1]
            + 3 * batch * max(spec.dims) + spec.num_params + _NORM_PARTS)


def saved_dropout(work: torch.Tensor, spec: ForwardTrainSpec, batch: int) -> list:
    """Views of the (B, C) dropout factors that the kernel left in ``work``
    for each hidden layer: those of the last step it ran (written only when
    the rate is above 0)."""
    out, pos = [], 0
    for c in spec.dims[1:-1]:
        out.append(work[pos + 2 * batch * c: pos + 3 * batch * c].view(batch, c))
        pos += 4 * batch * c + batch
    return out


def _check(params, m, v, streams: Streams, spec: ForwardTrainSpec) -> bool:
    """Validate the call; True when it goes to the kernel (CUDA tensors)."""
    p = spec.num_params
    for name, t in (("params", params), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or t.shape != (p,) or not t.is_contiguous():
            raise ValueError(f"forward_train: {name} must be contiguous float32 ({p},)")
    steps, batch, din = streams.params_norm.shape
    want = {
        "params_norm": (steps, batch, spec.dims[0]),
        "spectra": (steps, batch, spec.spectrum_dim),
        "metrics_norm": (steps, batch, spec.dims[-1] - spec.spectrum_dim),
    }
    for name, shape in want.items():
        t = getattr(streams, name)
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"forward_train: stream {name} must be contiguous "
                             f"float32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != params.device:
            raise ValueError(f"forward_train: {name} on {t.device}, state on {params.device}")
    if m.device != params.device or v.device != params.device:
        raise ValueError("forward_train: params, m and v must share a device")
    if tuple(streams.sched.shape) != (steps, 3) or streams.seeds.numel() != steps:
        raise ValueError("forward_train: sched must be (T, 3) and seeds (T,)")
    if params.device.type == "cpu":
        return False
    if params.device.type != "cuda":
        raise ValueError(f"forward_train: no kernel for device {params.device}")
    check_capability(params.device.index)
    return True


def forward_train(params: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                  streams: Streams, spec: ForwardTrainSpec,
                  work: torch.Tensor | None = None) -> torch.Tensor:
    """T training steps over the flat state in place, one kernel launch per
    call on the card; returns the (T, 3) per-step metric rows.  ``work``
    optionally supplies the kernel's scratch (``workspace_floats`` floats),
    so that a caller can read what the last step left there
    (``saved_dropout``)."""
    if not _check(params, m, v, streams, spec):
        return forward_train_plain(params, m, v, streams, spec)
    steps, batch, _ = streams.params_norm.shape
    dev = params.device
    rows = torch.empty((steps, 3), dtype=torch.float32, device=dev)
    if steps == 0:
        return rows
    n_work = workspace_floats(spec, batch)
    if work is None:
        work = torch.empty(n_work, dtype=torch.float32, device=dev)
    elif (work.dtype != torch.float32 or work.device != dev or not work.is_contiguous()
          or work.numel() < n_work):
        raise ValueError(f"forward_train: work must be contiguous float32 with at least "
                         f"{n_work} floats on {dev}")
    sched = streams.sched.to(torch.float32).contiguous()
    seeds = [int(s) for s in streams.seeds.tolist()]
    n_layers = len(spec.dims) - 1
    hp = (spec.spectrum_w, spec.metrics_w, spec.smoothness_w, spec.l1_w,
          spec.dropout_rate, spec.clip, spec.b1, spec.b2, spec.eps, spec.slope,
          spec.ln_eps)
    launch(
        "forward_train", dev,
        params.data_ptr(), m.data_ptr(), v.data_ptr(),
        streams.params_norm.data_ptr(), streams.spectra.data_ptr(),
        streams.metrics_norm.data_ptr(),
        (ctypes.c_float * (3 * steps))(*sched.reshape(-1).tolist()),
        (ctypes.c_uint32 * steps)(*seeds),
        rows.data_ptr(), work.data_ptr(), n_work,
        (ctypes.c_int * len(spec.dims))(*spec.dims), spec.n_hidden,
        (ctypes.c_longlong * (4 * n_layers))(*(o for offs in spec.offsets for o in offs)),
        spec.spectrum_dim, batch, steps,
        (ctypes.c_double * len(hp))(*hp),
        keep_threshold(spec.dropout_rate), int(spec.bf16),
    )
    return rows


# ---------------------------------------------------------------------------
# The multi-epoch function
# ---------------------------------------------------------------------------


def epoch_means(rows: torch.Tensor, epochs: int) -> dict[str, torch.Tensor]:
    """(T, 3) per-step rows -> {key: (E,) per-epoch means}."""
    per_epoch = rows.reshape(epochs, -1, 3).mean(dim=1)
    return {k: per_epoch[:, j] for j, k in enumerate(METRIC_KEYS)}


def make_forward_epoch_fn(cfg: PiGanConfig, fsettings, lr: float | None = None,
                          total_epochs: int | None = None, schedule: str = "cosine"):
    """multi_epoch(state, ds, scales, indices=None, seeds=None) ->
    (state, {key: (E,) per-epoch means}) through ``forward_train``, one
    launch per call: the contract of the eager
    ``make_multi_epoch_fn(make_forward_step(...), B)``.

    ``scales`` (E,) multiplies each epoch's learning rate (the plateau
    controller's scale).  ``lr`` / ``total_epochs`` / ``schedule`` set the
    schedule as the Trainer's override does; by default it is the config's
    (fwd_pretrain_lr, cosine to 0 over fwd_pretrain_epochs).  The state is
    updated in place and returned."""
    from ..train.schedules import make_schedule

    reason = supports_forward_kernel(cfg)
    if reason is not None:
        raise ValueError(f"forward-training kernel unsupported here: {reason}")
    spec = forward_train_spec(cfg, fsettings)
    batch = cfg.train.batch_size
    base_lr = cfg.train.fwd_pretrain_lr if lr is None else lr
    horizon = cfg.train.fwd_pretrain_epochs if total_epochs is None else total_epochs

    def multi_epoch(state, ds: ThzDataset, scales: Sequence[float] | torch.Tensor,
                    indices: torch.Tensor | None = None,
                    seeds: torch.Tensor | None = None):
        scales = torch.as_tensor(scales, dtype=torch.float32).reshape(-1)
        epochs = int(scales.numel())
        spe = max(1, ds.num_samples // batch)
        indices, seeds = resolve_draws(state.generator, ds.num_samples, batch,
                                       epochs, indices, seeds)
        sched_fn = make_schedule(schedule, base_lr, horizon, spe, schedule_alpha=0.0)
        streams = build_streams(ds, indices, seeds, scales, state.opt.count, sched_fn)
        rows = forward_train(state.params, state.opt.m, state.opt.v, streams, spec)
        steps = epochs * spe
        state.step += steps
        state.opt.count += steps
        return state, epoch_means(rows, epochs)

    return multi_epoch
