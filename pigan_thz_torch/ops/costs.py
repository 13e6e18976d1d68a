"""Analytic cost model of the PI-GAN training step, and the card's peaks:
the port of ``pigan_thz_tpu/ops/costs.py``.

``pigan_step_costs`` counts one D-then-G step's FLOPs, streamed bytes and
resident state bytes, so that a throughput can be given as TFLOP/s and MFU
beside steps/s.  The field names are the JAX package's:

- ``model_flops``: 2 x the MACs of the reference shapes (S = 250 ...), the
  numerator of MFU, the same arithmetic as the JAX package's;
- ``padded_flops``: the products the GAN-training kernel (``csrc/
  gan_train.cu``, K2) executes in a step.  It pads nothing (every product
  runs at its true width), but it computes some products the logical count
  leaves out and skips some it keeps: D's input gradient stops at the four
  parameter columns in the adversarial pass, the first layers take no input
  gradient, F's input backward runs only without ``detach_forward``;
- ``stream_bytes``: what K2 reads a step from its streams (the gathered
  batch, the schedule lanes, the noise streams that are on) and writes (the
  metric row);
- ``state_bytes``: K2's state, the buffers it keeps and updates in place
  (G's and D's parameters and Adam's two moments, G's BatchNorm running
  stats, the frozen F, the EMA when on), counted from the port's own spec
  tables (``ops/gan_train.py:gan_train_spec``);
- ``xla_hbm_bytes``: the JAX package's count of the XLA step's state
  traffic, the same arithmetic.  For the port it is the eager step's
  (``train/steps.py``): each step reads and writes G's and D's parameters
  and moments, reads F and the batch.

The peaks are the card's, by the prefix of ``torch.cuda.get_device_name()``
(NVIDIA's H100 data sheets, dense, no sparsity): fp32 outside the tensor
cores, since the port's kernels multiply in fp32 (K1-K4) or in 3xTF32 (K5,
K6), and HBM.  An unknown name gives None, and MFU is then left out.
``roofline`` is the bound every kernel of ``chip_smoke.py``'s record is
held to; ``design_bound_3xtf32`` the bound of K5 / K6's design.
"""

from __future__ import annotations

from dataclasses import dataclass

# H100 SXM (the card of the port's measurements), NVIDIA's data sheet
PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # HBM3
PEAK_TF32_FLOPS = 495e12     # TF32 dense tensor cores
PEAK_BF16_FLOPS = 989e12     # bf16 dense tensor cores

# fp32 peak (FLOP/s) and memory rate (bytes/s) by device-name prefix
FP32_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": PEAK_FP32_FLOPS,    # SXM
    "NVIDIA H100 PCIe": 51e12,
}
HBM_PEAK_BYTES = {
    "NVIDIA H100 80GB HBM3": PEAK_BYTES_PER_S,
    "NVIDIA H100 PCIe": 2.0e12,
}

_ROW_WIDTH = 11      # a step's metric row (ops/gan_train.py:ROW_WIDTH)
_SCHED_LANES = 8     # a step's schedule lanes (ops/gan_train.py:SCHED_LANES)


def _by_prefix(table: dict, device_name: str) -> float | None:
    for prefix, peak in table.items():
        if device_name.startswith(prefix):
            return peak
    return None


def device_peak_flops(device_name: str) -> float | None:
    """The fp32 peak of the card named ``device_name``, or None."""
    return _by_prefix(FP32_PEAK_FLOPS, device_name)


def device_peak_hbm(device_name: str) -> float | None:
    """The memory rate of the card named ``device_name``, or None."""
    return _by_prefix(HBM_PEAK_BYTES, device_name)


def roofline(flops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for work of
    ``flops`` fp32 operations and ``nbytes`` bytes moved once."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def design_bound_3xtf32(flops: float, nbytes: float) -> float:
    """A bound for K5 / K6's design, not the function's roofline: three TF32
    products for each fp32 one (3xTF32) at the tensor-core peak, ms."""
    return max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3


def compiled_fn_analysis(fn, *args, **kwargs) -> dict:
    """The FLOPs of ``fn(*args, **kwargs)`` as PyTorch counts them, the one
    generic FLOP source for the enhanced variants (conv, attention,
    residual, branched: arbitrary graphs).  Returns ``{"flops": float,
    "bytes_accessed": float}``, the JAX package's keys.

    ``fn`` runs once under ``torch.utils.flop_counter.FlopCounterMode``,
    which counts the matrix products, convolutions and attention (2 x MACs,
    their backward too where ``fn`` runs one).  XLA's cost analysis counts
    besides every elementwise and reduction op (norms, activations, adds)
    and the bytes of the optimised program; FlopCounterMode counts neither,
    so ``bytes_accessed`` is 0.0 and ``flops`` is the products' alone, a few
    per cent below XLA's on these trios."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": 0.0}


def _chain_macs(dims: tuple) -> int:
    """Per-sample MACs of one forward pass through Dense dims[0]->...->[-1]."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


@dataclass(frozen=True)
class StepCosts:
    model_flops: int        # logical FLOPs per train step (both phases)
    padded_flops: int       # FLOPs the GAN-training kernel executes a step
    stream_bytes: int       # bytes the kernel reads and writes a step besides its state
    state_bytes: int        # the kernel's state (params, moments, stats, frozen F, EMA)
    xla_hbm_bytes: int      # state traffic a step of the eager (JAX: XLA) step


def pigan_step_costs(cfg, settings) -> StepCosts:
    """The cost of ONE D-then-G training step under ``settings`` (a
    ``StepSettings``) at ``cfg``'s widths and batch.

    ``model_flops`` is the JAX package's inventory: D phase, G forward (B),
    D forward and backward on 2B rows; WGAN-GP its penalty chain (3 x D);
    G phase, D forward and input gradient (B), G backward, F forward, F's
    input gradient without ``detach_forward``; ``cycle_w`` and
    ``stability_w`` a second G pass forward and backward each (3 x G).  A
    full backward costs 2 x its forward MACs, an input-gradient-only chain
    1 x.  ``padded_flops`` counts K2's products (module docstring)."""
    S, P, M = cfg.data.spectrum_dim, cfg.data.param_dim, cfg.data.metrics_dim
    B = cfg.train.batch_size
    gh = tuple(cfg.generator.hidden_dims)
    dh = tuple(cfg.discriminator.hidden_dims)
    fh = tuple(cfg.forward_model.hidden_dims)
    g_dims, d_dims, f_dims = (S, *gh, P), (S + P, *dh, 1), (P, *fh, S + M)
    gm, dm, fm = _chain_macs(g_dims), _chain_macs(d_dims), _chain_macs(f_dims)

    wgan = settings.gan_loss == "wgan_gp"
    cyc = float(getattr(settings, "cycle_w", 0.0)) > 0.0
    stab = float(getattr(settings, "stability_w", 0.0)) > 0.0
    inoise = float(getattr(settings, "instance_noise", 0.0)) > 0.0
    detach = bool(settings.detach_forward)

    macs = gm + 2 * dm + 4 * dm          # D phase: G fwd, D fwd 2B, D bwd 2B
    if wgan:
        macs += 3 * dm                   # GP fwd chain + 2nd-order bwd
    macs += dm + dm + 2 * gm + fm        # G phase: D fwd+dX, G bwd, F fwd
    if not detach:
        macs += fm                       # F dX
    if cyc:
        macs += 3 * gm                   # second G pass fwd + bwd
    if stab:
        macs += 3 * gm                   # noisy G fwd + hand adjoint
    model_flops = 2 * macs * B

    # K2's products a step (chip_smoke.py's bound counts the same): G forward,
    # dW, dX but the first layer's; D on 2B rows forward, dW, dX but the first
    # layer's; the adversarial pass forward and dX down to the parameter
    # columns; F forward and, through F, its input gradient
    g_first, d_first = g_dims[0] * g_dims[1], d_dims[0] * d_dims[1]
    k2 = (3 * gm - g_first) + 2 * (3 * dm - d_first) + (2 * dm - (d_dims[0] - P) * d_dims[1])
    k2 += fm if detach else 2 * fm
    if wgan:                             # the penalty's 8 B-row products of D's first two layers
        k2 += 4 * d_dims[0] * d_dims[1] + 4 * d_dims[1] * d_dims[2]
    if cyc:                              # forward, dW, dX (into F's output unless detached)
        k2 += 3 * gm - (g_first if detach else 0)
    if stab:                             # forward, dW; its input gradient is dropped
        k2 += 3 * gm - g_first
    padded_flops = 2 * k2 * B

    stream = B * (S + P + M) + _SCHED_LANES + _ROW_WIDTH
    if inoise:
        stream += 2 * B * S
    if stab:
        stream += B * S
    if wgan:
        stream += B
    stream_bytes = 4 * stream

    from .gan_train import GanTrainSpec  # noqa: PLC0415

    spec = GanTrainSpec(spectrum_dim=S, g_hidden=gh, d_hidden=dh, f_hidden=fh)
    ema = float(getattr(settings, "ema_decay", 0.0)) > 0.0
    state_elems = (3 * (spec.num_g + spec.num_d) + 2 * sum(gh) + spec.f_spec.num_params
                   + (spec.num_g if ema else 0))
    state_bytes = 4 * state_elems

    # the JAX package's XLA-step traffic: read AND write params + mu + nu of
    # G and D, read the frozen F, stream the batch
    g_params = gm + sum(gh) + P + 2 * (gh[0] + gh[1])
    d_params = dm + sum(dh) + 1
    f_params = fm + sum(fh) + S + M + 2 * sum(fh)
    xla_hbm = 4 * (2 * 3 * (g_params + d_params) + f_params + B * (S + P + M))
    return StepCosts(model_flops=int(model_flops), padded_flops=int(padded_flops),
                     stream_bytes=int(stream_bytes), state_bytes=int(state_bytes),
                     xla_hbm_bytes=int(xla_hbm))
