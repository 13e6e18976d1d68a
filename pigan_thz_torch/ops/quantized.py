"""Int8 quantized serving path for the baseline inverse-design cycle.

The port of ``pigan_thz_tpu/ops/quantized.py``: the serving dtype ladder's
third rung (fp32 -> bf16 -> int8), standard symmetric post-training
quantization:

- Weights: per-output-channel symmetric int8, ``w_q = round(W / sw)`` with
  ``sw[j] = max|W[:, j]| / 127``, computed ONCE at build time.  The
  generator's BatchNorms are folded into the dense weights first
  (``ops/fused_kernels.py:fold_batchnorm``, exact for inference).
- Activations: dynamic per-row symmetric int8, ``sx[i] = max|x[i, :]| / 127``.
- Matmul: int8 x int8 -> int32 through ``torch._int_mm`` on both devices
  (``int_mm``).  The JAX package computes this product outside any Pallas
  kernel (``lax.dot_general`` with an int32 result), so it stays a library
  product here.  ``int_mm`` zero-pads the operands to the shapes CUDA's
  ``_int_mm`` takes (more than 16 rows, K and N multiples of 8) and, as
  cuBLASLt's int8 path on an H100 refuses some of those (17 to 48 rows
  that are not a multiple of 32 with K <= 64 and N >= 256, CUDA 12.8), the
  rows to a multiple of 32; then it slices the result.  Zero padding is
  exact for integers, and the int32 sums cannot overflow (127² x 1024 <
  2³¹).
- Everything BETWEEN matmuls (dequant, LayerNorm, LeakyReLU / ReLU / tanh,
  bias) runs in fp32: ``out = acc * (sx * sw) + b``.

Rounding is half to even (``torch.round``, as ``jnp.round``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .fused_kernels import extract_forward_mlp_weights, extract_generator_weights

# CUDA's _int_mm: more than 16 rows, K and N multiples of 8; the rows a
# multiple of 32 for every shape of the chains on an H100 (see above).
INT_MM_ROW_ALIGN, INT_MM_K_ALIGN, INT_MM_N_ALIGN = 32, 8, 8
_TINY = torch.finfo(torch.float32).tiny


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 x_q (B, K) @ int8 w_q (K, N) -> exact int32 (B, N) through
    ``torch._int_mm``, the operands zero-padded to its shape rules on every
    device (so the CPU runs the padding the card needs)."""
    b, k = x_q.shape
    n = w_q.shape[1]
    rows = _round_up(b, INT_MM_ROW_ALIGN)
    kp, np_ = _round_up(k, INT_MM_K_ALIGN), _round_up(n, INT_MM_N_ALIGN)
    if (rows, kp) != (b, k):
        x_q = F.pad(x_q, (0, kp - k, 0, rows - b))
    if (kp, np_) != (k, n):
        w_q = F.pad(w_q, (0, np_ - n, 0, kp - k))
    acc = torch._int_mm(x_q.contiguous(), w_q.contiguous())
    return acc[:b, :n]


def quantize_weight(W: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: returns (w_q int8 (I, O), sw (O,))
    with W ~= w_q * sw[None, :]."""
    W = W.to(torch.float32)
    sw = torch.clamp(W.abs().amax(dim=0) / 127.0, min=_TINY)
    w_q = torch.clamp(torch.round(W / sw[None, :]), -127, 127).to(torch.int8)
    return w_q, sw


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8: returns (x_q int8 (B, I), sx (B, 1))."""
    sx = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127.0, min=_TINY)
    x_q = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    return x_q, sx


def qdense(x: torch.Tensor, w_q: torch.Tensor, sw: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """fp32 x (B, I) -> fp32 (B, O) through an int8 x int8 -> int32 product."""
    x_q, sx = _quantize_rows(x)
    acc = int_mm(x_q, w_q)
    return acc.to(torch.float32) * (sx * sw[None, :]) + b[None, :]


def quantize_dense_chain(layers: Sequence[tuple], head: tuple):
    """[(W, b)] + (W, b) -> quantized [(w_q, sw, b)] + (w_q, sw, b)."""
    q_layers = [(*quantize_weight(W), b.to(torch.float32)) for W, b in layers]
    return q_layers, (*quantize_weight(head[0]), head[1].to(torch.float32))


def quantize_generator(generator: nn.Module, num_hidden: int = 2):
    """BatchNorm-folded baseline MLPGenerator -> int8 chain (refuses any
    other layout, as ``extract_generator_weights`` does)."""
    layers, head = extract_generator_weights(generator, num_hidden)
    return quantize_dense_chain(
        [(W.detach(), b.detach()) for W, b in layers], tuple(t.detach() for t in head))


def quantize_forward(forward_model: nn.Module, num_blocks: int = 5):
    """Baseline ForwardMLP -> (int8 blocks [(w_q, sw, b, ln_scale, ln_bias)],
    int8 head (w_q, sw, b))."""
    layers, head = extract_forward_mlp_weights(forward_model, num_blocks)
    q_layers = [(*quantize_weight(W.detach()), *(t.detach().to(torch.float32)
                                                  for t in (b, scale, bias)))
                for W, b, scale, bias in layers]
    return q_layers, (*quantize_weight(head[0].detach()), head[1].detach().to(torch.float32))


def int8_generator_apply(q_chain, spectra: torch.Tensor) -> torch.Tensor:
    """spectra (B, S) -> normalised params (B, 4) through the int8 chain."""
    q_layers, q_head = q_chain
    h = spectra.to(torch.float32)
    for w_q, sw, b in q_layers:
        h = torch.relu(qdense(h, w_q, sw, b))
    return torch.tanh(qdense(h, *q_head))


def int8_forward_apply(q_chain, params_norm: torch.Tensor, spectrum_dim: int,
                       leaky_slope: float = 0.2, ln_eps: float = 1e-6
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """params_norm (B, 4) -> (spectrum (B, S), metrics (B, 8)) through int8."""
    q_layers, q_head = q_chain
    h = params_norm.to(torch.float32)
    for w_q, sw, b, scale, bias in q_layers:
        h = qdense(h, w_q, sw, b)
        mean = h.mean(dim=-1, keepdim=True)
        var = ((h - mean) ** 2).mean(dim=-1, keepdim=True)
        h = (h - mean) * torch.rsqrt(var + ln_eps)
        h = h * scale[None, :] + bias[None, :]
        h = torch.where(h >= 0.0, h, leaky_slope * h)
    out = qdense(h, *q_head)
    return out[..., :spectrum_dim], out[..., spectrum_dim:]


def make_int8_cycle_fn(generator: nn.Module, forward_model: nn.Module, spectrum_dim: int):
    """Build-once int8 cycle: spectra (B, S) -> (params_norm, spec, metrics).

    Quantization (weight scales, BatchNorm folding) happens here, once, on
    the device of the modules' weights; the returned callable closes over
    the int8 weights."""
    qg = quantize_generator(generator)
    qf = quantize_forward(forward_model)

    def fn(spectra: torch.Tensor):
        pn = int8_generator_apply(qg, spectra)
        spec, met = int8_forward_apply(qf, pn, spectrum_dim)
        return pn, spec, met

    return fn
