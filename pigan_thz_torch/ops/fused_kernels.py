"""Fused MLP-chain serving kernels: the port of pigan_thz_tpu/ops/pallas_kernels.py.

Two hand-written CUDA kernels (``csrc/fused_mlp_chain.cu``) run the serving
cycle's two models on the card, each as one launch over the whole chain:

- ``fused_mlp_forward`` (forward surrogate): per hidden layer
  h@W+b -> LayerNorm (two-pass variance, eps 1e-6) -> LeakyReLU 0.2, then a
  linear head; ``forward_surrogate_fused`` splits it 250 | 8.
- ``fused_dense_chain`` (generator): ReLU hidden layers with BatchNorm
  folded into the dense weights, tanh head; ``generator_fused``.

Weights are packed once per model (``pack_forward_model``,
``pack_generator``) into one contiguous fp32 buffer on the serving device
plus an offsets table; BatchNorm is folded at that point, not per call.

Each wrapper checks dtype, shape, device and contiguity, then routes by the
input's device: a CPU tensor goes to the kernel's plain PyTorch version
(``*_plain``, the reference the kernel is tested against), a CUDA tensor to
the kernel, and anything else raises.  There is no fallback from a failed
launch.  ``LAUNCHES[name]`` counts the kernel's successful launches, so a
run can show that its path went through the kernel.  The wrappers serve
inference only: they carry no gradient.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

# Successful kernel launches, by kernel (one dict for all the port's kernels).
from ._cuda_build import LAUNCHES, check_capability, launch


# ---------------------------------------------------------------------------
# Weight extraction (reference torch layout -> (in, out) chains)
# ---------------------------------------------------------------------------


def extract_forward_mlp_weights(forward_model: nn.Module, num_blocks: int = 5):
    """A ForwardMLP -> per-layer (W, b, scale, shift) with W as (in, out),
    plus the head (W, b).  Raises on any other layout: an enhanced forward
    model's weights would otherwise be mis-wired into a wrong chain."""
    sd = forward_model.state_dict()
    head_idx = 4 * num_blocks
    expected = {
        f"model.{i}.{p}"
        for blk in range(num_blocks)
        for i in (4 * blk, 4 * blk + 1)
        for p in ("weight", "bias")
    } | {f"model.{head_idx}.weight", f"model.{head_idx}.bias"}
    if set(sd) != expected:
        raise ValueError(
            "fused kernel supports the baseline ForwardMLP only; got state_dict "
            f"keys {sorted(sd)} (expected {sorted(expected)})"
        )
    layers = [
        (
            sd[f"model.{4 * i}.weight"].T,
            sd[f"model.{4 * i}.bias"],
            sd[f"model.{4 * i + 1}.weight"],
            sd[f"model.{4 * i + 1}.bias"],
        )
        for i in range(num_blocks)
    ]
    head = (sd[f"model.{head_idx}.weight"].T, sd[f"model.{head_idx}.bias"])
    return layers, head


def fold_batchnorm(W, b, scale, bias, mean, var, eps: float = 1e-5):
    """Fold an eval-mode BatchNorm into the preceding Dense (W as (in, out)):
    BN(xW+b) = (xW+b-mean)/sqrt(var+eps)*scale+bias = x(W*s) + (b-mean)*s+bias
    with s = scale/sqrt(var+eps).  Exact for inference (running stats)."""
    s = scale / torch.sqrt(var + eps)
    return W * s[None, :], (b - mean) * s + bias


def extract_generator_weights(generator: nn.Module, num_hidden: int = 2):
    """An MLPGenerator (Dense->BatchNorm->ReLU blocks + Dense head, tanh) ->
    BatchNorm-folded [(W, b)] chain with W as (in, out), plus the head.
    Raises on any other layout."""
    sd = generator.state_dict()
    head_idx = 3 * num_hidden
    bn = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
    expected = (
        {f"main.{3 * i}.{p}" for i in range(num_hidden) for p in ("weight", "bias")}
        | {f"main.{3 * i + 1}.{p}" for i in range(num_hidden) for p in bn}
        | {f"main.{head_idx}.weight", f"main.{head_idx}.bias"}
    )
    if set(sd) != expected:
        raise ValueError(
            "fused generator supports the baseline MLPGenerator (BatchNorm "
            f"blocks) only; got state_dict keys {sorted(sd)}"
        )
    layers = []
    for i in range(num_hidden):
        lin, norm = f"main.{3 * i}", f"main.{3 * i + 1}"
        layers.append(fold_batchnorm(
            sd[f"{lin}.weight"].T, sd[f"{lin}.bias"],
            sd[f"{norm}.weight"], sd[f"{norm}.bias"],
            sd[f"{norm}.running_mean"], sd[f"{norm}.running_var"],
        ))
    head = (sd[f"main.{head_idx}.weight"].T, sd[f"main.{head_idx}.bias"])
    return layers, head


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PackedChain:
    """One model's weights in one contiguous fp32 buffer.

    Layer l maps dims[l] -> dims[l + 1]; ``offsets[l]`` holds the float
    offsets of its (W, b, scale, shift) in ``weights``, -1 where the layer
    has no such tensor.  W is stored (in, out) row-major, as in JAX."""

    weights: torch.Tensor
    offsets: tuple[tuple[int, int, int, int], ...]
    dims: tuple[int, ...]
    layer_norm: bool

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def device(self) -> torch.device:
        return self.weights.device

    def layer(self, l: int) -> tuple[torch.Tensor, ...]:
        """Views of layer l's tensors: (W, b) or (W, b, scale, shift)."""
        din, dout = self.dims[l], self.dims[l + 1]
        shapes = ((din, dout), (dout,), (dout,), (dout,))
        return tuple(
            self.weights[off : off + math.prod(shape)].view(shape)
            for off, shape in zip(self.offsets[l], shapes)
            if off >= 0
        )


def pack_chain(
    layers: Sequence[tuple], head: tuple, device: torch.device | str | None = None
) -> PackedChain:
    """Pack hidden ``layers`` [(W, b)] or [(W, b, scale, shift)] (W as
    (in, out)) and ``head`` (W, b) into a ``PackedChain`` on ``device``
    (default: where the weights are)."""
    arity = {len(t) for t in layers}
    if len(arity) > 1 or arity - {2, 4} or len(head) != 2:
        raise ValueError("layers must all be (W, b) or all (W, b, scale, shift); head (W, b)")
    entries = [*layers, head]
    dims = [int(entries[0][0].shape[0])] + [int(t[0].shape[1]) for t in entries]
    chunks: list[torch.Tensor] = []
    offsets = []
    pos = 0
    for l, tensors in enumerate(entries):
        din, dout = dims[l], dims[l + 1]
        offs = []
        for k, t in enumerate(tensors):
            want = (din, dout) if k == 0 else (dout,)
            if tuple(t.shape) != want:
                raise ValueError(f"layer {l}: tensor {k} is {tuple(t.shape)}, expected {want}")
            offs.append(pos)
            chunks.append(t.detach().to(torch.float32).reshape(-1))
            pos += t.numel()
        offsets.append(tuple(offs + [-1] * (4 - len(offs))))
    if device is None:
        device = head[0].device
    weights = torch.cat([c.to(device) for c in chunks]).contiguous()
    return PackedChain(weights, tuple(offsets), tuple(dims), layer_norm=arity == {4})


def pack_forward_model(
    forward_model: nn.Module, device: torch.device | str | None = None
) -> PackedChain:
    return pack_chain(*extract_forward_mlp_weights(forward_model), device)


def pack_generator(
    generator: nn.Module, device: torch.device | str | None = None
) -> PackedChain:
    """Folds BatchNorm into the dense weights, once, then packs."""
    return pack_chain(*extract_generator_weights(generator), device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' reference; the CPU path)
# ---------------------------------------------------------------------------


def fused_mlp_forward_plain(
    x: torch.Tensor, packed: PackedChain, leaky_slope: float = 0.2, ln_eps: float = 1e-6
) -> torch.Tensor:
    h = x
    for l in range(packed.n_layers - 1):
        W, b, scale, shift = packed.layer(l)
        h = h @ W + b
        mean = h.mean(dim=-1, keepdim=True)
        var = ((h - mean) ** 2).mean(dim=-1, keepdim=True)
        h = (h - mean) * torch.rsqrt(var + ln_eps)
        h = h * scale + shift
        h = torch.where(h >= 0.0, h, leaky_slope * h)
    W, b = packed.layer(packed.n_layers - 1)
    return h @ W + b


def fused_dense_chain_plain(x: torch.Tensor, packed: PackedChain) -> torch.Tensor:
    h = x
    for l in range(packed.n_layers - 1):
        W, b = packed.layer(l)
        h = torch.relu(h @ W + b)
    W, b = packed.layer(packed.n_layers - 1)
    return torch.tanh(h @ W + b)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, packed: PackedChain, layer_norm: bool, name: str) -> bool:
    """Validate the call; True when it goes to the kernel (CUDA input)."""
    if packed.layer_norm != layer_norm:
        raise ValueError(f"{name}: packed chain has layer_norm={packed.layer_norm}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 input, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != packed.dims[0]:
        raise ValueError(f"{name}: expected input (B, {packed.dims[0]}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device != packed.device:
        raise ValueError(f"{name}: input on {x.device}, weights on {packed.device}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    check_capability(x.device.index)
    return True


def _launch(name: str, x: torch.Tensor, packed: PackedChain, *scalars) -> torch.Tensor:
    batch = x.shape[0]
    out = torch.empty((batch, packed.dims[-1]), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    offsets = (ctypes.c_longlong * (4 * packed.n_layers))(
        *(o for offs in packed.offsets for o in offs)
    )
    dims = (ctypes.c_int * len(packed.dims))(*packed.dims)
    launch(name, x.device, x.data_ptr(), out.data_ptr(), packed.weights.data_ptr(),
           offsets, dims, packed.n_layers, batch, *scalars)
    return out


def fused_mlp_forward(
    x: torch.Tensor, packed: PackedChain, leaky_slope: float = 0.2, ln_eps: float = 1e-6
) -> torch.Tensor:
    """Fused LayerNorm-MLP chain: x (B, D_in) -> (B, D_out), one launch."""
    if not _check(x, packed, True, "fused_mlp_forward"):
        return fused_mlp_forward_plain(x, packed, leaky_slope, ln_eps)
    return _launch("fused_mlp_forward", x, packed, leaky_slope, ln_eps)


def fused_dense_chain(x: torch.Tensor, packed: PackedChain) -> torch.Tensor:
    """Fused dense chain, ReLU hidden layers and tanh head (fold norms
    first): x (B, D_in) -> (B, D_out), one launch."""
    if not _check(x, packed, False, "fused_dense_chain"):
        return fused_dense_chain_plain(x, packed)
    return _launch("fused_dense_chain", x, packed)


def generator_fused(packed: PackedChain, spectra: torch.Tensor) -> torch.Tensor:
    """The fused counterpart of ``MLPGenerator`` in eval mode:
    spectra (B, S) -> normalized params (B, 4)."""
    return fused_dense_chain(spectra, packed)


def forward_surrogate_fused(
    packed: PackedChain, params_norm: torch.Tensor, spectrum_dim: int = 250
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused counterpart of ``ForwardMLP`` in eval mode:
    params (B, 4) -> (spectrum (B, 250), metrics (B, 8)), views of one
    (B, 258) output."""
    out = fused_mlp_forward(params_norm, packed)
    return out[:, :spectrum_dim], out[:, spectrum_dim:]
