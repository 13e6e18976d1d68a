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
plus an offsets table, zero-padded to the tensor-core tile (multiples of
8); BatchNorm is folded at that point, not per call.  The kernels compute
their products in 3xTF32 on the tensor cores; ``fused_*_tf32`` repeat that
arithmetic in plain PyTorch for the tests.  ``launch_shape`` picks, from the
batch and the card's SM count, the row-tile shape (a block per 32 rows) or
the cluster shape (a cluster of blocks shares 32 rows) for small batches.

Each wrapper checks dtype, shape, device and contiguity, then routes by the
input's device: a CPU tensor goes to the kernel's plain PyTorch version
(``*_plain``, the reference the kernel is tested against), a CUDA tensor to
the kernel, and anything else raises.  There is no fallback from a failed
launch, and none to another shape.  ``LAUNCHES[name]`` counts the kernel's
successful launches, so a run can show that its path went through the
kernel.  The wrappers serve inference only: they carry no gradient.

The two kernels are also registered as the custom ops
``torch.ops.pigan_thz.fused_mlp_forward`` and ``...fused_dense_chain`` (a
packed chain's buffer and its layout as int lists; ``packed_op_args``),
which call the wrappers and so route and count the same way; torch.export
traces them as opaque calls (``serve.export_*`` with ``use_pallas``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

# Successful kernel launches, by kernel (one dict for all the port's kernels).
from ._cuda_build import LAUNCHES, check_capability, launch, load_library


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

# The kernels' tensor-core tile: every width is padded to a multiple of
# PAD (the m16n8k8 products' n and k), every tensor starts ALIGN floats
# (64 bytes) into the buffer, which the kernels' 16-byte copies need.
PAD = 8
ALIGN = 16
# The kernels' W stages (csrc/fused_mlp_chain.cu: kPassTiles, kStageFloats):
# a pass covers at most PASS_TILES n8 tiles, a stage holds STAGE_FLOATS.
PASS_TILES = 32
STAGE_FLOATS = 16 * (8 * PASS_TILES + 8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def row_tile_stages(din_p: int, dout_p: int):
    """The W stages of one layer in the row-tile shape, in the kernel's
    order (csrc/fused_mlp_chain.cu: pass_geom with one block a row tile):
    (first column, columns, stage row stride, first k row, k rows) each."""
    t = dout_p // PAD
    np_ = -(-t // PASS_TILES)
    for p in range(np_):
        a, b = p * t // np_, (p + 1) * t // np_
        cols = PAD * (b - a)
        stride = _round_up(cols, 32) + 8
        kt = min((STAGE_FLOATS // stride) & ~7, din_p)
        for k0 in range(0, din_p, kt):
            yield PAD * a, cols, stride, k0, min(kt, din_p - k0)


@dataclass(frozen=True)
class PackedChain:
    """One model's weights in one contiguous fp32 buffer, in the kernels'
    layout.

    Layer l maps dims[l] -> dims[l + 1]; ``offsets[l]`` holds the float
    offsets of its (W, b, scale, shift) in ``weights``, -1 where the layer
    has no such tensor.  W is stored (in, out) row-major as in JAX, padded
    with zeros to ``padded_dims`` (multiples of ``PAD``); the vectors are
    zero-padded to the padded out width.  ``layer(l)`` gives the unpadded
    views."""

    weights: torch.Tensor
    offsets: tuple[tuple[int, int, int, int], ...]
    dims: tuple[int, ...]
    layer_norm: bool
    # per layer, the offset of its W in stage order (``row_tile_stages``:
    # each stage's k rows of its columns at the stage's row stride, zero
    # padded, one stage after another), -1 for the generator's head, which
    # its kernel computes on the CUDA cores; the row-tile shape streams W
    # from here, so the wrappers refuse a chain without one per layer
    tiled: tuple[int, ...]

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def padded_dims(self) -> tuple[int, ...]:
        return tuple(_round_up(d, PAD) for d in self.dims)

    @property
    def device(self) -> torch.device:
        return self.weights.device

    def layer(self, l: int) -> tuple[torch.Tensor, ...]:
        """Views of layer l's tensors, unpadded: (W, b) or (W, b, scale, shift)."""
        din, dout = self.dims[l], self.dims[l + 1]
        pin, pout = self.padded_dims[l], self.padded_dims[l + 1]
        views = []
        for k, off in enumerate(self.offsets[l]):
            if off < 0:
                continue
            if k == 0:
                views.append(self.weights[off : off + pin * pout].view(pin, pout)[:din, :dout])
            else:
                views.append(self.weights[off : off + dout])
        return tuple(views)


def pack_chain(
    layers: Sequence[tuple], head: tuple, device: torch.device | str | None = None
) -> PackedChain:
    """Pack hidden ``layers`` [(W, b)] or [(W, b, scale, shift)] (W as
    (in, out)) and ``head`` (W, b) into a ``PackedChain`` on ``device``
    (default: where the weights are), zero-padded to the kernels' tiles."""
    arity = {len(t) for t in layers}
    if len(arity) > 1 or arity - {2, 4} or len(head) != 2:
        raise ValueError("layers must all be (W, b) or all (W, b, scale, shift); head (W, b)")
    entries = [*layers, head]
    dims = [int(entries[0][0].shape[0])] + [int(t[0].shape[1]) for t in entries]
    pdims = [_round_up(d, PAD) for d in dims]
    placed: list[tuple[int, torch.Tensor]] = []
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
            placed.append((pos, t.detach().to(torch.float32)))
            size = pdims[l] * pdims[l + 1] if k == 0 else pdims[l + 1]
            pos += _round_up(size, ALIGN)
        offsets.append(tuple(offs + [-1] * (4 - len(offs))))
    layer_norm = arity == {4}
    tiled = []
    for l in range(len(entries)):
        if not layer_norm and l == len(entries) - 1:
            tiled.append(-1)
            continue
        tiled.append(pos)
        pos += _round_up(sum(rows * stride for *_, stride, _, rows in
                             row_tile_stages(pdims[l], pdims[l + 1])), ALIGN)
    if device is None:
        device = head[0].device
    weights = torch.zeros(pos, dtype=torch.float32)
    for off, t in placed:
        if t.dim() == 2:
            pout = _round_up(t.shape[1], PAD)
            weights[off : off + _round_up(t.shape[0], PAD) * pout].view(-1, pout)[
                : t.shape[0], : t.shape[1]] = t.cpu()
        else:
            weights[off : off + t.numel()] = t.cpu()
    for l, off in enumerate(tiled):
        if off < 0:
            continue
        pin, pout = pdims[l], pdims[l + 1]
        W = weights[offsets[l][0] : offsets[l][0] + pin * pout].view(pin, pout)
        for c0, cols, stride, k0, rows in row_tile_stages(pin, pout):
            weights[off : off + rows * stride].view(rows, stride)[:, :cols] = \
                W[k0 : k0 + rows, c0 : c0 + cols]
            off += rows * stride
    return PackedChain(weights.to(device).contiguous(), tuple(offsets), tuple(dims),
                       layer_norm=layer_norm, tiled=tuple(tiled))


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
# Plain PyTorch versions (the kernels' reference; the CPU path) and the
# kernels' 3xTF32 arithmetic in plain PyTorch
# ---------------------------------------------------------------------------


def _mlp_chain(x, packed: PackedChain, matmul, leaky_slope: float, ln_eps: float):
    h = x
    for l in range(packed.n_layers - 1):
        W, b, scale, shift = packed.layer(l)
        h = matmul(h, W) + b
        mean = h.mean(dim=-1, keepdim=True)
        var = ((h - mean) ** 2).mean(dim=-1, keepdim=True)
        h = (h - mean) * torch.rsqrt(var + ln_eps)
        h = h * scale + shift
        h = torch.where(h >= 0.0, h, leaky_slope * h)
    W, b = packed.layer(packed.n_layers - 1)
    return matmul(h, W) + b


def _dense_chain(x, packed: PackedChain, matmul, head_matmul):
    h = x
    for l in range(packed.n_layers - 1):
        W, b = packed.layer(l)
        h = torch.relu(matmul(h, W) + b)
    W, b = packed.layer(packed.n_layers - 1)
    return torch.tanh(head_matmul(h, W) + b)


def fused_mlp_forward_plain(
    x: torch.Tensor, packed: PackedChain, leaky_slope: float = 0.2, ln_eps: float = 1e-6
) -> torch.Tensor:
    return _mlp_chain(x, packed, torch.matmul, leaky_slope, ln_eps)


def fused_dense_chain_plain(x: torch.Tensor, packed: PackedChain) -> torch.Tensor:
    return _dense_chain(x, packed, torch.matmul, torch.matmul)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: what ``cvt.rna.tf32.f32`` gives, kept in fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b as the kernels' tensor cores compute it: with ``terms`` 3,
    each operand split into hi = tf32(x) and lo = tf32(x - hi), and
    lo@hi + hi@lo + hi@hi summed in fp32 (3xTF32); with 1, hi@hi alone."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if terms == 1:
        return a_hi @ b_hi
    if terms != 3:
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def fused_mlp_forward_tf32(
    x: torch.Tensor, packed: PackedChain, terms: int = 3, leaky_slope: float = 0.2,
    ln_eps: float = 1e-6,
) -> torch.Tensor:
    """The K5 kernel's arithmetic in plain PyTorch: every product through
    ``tf32_matmul``.  For the tests and ``examples/torch_serving_tiles.py``."""
    return _mlp_chain(x, packed, lambda h, W: tf32_matmul(h, W, terms), leaky_slope, ln_eps)


def fused_dense_chain_tf32(x: torch.Tensor, packed: PackedChain, terms: int = 3) -> torch.Tensor:
    """The K6 kernel's arithmetic in plain PyTorch: the hidden products
    through ``tf32_matmul``, the head in fp32 (the kernel's CUDA cores)."""
    return _dense_chain(x, packed, lambda h, W: tf32_matmul(h, W, terms), torch.matmul)


# ---------------------------------------------------------------------------
# Launch shape
# ---------------------------------------------------------------------------

ROW_TILE = 32       # batch rows a block owns (csrc/fused_mlp_chain.cu: kRows)
CLUSTER_SIZES = (1, 2, 4, 8)    # up to the portable cluster size (kMaxCluster)
MAX_CLUSTER = CLUSTER_SIZES[-1]


def launch_shape(batch: int, dims: Sequence[int], sm_count: int,
                 resident: dict[int, int] | None = None) -> int:
    """The cluster size for a call: 1 is the row-tile shape (a block per 32
    rows); C > 1 the cluster shape (C blocks share 32 rows, each computing
    1/C of every layer's columns).  The largest C, up to ``MAX_CLUSTER``
    and to the n8 tiles of the narrowest hidden layer, whose clusters for
    all row tiles are resident on the card at once: ``resident[C]`` of
    them (the card's answer, ``chain_limits``), by default ``sm_count // C``
    (one block an SM)."""
    tiles = -(-batch // ROW_TILE)
    widths = dims[1:-1] or dims[1:]
    col_tiles = min(_round_up(d, PAD) // PAD for d in widths)
    c = 1
    for size in CLUSTER_SIZES[1:]:
        if size > col_tiles:
            break
        if tiles <= (resident[size] if resident else sm_count // size):
            c = size
    return c


def crossover_batch(sm_count: int, resident: dict[int, int] | None = None) -> int:
    """The smallest batch that takes the row-tile shape (for chains whose
    hidden layers have at least 2 n8 tiles)."""
    return (resident[2] if resident else sm_count // 2) * ROW_TILE + 1


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _resident(index: int, layer_norm: bool, dims: tuple[int, ...]) -> dict[int, int]:
    lib = load_library()
    cdims = (ctypes.c_int * len(dims))(*dims)
    out = {}
    with torch.cuda.device(index):
        for size in CLUSTER_SIZES[1:]:
            n = ctypes.c_int(0)
            rc = lib.pigan_fused_chain_max_clusters(cdims, len(dims) - 1, int(layer_norm),
                                                    size, ctypes.byref(n))
            if rc != 0:
                raise RuntimeError(f"cluster occupancy query: CUDA error {rc} "
                                   f"({lib.pigan_cuda_error_string(rc).decode()})")
            out[size] = n.value
    return out


def chain_limits(packed: PackedChain) -> tuple[int, dict[int, int]]:
    """(SM count, clusters of each size resident at once) for ``packed``'s
    kernel on the card that holds it."""
    index = packed.device.index or 0
    return _sm_count(index), _resident(index, packed.layer_norm, packed.dims)


def chosen_shape(x: torch.Tensor, packed: PackedChain) -> int:
    """The cluster size the wrappers launch ``x`` with (a CUDA tensor)."""
    return launch_shape(x.shape[0], packed.dims, *chain_limits(packed))


def crossover_for(packed: PackedChain) -> int:
    """The smallest batch that takes the row-tile shape for ``packed`` on
    its card."""
    return crossover_batch(*chain_limits(packed))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, packed: PackedChain, layer_norm: bool, name: str,
           cluster: int | None) -> bool:
    """Validate the call; True when it goes to the kernel (CUDA input)."""
    if packed.layer_norm != layer_norm:
        raise ValueError(f"{name}: packed chain has layer_norm={packed.layer_norm}")
    if len(packed.tiled) != packed.n_layers:
        raise ValueError(f"{name}: packed chain has {len(packed.tiled)} stage-order "
                         f"offsets for {packed.n_layers} layers (pack it with pack_chain)")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 input, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != packed.dims[0]:
        raise ValueError(f"{name}: expected input (B, {packed.dims[0]}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device != packed.device:
        raise ValueError(f"{name}: input on {x.device}, weights on {packed.device}")
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"{name}: cluster must be one of {CLUSTER_SIZES}, got {cluster}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    check_capability(x.device.index)
    return True


def _launch(name: str, x: torch.Tensor, packed: PackedChain, cluster: int | None,
            *scalars) -> torch.Tensor:
    batch = x.shape[0]
    out = torch.empty((batch, packed.dims[-1]), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    if cluster is None:
        cluster = chosen_shape(x, packed)
    elif cluster > 1 and chain_limits(packed)[1][cluster] == 0:
        # launch_shape never picks such a size; a forced one is refused here
        raise RuntimeError(f"{name}: the card holds no cluster of {cluster} blocks "
                           f"of this chain's kernel")
    offsets = (ctypes.c_longlong * (4 * packed.n_layers))(
        *(o for offs in packed.offsets for o in offs)
    )
    tiled = (ctypes.c_longlong * packed.n_layers)(*packed.tiled)
    dims = (ctypes.c_int * len(packed.dims))(*packed.dims)
    launch(name, x.device, x.data_ptr(), out.data_ptr(), packed.weights.data_ptr(),
           offsets, tiled, dims, packed.n_layers, batch, cluster, *scalars)
    return out


def fused_mlp_forward(
    x: torch.Tensor, packed: PackedChain, leaky_slope: float = 0.2, ln_eps: float = 1e-6,
    *, cluster: int | None = None,
) -> torch.Tensor:
    """Fused LayerNorm-MLP chain: x (B, D_in) -> (B, D_out), one launch.
    ``cluster`` forces the launch shape (default ``launch_shape``'s)."""
    if not _check(x, packed, True, "fused_mlp_forward", cluster):
        return fused_mlp_forward_plain(x, packed, leaky_slope, ln_eps)
    return _launch("fused_mlp_forward", x, packed, cluster, leaky_slope, ln_eps)


def fused_dense_chain(
    x: torch.Tensor, packed: PackedChain, *, cluster: int | None = None
) -> torch.Tensor:
    """Fused dense chain, ReLU hidden layers and tanh head (fold norms
    first): x (B, D_in) -> (B, D_out), one launch.  ``cluster`` forces the
    launch shape (default ``launch_shape``'s)."""
    if not _check(x, packed, False, "fused_dense_chain", cluster):
        return fused_dense_chain_plain(x, packed)
    return _launch("fused_dense_chain", x, packed, cluster)


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


# ---------------------------------------------------------------------------
# The kernels as custom ops (what torch.export traces)
# ---------------------------------------------------------------------------
#
# ``torch.ops.pigan_thz.fused_mlp_forward`` and ``...fused_dense_chain`` take
# a packed chain as its buffer plus its layout as int lists, and run the
# wrappers above: a CUDA tensor launches the kernel and counts LAUNCHES, a
# CPU tensor takes the plain version, anything else raises.  The ctypes
# launch and the count happen inside the op's implementation, which
# torch.export keeps opaque; the registered fake gives the output's shape.
# An exported program that calls them runs only where this module is
# imported (``serve.load_exported`` imports it).


def packed_op_args(packed: PackedChain) -> tuple[list[int], list[int], list[int], bool]:
    """(offsets flattened, tiled, dims, layer_norm): a packed chain's layout
    as the custom ops take it beside ``packed.weights``."""
    return ([o for offs in packed.offsets for o in offs], list(packed.tiled),
            list(packed.dims), packed.layer_norm)


def _packed_from(weights: torch.Tensor, offsets: list[int], tiled: list[int],
                 dims: list[int], layer_norm: bool) -> PackedChain:
    n = len(dims) - 1
    return PackedChain(weights, tuple(tuple(offsets[4 * l: 4 * l + 4]) for l in range(n)),
                       tuple(dims), layer_norm=layer_norm, tiled=tuple(tiled))


@torch.library.custom_op("pigan_thz::fused_mlp_forward", mutates_args=())
def fused_mlp_forward_op(x: torch.Tensor, weights: torch.Tensor, offsets: list[int],
                         tiled: list[int], dims: list[int], layer_norm: bool,
                         leaky_slope: float, ln_eps: float) -> torch.Tensor:
    """``fused_mlp_forward`` (K5) as a custom op."""
    packed = _packed_from(weights, offsets, tiled, dims, layer_norm)
    return fused_mlp_forward(x, packed, leaky_slope, ln_eps)


@torch.library.custom_op("pigan_thz::fused_dense_chain", mutates_args=())
def fused_dense_chain_op(x: torch.Tensor, weights: torch.Tensor, offsets: list[int],
                         tiled: list[int], dims: list[int], layer_norm: bool) -> torch.Tensor:
    """``fused_dense_chain`` (K6) as a custom op."""
    return fused_dense_chain(x, _packed_from(weights, offsets, tiled, dims, layer_norm))


@fused_mlp_forward_op.register_fake
def _(x, weights, offsets, tiled, dims, layer_norm, leaky_slope, ln_eps):
    return x.new_empty((x.shape[0], dims[-1]))


@fused_dense_chain_op.register_fake
def _(x, weights, offsets, tiled, dims, layer_norm):
    return x.new_empty((x.shape[0], dims[-1]))
