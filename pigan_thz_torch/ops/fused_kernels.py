"""Fused MLP-chain serving kernels: the port of pigan_thz_tpu/ops/pallas_kernels.py,
and the residual generator's chain.

Two hand-written CUDA kernels (``csrc/fused_mlp_chain.cu``) run the serving
cycle's two baseline models on the card, each as one launch over the whole
chain:

- ``fused_mlp_forward`` (forward surrogate): per hidden layer
  h@W+b -> LayerNorm (two-pass variance, eps 1e-6) -> LeakyReLU 0.2, then a
  linear head; ``forward_surrogate_fused`` splits it 250 | 8.
- ``fused_dense_chain`` (generator): ReLU hidden layers with BatchNorm
  folded into the dense weights, tanh head; ``generator_fused``.

A third (``csrc/fused_residual_chain.cu``), which replaces no TPU kernel,
runs the enhanced designer's ``ResidualGenerator`` (BatchNorm, float32) as
one launch: ``fused_residual_chain`` on a chain that ``pack_residual``
packs (BatchNorm folded, the residual blocks' boundaries recorded, W
pre-split for its wgmma products); ``serve.py`` routes to it from
``RESIDUAL_CROSSOVER`` rows up.

Weights are packed once per model (``pack_forward_model``,
``pack_generator``) into one contiguous fp32 buffer on the serving device
plus an offsets table, zero-padded to the tensor-core tile (multiples of
8); BatchNorm is folded at that point, not per call.  The kernels compute
their products in 3xTF32 on the tensor cores; ``fused_*_tf32`` repeat that
arithmetic in plain PyTorch for the tests.  ``launch_shape`` picks, from the
batch and the card's SM count, the row-tile shape (a block per 32 rows),
the cluster shape (a cluster of blocks shares 32 rows) for small batches,
or for K5 from ``wgmma_crossover`` up its wgmma shape (a cluster of two
blocks shares 128 rows, products as warpgroup ``wgmma``), which reads W
from a second, pre-split copy (``wgmma_stream``) that ``pack_chain`` adds to
a LayerNorm chain once, at packing.

Each wrapper checks dtype, shape, device and contiguity, then routes by the
input's device: a CPU tensor goes to the kernel's plain PyTorch version
(``*_plain``, the reference the kernel is tested against), a CUDA tensor to
the kernel, and anything else raises.  There is no fallback from a failed
launch, and none to another shape.  ``LAUNCHES[name]`` counts the kernel's
successful launches, so a run can show that its path went through the
kernel; ``LAUNCHES["fused_mlp_forward.wgmma"]`` those of K5's wgmma shape
among them, ``LAUNCHES["fused_residual_chain"]`` those of the residual
generator's kernel.  The wrappers serve inference only: they carry no gradient.

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


# K5's wgmma shape (csrc/fused_mlp_chain.cu: kWgCluster, kWgRows, kWgPassTiles,
# kWgStages, kWgStageFloats): a cluster of WG_CLUSTER blocks owns WG_ROWS
# batch rows, block q half of every layer's n8 tiles (``cta_tiles``), in
# passes of at most WG_PASS_TILES tiles, each of a size in WG_TILES.
WG_CLUSTER = 2
WG_ROWS = 128
WG_PASS_TILES = 16
WG_TILES = (8, 9, 16)
WG_STAGE_BYTES = 4 * 4 * 128 * WG_PASS_TILES     # the ring: 4 stages of 8 KB
SMEM_OPTIN = 232448                               # a block's shared memory on an H100


def cta_tiles(ntiles: int, rank: int, csize: int) -> tuple[int, int]:
    """The n8 tiles [t0, t1) of a layer's ``ntiles`` that cluster rank
    ``rank`` of ``csize`` owns (csrc/fused_mlp_chain.cu: cta_tiles)."""
    return rank * ntiles // csize, (rank + 1) * ntiles // csize


def wgmma_passes(t: int):
    """The passes over a block's ``t`` tiles in the wgmma shape: (first tile,
    tile count) each (csrc/fused_mlp_chain.cu: wg_pass_tiles)."""
    np_ = -(-t // WG_PASS_TILES)
    return [(p * t // np_, (p + 1) * t // np_ - p * t // np_) for p in range(np_)]


def _wgmma_smem(pdims: Sequence[int], gl: int) -> int | None:
    """Shared memory a block of the wgmma shape takes with hidden layer
    ``gl``'s output in the global scratch (csrc/fused_mlp_chain.cu:
    configure_wg); None where a pass or a slice is not of a size it takes."""
    n = len(pdims) - 1
    width = [_round_up(pdims[0], 16), 0]
    for l in range(n):
        for q in range(WG_CLUSTER):
            t0, t1 = cta_tiles(pdims[l + 1] // PAD, q, WG_CLUSTER)
            if any(nt not in WG_TILES for _, nt in wgmma_passes(t1 - t0)):
                return None
            if l < n - 1:
                if (t1 - t0) % 4:
                    return None
                if l != gl:
                    width[(l + 1) % 2] = max(width[(l + 1) % 2], PAD * (t1 - t0))
    return (WG_STAGE_BYTES + 4 * WG_ROWS * (sum(_round_up(max(w, 1), 32) for w in width) + 2)
            + 8 * 10)


@functools.cache
def wgmma_global_layer(dims: tuple[int, ...]) -> int | None:
    """For K5's wgmma shape: -1 where every hidden layer's output fits in the
    blocks' shared memory, else the one hidden layer whose output goes to
    the global scratch (the widest that makes the rest fit); None where the
    shape does not take the chain (two layers or more, every pass of a size
    in WG_TILES, a multiple of 4 tiles a block for each hidden layer)."""
    n = len(dims) - 1
    if n < 2 or n > 8 or min(dims) < 1:
        return None
    pdims = [_round_up(d, PAD) for d in dims]
    for gl in [-1, *sorted(range(n - 1), key=lambda l: -pdims[l + 1])]:
        smem = _wgmma_smem(pdims, gl)
        if smem is None:
            return None
        if smem <= SMEM_OPTIN:
            return gl
    return None


def wgmma_stream(W: torch.Tensor) -> torch.Tensor:
    """A padded W (in, out) as the wgmma shape streams it: for each cluster
    rank in turn, each pass of its tiles, each k8 step, the hi = tf32(W) then
    the lo = tf32(W - hi) image of the pass's columns, each as core matrices
    (8 columns x 4 k, k fastest) by column group, then k half: the layout the
    kernel's shared-memory descriptors read, one bulk copy a stage."""
    pin, pout = W.shape
    hi = tf32_round(W)
    both = torch.stack([hi, tf32_round(W - hi)])            # (2, in, out)
    parts = []
    for q in range(WG_CLUSTER):
        t0, t1 = cta_tiles(pout // PAD, q, WG_CLUSTER)
        for a, nt in wgmma_passes(t1 - t0):
            cols = both[:, :, PAD * (t0 + a):PAD * (t0 + a + nt)]
            parts.append(cols.reshape(2, pin // 8, 2, 4, nt, 8)      # (h, j, c, k, g, n)
                         .permute(1, 0, 4, 2, 5, 3).reshape(-1))     # (j, h, g, c, n, k)
    return torch.cat(parts)


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

    @property
    def wgmma(self) -> tuple[int, ...] | None:
        """Per layer, the offset of its W stream for K5's wgmma shape
        (``wgmma_stream``), which ``pack_chain`` places after the stage-order
        copies; None where the chain has none (a generator, a chain the shape
        does not take, a buffer that ends before)."""
        if not self.layer_norm or not self.tiled or min(self.tiled) < 0:
            return None
        return _wgmma_offsets(self.dims, self.tiled[-1], self.weights.numel())

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


@functools.cache
def _wgmma_offsets(dims: tuple[int, ...], last_tiled: int, numel: int) -> tuple[int, ...] | None:
    if wgmma_global_layer(dims) is None:
        return None
    pdims = [_round_up(d, PAD) for d in dims]
    pos = last_tiled + _round_up(
        sum(rows * stride for *_, stride, _, rows in row_tile_stages(*pdims[-2:])), ALIGN)
    offs = []
    for l in range(len(dims) - 1):
        offs.append(pos)
        pos += _round_up(2 * pdims[l] * pdims[l + 1], ALIGN)
    return tuple(offs) if pos <= numel else None


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
    wg = []
    if layer_norm and wgmma_global_layer(tuple(dims)) is not None:
        for l in range(len(entries)):
            wg.append(pos)
            pos += _round_up(2 * pdims[l] * pdims[l + 1], ALIGN)
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
    for l, off in enumerate(wg):
        pin, pout = pdims[l], pdims[l + 1]
        W = weights[offsets[l][0] : offsets[l][0] + pin * pout].view(pin, pout)
        weights[off : off + 2 * pin * pout] = wgmma_stream(W)
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
WGMMA = "wgmma"     # K5's wgmma shape, as a launch shape


def launch_shape(batch: int, dims: Sequence[int], sm_count: int,
                 resident: dict | None = None, wgmma: bool = False) -> int | str:
    """The launch shape for a call: ``WGMMA`` (K5 only, ``wgmma`` True: the
    chain has its W streams) from ``wgmma_crossover`` up; else the cluster
    size: 1 is the row-tile shape (a block per 32 rows); C > 1 the cluster
    shape (C blocks share 32 rows, each computing 1/C of every layer's
    columns).  The largest C, up to ``MAX_CLUSTER`` and to the n8 tiles of
    the narrowest hidden layer, whose clusters for all row tiles are
    resident on the card at once: ``resident[C]`` of them (the card's
    answer, ``chain_limits``), by default ``sm_count // C`` (one block an
    SM)."""
    if wgmma and batch >= wgmma_crossover(sm_count):
        return WGMMA
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


def wgmma_crossover(sm_count: int) -> int:
    """The smallest batch that takes K5's wgmma shape: the first that the
    row-tile shape cannot run in one wave of one block an SM, where its
    second wave would cost a whole block's time; the wgmma shape runs its
    clusters of ``WG_ROWS`` rows on every SM in one wave up to 8448 rows on
    132 SMs (examples/torch_serving_tiles.py times both sides)."""
    return sm_count * ROW_TILE + 1


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _checked(lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"cluster occupancy query: CUDA error {rc} "
                           f"({lib.pigan_cuda_error_string(rc).decode()})")


@functools.cache
def _resident(index: int, layer_norm: bool, dims: tuple[int, ...], wgmma: bool) -> dict:
    lib = load_library()
    cdims = (ctypes.c_int * len(dims))(*dims)
    out = {}
    with torch.cuda.device(index):
        for size in CLUSTER_SIZES[1:]:
            n = ctypes.c_int(0)
            _checked(lib, lib.pigan_fused_chain_max_clusters(
                cdims, len(dims) - 1, int(layer_norm), size, ctypes.byref(n)))
            out[size] = n.value
        if wgmma:
            n = ctypes.c_int(0)
            _checked(lib, lib.pigan_fused_mlp_wgmma_max_clusters(
                cdims, len(dims) - 1, wgmma_global_layer(dims), ctypes.byref(n)))
            out[WGMMA] = n.value
    return out


def chain_limits(packed: PackedChain) -> tuple[int, dict]:
    """(SM count, clusters of each shape resident at once: of each size
    and, for a chain with W streams, of ``WGMMA``) for ``packed``'s kernel on
    the card that holds it."""
    index = packed.device.index or 0
    return _sm_count(index), _resident(index, packed.layer_norm, packed.dims,
                                       packed.wgmma is not None)


def chosen_shape(x: torch.Tensor, packed: PackedChain) -> int | str:
    """The launch shape the wrappers launch ``x`` with (a CUDA tensor)."""
    return launch_shape(x.shape[0], packed.dims, *chain_limits(packed),
                        wgmma=packed.wgmma is not None)


def shape_label(shape: int | str) -> str:
    """A launch shape by name: "wgmma", "row_tile" or "cluster<C>"."""
    return shape if shape == WGMMA else "row_tile" if shape == 1 else f"cluster{shape}"


def shape_name(x: torch.Tensor, packed: PackedChain) -> str:
    """The launch shape of a call by name: "plain" for a CPU input (the
    plain version), "empty" for no rows, else ``shape_label``'s."""
    if x.device.type != "cuda":
        return "plain"
    if x.shape[0] == 0:
        return "empty"
    return shape_label(chosen_shape(x, packed))


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
    if cluster == WGMMA:
        if packed.wgmma is None:
            raise ValueError(f"{name}: the wgmma shape takes K5's chains with W streams "
                             f"(pack_chain of a LayerNorm chain it fits) only")
    elif cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"{name}: cluster must be one of {CLUSTER_SIZES} or "
                         f"{WGMMA!r}, got {cluster}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    check_capability(x.device.index)
    return True


@functools.cache
def _c_layout(offsets: tuple, tiled: tuple, dims: tuple, wgmma: tuple | None):
    """A chain's layout as the C entry points take it, built once a layout:
    (offsets, tiled, dims, the W streams' offsets or None, the scratch
    layer, the scratch's row stride)."""
    n = len(dims) - 1
    gl = wgmma_global_layer(dims) if wgmma else -1
    return ((ctypes.c_longlong * (4 * n))(*(o for offs in offsets for o in offs)),
            (ctypes.c_longlong * n)(*tiled), (ctypes.c_int * len(dims))(*dims),
            (ctypes.c_longlong * n)(*wgmma) if wgmma else None, gl,
            _round_up(_round_up(dims[gl + 1], PAD), 32) if gl >= 0 else 0)


def _launch(name: str, x: torch.Tensor, packed: PackedChain, cluster: int | str | None,
            *scalars) -> torch.Tensor:
    batch = x.shape[0]
    out = torch.empty((batch, packed.dims[-1]), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    if cluster is None:
        cluster = chosen_shape(x, packed)
    elif cluster != 1 and chain_limits(packed)[1][cluster] == 0:
        # launch_shape never picks such a shape; a forced one is refused here
        raise RuntimeError(f"{name}: the card holds no cluster of the {cluster} shape "
                           f"of this chain's kernel")
    offsets, tiled, dims, wg, gl, sw = _c_layout(packed.offsets, packed.tiled, packed.dims,
                                                 packed.wgmma)
    if cluster == WGMMA:
        # the cluster's rows of the one hidden output kept in global memory
        scratch = (torch.empty(_round_up(batch, WG_ROWS) * sw, dtype=torch.float32,
                               device=x.device) if gl >= 0 else None)
        launch(f"{name}_wgmma", x.device, x.data_ptr(), out.data_ptr(),
               packed.weights.data_ptr(), None if scratch is None else scratch.data_ptr(),
               offsets, wg, dims, packed.n_layers, gl, batch, *scalars, count_as=name)
        LAUNCHES[f"{name}.{WGMMA}"] += 1
        return out
    launch(name, x.device, x.data_ptr(), out.data_ptr(), packed.weights.data_ptr(),
           offsets, tiled, dims, packed.n_layers, batch, cluster, *scalars)
    return out


def fused_mlp_forward(
    x: torch.Tensor, packed: PackedChain, leaky_slope: float = 0.2, ln_eps: float = 1e-6,
    *, cluster: int | str | None = None,
) -> torch.Tensor:
    """Fused LayerNorm-MLP chain: x (B, D_in) -> (B, D_out), one launch.
    ``cluster`` forces the launch shape (default ``launch_shape``'s): a
    cluster size, or ``WGMMA`` ("wgmma") for the wgmma shape, which a chain
    with W streams (``packed.wgmma``) takes at any batch."""
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
# The residual generator's chain (csrc/fused_residual_chain.cu)
# ---------------------------------------------------------------------------

# A cluster of 2 blocks owns RES_ROWS batch rows (csrc/fused_residual_chain.cu:
# kRows), a block half of every layer's columns, W streamed as K5's wgmma
# shape streams it (``wgmma_stream``).  Input and hidden widths are padded to
# RES_PAD (8 n8 tiles a half at least: kWidthPad), the head's output to PAD.
# The kernel's two shared-memory buffers hold RES_BUFFERS floats a row; an
# activation whose half is wider than its buffer lives in a global scratch.
RES_ROWS = 128
RES_PAD = 128
RES_BUFFERS = (128, 256)
# The smallest batch that ``serve.py`` sends through the kernel; below it the
# graphed module stage serves.  Measured where the kernel starts to win (an
# H100, examples/torch_residual_chain.py, a call each, in turns): a call of
# the kernel takes ~0.37 ms at any batch up to one wave of clusters (8448
# rows), the module's CUDA graph grows with the batch: 0.28 ms at 1024, 0.36
# at 1536, level at 2048 (0.37 and 0.38), 0.48 at 2560 and 0.95 at 8192.
RESIDUAL_CROSSOVER = 2048


def _residual_layout(generator: nn.Module):
    """A ``ResidualGenerator`` with BatchNorm -> ([(Dense, BatchNorm)] of its
    hidden layers in order, the head's Dense, per hidden layer whether it
    closes a residual block); ValueError for any other model or layout."""
    from ..models.blocks import Dense, Dropout, FlaxBatchNorm1d, ResidualBlock
    from ..models.generator import ResidualGenerator

    def refuse(what):
        return ValueError(f"the residual chain kernel takes a ResidualGenerator with "
                          f"BatchNorm only; {what}")

    if not isinstance(generator, ResidualGenerator):
        raise refuse(f"got {type(generator).__name__}")
    kinds = lambda mods: [type(m) for m in mods]    # noqa: E731
    mods, pairs, closes, i = list(generator.main), [], [], 0
    while i < len(mods) - 2:
        if isinstance(mods[i], ResidualBlock):
            body = list(mods[i].body)
            if kinds(body) != [Dense, FlaxBatchNorm1d, nn.ReLU, Dropout, Dense, FlaxBatchNorm1d]:
                raise refuse(f"residual block {i} is {kinds(body)}")
            pairs += [(body[0], body[1]), (body[4], body[5])]
            closes += [False, True]
            i += 1
        elif kinds(mods[i:i + 3]) == [Dense, FlaxBatchNorm1d, nn.ReLU]:
            pairs.append((mods[i], mods[i + 1]))
            closes.append(False)
            i += 4 if i + 3 < len(mods) and type(mods[i + 3]) is Dropout else 3
        else:
            raise refuse(f"main.{i} is {type(mods[i]).__name__}")
    if kinds(mods[i:]) != [Dense, nn.Tanh]:
        raise refuse(f"the head is {kinds(mods[i:])}")
    return pairs, mods[i], tuple(closes)


def residual_chain_covers(model: nn.Module) -> bool:
    """Whether the residual chain kernel computes ``model``'s eval forward: a
    ``ResidualGenerator`` with BatchNorm whose layers compute in float32 on
    float32 weights, none split over a model axis."""
    try:
        pairs, head, _ = _residual_layout(model)
    except ValueError:
        return False
    return all(m.compute_dtype is None and m.tp is None and m.weight.dtype == torch.float32
               for m in (*(m for pair in pairs for m in pair), head))


def extract_residual_weights(generator: nn.Module):
    """A ``ResidualGenerator`` with BatchNorm -> its hidden layers [(W, b)]
    with W as (in, out), each BatchNorm folded in (``fold_batchnorm``: its
    running statistics, flax's biased variance, and its own eps), the head
    (W, b), and per hidden layer whether it closes a residual block (adds
    the input of the layer before it, the block's input, before its ReLU).
    Raises ValueError on any other model or layout."""
    pairs, head, closes = _residual_layout(generator)
    layers = [fold_batchnorm(d.weight.T, d.bias, n.weight, n.bias, n.running_mean,
                             n.running_var, n.eps) for d, n in pairs]
    return layers, (head.weight.T, head.bias), closes


@dataclass(frozen=True)
class PackedResidual:
    """The residual generator's chain in one contiguous buffer (fp32 for the
    kernel), in the kernel's layout.

    Layer l maps dims[l] -> dims[l + 1]; ``offsets[l]`` holds the offsets of
    its W and b, and for a hidden layer of its W stream (``wgmma_stream``:
    the kernel reads W from there), -1 for the head, whose W the kernel
    reads as it is.  W is (in, out) row-major, zero-padded to
    ``padded_dims``, b zero-padded to the padded out width.  ``closes[l]``:
    hidden layer l adds the input of layer l - 1 before its ReLU.
    ``layer(l)`` gives the unpadded (W, b)."""

    weights: torch.Tensor
    offsets: tuple[tuple[int, int, int], ...]
    dims: tuple[int, ...]
    closes: tuple[bool, ...]

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def padded_dims(self) -> tuple[int, ...]:
        return residual_padded_dims(self.dims)

    @property
    def device(self) -> torch.device:
        return self.weights.device

    def layer(self, l: int) -> tuple[torch.Tensor, torch.Tensor]:
        din, dout = self.dims[l], self.dims[l + 1]
        pin, pout = self.padded_dims[l], self.padded_dims[l + 1]
        w_off, b_off, _ = self.offsets[l]
        return (self.weights[w_off:w_off + pin * pout].view(pin, pout)[:din, :dout],
                self.weights[b_off:b_off + dout])


def residual_padded_dims(dims: Sequence[int]) -> tuple[int, ...]:
    """The residual chain's padded widths: the input and hidden widths to
    ``RES_PAD``, the head's output to ``PAD``."""
    return (*(_round_up(d, RES_PAD) for d in dims[:-1]), _round_up(dims[-1], PAD))


def pack_residual(generator: nn.Module, device: torch.device | str | None = None,
                  dtype: torch.dtype = torch.float32) -> PackedResidual:
    """Fold ``generator``'s BatchNorms into its dense layers, once, and pack
    the chain into a ``PackedResidual`` on ``device`` (default: where the
    weights are); ``dtype`` float64 keeps the folded weights in float64 for
    the tests (the kernel takes float32)."""
    layers, head, closes = extract_residual_weights(generator)
    entries = [*layers, head]
    dims = (int(entries[0][0].shape[0]), *(int(W.shape[1]) for W, _ in entries))
    pdims = residual_padded_dims(dims)
    offsets, pos = [], 0
    for l, (pin, pout) in enumerate(zip(pdims, pdims[1:])):
        w_off = pos
        b_off = w_off + _round_up(pin * pout, ALIGN)
        pos = b_off + _round_up(pout, ALIGN)
        stream = -1
        if l < len(layers):
            stream, pos = pos, pos + _round_up(2 * pin * pout, ALIGN)
        offsets.append((w_off, b_off, stream))
    weights = torch.zeros(pos, dtype=dtype)
    for (W, b), (w_off, b_off, stream), pin, pout in zip(entries, offsets, pdims, pdims[1:]):
        Wp = torch.zeros(pin, pout, dtype=dtype)
        Wp[:W.shape[0], :W.shape[1]] = W.detach().cpu()
        weights[w_off:w_off + pin * pout] = Wp.reshape(-1)
        weights[b_off:b_off + b.shape[0]] = b.detach().cpu()
        if stream >= 0:
            weights[stream:stream + 2 * pin * pout] = wgmma_stream(Wp.float())
    if device is None:
        device = head[0].device
    return PackedResidual(weights.to(device).contiguous(), tuple(offsets), dims, closes)


def _residual_chain(x, packed: PackedResidual, matmul, head_matmul):
    h = block_in = x
    for l in range(packed.n_layers - 1):
        W, b = packed.layer(l)
        y = matmul(h, W) + b
        if packed.closes[l]:
            y = y + block_in
        block_in, h = h, torch.relu(y)
    W, b = packed.layer(packed.n_layers - 1)
    return torch.tanh(head_matmul(h, W) + b)


def fused_residual_chain_plain(x: torch.Tensor, packed: PackedResidual) -> torch.Tensor:
    """The residual chain in plain PyTorch (the kernel's reference; the CPU
    path)."""
    return _residual_chain(x, packed, torch.matmul, torch.matmul)


def fused_residual_chain_tf32(x: torch.Tensor, packed: PackedResidual,
                              terms: int = 3) -> torch.Tensor:
    """The residual chain kernel's arithmetic in plain PyTorch: the hidden
    products through ``tf32_matmul``, the head in fp32 (the kernel's CUDA
    cores)."""
    return _residual_chain(x, packed, lambda h, W: tf32_matmul(h, W, terms), torch.matmul)


@functools.cache
def residual_scratch_width(dims: tuple[int, ...]) -> int:
    """The row stride of the scratch the residual chain kernel keeps its
    activations in (0: none): the widest activation whose half outgrows its
    buffer (activation a, the input of layer a, in buffer a % 2)."""
    pdims = residual_padded_dims(dims)
    return max((pdims[a] for a in range(len(dims) - 1) if pdims[a] // 2 > RES_BUFFERS[a % 2]),
               default=0)


@functools.cache
def _residual_c_layout(offsets: tuple, dims: tuple, closes: tuple):
    """A residual chain's layout as the C entry point takes it, built once:
    (per layer the W the kernel reads and b, dims, the closing layers' bits)."""
    flat = [o for w_off, b_off, stream in offsets for o in (stream if stream >= 0 else w_off,
                                                             b_off)]
    return ((ctypes.c_longlong * len(flat))(*flat), (ctypes.c_int * len(dims))(*dims),
            sum(1 << l for l, c in enumerate(closes) if c))


def fused_residual_chain(x: torch.Tensor, packed: PackedResidual) -> torch.Tensor:
    """The residual generator's eval forward: x (B, D_in) -> (B, D_out), one
    launch of the fused kernel on the card (float32), the plain version for
    a CPU tensor."""
    name = "fused_residual_chain"
    if packed.weights.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 input and weights, got {x.dtype} and "
                        f"{packed.weights.dtype}")
    if x.dim() != 2 or x.shape[1] != packed.dims[0]:
        raise ValueError(f"{name}: expected input (B, {packed.dims[0]}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device != packed.device:
        raise ValueError(f"{name}: input on {x.device}, weights on {packed.device}")
    if x.device.type == "cpu":
        return fused_residual_chain_plain(x, packed)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    check_capability(x.device.index)
    return _launch_residual(x, packed)


def _launch_residual(x: torch.Tensor, packed: PackedResidual) -> torch.Tensor:
    batch = x.shape[0]
    out = torch.empty((batch, packed.dims[-1]), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    offsets, dims, closes = _residual_c_layout(packed.offsets, packed.dims, packed.closes)
    sw = residual_scratch_width(packed.dims)
    # the clusters' rows of the activations kept in global memory
    scratch = (torch.empty(_round_up(batch, RES_ROWS) * sw, dtype=torch.float32,
                           device=x.device) if sw else None)
    launch("fused_residual_chain", x.device, x.data_ptr(), out.data_ptr(),
           packed.weights.data_ptr(), None if scratch is None else scratch.data_ptr(), offsets,
           dims, packed.n_layers, closes, batch)
    return out


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
