"""The batch-row products of the training kernels: the Python side of
``csrc/brow_gemm.cuh``.

A batch-row product is one whose rows are the batch (M = B or 2B) and whose
N and K are a layer's widths: a forward layer or an input gradient of G, D
or F.  The GAN step (``gan_train.py``: K2, and K3 for M members) and the
forward-training step (``forward_train.py``: K1) launch every such product
of theirs through the kernel of ``csrc/brow_gemm.cuh`` from their C loops:
split-K across a thread-block cluster, the partial tiles summed in rank
order through distributed shared memory, a ``cp.async`` ring, exact fp32
FMAs or bf16 ``mma.sync`` on bfloat16 operands.  Here: ``brow_plan``
mirrors its launch plan, ``BrowProduct`` describes one product of a step
(``gan_train.brow_products`` and ``forward_train.brow_products`` list a
step's), ``brow_gemm_plain`` is its arithmetic in torch ops and
``brow_gemm`` launches one product alone (for the card tests and timing).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._cuda_build import check_capability, launch, load_library

BROW_TILE = (64, 32)       # output rows x columns of a tile
BROW_STAGES = 4            # the cp.async ring's stages
BROW_MAX_SPLIT = 8         # the portable cluster size
BROW_MIN_DEPTH = 32        # columns of depth a split block keeps at least
H100_SMS = 132


class BrowPlan(NamedTuple):
    """How the batch-row kernel launches one product: clusters of ``split``
    blocks, one K slice of ``slice`` columns each, over ``tiles_m`` x
    ``tiles_n`` output tiles of ``BROW_TILE``, a ``BROW_STAGES``-stage ring."""

    split: int
    tiles_m: int
    tiles_n: int
    slice: int

    @property
    def blocks(self) -> int:
        """Blocks of one member."""
        return self.split * self.tiles_m * self.tiles_n

    def grid(self, members: int = 1) -> tuple[int, int, int]:
        """The launch grid: clusters of ``split`` along x, the member on z."""
        return self.tiles_n * self.split, self.tiles_m, members


def brow_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> BrowPlan:
    """The plan of an (m x k) (k x n) product on a card of ``sms`` SMs, as
    ``brow_gemm.cuh:brow_plan_for`` computes it: the smallest cluster size
    that brings the blocks to the largest power of two not above ``sms``
    (128 on an H100), doubled only while each block keeps at least
    ``BROW_MIN_DEPTH`` columns of depth, at most ``BROW_MAX_SPLIT``.  A pure
    function of the shape and the SM count: never of the members, nor of
    the operands' layout."""
    if min(m, n, k, sms) < 1:
        raise ValueError(f"brow_plan: positive sizes needed, got {(m, n, k, sms)}")
    target = 1 << (sms.bit_length() - 1)
    tiles_m, tiles_n = -(-m // BROW_TILE[0]), -(-n // BROW_TILE[1])
    split = 1
    while (split < BROW_MAX_SPLIT and tiles_m * tiles_n * split < target
           and -(-k // (2 * split)) >= BROW_MIN_DEPTH):
        split *= 2
    return BrowPlan(split, tiles_m, tiles_n, -(-k // split))


class BrowProduct(NamedTuple):
    """One batch-row product of a step: C (m, n) = A (m, k) B (k, n) in the
    kernel's operand convention (``ak``: A contiguous along k; ``bnc``: B
    contiguous along n), with bfloat16 operands (``rnd``) and a bias."""

    name: str
    m: int
    n: int
    k: int
    ak: bool
    bnc: bool
    rnd: bool
    bias: bool


def bf16_rounder(bf16: bool):
    """The operand rounding of the TPU kernels' MXU products, in both
    training kernels' plain versions: to bfloat16 (round to nearest even) and
    back, in the tensor's own type; the identity in float32 mode."""
    if not bf16:
        return lambda x: x
    return lambda x: x.to(torch.bfloat16).to(x.dtype)


def brow_gemm_plain(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
                    c: torch.Tensor | None = None, rnd: bool = False,
                    split: int = 1) -> torch.Tensor:
    """The batch-row kernel's arithmetic in torch ops: ``split`` partial
    products over the same K slices as the kernel's cluster ranks
    (ceil(K / split) columns each), summed in rank order; then C + that
    (``c``, the kernel's ACC) and + bias, in that order.  With ``rnd`` the
    operands are rounded to bfloat16 first.  ``a`` (..., M, K), ``b``
    (..., K, N), ``bias`` (N,) or (members, N); the result in their type.  Used by the tests and
    ``chip_smoke.py``; nothing on the card's main path calls it."""
    if rnd:
        a, b = bf16_rounder(True)(a), bf16_rounder(True)(b)
    k = a.shape[-1]
    width = -(-k // split)
    total = None
    for r in range(split):
        part = a[..., r * width:(r + 1) * width] @ b[..., r * width:(r + 1) * width, :]
        total = part if total is None else total + part
    if c is not None:
        total = c + total
    if bias is None:
        return total
    return total + (bias.unsqueeze(-2) if bias.ndim > 1 else bias)   # (members, N): per member


def _member_stride(t: torch.Tensor, dims: int) -> int:
    return int(t.stride(0)) if t.ndim == dims + 1 else 0


def brow_gemm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
              out: torch.Tensor | None = None, acc: bool = False, rnd: bool = False,
              split: int = 0, route: str = "brow") -> torch.Tensor:
    """One batch-row product as the training steps launch it: ``a`` (M, K) and
    ``b`` (K, N), each with any strides and optionally a leading member axis
    (then one launch for every member, the member on the grid's z axis),
    ``bias`` (N,) or (members, N); into ``out`` ((members,) M, N, rows
    contiguous), added to it with ``acc``.  ``split`` > 0 forces the
    cluster size, else ``brow_plan`` chooses; ``route="sgemm"`` launches the
    tiled SGEMM the steps used before instead (for timing).  CUDA tensors
    launch the kernel (``LAUNCHES["brow_gemm"]``) or raise; CPU tensors
    take ``brow_gemm_plain`` with the plan's split."""
    if route not in ("brow", "sgemm"):
        raise ValueError(f"brow_gemm: route must be 'brow' or 'sgemm', got {route!r}")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if b.shape[-2] != k or a.ndim not in (2, 3) or b.ndim not in (2, 3):
        raise ValueError(f"brow_gemm: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    ak = a.stride(-1) <= a.stride(-2)
    bnc = b.stride(-1) <= b.stride(-2)
    members = max(a.shape[0] if a.ndim == 3 else 1, b.shape[0] if b.ndim == 3 else 1)
    shape = (members, m, n) if max(a.ndim, b.ndim) == 3 else (m, n)
    if out is None:
        if acc:
            raise ValueError("brow_gemm: acc needs out")
        out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if a.device.type != "cuda":
        s = split or (brow_plan(m, n, k).split if route == "brow" else 1)
        out.copy_(brow_gemm_plain(a, b, bias, out if acc else None, rnd, s))
        return out
    tensors = [t for t in (a, b, bias, out) if t is not None]
    if any(t.dtype != torch.float32 or t.device != a.device for t in tensors):
        raise ValueError("brow_gemm: float32 tensors on one device needed")
    if tuple(out.shape) != shape or out.stride(-1) != 1:
        raise ValueError(f"brow_gemm: out must be {shape} with contiguous rows")
    if bias is not None and (bias.shape[-1] != n or bias.stride(-1) != 1):
        raise ValueError(f"brow_gemm: bias must be (..., {n}) and contiguous")
    check_capability(a.device.index or 0)
    flags = int(ak) | (int(bnc) << 1) | (int(rnd) << 2) | (int(acc) << 3)
    launch("brow_gemm", a.device, 0 if route == "brow" else 1, split, m, n, k,
           a.data_ptr(), a.stride(-2), a.stride(-1), _member_stride(a, 2),
           b.data_ptr(), b.stride(-2), b.stride(-1), _member_stride(b, 2),
           out.data_ptr(), out.stride(-2), _member_stride(out, 2),
           None if bias is None else bias.data_ptr(),
           0 if bias is None else _member_stride(bias, 1), members, flags)
    return out


def brow_plan_on_card(m: int, n: int, k: int, index: int = 0) -> BrowPlan:
    """The plan the C code computes for this shape on card ``cuda:index``
    (``brow_plan`` mirrors it)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    res = (ctypes.c_int * 4)()
    rc = load_library().pigan_brow_plan(m, n, k, sms, res)
    if rc != 0:
        raise RuntimeError(f"pigan_brow_plan: error {rc}")
    return BrowPlan(*res)
