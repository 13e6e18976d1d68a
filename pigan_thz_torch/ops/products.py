"""The products of the training kernels that the batch-row kernel does not
take: the Python side of ``csrc/train_common.cuh``'s product dispatch.

K1, K2 and K3 launch every product of a step that ``brow.py``'s kernel does
not take (the heads, the weight gradients, F's 4-wide input layer and its
input gradient) through ``gemm_ex`` of ``csrc/train_common.cuh``, which
picks a kernel from the product's N and K alone (``product_route`` mirrors
the rule; never M, never the member count):

- ``deep_narrow``: at most 8 output columns over a depth of 128 to 1024
  (the heads of G and D, the adversarial pass's 4 parameter columns, F's
  input gradient, F's 8 metrics columns under bfloat16).  One warp an
  output row; lane l sums the depth l, l + 32, l + 64, ... in that order
  into every column, then a butterfly of shuffles adds the lanes' sums at
  offsets 16, 8, 4, 2, 1 (``deep_narrow_plain``).
- ``batch_depth``: a depth of 32 to 128 (the weight gradients, whose depth
  is the batch B or 2B).  A 32 x 32 output tile with the whole depth in
  shared memory; each output one FMA chain over k = 0 ... K - 1
  (``batch_depth_plain``).
- ``sgemm``: the rest (depth 4 or 8: F's input layer, G's head input
  gradient, the metrics columns' term of F's input gradient under
  bfloat16): the tiled SGEMM, whose sums run in batch_depth's order.

Every kernel ends with (C +) the sum (+ bias), in that order, and rounds
its operands to bfloat16 as it loads them where the step asks (``rnd``).
``GemmProduct`` describes one product of a step (``gan_train.gemm_products``
and ``forward_train.gemm_products`` list a step's in the C loops' order);
``product_gemm`` launches one product alone (for the card tests and the
timings); on the CPU it is ``product_gemm_plain``.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

from ._cuda_build import check_capability, launch, load_library
from .brow import _member_stride, bf16_rounder

ROUTES = ("deep_narrow", "batch_depth", "sgemm")   # the C route indices, in order
LAUNCH_KEYS = {"deep_narrow": "deep_narrow_gemm", "batch_depth": "batch_depth_gemm",
               "sgemm": "sgemm"}                  # their keys in LAUNCHES
LANES = 32
NARROW_MAX_N = 8
NARROW_MIN_K = 128
NARROW_MAX_K = 1024
NARROW_WARPS = 4          # output rows a block, one a warp
DEPTH_MIN_K = 32
DEPTH_MAX_K = 128
DEPTH_TILE = 32           # outputs a block: DEPTH_TILE x DEPTH_TILE


def product_route(n: int, k: int) -> str:
    """The route of a product of ``n`` output columns over a depth of ``k``,
    as ``train_common.cuh:gemm_route`` picks it."""
    if n <= NARROW_MAX_N and NARROW_MIN_K <= k <= NARROW_MAX_K:
        return "deep_narrow"
    if DEPTH_MIN_K <= k <= DEPTH_MAX_K:
        return "batch_depth"
    return "sgemm"


class GemmProduct(NamedTuple):
    """One product of a step through the dispatch: C (m, n) (+)= A (m, k)
    B (k, n) in the kernels' operand convention (``ak``: A contiguous along
    k; ``bnc``: B contiguous along n), with bfloat16 operands (``rnd``),
    added to C (``acc``), with a bias."""

    name: str
    m: int
    n: int
    k: int
    ak: bool
    bnc: bool
    rnd: bool
    acc: bool
    bias: bool

    @property
    def route(self) -> str:
        return product_route(self.n, self.k)


def routes_of(products: Iterable[GemmProduct]) -> dict[str, int]:
    """{route: products on it}, every route a key."""
    out = dict.fromkeys(ROUTES, 0)
    for p in products:
        out[p.route] += 1
    return out


def _fma(acc: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """acc + x y rounded once, as fmaf does, for float32 operands (the
    product is exact in float64, the sum rounds to float64 and then to
    float32); plain float64 arithmetic for float64 ones."""
    if acc.dtype == torch.float64:
        return acc + x * y
    return (acc.double() + x.double() * y.double()).to(acc.dtype)


def _epilogue(total, c, bias):
    if c is not None:
        total = c + total
    if bias is None:
        return total
    return total + (bias.unsqueeze(-2) if bias.ndim > 1 else bias)   # (members, N): per member


def deep_narrow_plain(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
                      c: torch.Tensor | None = None, rnd: bool = False) -> torch.Tensor:
    """The deep narrow kernel's arithmetic in torch ops: for each output
    row, lane l's sum over the depth l, l + 32, ... (one rounding a term, in
    that order), then the lanes' sums added pairwise, lane l and l + off at
    off = 16, 8, 4, 2, 1; then C + that and + bias.  ``a`` (..., M, K),
    ``b`` (..., K, N), ``bias`` (N,) or (members, N)."""
    if rnd:
        a, b = bf16_rounder(True)(a), bf16_rounder(True)(b)
    k = a.shape[-1]
    slices = -(-k // LANES)
    pad = slices * LANES - k
    a_l = torch.nn.functional.pad(a, (0, pad)).unflatten(-1, (slices, LANES))   # m, j, lane
    b_l = torch.nn.functional.pad(b, (0, 0, 0, pad)).unflatten(-2, (slices, LANES))
    shape = torch.broadcast_shapes(a.shape[:-1] + (LANES, 1), b.shape[:-2] + (1, LANES,
                                                                              b.shape[-1]))
    lanes = torch.zeros(shape, dtype=a.dtype, device=a.device)        # (..., M, lane, N)
    for j in range(slices):
        lanes = _fma(lanes, a_l[..., j, :].unsqueeze(-1), b_l[..., j, :, :].unsqueeze(-3))
    off = LANES // 2
    while off:
        lanes = lanes[..., :off, :] + lanes[..., off:2 * off, :]
        off //= 2
    return _epilogue(lanes[..., 0, :], c, bias)


def batch_depth_plain(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
                      c: torch.Tensor | None = None, rnd: bool = False) -> torch.Tensor:
    """The batch-depth kernel's arithmetic in torch ops, and the tiled
    SGEMM's: each output one chain of FMAs over k = 0 ... K - 1 (one
    rounding a term); then C + that and + bias."""
    if rnd:
        a, b = bf16_rounder(True)(a), bf16_rounder(True)(b)
    shape = torch.broadcast_shapes(a.shape[:-1] + (1,), b.shape[:-2] + (1, b.shape[-1]))
    total = torch.zeros(shape, dtype=a.dtype, device=a.device)
    for i in range(a.shape[-1]):
        total = _fma(total, a[..., :, i:i + 1], b[..., i:i + 1, :])
    return _epilogue(total, c, bias)


def product_gemm_plain(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
                       c: torch.Tensor | None = None, rnd: bool = False,
                       route: str | None = None) -> torch.Tensor:
    """The arithmetic of ``route`` (default: the shape's route)."""
    route = route or product_route(b.shape[-1], a.shape[-1])
    if route == "deep_narrow":
        return deep_narrow_plain(a, b, bias, c, rnd)
    return batch_depth_plain(a, b, bias, c, rnd)


def _check_route(route: str | None, n: int, k: int) -> None:
    if route is None:
        return
    if route not in ROUTES:
        raise ValueError(f"product_gemm: route must be one of {ROUTES}, got {route!r}")
    if route == "deep_narrow" and (n > NARROW_MAX_N or k > NARROW_MAX_K):
        raise ValueError(f"product_gemm: the deep narrow kernel takes N <= {NARROW_MAX_N} "
                         f"and K <= {NARROW_MAX_K}, got N = {n}, K = {k}")
    if route == "batch_depth" and k > DEPTH_MAX_K:
        raise ValueError(f"product_gemm: the batch-depth kernel takes K <= {DEPTH_MAX_K}, "
                         f"got K = {k}")


def product_gemm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
                 out: torch.Tensor | None = None, acc: bool = False, rnd: bool = False,
                 route: str | None = None) -> torch.Tensor:
    """One product as the training steps launch it through the dispatch:
    ``a`` (M, K) and ``b`` (K, N), each with any strides and optionally a
    leading member axis (then one launch for every member), ``bias`` (N,) or
    (members, N); into ``out`` ((members,) M, N, rows contiguous), added to
    it with ``acc``.  ``route`` None takes the shape's route, as a step does;
    a route name forces that kernel (within its limits).  CUDA tensors
    launch it (counted in ``LAUNCHES``) or raise; CPU tensors take
    ``product_gemm_plain``."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if b.shape[-2] != k or a.ndim not in (2, 3) or b.ndim not in (2, 3):
        raise ValueError(f"product_gemm: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    _check_route(route, n, k)
    members = max(a.shape[0] if a.ndim == 3 else 1, b.shape[0] if b.ndim == 3 else 1)
    shape = (members, m, n) if max(a.ndim, b.ndim) == 3 else (m, n)
    if out is None:
        if acc:
            raise ValueError("product_gemm: acc needs out")
        out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if a.device.type != "cuda":
        out.copy_(product_gemm_plain(a, b, bias, out if acc else None, rnd, route))
        return out
    tensors = [t for t in (a, b, bias, out) if t is not None]
    if any(t.dtype != torch.float32 or t.device != a.device for t in tensors):
        raise ValueError("product_gemm: float32 tensors on one device needed")
    if tuple(out.shape) != shape or out.stride(-1) != 1:
        raise ValueError(f"product_gemm: out must be {shape} with contiguous rows")
    if bias is not None and (bias.shape[-1] != n or bias.stride(-1) != 1):
        raise ValueError(f"product_gemm: bias must be (..., {n}) and contiguous")
    check_capability(a.device.index or 0)
    ak = a.stride(-1) <= a.stride(-2)
    bnc = b.stride(-1) <= b.stride(-2)
    flags = int(ak) | (int(bnc) << 1) | (int(rnd) << 2) | (int(acc) << 3)
    taken = route or product_route(n, k)
    launch("product_gemm", a.device, -1 if route is None else ROUTES.index(route), m, n, k,
           a.data_ptr(), a.stride(-2), a.stride(-1), _member_stride(a, 2),
           b.data_ptr(), b.stride(-2), b.stride(-1), _member_stride(b, 2),
           out.data_ptr(), out.stride(-2), _member_stride(out, 2),
           None if bias is None else bias.data_ptr(),
           0 if bias is None else _member_stride(bias, 1), members, flags,
           count_as=LAUNCH_KEYS[taken])
    return out


def product_route_on_card(n: int, k: int) -> str:
    """The route the C rule gives this shape (``product_route`` mirrors it)."""
    return ROUTES[load_library().pigan_product_route(n, k)]


def step_operands(p: GemmProduct, members: int = 1, seed: int = 0, *, device) -> tuple:
    """Seeded operands of ``p`` in the layouts a step gives them: A (m, k)
    contiguous along k (``ak``) or a transposed (k, m) buffer; B (k, n)
    contiguous along n (``bnc``) or a transposed (n, k) weight; bias (n,)
    and C (m, n) where ``p`` takes them, else None; a leading member axis on
    each when ``members`` > 1.  For the card tests and the timings."""
    gen = torch.Generator().manual_seed(seed)
    lead = (members,) if members > 1 else ()

    def draw(*shape):
        return torch.randn((*lead, *shape), generator=gen)

    a = draw(p.m, p.k) if p.ak else draw(p.k, p.m).transpose(-1, -2)
    b = draw(p.k, p.n) if p.bnc else draw(p.n, p.k).transpose(-1, -2)
    bias = draw(p.n) if p.bias else None
    c = draw(p.m, p.n) if p.acc else None
    return tuple(None if t is None else t.to(device) for t in (a, b, bias, c))
