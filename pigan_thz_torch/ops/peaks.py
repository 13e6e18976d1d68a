"""Resonance-peak analysis (f_res, Q, FoM, sensitivity S) on (B, N) batches.

The port of ``pigan_thz_tpu/ops/peaks.py``.  Dip detection has scipy
``find_peaks(-t, prominence=1.0, width=1)`` semantics (the reference's
call, ``data_loader.py:84``): plateau-aware local maxima of x = -t,
topographic prominence, width at half prominence.  Dip selection, the FWHM
and the eight metrics (f1, f2, Q1, FoM1, S1, Q2, FoM2, S2) follow
``data_loader.py:13-111`` with the JAX package's tie rules.

The qualification is the O(N^2)-per-spectrum part of the TPU's Pallas
kernel K4.  Its hand-written CUDA kernel (``csrc/dip_qualification.cu``, one
warp a spectrum) has two entry points:

- the four-output entry, behind ``batched_dip_qualification``: the masks,
  prominence and width of every index;
- the metrics entry, behind ``batched_peak_metrics``: the same qualification,
  then the selection of the two dips and their FWHM in the same launch, with
  the row still in shared memory, writing the (B, 8) metrics and nothing
  else.  The JAX package leaves that O(N) work to XLA, which fuses it; in
  eager torch (``spectrum_metrics``) it is ~250 small kernels a call.

Their plain PyTorch versions:

- ``dip_qualification``, the (N, N) index lattice of masked reductions: the
  same math as the TPU kernel, and the reference the CUDA kernel is held
  against;
- ``_dip_qualification_lifted``, the O(N log N) sparse-table form: the CPU
  batch path (on a row with a NaN sample it differs from the lattice, as
  the JAX package's does);
- for the metrics, ``spectrum_metrics``: selection and FWHM in plain torch,
  given a qualification.

The wrappers route by the input's device: a CPU tensor goes to the plain
versions (the lifted form, then ``spectrum_metrics``), a CUDA tensor to the
kernel, anything else raises; there is no fallback from a failed launch.

Everything is batched over rows, with no Python loop over spectra.  The
analysis computes in float32 while scipy computes in float64, so a dip
whose true prominence or width lies within fp32 rounding of a threshold
can be qualified differently (the JAX package's known boundary).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._cuda_build import check_capability, launch

MAX_N = 4096          # the kernel's cap on the spectrum length
LATTICE_CHUNK = 256   # rows per (rows, N, N) lattice pass: 64 MB of int32 at N = 250
LIFTED_CHUNK = 4096   # rows per sparse-table pass


class PeakMetrics(NamedTuple):
    f_res: torch.Tensor
    q: torch.Tensor
    fom: torch.Tensor
    t_min: torch.Tensor
    valid: torch.Tensor


class DipQualification(NamedTuple):
    """Per-index dip analysis, every field (B, N).

    ``qualified[b, i]`` is True iff scipy's
    ``find_peaks(-t[b], prominence=min_prominence, width=min_width)`` would
    return index i.  ``prominence`` / ``width`` carry the underlying
    measures, meaningful only where ``is_peak``; other entries are
    don't-care values."""

    qualified: torch.Tensor     # bool
    is_peak: torch.Tensor       # bool: plateau-midpoint local maximum of -t
    prominence: torch.Tensor    # topographic prominence of -t at the peak
    width: torch.Tensor         # interpolated width (samples) at half prominence


def _in_chunks(fn, t: torch.Tensor, chunk: int, *args) -> DipQualification:
    parts = [fn(t[s : s + chunk], *args) for s in range(0, max(t.shape[0], 1), chunk)]
    if len(parts) == 1:
        return parts[0]
    return DipQualification(*(torch.cat(f) for f in zip(*parts)))


# ---------------------------------------------------------------------------
# Plain versions of K4
# ---------------------------------------------------------------------------


def dip_qualification(
    t: torch.Tensor, min_prominence: float = 1.0, min_width: float = 1.0
) -> DipQualification:
    """scipy ``find_peaks(-t, prominence, width)`` parity over (B, N) spectra,
    as masked reductions over the (N, N) index lattice
    (``pigan_thz_tpu/ops/peaks.py:dip_qualification``), LATTICE_CHUNK rows
    at a time."""
    return _in_chunks(_lattice, t, LATTICE_CHUNK, min_prominence, min_width)


def _lattice(t, min_prominence, min_width) -> DipQualification:
    x = -t
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device)
    j = iota.to(torch.int32)[None, :]   # scan axis (int32 halves the lattice)
    i = j.T                             # peak-candidate axis
    xi = x[:, :, None]
    xj = x[:, None, :]

    # --- plateau-aware local maxima (scipy _local_maxima_1d) ---
    greater = xj > xi
    lower = xj < xi
    left = j < i
    right = j > i
    lg = torch.where(greater & left, j, -1).amax(-1)    # last strictly-higher left
    rg = torch.where(greater & right, j, n).amin(-1)    # first strictly-higher right
    llt = torch.where(lower & left, j, -1).amax(-1)     # last strictly-lower left
    rlt = torch.where(lower & right, j, n).amin(-1)     # first strictly-lower right
    ld = torch.maximum(lg, llt)                         # nearest differing left
    rd = torch.minimum(rg, rlt)                         # nearest differing right
    # the nearer differing neighbour is lower iff the lower one is the nearer
    run_is_peak = (ld >= 0) & (llt > lg) & (rd <= n - 1) & (rlt < rg)
    midpoint = torch.div(ld + rd, 2, rounding_mode="floor")   # plateau midpoint
    is_peak = run_is_peak & (iota == midpoint)

    # --- topographic prominence (scipy _peak_prominences, wlen=None) ---
    lwin = (j > lg[..., None]) & (j <= i)     # (lg, i]
    rwin = (j >= i) & (j < rg[..., None])     # [i, rg)
    left_min = torch.where(lwin, xj, torch.inf).amin(-1)
    right_min = torch.where(rwin, xj, torch.inf).amin(-1)
    prominence = x - torch.maximum(left_min, right_min)

    # --- interpolated width at rel_height=0.5 (scipy _peak_widths) ---
    # the unbounded nearest search equals scipy's base-bounded walk for a
    # true peak: x[base] <= x[peak] - prominence < height
    height = x - 0.5 * prominence
    at_or_below = xj <= height[..., None]
    jl = torch.where(at_or_below & left, j, -1).amax(-1)
    jr = torch.where(at_or_below & right, j, n).amin(-1)
    width = _interp_width(x, height, jl, jr)

    qualified = is_peak & (prominence >= min_prominence) & (width >= min_width)
    return DipQualification(qualified, is_peak, prominence, width)


def _interp_width(x, height, jl, jr):
    """scipy _peak_widths intersection interpolation given the stop samples
    jl / jr (-1 / n where there is none)."""
    n = x.shape[-1]
    jl_c = jl.long().clamp(0, n - 1)
    jr_c = jr.long().clamp(0, n - 1)
    x_jl = x.gather(-1, jl_c)
    x_jl1 = x.gather(-1, (jl_c + 1).clamp(max=n - 1))
    x_jr = x.gather(-1, jr_c)
    x_jr1 = x.gather(-1, (jr_c - 1).clamp(min=0))
    # interpolate only when the stop sample is strictly below the height
    # (scipy: `if x[i] < height`)
    dl = torch.where(x_jl1 != x_jl, x_jl1 - x_jl, 1.0)
    dr = torch.where(x_jr1 != x_jr, x_jr1 - x_jr, 1.0)
    left_ip = jl_c + torch.where(x_jl < height, (height - x_jl) / dl, 0.0)
    right_ip = jr_c - torch.where(x_jr < height, (height - x_jr) / dr, 0.0)
    return right_ip - left_ip


def _dip_qualification_lifted(
    t: torch.Tensor, min_prominence: float = 1.0, min_width: float = 1.0
) -> DipQualification:
    """Same semantics as ``dip_qualification``, O(N log N) per spectrum via
    sparse tables (``pigan_thz_tpu/ops/peaks.py:_dip_qualification_lifted``),
    LIFTED_CHUNK rows at a time: the CPU batch path."""
    return _in_chunks(_lifted, t, LIFTED_CHUNK, min_prominence, min_width)


def _lifted(t, min_prominence, min_width) -> DipQualification:
    x = -t
    b, n = x.shape
    iota = torch.arange(n, device=x.device).expand(b, n)
    K = max(1, (n - 1).bit_length())     # 2^K >= n
    pad = 1 << K

    # sparse tables over the padded signal: level k holds the max / min of
    # [j, j+2^k); the -inf / +inf sentinels qualify for no predicate below.
    # (roll wraps, but blocks starting inside the real signal never reach
    # the wrapped region, and blocks starting in the sentinel run only ever
    # delay a walk that is already out of range.)
    maxt = [torch.cat([x, x.new_full((b, pad), -torch.inf)], dim=1)]
    mint = [torch.cat([x, x.new_full((b, pad), torch.inf)], dim=1)]
    for k in range(1, K + 1):
        h = 1 << (k - 1)
        maxt.append(torch.maximum(maxt[-1], torch.roll(maxt[-1], -h, dims=1)))
        mint.append(torch.minimum(mint[-1], torch.roll(mint[-1], -h, dims=1)))

    def nearest_left(tabs, thr, has):
        """Largest j < i with has(x[j], thr[i]); -1 if none.  Branchless
        binary descent: extend the non-qualifying suffix [hi, i) by dyadic
        blocks, largest first."""
        hi = iota
        for k in range(K - 1, -1, -1):
            cand = hi - (1 << k)
            agg = tabs[k].gather(1, cand.clamp(min=0))
            hi = torch.where((cand >= 0) & ~has(agg, thr), cand, hi)
        return hi - 1

    def nearest_right(tabs, thr, has):
        """Smallest j > i with has(x[j], thr[i]); n if none."""
        lo = iota + 1
        for k in range(K - 1, -1, -1):
            agg = tabs[k].gather(1, lo)   # block [lo, lo + 2^k); padding in range
            lo = torch.where(~has(agg, thr), lo + (1 << k), lo)
        return lo.clamp(max=n)

    # --- plateau-aware local maxima (scipy _local_maxima_1d) ---
    # a block holds a sample > thr iff its max does; < or <= iff its min does
    lgt = nearest_left(maxt, x, torch.gt)      # last strictly-higher left
    llt = nearest_left(mint, x, torch.lt)      # last strictly-lower left
    rgt = nearest_right(maxt, x, torch.gt)     # first strictly-higher right
    rlt = nearest_right(mint, x, torch.lt)     # first strictly-lower right
    ld = torch.maximum(lgt, llt)
    rd = torch.minimum(rgt, rlt)
    run_is_peak = (ld >= 0) & (llt > lgt) & (rd <= n - 1) & (rlt < rgt)
    midpoint = torch.div(ld + rd, 2, rounding_mode="floor")
    is_peak = run_is_peak & (iota == midpoint)

    # --- prominence: range-min over the walk windows (lg, i] and [i, rg) ---
    stacked = torch.stack(mint)                      # (K+1, b, n+pad)
    rows = torch.arange(b, device=x.device)[:, None]

    def range_min(l, r):
        """min x over [l, r] inclusive (l <= r): two overlapping blocks."""
        length = r - l + 1
        kq = torch.zeros_like(length)
        for k in range(1, K + 1):
            kq = torch.where(length >= (1 << k), k, kq)
        left_block = stacked[kq, rows, l]
        right_block = stacked[kq, rows, (r - 2**kq + 1).clamp(min=0)]
        return torch.minimum(left_block, right_block)

    left_min = range_min((lgt + 1).clamp(min=0), iota)
    right_min = range_min(iota, (rgt - 1).clamp(max=n - 1))
    prominence = x - torch.maximum(left_min, right_min)

    # --- width at rel_height=0.5: nearest at-or-below the eval height ---
    height = x - 0.5 * prominence
    jl = nearest_left(mint, height, torch.le)
    jr = nearest_right(mint, height, torch.le)
    width = _interp_width(x, height, jl, jr)

    qualified = is_peak & (prominence >= min_prominence) & (width >= min_width)
    return DipQualification(qualified, is_peak, prominence, width)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------


def _check_spectra(name: str, spectra: torch.Tensor) -> None:
    if spectra.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 spectra, got {spectra.dtype}")
    if spectra.dim() != 2:
        raise ValueError(f"{name}: expected spectra (B, N), got {tuple(spectra.shape)}")
    if not spectra.is_contiguous():
        raise ValueError(f"{name}: spectra must be contiguous")
    if spectra.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {spectra.device}")


def _kernel_shape(name: str, spectra: torch.Tensor) -> tuple[int, int]:
    """(B, N) of CUDA spectra the kernel takes; raises for any other."""
    batch, n = spectra.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name}: the kernel takes 1 <= N <= {MAX_N}, got N = {n}")
    check_capability(spectra.device.index)
    return batch, n


def batched_dip_qualification(
    spectra: torch.Tensor, min_prominence: float = 1.0, min_width: float = 1.0
) -> DipQualification:
    """(B, N) float32 spectra -> DipQualification, every field (B, N).

    A CUDA tensor goes to the CUDA kernel's four-output entry (one launch;
    prominence and width are 0 off peaks), a CPU tensor to
    ``_dip_qualification_lifted``; any other device raises."""
    name = "dip_qualification"
    _check_spectra(name, spectra)
    if spectra.device.type == "cpu":
        return _dip_qualification_lifted(spectra, min_prominence, min_width)
    batch, n = _kernel_shape(name, spectra)
    out = DipQualification(*(
        torch.empty((batch, n), dtype=dtype, device=spectra.device)
        for dtype in (torch.bool, torch.bool, torch.float32, torch.float32)
    ))
    if batch:
        launch(name, spectra.device, spectra.data_ptr(),
               *(o.data_ptr() for o in out), batch, n,
               float(min_prominence), float(min_width))
    return out


# ---------------------------------------------------------------------------
# Selection, FWHM and the eight metrics: the plain version of the metrics
# entry, in torch on the input's device
# ---------------------------------------------------------------------------


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[b, idx[b]] for a (B, N) and idx (B,)."""
    return a.gather(1, idx[:, None])[:, 0]


def _per_row(v, t: torch.Tensor) -> torch.Tensor:
    """None / scalar / (B,) -> (B,) tensor of t's dtype on t's device."""
    v = torch.nan if v is None else v
    return torch.as_tensor(v, dtype=t.dtype, device=t.device).expand(t.shape[0])


def find_two_dips(
    t: torch.Tensor,
    min_prominence: float = 1.0,
    freq: torch.Tensor | None = None,
    centers: tuple[torch.Tensor, torch.Tensor] | None = None,
    min_width: float = 1.0,
    qualified: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Indices of the two reference dips among scipy-qualified candidates,
    for (B, N) spectra: ``(i1, i2, has1, has2)``, each (B,).

    With ``centers=(c1, c2)`` (each (B,)) and ``freq``, dip 1 is the
    qualified dip closest to c1 and dip 2 the closest to c2 among the rest
    (``data_loader.py:91-105``); rows with a NaN centre fall back to depth
    selection.  Without centres, the two deepest qualified dips in frequency
    order.  ``has1`` / ``has2`` say whether enough qualified dips exist;
    where False the paired index is a placeholder.  Ties go to the lower
    index (``argmin`` takes the first minimum)."""
    n = t.shape[-1]
    iota = torch.arange(n, device=t.device)
    qual = (
        qualified
        if qualified is not None
        else batched_dip_qualification(t, min_prominence, min_width).qualified
    )

    # depth selection: deepest qualified dip, then deepest of the rest
    depth1 = torch.where(qual, t, torch.inf)
    d1 = depth1.argmin(1)
    has1 = torch.isfinite(_take(depth1, d1))
    depth2 = torch.where(qual & (iota != d1[:, None]), t, torch.inf)
    d2 = depth2.argmin(1)
    has2 = has1 & torch.isfinite(_take(depth2, d2))
    # frequency order when no centres constrain the roles
    d1o = torch.where(has2, torch.minimum(d1, d2), d1)
    d2o = torch.where(has2, torch.maximum(d1, d2), d1)

    if centers is None or freq is None:
        return d1o, d2o, has1, has2

    c1, c2 = centers
    use_centers = torch.isfinite(c1) & torch.isfinite(c2)
    dist1 = torch.where(qual, (freq - c1[:, None]).abs(), torch.inf)
    i1c = dist1.argmin(1)
    dist2 = torch.where(qual & (iota != i1c[:, None]), (freq - c2[:, None]).abs(), torch.inf)
    i2c = dist2.argmin(1)
    has2c = has1 & torch.isfinite(_take(dist2, i2c))

    i1 = torch.where(use_centers, i1c, d1o)
    i2 = torch.where(use_centers, i2c, d2o)
    has2 = torch.where(use_centers, has2c, has2)
    i2 = torch.where(has2, i2, i1)
    return i1, i2, has1, has2


def _interp_crossing(freq, t, j, level):
    """Frequency where row b of t crosses level[b] in [j[b], j[b]+1]
    (``data_loader.py:25-26``); freq[j] where the segment is flat."""
    t0 = _take(t, j)
    t1 = _take(t, j + 1)
    denom = t1 - t0
    frac = torch.where(denom.abs() > 1e-12, (level - t0) / denom, 0.0)
    return freq[j] + frac * (freq[j + 1] - freq[j])


def peak_parameters(
    freq: torch.Tensor, t: torch.Tensor, peak_idx: torch.Tensor, baseline: float = 0.0
) -> PeakMetrics:
    """FWHM-based Q and FoM for one dip per row (``data_loader.py:13-58``).

    A crossing at segment j means the half-depth level separates t[j] and
    t[j+1], in either direction; the nearest crossing strictly left / right
    of the dip gives the FWHM edges."""
    n = t.shape[-1]
    f_res = freq[peak_idx]
    t_min = _take(t, peak_idx)
    half = t_min + (baseline - t_min) / 2.0

    seg = torch.arange(n - 1, device=t.device)
    h = half[:, None]
    t0, t1 = t[:, :-1], t[:, 1:]
    above0 = t0 >= h
    below1 = t1 < h
    crossing = (above0 & below1) | (~above0 & ~below1 & (t0 < h) & (t1 >= h))
    # left search over segments [0, peak_idx - 1], right over [peak_idx + 1, n - 2]
    left_ok = crossing & (seg <= peak_idx[:, None] - 1)
    right_ok = crossing & (seg >= peak_idx[:, None] + 1)
    jl = torch.where(left_ok, seg, -1).amax(1)
    jr = torch.where(right_ok, seg, n).amin(1)

    f_lower = _interp_crossing(freq, t, jl.clamp(0, n - 2), half)
    f_upper = _interp_crossing(freq, t, jr.clamp(0, n - 2), half)
    delta_f = f_upper - f_lower
    valid = (jl >= 0) & (jr < n) & (delta_f > 1e-9)
    q = torch.where(valid, f_res / torch.where(valid, delta_f, 1.0), torch.nan)
    fom_ok = valid & (t_min.abs() > 1e-6)
    fom = torch.where(fom_ok, q / t_min.abs(), torch.nan)
    return PeakMetrics(f_res=f_res, q=q, fom=fom, t_min=t_min, valid=valid)


def sensitivity(f_res: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """S = (f/1.0)·(Q/100)·100 with the reference's scale constants
    (``data_loader.py:96,105``)."""
    return torch.where(torch.isnan(q), torch.nan, f_res * q)


def spectrum_metrics(
    freq: torch.Tensor,
    t: torch.Tensor,
    fallback_f1=None,
    fallback_f2=None,
    min_prominence: float = 1.0,
    qualified: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, N) spectra -> (B, 8) metrics (f1, f2, Q1, FoM1, S1, Q2, FoM2, S2).

    The expected centres (None, scalars or (B,)) select the dips closest to
    them (``data_loader.py:93,102``) and stand in for f when no dip
    qualifies (``data_loader.py:108-109``); Q / FoM / S stay NaN then."""
    fb1, fb2 = _per_row(fallback_f1, t), _per_row(fallback_f2, t)
    i1, i2, has1, has2 = find_two_dips(
        t, min_prominence=min_prominence, freq=freq, centers=(fb1, fb2),
        qualified=qualified,
    )
    p1 = peak_parameters(freq, t, i1)
    p2 = peak_parameters(freq, t, i2)

    f1 = torch.where(has1, p1.f_res, torch.nan)
    q1 = torch.where(has1, p1.q, torch.nan)
    fom1 = torch.where(has1, p1.fom, torch.nan)
    f2 = torch.where(has2, p2.f_res, torch.nan)
    q2 = torch.where(has2, p2.q, torch.nan)
    fom2 = torch.where(has2, p2.fom, torch.nan)

    f1 = torch.where(torch.isnan(f1), fb1, f1)
    f2 = torch.where(torch.isnan(f2), fb2, f2)
    return torch.stack(
        [f1, f2, q1, fom1, sensitivity(f1, q1), q2, fom2, sensitivity(f2, q2)], dim=1
    )


def batched_peak_metrics(
    freq,
    spectra: torch.Tensor,
    fallback_f1=None,
    fallback_f2=None,
    min_prominence: float = 1.0,
) -> torch.Tensor:
    """(B, N) float32 spectra -> (B, 8) metrics (f1, f2, Q1, FoM1, S1, Q2,
    FoM2, S2) on the spectra's device; the centres as ``spectrum_metrics``
    takes them.

    A CUDA tensor goes to the kernel's metrics entry: one launch for the
    qualification, the selection and the FWHM of the whole batch, counted
    under ``LAUNCHES["dip_qualification"]``.  A CPU tensor goes to the
    plain versions: ``_dip_qualification_lifted``, then
    ``spectrum_metrics``.  Any other device raises."""
    name = "peak_metrics"
    _check_spectra(name, spectra)
    freq = torch.as_tensor(freq, dtype=torch.float32, device=spectra.device)
    if spectra.device.type == "cpu":
        qual = _dip_qualification_lifted(spectra, min_prominence).qualified
        return spectrum_metrics(
            freq, spectra, fallback_f1, fallback_f2, min_prominence=min_prominence,
            qualified=qual,
        )
    batch, n = _kernel_shape(name, spectra)
    if tuple(freq.shape) != (n,):
        raise ValueError(f"{name}: expected freq ({n},), got {tuple(freq.shape)}")
    freq = freq.contiguous()
    # no centres: a null pointer, which the kernel reads as NaN in every row
    fb = [None if v is None else _per_row(v, spectra).contiguous()
          for v in (fallback_f1, fallback_f2)]
    out = torch.empty((batch, 8), dtype=torch.float32, device=spectra.device)
    if batch:
        launch(name, spectra.device, spectra.data_ptr(), freq.data_ptr(),
               *(None if v is None else v.data_ptr() for v in fb), out.data_ptr(), batch,
               n, float(min_prominence), 1.0, count_as="dip_qualification")
    return out
