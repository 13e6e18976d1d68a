// Resonance-dip qualification and the eight peak metrics, fp32, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of pigan_thz_tpu/ops/peaks.py:
// batched_dip_qualification (K4), and in its second entry the selection and
// FWHM that the JAX package leaves to XLA after it (peaks.py:find_two_dips,
// peak_parameters, spectrum_metrics).
//
// What it computes.  For each spectrum t, on x = -t, index by index, what
// scipy's find_peaks(-t, prominence=min_prominence, width=min_width) decides:
//   - is_peak: plateau-aware local maxima (a sample strictly above its nearest
//     differing neighbours on both sides; a flat run reports its midpoint;
//     the signal's endpoints never qualify);
//   - prominence: x[i] - max(min of x over (lg, i], min of x over [i, rg)),
//     with lg / rg the nearest strictly higher samples (or the borders);
//   - width at half prominence, interpolated between the nearest samples at
//     or below x[i] - prominence / 2 on each side, as the plain versions'
//     _interp_width does;
//   - qualified = is_peak && prominence >= min_prominence && width >= min_width.
// pigan_dip_qualification writes these four per index (prominence and width
// 0 off peaks).  pigan_peak_metrics goes on, with the row still in shared
// memory, to spectrum_metrics of ops/peaks.py: the two dips (by depth, or
// closest to the row's two centres where both are finite), the half-depth
// crossings around each, and writes (f1, f2, Q1, FoM1, S1, Q2, FoM2, S2):
// 32 bytes a row in place of 10 bytes a sample.
//
// Design.  One warp a spectrum, up to kWarps spectra a block, each warp's row
// of x in its own slice of shared memory; warps never wait for one another
// (no block barrier).  Every quantity is a nearest index (the nearest
// differing, strictly higher, or at-or-below sample on a side) or a window
// minimum along that walk.  The TPU kernel evaluates each as a masked
// reduction over the (N, N) lattice; here:
//   - the local maxima, 32 candidates a step: the nearest differing samples
//     bound a candidate's run of equal samples, whose start and end are the
//     nearest set bits of two ballots (x[j] != x[j - 1], x[j] != x[j + 1]),
//     so a plateau costs no walk;
//   - the peaks go to a list, and the lanes take them 32 at a time, so no
//     lane idles on a candidate that is not a peak;
//   - each walk skips blocks of kBlock samples on the blocks' max / min
//     (kept beside the row): the window minimum folds a block's min, the
//     stop lies in the first block whose max (higher) or min (at or below)
//     says so.  A walk to the border is at most 2 kBlock + N / kBlock steps
//     in place of N; the lanes of a warp wait on its longest walk.
// A NaN is of every level (neither higher nor lower) and a block's max / min
// cannot say where it is, so a row that holds one walks sample by sample
// (the parent kernel's walks).  In the metrics entry the qualified
// candidates become bits, the selection is a warp argmin with
// torch.argmin's order (NaN first, ties to the lower index) and the
// crossings' searches are ballot scans.
//
// Bounds on the card.  At N = 250 the four-output entry reads 1 KB and writes
// 2.5 KB a spectrum, the metrics entry reads 1 KB and writes 32 bytes: 29 MB
// and 8.5 MB at B = 8192, 8.6 and 2.5 us at 3.35 TB/s.  The work is shared
// loads and compares along the walks, data-dependent: a spectrum of white
// noise has ~N / 3 peaks whose windows average 12 samples a side, with a
// long tail.  The kernel is bound by instruction issue, not by device
// memory: at B = 8192 every row is resident at once (8 warps a block, 64
// warps an SM), and a warp's walks take most of its time.
//
// Exactness.  A nearest index does not depend on how it is found, and min /
// max of floats are exact in any order (NaN propagates as torch.minimum
// does), so the masks and prominence equal the lattice's bit for bit (up to
// the sign of a zero minimum).  The arithmetic after the walks rounds after
// every operation in the plain versions' order (__f*_rn: no contraction), with
// thresholds as float32 constants, as torch compares a float32 tensor with a
// Python float.  Built without --use_fast_math: divisions are IEEE.
//
// Interface: plain C, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kWarps = 8;               // spectra a block where shared memory allows
constexpr int kMaxN = 4096;
constexpr int kSmemBudget = 48 * 1024;  // no opt-in: fewer warps a block for large N
constexpr int kBlockShift = 3;          // the walks skip blocks of 8 samples
constexpr int kBlock = 1 << kBlockShift;
constexpr unsigned kFull = 0xffffffffu;

// torch.minimum / torch.maximum semantics: NaN propagates.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Stop predicates of the walks, on a sample and on a block's (max, min):
// the block holds a stop iff its max / min says so.
struct Higher {     // nearest strictly higher sample
  float ref;
  __device__ bool operator()(float v) const { return v > ref; }
  __device__ bool block(float mx, float) const { return mx > ref; }
};
struct AtOrBelow {  // nearest sample at or below the evaluation height
  float ref;
  __device__ bool operator()(float v) const { return v <= ref; }
  __device__ bool block(float, float mn) const { return mn <= ref; }
};

__device__ __forceinline__ bool outside(int j, int n, int dir) {
  return dir < 0 ? j < 0 : j >= n;
}

// The nearest j beyond i in direction kDir with stop(x[j]) (-1 / n where
// there is none), folding the samples passed into mn (kMin).  Sample by
// sample where the row holds a NaN (blocks = false); else sample by sample
// to the edge of i's block, block by block on the blocks' max / min while
// no block holds a stop, and sample by sample in the block that does.  Not
// inlined: its four calls inlined ran no faster and took more registers
// (examples/torch_k4_times.py --ablate).
template <int kDir, bool kMin, class Stop>
__device__ __noinline__ int walk(const float* x, const float* bmax, const float* bmin, int n,
                                 int i, bool blocks, Stop stop, float& mn) {
  int j = i + kDir;
  const int edge = kDir > 0 ? 0 : kBlock - 1;
  for (; !outside(j, n, kDir) && (!blocks || (j & (kBlock - 1)) != edge); j += kDir) {
    const float v = x[j];
    if (stop(v)) return j;
    if (kMin) mn = nan_min(mn, v);
  }
  if (outside(j, n, kDir)) return j;
  const int nb = (n + kBlock - 1) >> kBlockShift;
  int b = j >> kBlockShift;
  for (; !outside(b, nb, kDir) && !stop.block(bmax[b], bmin[b]); b += kDir)
    if (kMin) mn = nan_min(mn, bmin[b]);
  if (outside(b, nb, kDir)) return kDir < 0 ? -1 : n;
  for (j = kDir > 0 ? b << kBlockShift : min((b << kBlockShift) + kBlock - 1, n - 1);;
       j += kDir) {
    const float v = x[j];
    if (stop(v)) return j;
    if (kMin) mn = nan_min(mn, v);
  }
}

// Where a NaN-free row's run of equal samples that goes on past a chunk
// ends: the first j >= from with x[j] != x[j + 1] (or n - 1), by ballots a
// chunk at a time.  Warp-uniform.
__device__ int run_end(const float* x, int n, int from, int lane) {
  for (int base = from & ~31;; base += 32) {
    const int j = base + lane;
    const unsigned ends =
        __ballot_sync(kFull, j >= from && j < n && (j == n - 1 || x[j + 1] != x[j]));
    if (ends) return base + __ffs(ends) - 1;
  }
}

// One peak's prominence, width and qualification (scipy's _peak_prominences
// with wlen=None and _peak_widths at rel_height 0.5, as the plain versions
// compute them).
struct Measures {
  float prominence, width;
  bool qualified;
};

__device__ Measures measure(const float* x, const float* bmax, const float* bmin, int n,
                            int i, bool blocks, float min_prominence, float min_width) {
  const float xi = x[i];
  // window minima up to the nearest strictly higher sample on each side
  float left_min = xi, right_min = xi, unused = 0.f;
  walk<-1, true>(x, bmax, bmin, n, i, blocks, Higher{xi}, left_min);
  walk<1, true>(x, bmax, bmin, n, i, blocks, Higher{xi}, right_min);
  Measures m;
  m.prominence = __fsub_rn(xi, nan_max(left_min, right_min));
  // the nearest samples at or below the evaluation height, then scipy's
  // intersection interpolation (peaks.py:_interp_width)
  const float height = __fsub_rn(xi, __fmul_rn(0.5f, m.prominence));
  const int jl = walk<-1, false>(x, bmax, bmin, n, i, blocks, AtOrBelow{height}, unused);
  const int jr = walk<1, false>(x, bmax, bmin, n, i, blocks, AtOrBelow{height}, unused);
  const int jlc = min(max(jl, 0), n - 1);
  const int jrc = min(max(jr, 0), n - 1);
  const float x_jl = x[jlc];
  const float x_jl1 = x[min(jlc + 1, n - 1)];
  const float x_jr = x[jrc];
  const float x_jr1 = x[max(jrc - 1, 0)];
  const float dl = x_jl1 != x_jl ? __fsub_rn(x_jl1, x_jl) : 1.f;
  const float dr = x_jr1 != x_jr ? __fsub_rn(x_jr1, x_jr) : 1.f;
  const float left_ip =
      __fadd_rn((float)jlc, x_jl < height ? __fdiv_rn(__fsub_rn(height, x_jl), dl) : 0.f);
  const float right_ip =
      __fsub_rn((float)jrc, x_jr < height ? __fdiv_rn(__fsub_rn(height, x_jr), dr) : 0.f);
  m.width = __fsub_rn(right_ip, left_ip);
  m.qualified = m.prominence >= min_prominence && m.width >= min_width;
  return m;
}

// torch.argmin's order on (value, index): NaN first, ties to the lower index.
__device__ __forceinline__ bool precedes(float a, int ia, float b, int ib) {
  if (a != a) return b != b ? ia < ib : true;
  if (b != b) return false;
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmin(float& v, int& idx) {
  for (int o = 16; o; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (precedes(ov, oi, v, idx)) {
      v = ov;
      idx = oi;
    }
  }
}

// argmin over j of where(qualified[j] && j != skip, value(j), inf), every
// lane left with (the minimum, its index): index 0 where all are inf, as
// torch.argmin gives.
template <class Value>
__device__ __forceinline__ void qualified_argmin(const unsigned* qbits, int n, int skip,
                                                 Value value, int lane, float& v, int& idx) {
  v = CUDART_INF_F;
  idx = lane < n ? lane : INT_MAX;  // the first inf this lane sees
  for (int j = lane, k = 0; j < n; j += 32, ++k) {
    if ((qbits[k] >> lane) & 1u && j != skip) {
      const float vj = value(j);
      if (precedes(vj, j, v, idx)) {
        v = vj;
        idx = j;
      }
    }
  }
  warp_argmin(v, idx);
}

__device__ __forceinline__ bool crossing(float t0, float t1, float h) {
  const bool above0 = t0 >= h;
  const bool below1 = t1 < h;
  return (above0 && below1) || (!above0 && !below1 && t0 < h && t1 >= h);
}

struct DipMetrics {
  float f_res, q, fom;
};

// peaks.py:peak_parameters for the dip at p (baseline 0): the nearest
// half-depth crossing strictly left and right of p by ballot scans over the
// segments, then the interpolated FWHM edges.  Warp-uniform.
__device__ DipMetrics dip_metrics(const float* x, const float* __restrict__ freq, int n,
                                  int p, int lane) {
  const float t_min = -x[p];
  const float half = __fadd_rn(t_min, __fmul_rn(__fsub_rn(0.f, t_min), 0.5f));
  int jl = -1;
  for (int base = p - 1; base >= 0; base -= 32) {
    const int s = base - lane;
    const unsigned hit = __ballot_sync(kFull, s >= 0 && crossing(-x[s], -x[s + 1], half));
    if (hit) {
      jl = base - (__ffs(hit) - 1);
      break;
    }
  }
  int jr = n;
  for (int base = p + 1; base <= n - 2; base += 32) {
    const int s = base + lane;
    const unsigned hit = __ballot_sync(kFull, s <= n - 2 && crossing(-x[s], -x[s + 1], half));
    if (hit) {
      jr = base + (__ffs(hit) - 1);
      break;
    }
  }
  auto interp = [&](int j) {  // peaks.py:_interp_crossing
    j = min(max(j, 0), n - 2);
    const float t0 = -x[j], t1 = -x[j + 1];
    const float denom = __fsub_rn(t1, t0);
    const float frac = fabsf(denom) > 1e-12f ? __fdiv_rn(__fsub_rn(half, t0), denom) : 0.f;
    const float f0 = freq[j], f1 = freq[j + 1];
    return __fadd_rn(f0, __fmul_rn(frac, __fsub_rn(f1, f0)));
  };
  const float delta_f = __fsub_rn(interp(jr), interp(jl));
  const bool valid = jl >= 0 && jr < n && delta_f > 1e-9f;
  DipMetrics m;
  m.f_res = freq[p];
  m.q = valid ? __fdiv_rn(m.f_res, delta_f) : CUDART_NAN_F;
  m.fom = valid && fabsf(t_min) > 1e-6f ? __fdiv_rn(m.q, fabsf(t_min)) : CUDART_NAN_F;
  return m;
}

struct Args {
  const float* t;
  int batch, n;
  float min_prominence, min_width;
  // the four-output entry
  unsigned char* qualified;
  unsigned char* is_peak;
  float* prominence;
  float* width;
  // the metrics entry (fb1 / fb2 null: no centres)
  const float* freq;
  const float* fb1;
  const float* fb2;
  float* metrics;
};

// A warp's slice of shared memory, in 4-byte words, for rows of n samples:
// x, the blocks' max and min, the list of peaks, the qualified bits.
__host__ __device__ __forceinline__ int blocks_of(int n) {
  return (n + kBlock - 1) >> kBlockShift;
}
__host__ __device__ __forceinline__ int warp_words(int n) {
  return n + 2 * blocks_of(n) + (n / 2 + 1) + (n + 31) / 32;
}

template <bool kMetrics>
__global__ void __launch_bounds__(kWarps * 32) dip_kernel(const Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + warp;
  if (row >= a.batch) return;  // whole warps: no block barrier below
  const int n = a.n, nb = blocks_of(n), words = (n + 31) / 32;
  float* x = smem + (size_t)warp * warp_words(n);
  float* bmax = x + n;
  float* bmin = bmax + nb;
  int* peaks = reinterpret_cast<int*>(bmin + nb);
  unsigned* qbits = reinterpret_cast<unsigned*>(peaks + n / 2 + 1);
  const size_t off = (size_t)row * n;

  // The row, negated, with coalesced loads; each block's max and min by
  // shuffles within its kBlock lanes; whether the row holds a NaN.
  bool has_nan = false;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    const float v = j < n ? -a.t[off + j] : 0.f;
    if (j < n) x[j] = v;
    has_nan |= v != v;
    float mx = j < n ? v : -CUDART_INF_F, mn = j < n ? v : CUDART_INF_F;
    for (int o = 1; o < kBlock; o <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    }
    if ((lane & (kBlock - 1)) == 0 && j < n) {
      bmax[j >> kBlockShift] = mx;
      bmin[j >> kBlockShift] = mn;
    }
  }
  for (int k = lane; k < words; k += 32) qbits[k] = 0u;
  // block max / min skip no stop where the row holds no NaN
  const bool blocks = !__any_sync(kFull, has_nan);
  __syncwarp();

  // Plateau-aware local maxima, 32 candidates a step.  Without NaN the
  // nearest differing samples bound i's run of equal samples, whose start
  // and end come from ballots of x[j] != x[j - 1] and x[j] != x[j + 1];
  // with a NaN (of every level) each lane walks sample by sample.  The
  // peaks go to a list, in order.
  int count = 0, run_start = 0, next_end = -1;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool live = i < n;
    const float xi = live ? x[i] : 0.f;
    int ld = -1, rd = n;
    if (blocks) {
      const unsigned starts = __ballot_sync(kFull, live && (i == 0 || x[i - 1] != xi));
      const unsigned ends = __ballot_sync(kFull, live && (i == n - 1 || x[i + 1] != xi));
      const unsigned below = starts & (kFull >> (31 - lane));
      ld = (below ? base + 31 - __clz(below) : run_start) - 1;
      if (starts) run_start = base + 31 - __clz(starts);
      const unsigned above = ends & (kFull << lane);
      // a run that goes on past this chunk ends at the next end beyond it
      if (next_end < base + 32 && __ballot_sync(kFull, live && !above))
        next_end = run_end(x, n, base + 32, lane);
      rd = (above ? base + __ffs(above) - 1 : next_end) + 1;
    } else if (live) {
      ld = i - 1;
      while (ld >= 0 && !(x[ld] > xi || x[ld] < xi)) --ld;
      rd = i + 1;
      while (rd < n && !(x[rd] > xi || x[rd] < xi)) ++rd;
    }
    const bool peak =
        live && ld >= 0 && rd < n && x[ld] < xi && x[rd] < xi && i == (ld + rd) / 2;
    const unsigned pm = __ballot_sync(kFull, peak);
    if (peak) peaks[count + __popc(pm & ((1u << lane) - 1u))] = i;
    count += __popc(pm);
    if (!kMetrics && live) {
      a.qualified[off + i] = 0;
      a.is_peak[off + i] = peak;
      a.prominence[off + i] = 0.f;
      a.width[off + i] = 0.f;
    }
  }
  __syncwarp();

  // The peaks' measures, 32 peaks a step, each lane walking its own.
  for (int first = 0; first < count; first += 32) {
    if (first + lane >= count) continue;
    const int i = peaks[first + lane];
    const Measures m = measure(x, bmax, bmin, n, i, blocks, a.min_prominence, a.min_width);
    if (kMetrics) {
      if (m.qualified) atomicOr(&qbits[i >> 5], 1u << (i & 31));
    } else {
      a.qualified[off + i] = m.qualified;
      a.prominence[off + i] = m.prominence;
      a.width[off + i] = m.width;
    }
  }
  if (!kMetrics) return;
  __syncwarp();

  // peaks.py:find_two_dips.  Depth: the deepest qualified dip, then the
  // deepest of the rest.
  float v1, v2;
  int d1, d2, i1, i2;
  qualified_argmin(qbits, n, -1, [&](int j) { return -x[j]; }, lane, v1, d1);
  const bool has1 = isfinite(v1);
  const float c1 = a.fb1 ? a.fb1[row] : CUDART_NAN_F;
  const float c2 = a.fb2 ? a.fb2[row] : CUDART_NAN_F;
  if (isfinite(c1) && isfinite(c2)) {
    // the qualified dip closest to c1, then the one closest to c2 of the rest
    const float* freq = a.freq;
    qualified_argmin(qbits, n, -1, [&](int j) { return fabsf(__fsub_rn(freq[j], c1)); },
                     lane, v1, i1);
    qualified_argmin(qbits, n, i1, [&](int j) { return fabsf(__fsub_rn(freq[j], c2)); },
                     lane, v2, i2);
  } else {
    qualified_argmin(qbits, n, d1, [&](int j) { return -x[j]; }, lane, v2, d2);
    // frequency order where there are two
    const bool two = has1 && isfinite(v2);
    i1 = two ? min(d1, d2) : d1;
    i2 = two ? max(d1, d2) : d1;
  }
  const bool has2 = has1 && isfinite(v2);
  if (!has2) i2 = i1;

  // peaks.py:spectrum_metrics: the FWHM metrics of each dip found, the
  // centres standing in for a missing f.
  const DipMetrics none{CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F};
  DipMetrics m1 = none, m2 = none;
  if (has1 && n >= 2) m1 = dip_metrics(x, a.freq, n, i1, lane);
  if (has2 && n >= 2) m2 = dip_metrics(x, a.freq, n, i2, lane);
  const float f1 = m1.f_res != m1.f_res ? c1 : m1.f_res;
  const float f2 = m2.f_res != m2.f_res ? c2 : m2.f_res;
  if (lane == 0) {
    float4* dst = reinterpret_cast<float4*>(a.metrics + (size_t)row * 8);
    dst[0] = make_float4(f1, f2, m1.q, m1.fom);
    dst[1] = make_float4(m1.q != m1.q ? CUDART_NAN_F : __fmul_rn(f1, m1.q), m2.q, m2.fom,
                         m2.q != m2.q ? CUDART_NAN_F : __fmul_rn(f2, m2.q));
  }
}

// Warps a block: kWarps where the static 48 KB of shared memory allow it.
int warps_for(int n) {
  return std::min(kWarps, kSmemBudget / (warp_words(n) * (int)sizeof(float)));
}

template <bool kMetrics>
int launch(const Args& a, void* stream) {
  if (a.batch < 1 || a.n < 1 || a.n > kMaxN) return (int)cudaErrorInvalidValue;
  const int warps = warps_for(a.n);
  const size_t smem = (size_t)warps * warp_words(a.n) * sizeof(float);
  const int blocks = (a.batch + warps - 1) / warps;
  dip_kernel<kMetrics><<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: t (batch, n) row-major fp32 -> four (batch, n) outputs: the qualified
// and is_peak masks as bytes (0 / 1), prominence and width as fp32.
int pigan_dip_qualification(const float* t, unsigned char* qualified,
                            unsigned char* is_peak, float* prominence,
                            float* width, int batch, int n, float min_prominence,
                            float min_width, void* stream) {
  Args a{t, batch, n, min_prominence, min_width, qualified, is_peak, prominence, width,
         nullptr, nullptr, nullptr, nullptr};
  return launch<false>(a, stream);
}

// K4 with the selection and FWHM: t (batch, n) row-major fp32, freq (n,),
// the centres fb1 / fb2 (batch,) (NaN, or a null pointer for all rows: none)
// -> metrics (batch, 8) fp32, (f1, f2, Q1, FoM1, S1, Q2, FoM2, S2) as
// ops/peaks.py:spectrum_metrics.
int pigan_peak_metrics(const float* t, const float* freq, const float* fb1,
                       const float* fb2, float* metrics, int batch, int n,
                       float min_prominence, float min_width, void* stream) {
  Args a{t, batch, n, min_prominence, min_width, nullptr, nullptr, nullptr, nullptr,
         freq, fb1, fb2, metrics};
  return launch<true>(a, stream);
}

}  // extern "C"
