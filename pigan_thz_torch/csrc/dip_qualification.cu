// Resonance-dip qualification, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of pigan_thz_tpu/ops/peaks.py:
// batched_dip_qualification (K4).  For each spectrum t it computes what
// scipy's find_peaks(-t, prominence=min_prominence, width=min_width) decides,
// index by index, on x = -t:
//   - is_peak: plateau-aware local maxima (a sample strictly above its nearest
//     differing neighbours on both sides; a flat run reports its midpoint;
//     the signal's endpoints never qualify);
//   - prominence: x[i] - max(min of x over (lg, i], min of x over [i, rg)),
//     with lg / rg the nearest strictly higher samples (or the borders);
//   - width at half prominence, interpolated between the nearest samples at
//     or below x[i] - prominence / 2 on each side, as the JAX package's
//     _interp_width does;
//   - qualified = is_peak && prominence >= min_prominence && width >= min_width.
// Prominence and width are defined at peaks only; elsewhere the kernel writes
// 0 (the plain versions leave don't-care values there).
//
// Design.  The TPU kernel evaluates every query as a masked reduction over an
// (N, N) index lattice, because Mosaic has no vector gather.  On the card an
// index into shared memory costs one load, so this kernel walks instead: one
// block per spectrum, the N samples of x in shared memory, one thread per
// candidate index i (a loop over i when N exceeds the block).  Each thread
// walks outward from i to the nearest differing sample on each side, which
// decides is_peak; only at a peak does it walk on to the nearest strictly
// higher samples (accumulating the window minima) and to the half-height
// crossings.  Every quantity is a nearest index or a window minimum, so the
// early-exit walks give exactly the lattice's indices.  Comparisons are
// written so that NaN behaves as in the lattice (it is neither higher nor
// lower than anything, and it propagates through the minima).
//
// Bounds on the card.  A spectrum reads 1 KB and writes 2.5 KB at N = 250:
// under 30 MB of device traffic at B = 8192, a few microseconds at 3.35 TB/s.
// The work is O(N x walk length) shared-memory loads and compares per
// spectrum, with warps waiting on their longest walk, so the kernel is bound
// by instruction issue and shared-memory loads, not by device memory.  Several
// spectra per block, warp-level scans and the like are later work.
//
// Exactness.  Built without --use_fast_math: the width's divisions are IEEE.
// x - 0.5f * p may contract into an FMA, which changes nothing because
// 0.5f * p is exact.  The masks agree with the plain versions bit for bit.
//
// Interface: plain C, loaded with ctypes.  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 4096;  // 16 KB of shared memory per block

// torch.minimum / torch.maximum semantics: NaN propagates.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// True when v is neither higher nor lower than ref (equal, or either is NaN).
__device__ __forceinline__ bool same_level(float v, float ref) {
  return !(v > ref || v < ref);
}

__global__ void __launch_bounds__(kThreads)
dip_kernel(const float* __restrict__ t, unsigned char* __restrict__ qualified,
           unsigned char* __restrict__ is_peak, float* __restrict__ prominence,
           float* __restrict__ width, int n, float min_prominence,
           float min_width) {
  extern __shared__ float x[];
  const size_t row = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = -t[row + i];
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float xi = x[i];

    // Nearest differing sample on each side (-1 / n when there is none).
    int ld = i - 1;
    while (ld >= 0 && same_level(x[ld], xi)) --ld;
    int rd = i + 1;
    while (rd < n && same_level(x[rd], xi)) ++rd;
    const bool peak = ld >= 0 && x[ld] < xi && rd < n && x[rd] < xi &&
                      i == (ld + rd) / 2;

    float prom = 0.f;
    float wid = 0.f;
    bool qual = false;
    if (peak) {
      // Window minima up to the nearest strictly higher sample on each side.
      float left_min = xi;
      for (int j = i - 1; j >= 0 && !(x[j] > xi); --j) left_min = nan_min(left_min, x[j]);
      float right_min = xi;
      for (int j = i + 1; j < n && !(x[j] > xi); ++j) right_min = nan_min(right_min, x[j]);
      prom = xi - nan_max(left_min, right_min);

      // Nearest samples at or below the evaluation height.
      const float height = xi - 0.5f * prom;
      int jl = i - 1;
      while (jl >= 0 && !(x[jl] <= height)) --jl;
      int jr = i + 1;
      while (jr < n && !(x[jr] <= height)) ++jr;

      // scipy's intersection interpolation (peaks.py:_interp_width).
      const int jlc = min(max(jl, 0), n - 1);
      const int jrc = min(max(jr, 0), n - 1);
      const float x_jl = x[jlc];
      const float x_jl1 = x[min(jlc + 1, n - 1)];
      const float x_jr = x[jrc];
      const float x_jr1 = x[max(jrc - 1, 0)];
      const float dl = x_jl1 != x_jl ? x_jl1 - x_jl : 1.f;
      const float dr = x_jr1 != x_jr ? x_jr1 - x_jr : 1.f;
      const float left_ip = (float)jlc + (x_jl < height ? (height - x_jl) / dl : 0.f);
      const float right_ip = (float)jrc - (x_jr < height ? (height - x_jr) / dr : 0.f);
      wid = right_ip - left_ip;
      qual = prom >= min_prominence && wid >= min_width;
    }
    qualified[row + i] = qual;
    is_peak[row + i] = peak;
    prominence[row + i] = prom;
    width[row + i] = wid;
  }
}

}  // namespace

extern "C" {

// K4: t (batch, n) row-major fp32 -> four (batch, n) outputs: the qualified
// and is_peak masks as bytes (0 / 1), prominence and width as fp32.
int pigan_dip_qualification(const float* t, unsigned char* qualified,
                            unsigned char* is_peak, float* prominence,
                            float* width, int batch, int n, float min_prominence,
                            float min_width, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const int threads = n < kThreads ? (n + 31) / 32 * 32 : kThreads;
  dip_kernel<<<batch, threads, sizeof(float) * n, (cudaStream_t)stream>>>(
      t, qualified, is_peak, prominence, width, n, min_prominence, min_width);
  return (int)cudaGetLastError();
}

}  // extern "C"
