// Device code shared by the two training kernels, forward_train.cu (K1) and
// gan_train.cu (K2), fp32, for Hopper (sm_90a): the tiled SGEMM every product
// of a training step goes through, the fixed-order block sum, the dropout
// hash, LayerNorm rows (forward and backward), column sums over the batch,
// and the deterministic two-pass global-norm clip with Adam.  Everything
// lives in an anonymous namespace: each source that includes this header
// gets its own copy, and no symbol leaves it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;       // hidden layers + head
constexpr int kMaxPerThread = 8;    // row kernels: widths up to 2048
constexpr int kNormParts = 256;     // blocks of the first norm pass
constexpr int kAdamBlocks = 264;    // 2 per SM on an H100
constexpr int kBK = 16;             // depth of a GEMM tile
static_assert(kNormParts == kThreads, "adam_update reduces one partial per thread");

// --------------------------------------------------------------------------
// Tiled SGEMM: C[m, n] = sum_k A(m, k) B(k, n) (+ bias[n]), C row-major.
// A(m, k) = A[m * sam + k * sak], B(k, n) = B[k * sbk + n * sbn].
// AK: A is contiguous along k (else along m); BN: B is contiguous along n
// (else along k).  The flags choose the thread mapping of the tile loads so
// that neighbouring threads read neighbouring addresses.
// --------------------------------------------------------------------------
template <int BM, int BN, bool AK, bool BNC>
__global__ void __launch_bounds__(kThreads)
sgemm(int M, int N, int K, const float* __restrict__ A, long long sam,
      long long sak, const float* __restrict__ B, long long sbk, long long sbn,
      float* __restrict__ C, int ldc, const float* __restrict__ bias) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  __shared__ float As[kBK][BM + 1];
  __shared__ float Bs[kBK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      int m, k;
      if (AK) { k = e % kBK; m = e / kBK; } else { m = e % BM; k = e / BM; }
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[(long long)gm * sam + (long long)gk * sak] : 0.f;
    }
    for (int e = tid; e < BN * kBK; e += kThreads) {
      int n, k;
      if (BNC) { n = e % BN; k = e / BN; } else { k = e % kBK; n = e / kBK; }
      const int gn = n0 + n, gk = k0 + k;
      Bs[k][n] = (gn < N && gk < K) ? B[(long long)gk * sbk + (long long)gn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[(long long)m * ldc + n] = acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

template <bool AK, bool BNC>
cudaError_t gemm(int M, int N, int K, const float* A, long long sam, long long sak,
                 const float* B, long long sbk, long long sbn, float* C, int ldc,
                 const float* bias, cudaStream_t s) {
  // 64 x 64 tiles where they fill the card, else 32 x 32 (4x the blocks)
  if (((M + 63) / 64) * ((N + 63) / 64) >= 128) {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    sgemm<64, 64, AK, BNC><<<grid, kThreads, 0, s>>>(M, N, K, A, sam, sak, B, sbk,
                                                      sbn, C, ldc, bias);
  } else {
    dim3 grid((N + 31) / 32, (M + 31) / 32);
    sgemm<32, 32, AK, BNC><<<grid, kThreads, 0, s>>>(M, N, K, A, sam, sak, B, sbk,
                                                      sbn, C, ldc, bias);
  }
  return cudaGetLastError();
}

// Fixed-order block sum of one value per thread (kThreads threads); the
// result is valid in every thread.  `red` holds kThreads floats.
__device__ float block_sum(float x, float* red) {
  const int tid = threadIdx.x;
  __syncthreads();  // red may still be read from a previous call
  red[tid] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// --------------------------------------------------------------------------
// LayerNorm + LeakyReLU + dropout forward, one block per row.  tc holds the
// row's pre-norm t (bias included) on entry and t - mean on exit.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ln_forward(float* __restrict__ tc, float* __restrict__ ln, float* __restrict__ sc,
           float* __restrict__ act, float* __restrict__ ivar_out,
           const float* __restrict__ gamma, const float* __restrict__ beta, int C,
           float ln_eps, float slope, uint32_t layer_key, int use_drop,
           uint32_t thresh, float inv_keep) {
  __shared__ float red[kThreads];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  float* t = tc + (long long)r * C;
  float v[kMaxPerThread];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = tid + i * kThreads;
    v[i] = c < C ? t[c] : 0.f;
    s += v[i];
    s2 = fmaf(v[i], v[i], s2);
  }
  const float mu = block_sum(s, red) / C;
  const float msq = block_sum(s2, red) / C;
  const float var = fmaxf(0.f, msq - mu * mu);
  const float ivar = 1.f / sqrtf(var + ln_eps);
  if (tid == 0) ivar_out[r] = ivar;
  const uint32_t row_key = mix32(layer_key ^ (uint32_t)r);
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = tid + i * kThreads;
    if (c >= C) continue;
    const long long o = (long long)r * C + c;
    const float d = v[i] - mu;
    const float y = d * ivar * gamma[c] + beta[c];
    float a = y >= 0.f ? y : slope * y;
    if (use_drop) {
      const float f = mix32(row_key ^ (uint32_t)c) < thresh ? inv_keep : 0.f;
      sc[o] = f;
      a *= f;
    }
    tc[o] = d;
    ln[o] = y;
    act[o] = a;
  }
}

// --------------------------------------------------------------------------
// LayerNorm backward, one block per row: da (gradient at the layer's output)
// -> dln (at the pre-activation) and dt (at the pre-norm t).
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ln_backward(const float* __restrict__ da, const float* __restrict__ sc,
            const float* __restrict__ ln, const float* __restrict__ tc,
            const float* __restrict__ ivar_in, const float* __restrict__ gamma,
            float* __restrict__ dln_out, float* __restrict__ dt_out, int C,
            float slope, int use_drop) {
  __shared__ float red[kThreads];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const float ivar = ivar_in[r];
  float dxh[kMaxPerThread], tcv[kMaxPerThread];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = tid + i * kThreads;
    dxh[i] = 0.f;
    tcv[i] = 0.f;
    if (c >= C) continue;
    const long long o = (long long)r * C + c;
    float d = da[o];
    if (use_drop) d *= sc[o];
    const float dl = d * (ln[o] >= 0.f ? 1.f : slope);
    dln_out[o] = dl;
    dxh[i] = dl * gamma[c];
    tcv[i] = tc[o];
    s += dxh[i] * tcv[i];
  }
  const float dvar = block_sum(s, red) * -0.5f * ivar * ivar * ivar;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) s2 += dxh[i] * ivar;
  const float mean = block_sum(s2, red) / C;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = tid + i * kThreads;
    if (c < C) {
      dt_out[(long long)r * C + c] = dxh[i] * ivar - mean + dvar * 2.f * tcv[i] / C;
    }
  }
}

// Per column c of (B, C) buffers: dgamma = sum_b dln * (tc * ivar[b]),
// dbeta = sum_b dln, db = sum_b dt, in row order.
__global__ void ln_param_grads(const float* __restrict__ dln, const float* __restrict__ tc,
                               const float* __restrict__ ivar, const float* __restrict__ dt,
                               int B, int C, float* __restrict__ dgamma,
                               float* __restrict__ dbeta, float* __restrict__ db) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sg = 0.f, sb = 0.f, sd = 0.f;
  for (int b = 0; b < B; ++b) {
    const long long o = (long long)b * C + c;
    sg += dln[o] * (tc[o] * ivar[b]);
    sb += dln[o];
    sd += dt[o];
  }
  dgamma[c] = sg;
  dbeta[c] = sb;
  db[c] = sd;
}

__global__ void column_sum(const float* __restrict__ x, int B, int C, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += x[(long long)b * C + c];
  out[c] = s;
}

// Second difference of a row at j: (p[j+2] - p[j+1]) - (p[j+1] - p[j]).
__device__ __forceinline__ float second_diff(const float* p, int j) {
  return (p[j + 2] - p[j + 1]) - (p[j + 1] - p[j]);
}

// --------------------------------------------------------------------------
// Clip + Adam
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sumsq_partial(const float* __restrict__ g, long long P, float* __restrict__ partial) {
  __shared__ float red[kThreads];
  float s = 0.f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < P;
       i += (long long)kThreads * kNormParts) {
    s = fmaf(g[i], g[i], s);
  }
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

struct AdamCoef {
  float clip, b1, c1, b2, c2, eps;   // c1 = 1 - b1, c2 = 1 - b2
  float lr, inv1, inv2;
};

__global__ void __launch_bounds__(kThreads)
adam_update(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
            const float* __restrict__ g, long long P, const float* __restrict__ partial,
            AdamCoef k) {
  __shared__ float red[kThreads];
  // every block reduces the partials in the same order: one norm for all
  const float gn = sqrtf(block_sum(partial[threadIdx.x], red));
  const float scale = gn < k.clip ? 1.f : k.clip / gn;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < P;
       i += (long long)kThreads * gridDim.x) {
    const float gi = g[i] * scale;
    const float mi = k.b1 * m[i] + k.c1 * gi;
    const float vi = k.b2 * v[i] + k.c2 * gi * gi;
    m[i] = mi;
    v[i] = vi;
    p[i] = p[i] - k.lr * (mi * k.inv1) / (sqrtf(vi * k.inv2) + k.eps);
  }
}

}  // namespace
