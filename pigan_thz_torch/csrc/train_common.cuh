// Device code shared by the training kernels, forward_train.cu (K1) and
// gan_train.cu (K2, and K3: K2's step for M ensemble members at once), fp32,
// for Hopper (sm_90a): the tiled SGEMM every product of a training step goes
// through, the fixed-order block sum, the dropout hash, LayerNorm rows
// (forward and backward), column sums over the batch, and the deterministic
// two-pass global-norm clip with Adam.  Everything lives in an anonymous
// namespace: each source that includes this header gets its own copy, and no
// symbol leaves it.
//
// bfloat16 operands (compute_dtype="bfloat16").  The TPU kernels round the
// operands of their MXU products to bfloat16 and accumulate in fp32.  The
// SGEMM's RND flag does the same in its tile loads: each element of A and B
// is rounded to bfloat16 (round to nearest even, __float2bfloat16_rn) as it
// enters shared memory, and the FMAs accumulate in fp32; a product of two
// bfloat16 values is exact in fp32, so only the order of the sums differs
// from the MXU's.  The flag is chosen per launch (gemm_ex): the products the
// TPU kernels run on the VPU in fp32 stay fp32.  ACC adds the product to C
// instead of overwriting it.  The fp32 instantiations (RND and ACC false)
// are the code of the fp32 kernels, unchanged.
//
// The member axis.  Every kernel here that the GAN step launches takes its
// operands as Per<T>: a
// pointer and a per-member stride.  The member is the grid's last used axis
// (blockIdx.z of the SGEMM, blockIdx.y of the others), and member m works on
// p + m * stride.  A plain pointer converts to a Per with stride 0, so a
// caller without members (K1; K2 is the one-member case) launches as before,
// with that axis 1.  Nothing else reads the member or the size of its axis:
// member m's arithmetic, and its order, are those of a launch for m alone.

#pragma once

#include <cuda_bf16.h>
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

template <typename T>
struct Per {
  T* p;
  long long stride;   // floats between two members' data; 0: shared by all
  __host__ __device__ Per(T* ptr = nullptr, long long s = 0) : p(ptr), stride(s) {}
  template <typename U>
  __host__ __device__ Per(const Per<U>& o) : p(o.p), stride(o.stride) {}
  __host__ __device__ Per operator+(long long off) const { return Per(p + off, stride); }
  __device__ __forceinline__ T* at(int m) const { return p + (long long)m * stride; }
};
using PerIn = Per<const float>;
using PerOut = Per<float>;

// --------------------------------------------------------------------------
// Tiled SGEMM: C[m, n] = sum_k A(m, k) B(k, n) (+ bias[n]), C row-major.
// A(m, k) = A[m * sam + k * sak], B(k, n) = B[k * sbk + n * sbn].
// AK: A is contiguous along k (else along m); BN: B is contiguous along n
// (else along k).  The flags choose the thread mapping of the tile loads so
// that neighbouring threads read neighbouring addresses.  RND rounds every
// operand to bfloat16 as it is loaded; ACC adds to C (C += A B).
// --------------------------------------------------------------------------
template <bool RND>
__device__ __forceinline__ float operand(float x) {
  if (RND) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <int BM, int BN, bool AK, bool BNC, bool RND = false, bool ACC = false>
__global__ void __launch_bounds__(kThreads)
sgemm(int M, int N, int K, PerIn Am, long long sam, long long sak, PerIn Bm,
      long long sbk, long long sbn, PerOut Cm, int ldc, PerIn biasm) {
  const float* __restrict__ A = Am.at(blockIdx.z);
  const float* __restrict__ B = Bm.at(blockIdx.z);
  float* __restrict__ C = Cm.at(blockIdx.z);
  const float* __restrict__ bias = biasm.p ? biasm.at(blockIdx.z) : nullptr;
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
      As[k][m] = (gm < M && gk < K)
                     ? operand<RND>(A[(long long)gm * sam + (long long)gk * sak]) : 0.f;
    }
    for (int e = tid; e < BN * kBK; e += kThreads) {
      int n, k;
      if (BNC) { n = e % BN; k = e / BN; } else { k = e % kBK; n = e / kBK; }
      const int gn = n0 + n, gk = k0 + k;
      Bs[k][n] = (gn < N && gk < K)
                     ? operand<RND>(B[(long long)gk * sbk + (long long)gn * sbn]) : 0.f;
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
      if (n >= N) continue;
      float* c = C + (long long)m * ldc + n;
      if (ACC) *c = *c + acc[i][j] + (bias ? bias[n] : 0.f);
      else *c = acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

template <bool AK, bool BNC, bool RND = false, bool ACC = false>
cudaError_t gemm(int M, int N, int K, PerIn A, long long sam, long long sak, PerIn B,
                 long long sbk, long long sbn, PerOut C, int ldc, PerIn bias,
                 cudaStream_t s, int members = 1) {
  // 64 x 64 tiles where they fill the card, else 32 x 32 (4x the blocks).
  // The choice reads one member's shape only: it must not move with members.
  if (((M + 63) / 64) * ((N + 63) / 64) >= 128) {
    dim3 grid((N + 63) / 64, (M + 63) / 64, members);
    sgemm<64, 64, AK, BNC, RND, ACC><<<grid, kThreads, 0, s>>>(M, N, K, A, sam, sak, B,
                                                                sbk, sbn, C, ldc, bias);
  } else {
    dim3 grid((N + 31) / 32, (M + 31) / 32, members);
    sgemm<32, 32, AK, BNC, RND, ACC><<<grid, kThreads, 0, s>>>(M, N, K, A, sam, sak, B,
                                                                sbk, sbn, C, ldc, bias);
  }
  return cudaGetLastError();
}

// gemm with the operand rounding and the accumulation chosen per launch.
template <bool AK, bool BNC>
cudaError_t gemm_ex(bool rnd, bool acc, int M, int N, int K, PerIn A, long long sam,
                    long long sak, PerIn B, long long sbk, long long sbn, PerOut C, int ldc,
                    PerIn bias, cudaStream_t s, int members = 1) {
  if (rnd) {
    return acc ? gemm<AK, BNC, true, true>(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, s,
                                           members)
               : gemm<AK, BNC, true, false>(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias,
                                            s, members);
  }
  return acc ? gemm<AK, BNC, false, true>(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, s,
                                          members)
             : gemm<AK, BNC, false, false>(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, s,
                                           members);
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
ln_forward(PerOut tcm, PerOut lnm, PerOut scm, PerOut actm, PerOut ivarm, PerIn gammam,
           PerIn betam, int C, float ln_eps, float slope, uint32_t layer_key,
           int use_drop, uint32_t thresh, float inv_keep) {
  __shared__ float red[kThreads];
  const int mem = blockIdx.y;
  float* __restrict__ tc = tcm.at(mem);
  float* __restrict__ ln = lnm.at(mem);
  float* __restrict__ sc = scm.at(mem);
  float* __restrict__ act = actm.at(mem);
  float* __restrict__ ivar_out = ivarm.at(mem);
  const float* __restrict__ gamma = gammam.at(mem);
  const float* __restrict__ beta = betam.at(mem);
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
ln_backward(PerIn dam, PerIn scm, PerIn lnm, PerIn tcm, PerIn ivarm, PerIn gammam,
            PerOut dlnm, PerOut dtm, int C, float slope, int use_drop) {
  __shared__ float red[kThreads];
  const int mem = blockIdx.y;
  const float* __restrict__ da = dam.at(mem);
  const float* __restrict__ sc = scm.at(mem);
  const float* __restrict__ ln = lnm.at(mem);
  const float* __restrict__ tc = tcm.at(mem);
  const float* __restrict__ ivar_in = ivarm.at(mem);
  const float* __restrict__ gamma = gammam.at(mem);
  float* __restrict__ dln_out = dlnm.at(mem);
  float* __restrict__ dt_out = dtm.at(mem);
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

__global__ void column_sum(PerIn xm, int B, int C, PerOut outm) {
  const float* __restrict__ x = xm.at(blockIdx.y);
  float* __restrict__ out = outm.at(blockIdx.y);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += x[(long long)b * C + c];
  out[c] = s;
}

// column_sum with the sum in double: for the critic's bias gradients under
// WGAN-GP, differences of the real and the fake rows' sums, rows that share
// all but 4 of their input columns (float sums lose what the difference keeps).
__global__ void column_sum_f64(PerIn xm, int B, int C, PerOut outm) {
  const float* __restrict__ x = xm.at(blockIdx.y);
  float* __restrict__ out = outm.at(blockIdx.y);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double s = 0.0;
  for (int b = 0; b < B; ++b) s += x[(long long)b * C + c];
  out[c] = (float)s;
}

// Second difference of a row at j: (p[j+2] - p[j+1]) - (p[j+1] - p[j]).
__device__ __forceinline__ float second_diff(const float* p, int j) {
  return (p[j + 2] - p[j + 1]) - (p[j + 1] - p[j]);
}

// --------------------------------------------------------------------------
// Clip + Adam
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sumsq_partial(PerIn gm, long long P, PerOut partialm) {
  __shared__ float red[kThreads];
  const float* __restrict__ g = gm.at(blockIdx.y);
  float* __restrict__ partial = partialm.at(blockIdx.y);
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
adam_update(PerOut pm, PerOut mm, PerOut vm, PerIn gm, long long P, PerIn partialm,
            AdamCoef k) {
  __shared__ float red[kThreads];
  float* __restrict__ p = pm.at(blockIdx.y);
  float* __restrict__ m = mm.at(blockIdx.y);
  float* __restrict__ v = vm.at(blockIdx.y);
  const float* __restrict__ g = gm.at(blockIdx.y);
  const float* __restrict__ partial = partialm.at(blockIdx.y);
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
