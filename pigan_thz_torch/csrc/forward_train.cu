// Forward-surrogate pretraining, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pigan_thz_tpu/ops/megakernel.py:
// _make_forward_kernel (K1), launched by make_pallas_forward_epoch_fn: E
// epochs of F pretraining in one launch.  Per step, for F = 4 -> 256 -> 512
// -> 1024 -> 512 -> 256 -> (S + 8):
//   forward   5 x [x W^T + b -> LayerNorm (mean, then mean(t^2) - mean^2
//             clamped at 0, eps 1e-6) -> LeakyReLU 0.2 -> dropout], head;
//   loss      w_spec MSE(spectrum) + w_met MSE(metrics) [+ w_smooth mean
//             squared second difference] [+ w_l1 (MAE + MAE)], true counts;
//   backward  hand-derived, LayerNorm included;
//   update    global-norm clip (scale clip/|g| when |g| >= clip), then Adam
//             b1 0.9 with the precomputed lr*scale, 1/(1-b1^t), 1/(1-b2^t).
//
// Design.  One C entry point per chunk of T steps: pigan_forward_train
// enqueues every step's kernels on the caller's stream from a host loop (36
// launches a step), the analogue of "one Pallas launch per chunk".  The
// state is three flat fp32 buffers of P ~ 1.38 M floats (params, m, v) in
// the layout of ForwardMLP.named_parameters(): each Linear W is (out, in)
// row-major, then its bias, then the LayerNorm weight and bias.  The
// gradient is one more flat buffer in the same layout, so clip is one
// deterministic two-pass reduction over it (per-block partial sums of
// squares, then every Adam block reduces the partials in the same fixed
// order) and Adam one elementwise pass.  No atomics anywhere: reruns are
// bit-identical.  The products x W^T, dW = dt^T a and dx = dt W are one
// tiled SGEMM (sgemm below, shared-memory tiles, fp32 FMAs on the CUDA
// cores, no TF32), parameterised by strides so that no operand is
// transposed in memory.  Row kernels (one block per batch row) do bias-free
// LayerNorm + LeakyReLU + dropout forward, saving t - mean, 1/sigma, the
// pre-activation and the dropout factor, and the LayerNorm backward;
// column-sum kernels reduce bias, gamma and beta gradients over the batch in
// a fixed order.  The loss kernel is one block over the (B, S + 8)
// prediction and writes its per-step (loss, spectrum, metrics) row.
//
// Dropout.  The TPU kernel drew its masks from the TPU's hardware generator.
// Here the bits are a counter-based hash of (step seed, layer, row, column),
// mix(mix(mix(mix(seed) ^ layer) ^ row) ^ column) with mix the lowbias32
// finaliser; keep when bits < round(keep * 2^32), scale 1/keep.  The plain
// version and the eager step (Python) compute the same bits.
//
// Bounds on the card.  About 0.53 GFLOP a step at B = 64 (2 * 64 * 1.38 M
// per pass, three passes), so ~7 us at the 67 TFLOP/s fp32 peak; the state
// (params, m, v, gradient: 22 MB) stays in the 50 MB L2 between steps.  The
// products at B = 64 are small (64 x {256..1024} x {256..1024}, dW with
// depth 64), so neither FLOPs nor bytes bound the step: latency does.  On
// an H100 the 36 launches keep the device ~88 % busy, and the eleven
// products with B output rows take ~74 % of that: their 32 x 32 tiles give
// 16-64 blocks, each walking the whole depth.  The design keeps every
// launch short and allocation-free; split-K for those products, a
// persistent kernel, wgmma / TMA and CUDA-graph capture of a chunk are
// later work.
//
// Interface: plain C, loaded with ctypes.  pigan_forward_train launches on
// the given stream, does not synchronise, allocates nothing (the workspace
// comes from the caller, and a short one is refused), and returns the first
// cudaError_t (0 on success), checking cudaGetLastError() after each launch.

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

// --------------------------------------------------------------------------
// Loss and its gradient seeds, one block over the (B, S + M) prediction.
// --------------------------------------------------------------------------
struct LossCoef {
  float w_spec, w_met, w_smooth, w_l1;
  float c_spec, c_met, c_smooth;  // w_spec*2, w_met*2, w_smooth*2/(B(S-2))
  float n_spec, n_met, n_smooth;  // B*S, B*M, B*(S-2)
};

__device__ __forceinline__ float second_diff(const float* p, int j) {
  return (p[j + 2] - p[j + 1]) - (p[j + 1] - p[j]);
}

__global__ void __launch_bounds__(kThreads)
loss_kernel(const float* __restrict__ pred, const float* __restrict__ spec,
            const float* __restrict__ met, float* __restrict__ dpred,
            float* __restrict__ row, int B, int S, int M, LossCoef k) {
  __shared__ float red[kThreads];
  const int D = S + M;
  float s_spec = 0.f, s_met = 0.f, s_smooth = 0.f, a_spec = 0.f, a_met = 0.f;
  for (int e = threadIdx.x; e < B * D; e += kThreads) {
    const int b = e / D;
    const int c = e - b * D;
    const float* p = pred + (long long)b * D;
    float g;
    if (c < S) {
      const float d = p[c] - spec[(long long)b * S + c];
      s_spec = fmaf(d, d, s_spec);
      g = k.c_spec * d / k.n_spec;
      if (k.w_smooth != 0.f) {
        float adj = 0.f;
        if (c <= S - 3) {
          const float d2 = second_diff(p, c);
          s_smooth = fmaf(d2, d2, s_smooth);
          adj = d2;
        }
        if (c >= 1 && c - 1 <= S - 3) adj = adj - 2.f * second_diff(p, c - 1);
        if (c >= 2 && c - 2 <= S - 3) adj = adj + second_diff(p, c - 2);
        g = g + k.c_smooth * adj;
      }
      if (k.w_l1 != 0.f) {
        a_spec += fabsf(d);
        g = g + k.w_l1 * (float)((d > 0.f) - (d < 0.f)) / k.n_spec;
      }
    } else {
      const float d = p[c] - met[(long long)b * M + (c - S)];
      s_met = fmaf(d, d, s_met);
      g = k.c_met * d / k.n_met;
      if (k.w_l1 != 0.f) {
        a_met += fabsf(d);
        g = g + k.w_l1 * (float)((d > 0.f) - (d < 0.f)) / k.n_met;
      }
    }
    dpred[e] = g;
  }
  const float spec_l = block_sum(s_spec, red) / k.n_spec;
  const float met_l = block_sum(s_met, red) / k.n_met;
  float loss = k.w_spec * spec_l + k.w_met * met_l;
  if (k.w_smooth != 0.f) loss += k.w_smooth * (block_sum(s_smooth, red) / k.n_smooth);
  if (k.w_l1 != 0.f) {
    const float l1s = block_sum(a_spec, red) / k.n_spec;
    const float l1m = block_sum(a_met, red) / k.n_met;
    loss += k.w_l1 * (l1s + l1m);
  }
  if (threadIdx.x == 0) {
    row[0] = loss;
    row[1] = spec_l;
    row[2] = met_l;
  }
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

extern "C" {

// T training steps over the flat state in place.
//   params, m, v   (P,) device, updated
//   x, spec, met   (T, B, dims[0]), (T, B, S), (T, B, dims[L] - S) device
//   sched          (T, 3) host: lr * scale, 1/(1 - b1^t), 1/(1 - b2^t)
//   seeds          (T,) host dropout seeds
//   rows           (T, 3) device out: loss, spectrum_loss, metrics_loss
//   work           device scratch of work_floats floats
//   dims           n_hidden + 2 widths (host); offsets 4 per layer (host):
//                  W, b, LayerNorm weight, LayerNorm bias (-1 for the head)
//   hp             host: w_spec, w_met, w_smooth, w_l1, dropout rate, clip,
//                  b1, b2, eps, leaky slope, LayerNorm eps
//   thresh         keep an entry when its hash is below this
int pigan_forward_train(float* params, float* m, float* v, const float* x,
                        const float* spec, const float* met, const float* sched,
                        const uint32_t* seeds, float* rows, float* work,
                        long long work_floats, const int* dims, int n_hidden,
                        const long long* offsets, int S, int B, int T,
                        const double* hp, uint32_t thresh, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int L = n_hidden + 1;
  if (n_hidden < 1 || L > kMaxLayers || B < 1 || T < 0 || S < 3) return cudaErrorInvalidValue;
  int maxc = 0;
  for (int i = 0; i <= L; ++i) {
    if (dims[i] < 1) return cudaErrorInvalidValue;
    if (dims[i] > maxc) maxc = dims[i];
  }
  for (int l = 0; l < n_hidden; ++l) {
    if (dims[l + 1] > kThreads * kMaxPerThread) return cudaErrorInvalidValue;
  }
  const int D = dims[L];
  const int Mdim = D - S;
  if (Mdim < 1) return cudaErrorInvalidValue;
  const long long P = offsets[4 * n_hidden + 1] + D;

  // Workspace: per hidden layer tc, ln, sc, act (B x C) and ivar (B); the
  // head's pred and dpred; da, dln, dt (B x max C); the gradient; partials.
  float* tc[kMaxLayers];
  float* ln[kMaxLayers];
  float* sc[kMaxLayers];
  float* act[kMaxLayers];
  float* ivar[kMaxLayers];
  long long pos = 0;
  for (int l = 0; l < n_hidden; ++l) {
    const long long bc = (long long)B * dims[l + 1];
    tc[l] = work + pos;  pos += bc;
    ln[l] = work + pos;  pos += bc;
    sc[l] = work + pos;  pos += bc;
    act[l] = work + pos; pos += bc;
    ivar[l] = work + pos; pos += B;
  }
  float* pred = work + pos;  pos += (long long)B * D;
  float* dpred = work + pos; pos += (long long)B * D;
  float* da = work + pos;    pos += (long long)B * maxc;
  float* dln = work + pos;   pos += (long long)B * maxc;
  float* dt = work + pos;    pos += (long long)B * maxc;
  float* grad = work + pos;  pos += P;
  float* partial = work + pos; pos += kNormParts;
  if (pos > work_floats) return cudaErrorInvalidValue;

  const double rate = hp[4];
  const int use_drop = rate > 0.0;
  const float inv_keep = (float)(1.0 / (1.0 - rate));
  const float slope = (float)hp[9];
  const float ln_eps = (float)hp[10];
  LossCoef lk;
  lk.w_spec = (float)hp[0];
  lk.w_met = (float)hp[1];
  lk.w_smooth = (float)hp[2];
  lk.w_l1 = (float)hp[3];
  lk.c_spec = (float)(hp[0] * 2.0);
  lk.c_met = (float)(hp[1] * 2.0);
  lk.c_smooth = (float)(hp[2] * 2.0 / ((double)B * (S - 2)));
  lk.n_spec = (float)((long long)B * S);
  lk.n_met = (float)((long long)B * Mdim);
  lk.n_smooth = (float)((long long)B * (S - 2));
  AdamCoef ak;
  ak.clip = (float)hp[5];
  ak.b1 = (float)hp[6];
  ak.c1 = (float)(1.0 - hp[6]);
  ak.b2 = (float)hp[7];
  ak.c2 = (float)(1.0 - hp[7]);
  ak.eps = (float)hp[8];

  cudaError_t e;
#define CHECK(call)                      \
  do {                                   \
    e = (call);                          \
    if (e != cudaSuccess) return (int)e; \
  } while (0)
#define CHECK_LAUNCH() CHECK(cudaGetLastError())

  for (int t = 0; t < T; ++t) {
    const float* xt = x + (long long)t * B * dims[0];
    const float* spec_t = spec + (long long)t * B * S;
    const float* met_t = met + (long long)t * B * Mdim;
    const uint32_t seed_key = mix32(seeds[t]);

    // forward
    const float* a = xt;
    for (int l = 0; l < n_hidden; ++l) {
      const int din = dims[l], C = dims[l + 1];
      const long long* o = offsets + 4 * l;
      CHECK((gemm<true, false>(B, C, din, a, din, 1, params + o[0], 1, din, tc[l], C,
                               params + o[1], st)));
      ln_forward<<<B, kThreads, 0, st>>>(tc[l], ln[l], sc[l], act[l], ivar[l],
                                         params + o[2], params + o[3], C, ln_eps,
                                         slope, mix32(seed_key ^ (uint32_t)l),
                                         use_drop, thresh, inv_keep);
      CHECK_LAUNCH();
      a = act[l];
    }
    const int dh = dims[n_hidden];
    const long long* oh = offsets + 4 * n_hidden;
    CHECK((gemm<true, false>(B, D, dh, a, dh, 1, params + oh[0], 1, dh, pred, D,
                             params + oh[1], st)));
    loss_kernel<<<1, kThreads, 0, st>>>(pred, spec_t, met_t, dpred, rows + 3LL * t,
                                        B, S, Mdim, lk);
    CHECK_LAUNCH();

    // backward: head
    CHECK((gemm<false, true>(D, dh, B, dpred, 1, D, a, dh, 1, grad + oh[0], dh,
                             nullptr, st)));
    column_sum<<<(D + kThreads - 1) / kThreads, kThreads, 0, st>>>(dpred, B, D,
                                                                   grad + oh[1]);
    CHECK_LAUNCH();
    CHECK((gemm<true, true>(B, dh, D, dpred, D, 1, params + oh[0], dh, 1, da, dh,
                            nullptr, st)));
    // backward: hidden layers
    for (int l = n_hidden - 1; l >= 0; --l) {
      const int din = dims[l], C = dims[l + 1];
      const long long* o = offsets + 4 * l;
      const float* a_in = l == 0 ? xt : act[l - 1];
      ln_backward<<<B, kThreads, 0, st>>>(da, sc[l], ln[l], tc[l], ivar[l],
                                          params + o[2], dln, dt, C, slope, use_drop);
      CHECK_LAUNCH();
      ln_param_grads<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          dln, tc[l], ivar[l], dt, B, C, grad + o[2], grad + o[3], grad + o[1]);
      CHECK_LAUNCH();
      CHECK((gemm<false, true>(C, din, B, dt, 1, C, a_in, din, 1, grad + o[0], din,
                               nullptr, st)));
      if (l > 0) {
        CHECK((gemm<true, true>(B, din, C, dt, C, 1, params + o[0], din, 1, da, din,
                                nullptr, st)));
      }
    }

    // clip + Adam
    sumsq_partial<<<kNormParts, kThreads, 0, st>>>(grad, P, partial);
    CHECK_LAUNCH();
    ak.lr = sched[3 * t];
    ak.inv1 = sched[3 * t + 1];
    ak.inv2 = sched[3 * t + 2];
    adam_update<<<kAdamBlocks, kThreads, 0, st>>>(params, m, v, grad, P, partial, ak);
    CHECK_LAUNCH();
  }
#undef CHECK_LAUNCH
#undef CHECK
  return 0;
}

}  // extern "C"
