// Device code shared by the training kernels, forward_train.cu (K1) and
// gan_train.cu (K2, and K3: K2's step for M ensemble members at once), fp32,
// for Hopper (sm_90a): the product kernels of every product a training step
// does not run through brow_gemm.cuh (the deep narrow heads, the
// batch-depth weight gradients, the tiled SGEMM for the rest; gemm_route
// picks one by shape), the fixed-order block sum, the dropout hash,
// LayerNorm rows (forward and backward), column sums over the batch, and
// the deterministic two-pass global-norm clip with Adam.  Everything lives
// in an anonymous namespace: each source that includes this header gets its
// own copy, and no symbol leaves it.
//
// bfloat16 operands (compute_dtype="bfloat16").  The TPU kernels round the
// operands of their MXU products to bfloat16 and accumulate in fp32.  The
// product kernels' RND flag does the same as they load: each element of A
// and B is rounded to bfloat16 (round to nearest even, __float2bfloat16_rn)
// before it reaches an FMA, and the FMAs accumulate in fp32; a product of
// two bfloat16 values is exact in fp32, so only the order of the sums
// differs from the MXU's.  The flag is chosen per launch (gemm_ex): the
// products the TPU kernels run on the VPU in fp32 stay fp32.  ACC adds the
// product to C instead of overwriting it.  The fp32 instantiations (RND and
// ACC false) are the code of the fp32 kernels, unchanged.
//
// The member axis.  Every kernel here that the GAN step launches takes its
// operands as Per<T>: a pointer and a per-member stride.  The member is the
// grid's last used axis (blockIdx.z of the SGEMM and batch_depth_gemm,
// blockIdx.y of the others), and member m works on p + m * stride.  A
// plain pointer converts to a Per with stride 0, so a
// caller without members (K1; K2 is the one-member case) launches as before,
// with that axis 1.  Nothing else reads the member or the size of its axis:
// member m's arithmetic, and its order, are those of a launch for m alone.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;       // hidden layers + head
constexpr int kMaxPerThread = 8;    // row kernels: widths up to 2048
constexpr int kNormParts = 256;     // blocks of the first norm pass
constexpr int kAdamBlocks = 264;    // 2 per SM on an H100
constexpr int kBK = 16;             // depth of an SGEMM tile step
static_assert(kNormParts == kThreads, "adam_update reduces one partial per thread");

// The routes of the product dispatch below (gemm_route), in the order of
// ops/products.py's ROUTES.
enum { kRouteDeepNarrow = 0, kRouteBatchDepth = 1, kRouteSgemm = 2, kRoutes = 3 };

// What one call of a training C loop enqueued, in the caller's array of 7
// long longs (ops/_cuda_build.py's LoopReport, field for field): the device
// kernels; of those, the batch-row products (brow_gemm.cuh) and the other
// products by their route; and the call's enqueue head.  The entry point
// zeroes it, the loop's launch macros count into it.
struct LoopReport {
  long long kernels;
  long long brow;
  long long routes[kRoutes];
  long long head_kernels;   // launches in the enqueue head
  long long head_ns;        // host nanoseconds the head took
};
static_assert(sizeof(LoopReport) == 7 * sizeof(long long), "the caller passes 7 long longs");

// The enqueue head of a training C loop: the host clock from the loop's start
// to the first step boundary at which kHeadKernels launches are enqueued (to
// the loop's end if it enqueues fewer).  A chunk starts on an idle card, and
// the card's launch queue holds more than kHeadKernels launches, so no launch
// of the head waits for a free slot: its time is the host's own cost of the
// launches, where the whole loop, once the queue is full, runs at the card's
// pace.  Two clock reads a loop; it writes the report's head fields.
constexpr long long kHeadKernels = 512;

struct EnqueueHead {
  LoopReport& r;
  std::chrono::steady_clock::time_point t0 = std::chrono::steady_clock::now();

  void at_step() {
    if (r.head_kernels == 0 && r.kernels >= kHeadKernels) finish();
  }
  void finish() {
    if (r.head_kernels != 0 || r.kernels == 0) return;
    r.head_kernels = r.kernels;
    r.head_ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - t0).count();
  }
};

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
// The products of a training step that brow_gemm.cuh does not take, and the
// kernel each goes to.  Each computes
//   C[m, n] = sum_k A(m, k) B(k, n) (+ bias[n]), or C += that (ACC),
//   A(m, k) = A[m * sam + k * sak], B(k, n) = B[k * sbk + n * sbn], C row-major.
// AK: A is contiguous along k (else along m); BNC: B is contiguous along n
// (else along k).  The flags choose the thread mapping of the loads so that
// neighbouring threads read neighbouring addresses.  RND rounds every
// operand to bfloat16 as it is loaded; ACC adds to C.  All three kernels run
// exact fp32 FMAs on the CUDA cores (no TF32), use no atomics, and end with
// the same epilogue: (C +) the sum (+ bias), in that order.
//
// gemm_route picks the kernel from one member's N and K (M and the member
// count never matter), so every launch of a shape takes one route:
//
// - deep narrow (N <= 8 output columns, depth 128-1024: the heads of G and
//   D, the adversarial pass's 4 parameter columns, F's input gradient, F's
//   8 metrics columns under bfloat16).  The tiled SGEMM gave these one or
//   two 32 x 32 tiles, so 2-4 blocks walked the whole depth 16 columns a
//   step, two barriers a step: 17-24 us for ~65 K FMAs on an H100.
//   deep_narrow_gemm gives each output row a warp: lane l takes the depth
//   l, l + 32, l + 64, ... (coalesced where A is contiguous along k), sums
//   it in that order into all N columns at once, and a butterfly of
//   shuffles (offsets 16, 8, 4, 2, 1) adds the lanes' sums.  The row's A
//   loads are issued first and stay in flight while the block copies B
//   (K x N, <= 32 KB) into shared memory by cp.async: one wait, one
//   barrier, none in the depth loop: 2.5-3.7 us a product (PERF.md).
// - batch depth (depth 32-128: the weight gradients, whose depth is the
//   batch, B or 2B).  The SGEMM loaded each 32 x 32 tile in four or eight
//   16-deep steps of scalar loads, a barrier pair a step: ~10 us a product.
//   batch_depth_gemm loads the whole depth of its 32-row slice of A and
//   32-column slice of B at once (16-byte cp.async where the source is
//   aligned, 4-byte copies elsewhere: rows of 250, 254 and 258 floats), waits
//   once, and runs the FMAs 8 outputs a thread (4 rows x 2 columns, 128
//   threads): 128 blocks at 256 x 512; 3.5-5.2 us a product.  Each output's
//   sum runs k = 0, 1, ... K - 1 in one FMA chain, as the SGEMM's does, so
//   the two agree bit for bit.
// - the tiled SGEMM for the rest (depth 4 or 8: F's input layer, G's head
//   input gradient, F's metrics columns' input gradient under bfloat16).
// --------------------------------------------------------------------------
template <bool RND>
__device__ __forceinline__ float operand(float x) {
  if (RND) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

constexpr int kNarrowMaxN = 8;                    // output columns (a power of two)
constexpr int kNarrowMinK = 128;
constexpr int kNarrowMaxK = 1024;
constexpr int kNarrowWarps = 4;                   // output rows a block, one a warp
constexpr int kNarrowSlice = kNarrowMaxK / 32;    // depth a lane takes at most
constexpr int kDepthMinK = 32;
constexpr int kDepthMaxK = 128;
constexpr int kDepthTile = 32;                    // 32 x 32 outputs a block
constexpr int kDepthThreads = 128;                // 16 x 8: 2 columns x 4 rows each

// The route of a product: a pure function of its N and K.
__host__ inline int gemm_route(int N, int K) {
  if (N <= kNarrowMaxN && K >= kNarrowMinK && K <= kNarrowMaxK) return kRouteDeepNarrow;
  if (K >= kDepthMinK && K <= kDepthMaxK) return kRouteBatchDepth;
  return kRouteSgemm;
}

// The tiled SGEMM: BM x BN outputs a block, 16 deep a step.
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

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Deep narrow: one warp an output row m, NP >= N columns at once (NP the
// next power of two, the extra columns zero), the depth padded with zeros
// to a multiple of 128 so that the FMA loop runs whole groups of four
// slices under warp-uniform conditions only (see above).
template <int NP, bool AK, bool BNC, bool RND, bool ACC>
__global__ void __launch_bounds__(kNarrowWarps * 32)
deep_narrow_gemm(int M, int N, int K, PerIn Am, long long sam, long long sak, PerIn Bm,
                 long long sbk, long long sbn, PerOut Cm, int ldc, PerIn biasm) {
  constexpr int kThreadsHere = kNarrowWarps * 32;
  __shared__ float Bs[NP * (kNarrowMaxK + 1)];   // [n][k], pitch kpad + 1
  const float* __restrict__ A = Am.at(blockIdx.y);
  const float* __restrict__ B = Bm.at(blockIdx.y);
  float* __restrict__ C = Cm.at(blockIdx.y);
  const float* __restrict__ bias = biasm.p ? biasm.at(blockIdx.y) : nullptr;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int m = blockIdx.x * kNarrowWarps + (tid >> 5);
  const bool has_row = m < M;
  const int kpad = (K + 127) & ~127;
  const int ldb = kpad + 1;   // odd: the copies along n land in distinct banks

  // the row's slice of A into registers and B by cp.async into shared
  // memory, all in flight at once; A is rounded only where it is used, B by
  // the thread that copied it, after the copies land
  float a[kNarrowSlice];
#pragma unroll
  for (int j0 = 0; j0 < kNarrowSlice; j0 += 4) {
    if (32 * j0 < kpad) {
#pragma unroll
      for (int j = j0; j < j0 + 4; ++j) {
        const int k = lane + 32 * j;
        a[j] = has_row && k < K ? A[(long long)m * sam + (long long)k * sak] : 0.f;
      }
    }
  }
  // element e of B: threads along B's contiguous dimension
  auto element = [&](int e, int& k, int& n) {
    if (BNC) { n = e % N; k = e / N; } else { k = e % K; n = e / K; }
  };
  for (int e = tid; e < K * N; e += kThreadsHere) {
    int k, n;
    element(e, k, n);
    copy4_async(&Bs[n * ldb + k], B + (long long)k * sbk + (long long)n * sbn);
  }
  const int tail = kpad - K;
  for (int e = tid; e < N * tail; e += kThreadsHere) Bs[(e / tail) * ldb + K + e % tail] = 0.f;
  for (int e = tid; e < (NP - N) * kpad; e += kThreadsHere) {
    Bs[(N + e / kpad) * ldb + e % kpad] = 0.f;
  }
  copies_wait();
  if (RND) {
    for (int e = tid; e < K * N; e += kThreadsHere) {
      int k, n;
      element(e, k, n);
      Bs[n * ldb + k] = operand<true>(Bs[n * ldb + k]);
    }
  }
  __syncthreads();
  if (!has_row) return;

  // lane l: k = l, l + 32, ... in order (the zeros past K add nothing)
  float acc[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) acc[n] = 0.f;
#pragma unroll
  for (int j0 = 0; j0 < kNarrowSlice; j0 += 4) {
    if (32 * j0 < kpad) {
#pragma unroll
      for (int j = j0; j < j0 + 4; ++j) {
        const float x = operand<RND>(a[j]);
        const float* b = Bs + lane + 32 * j;
#pragma unroll
        for (int n = 0; n < NP; ++n) acc[n] = fmaf(x, b[n * ldb], acc[n]);
      }
    }
  }
  // lane l + off's sum added to lane l's: after offset 1 every lane holds
  // the same total
#pragma unroll
  for (int n = 0; n < NP; ++n) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], off);
  }
  if (lane < N) {
    float v = acc[0];
#pragma unroll
    for (int n = 1; n < NP; ++n) {
      if (lane == n) v = acc[n];
    }
    float* c = C + (long long)m * ldc + lane;
    if (ACC) *c = *c + v + (bias ? bias[lane] : 0.f);
    else *c = v + (bias ? bias[lane] : 0.f);
  }
}

// One operand's slice for batch_depth_gemm: X(i, k) = X[i * si + k * sk] for
// i in [i0, i0 + 32) and every k < K -> Xs[k][i - i0], zeros from i = extent.
// CI: X is contiguous along i.  fp32 operands travel by cp.async (16 bytes
// where four consecutive i are in range and the source is 16-byte aligned);
// RND rounds them to bfloat16 on their way through registers.
template <bool CI, bool RND>
__device__ __forceinline__ void depth_stage(float (*Xs)[kDepthTile], const float* X,
                                            long long si, long long sk, int i0, int extent,
                                            int K) {
  const int tid = threadIdx.x;
  if (CI) {
    for (int c = tid; c < K * (kDepthTile / 4); c += kDepthThreads) {
      const int k = c / (kDepthTile / 4), i = (c % (kDepthTile / 4)) * 4;
      const int gi = i0 + i;
      const float* src = X + (long long)gi * si + (long long)k * sk;
      if (!RND && si == 1 && gi + 3 < extent && ((uintptr_t)src & 15) == 0) {
        copy16_async(&Xs[k][i], src);
        continue;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = gi + q < extent;
        const float* sq = X + (long long)(gi + q) * si + (long long)k * sk;
        if (RND) Xs[k][i + q] = ok ? operand<true>(*sq) : 0.f;
        else if (ok) copy4_async(&Xs[k][i + q], sq);
        else Xs[k][i + q] = 0.f;
      }
    }
  } else {
    for (int e = tid; e < K * kDepthTile; e += kDepthThreads) {
      const int k = e % K, i = e / K;
      const bool ok = i0 + i < extent;
      const float* src = X + (long long)(i0 + i) * si + (long long)k * sk;
      if (RND) Xs[k][i] = ok ? operand<true>(*src) : 0.f;
      else if (ok) copy4_async(&Xs[k][i], src);
      else Xs[k][i] = 0.f;
    }
  }
}

// Batch depth: a 32 x 32 output tile, the whole depth (<= 128) in shared
// memory at once (see above).
template <bool AK, bool BNC, bool RND, bool ACC>
__global__ void __launch_bounds__(kDepthThreads)
batch_depth_gemm(int M, int N, int K, PerIn Am, long long sam, long long sak, PerIn Bm,
                 long long sbk, long long sbn, PerOut Cm, int ldc, PerIn biasm) {
  __shared__ __align__(16) float As[kDepthMaxK][kDepthTile];
  __shared__ __align__(16) float Bs[kDepthMaxK][kDepthTile];
  const float* __restrict__ A = Am.at(blockIdx.z);
  const float* __restrict__ B = Bm.at(blockIdx.z);
  float* __restrict__ C = Cm.at(blockIdx.z);
  const float* __restrict__ bias = biasm.p ? biasm.at(blockIdx.z) : nullptr;
  const int m0 = blockIdx.y * kDepthTile;
  const int n0 = blockIdx.x * kDepthTile;
  depth_stage<!AK, RND>(As, A, sam, sak, m0, M, K);
  depth_stage<BNC, RND>(Bs, B, sbn, sbk, n0, N, K);
  copies_wait();
  __syncthreads();

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // columns 2 tx, 2 tx + 1; rows 4 ty .. 4 ty + 3
  float acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
    const float2 b = *reinterpret_cast<const float2*>(&Bs[k][2 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
      acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + 2 * tx + j;
      if (n >= N) continue;
      float* c = C + (long long)m * ldc + n;
      if (ACC) *c = *c + acc[i][j] + (bias ? bias[n] : 0.f);
      else *c = acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

// One product through the kernel of `route`, the member on the grid's last
// axis.  A shape outside a forced route's limits is refused.
template <bool AK, bool BNC, bool RND, bool ACC>
cudaError_t product_launch(int route, int M, int N, int K, PerIn A, long long sam,
                           long long sak, PerIn B, long long sbk, long long sbn, PerOut C,
                           int ldc, PerIn bias, cudaStream_t s, int members) {
  if (route == kRouteDeepNarrow) {
    if (N > kNarrowMaxN || K > kNarrowMaxK) return cudaErrorInvalidValue;
    dim3 grid((M + kNarrowWarps - 1) / kNarrowWarps, members);
#define NARROW(NP)                                                                   \
  deep_narrow_gemm<NP, AK, BNC, RND, ACC><<<grid, kNarrowWarps * 32, 0, s>>>(       \
      M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias)
    if (N == 1) NARROW(1);
    else if (N == 2) NARROW(2);
    else if (N <= 4) NARROW(4);
    else NARROW(8);
#undef NARROW
  } else if (route == kRouteBatchDepth) {
    if (K > kDepthMaxK) return cudaErrorInvalidValue;
    dim3 grid((N + kDepthTile - 1) / kDepthTile, (M + kDepthTile - 1) / kDepthTile, members);
    batch_depth_gemm<AK, BNC, RND, ACC><<<grid, kDepthThreads, 0, s>>>(
        M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias);
  } else if (((M + 63) / 64) * ((N + 63) / 64) >= 128) {
    // the SGEMM: 64 x 64 tiles where they fill the card, else 32 x 32 (4x
    // the blocks); the choice reads one member's shape only
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

// product_launch with the operand rounding and the accumulation chosen per launch.
template <bool AK, bool BNC>
cudaError_t product_ex(int route, bool rnd, bool acc, int M, int N, int K, PerIn A,
                       long long sam, long long sak, PerIn B, long long sbk, long long sbn,
                       PerOut C, int ldc, PerIn bias, cudaStream_t s, int members) {
  if (rnd) {
    return acc ? product_launch<AK, BNC, true, true>(route, M, N, K, A, sam, sak, B, sbk, sbn,
                                                     C, ldc, bias, s, members)
               : product_launch<AK, BNC, true, false>(route, M, N, K, A, sam, sak, B, sbk,
                                                      sbn, C, ldc, bias, s, members);
  }
  return acc ? product_launch<AK, BNC, false, true>(route, M, N, K, A, sam, sak, B, sbk, sbn,
                                                    C, ldc, bias, s, members)
             : product_launch<AK, BNC, false, false>(route, M, N, K, A, sam, sak, B, sbk, sbn,
                                                     C, ldc, bias, s, members);
}

// A step's product on the route of its shape, counted in routes[route]
// when routes is given.
template <bool AK, bool BNC>
cudaError_t gemm_ex(bool rnd, bool acc, int M, int N, int K, PerIn A, long long sam,
                    long long sak, PerIn B, long long sbk, long long sbn, PerOut C, int ldc,
                    PerIn bias, cudaStream_t s, int members = 1,
                    long long* routes = nullptr) {
  const int route = gemm_route(N, K);
  if (routes) ++routes[route];
  return product_ex<AK, BNC>(route, rnd, acc, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias,
                             s, members);
}

template <bool AK, bool BNC, bool RND = false, bool ACC = false>
cudaError_t gemm(int M, int N, int K, PerIn A, long long sam, long long sak, PerIn B,
                 long long sbk, long long sbn, PerOut C, int ldc, PerIn bias,
                 cudaStream_t s, int members = 1, long long* routes = nullptr) {
  return gemm_ex<AK, BNC>(RND, ACC, M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, s,
                          members, routes);
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
