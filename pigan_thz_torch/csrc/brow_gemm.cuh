// The batch-row product of the training kernels, for Hopper (sm_90a):
// included by gan_train.cu (K2, and K3: K2's step for M ensemble members at
// once) and by forward_train.cu (K1).  Everything here is in an anonymous
// namespace, so each of the two sources compiles its own copy.
//
//   C[m, n] = sum_k A(m, k) B(k, n) (+ bias[n]), or C += that (ACC),
//   A(m, k) = A[m * sam + k * sak], B(k, n) = B[k * sbk + n * sbn],
//
// the strided operand convention of train_common.cuh's sgemm (AK: A is
// contiguous along k, else along m; BNC: B is contiguous along n, else
// along k), with the member on blockIdx.z through Per<T>.  It replaces the
// products of pigan_thz_tpu/ops/megakernel.py:_make_kernel whose rows are
// the batch (M = B or 2B): the forward layers and the input gradients of G,
// D and the frozen F, which that kernel runs on the MXU from VMEM; and those
// of _make_forward_kernel (K1): F's forward layers and input gradients.
//
// What bounds them on an H100.  At B = 64 a product such as 64 x 512 x 250
// is 8 MFLOP of FMAs (0.1 us at the 67 TFLOP/s fp32 peak) over 0.6 MB of
// operands (0.2 us from HBM, less from L2): nothing of the card's rates.
// sgemm gave it 16 tiles of 32 x 32 on 132 SMs, each block walking the
// whole depth 16 columns a step with no prefetch, so every step waited on
// an L2 round trip: ~34 us a product, latency-bound.  This kernel goes after
// the three things that held it back:
//
// - Too few blocks and serial depth: split-K across a thread-block cluster.
//   An output tile of 64 rows x 32 columns goes to a cluster of S blocks
//   (S in {1, 2, 4, 8}, 8 the portable cluster size); block r walks its own
//   contiguous slice of K.  The partial tiles are summed through
//   distributed shared memory in one fixed order, rank 0, 1, ..., S - 1,
//   each output read by the block that owns its rows; a cluster barrier
//   before the sum and one after it (no block exits while a peer still
//   reads its shared memory).  No atomics: reruns are bit-identical.
// - No prefetch: a ring of kBrowStages shared-memory stages filled by
//   cp.async, so one stage's L2 latency hides under the FMAs of the stages
//   before it.  The copies are 4 bytes an element, with the src-size
//   operand 0 (zero fill) past the slice, the rows or the columns: the
//   operands' rows are 250, 254 and 258 floats long at the published widths
//   (spectra, D's input, F's head), so a 16-byte copy would be misaligned
//   on most rows, and at 6 elements a thread a stage the instruction count
//   does not matter.  Each tile is stored in its operand's own layout (the
//   contiguous dimension innermost, padded to an odd pitch), so the copies
//   of a warp land on consecutive addresses and the compute reads are free
//   of bank conflicts.
// - The plan (ops/brow.py: brow_plan mirrors it) is a pure function of
//   (M, N, K) and the card's SM count: the smallest S that gives
//   the largest power of two of blocks not above the SM count (128 on 132
//   SMs), while every block keeps at least kBrowMinDepth columns of depth.
//   It never reads the member count or blockIdx.z, so member m's arithmetic
//   and its order are those of a launch for m alone.
//
// Arithmetic.  fp32 operands (RND false): exact fp32 FMAs on the CUDA
// cores, 8 outputs a thread, k ascending within a block's slice; the
// partial sums then added in rank order; the epilogue of sgemm.  bfloat16
// operands (RND true): each element rounded to bfloat16 (round to nearest
// even, as sgemm's tile loads round it) as its fragment is built, and
// mma.sync.m16n8k16 bf16 x bf16 -> fp32 on the tensor cores, one 16 x 16
// output block a warp.  A product of two bfloat16 values is exact in fp32,
// so only the order of the sums differs from the fp32 FMAs on the same
// rounded operands: the TPU's MXU arithmetic.
//
// A launch whose cluster shape the card refuses returns its error; there is
// no other route.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "train_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBrowBM = 64;        // output rows of a tile
constexpr int kBrowBN = 32;        // output columns of a tile
constexpr int kBrowBK = 16;        // depth of a ring stage
constexpr int kBrowStages = 4;     // ring stages
constexpr int kBrowMaxSplit = 8;   // the portable cluster size
constexpr int kBrowMinDepth = 32;  // columns of depth a split block keeps at least
constexpr int kBrowThreads = 256;

struct BrowPlan {
  int split;     // S: blocks of a cluster, one K slice each
  int tiles_m;   // row tiles of 64
  int tiles_n;   // column tiles of 32
  int slice;     // columns of depth a block: ceil(K / S)
};

// The launch plan of one product (one member's shape).
__host__ inline BrowPlan brow_plan_for(int M, int N, int K, int sms) {
  int target = 1;
  while (target * 2 <= sms) target *= 2;
  BrowPlan p;
  p.tiles_m = (M + kBrowBM - 1) / kBrowBM;
  p.tiles_n = (N + kBrowBN - 1) / kBrowBN;
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  int s = 1;
  while (s < kBrowMaxSplit && tiles * s < target &&
         (K + 2 * s - 1) / (2 * s) >= kBrowMinDepth) {
    s *= 2;
  }
  p.split = s;
  p.slice = (K + s - 1) / s;
  return p;
}

// One tile stage in shared memory, each operand in its own layout:
// A (AK) [BM][BK + 1], A (!AK) [BK][BM + 1]; B (BNC) [BK][BN + 1],
// B (!BNC) [BN][BK + 1].
template <bool AK>
struct BrowA {
  static constexpr int kFloats = AK ? kBrowBM * (kBrowBK + 1) : kBrowBK * (kBrowBM + 1);
  __device__ static __forceinline__ int at(int m, int k) {
    return AK ? m * (kBrowBK + 1) + k : k * (kBrowBM + 1) + m;
  }
};
template <bool BNC>
struct BrowB {
  static constexpr int kFloats = BNC ? kBrowBK * (kBrowBN + 1) : kBrowBN * (kBrowBK + 1);
  __device__ static __forceinline__ int at(int k, int n) {
    return BNC ? k * (kBrowBN + 1) + n : n * (kBrowBK + 1) + k;
  }
};

constexpr int kBrowRedPitch = kBrowBN + 1;   // the partial tile, [BM][BN + 1]

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 4 : 0;   // 0: no read, the 4 bytes zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One ring stage <- depth [k0, k0 + BK) of the block's tile, zeros past
// the slice's end (ke), the rows or the columns.
template <bool AK, bool BNC>
__device__ __forceinline__ void brow_load(float* As, int m0, int n0, int k0, int ke, int M,
                                          int N, const float* A, long long sam,
                                          long long sak, const float* B, long long sbk,
                                          long long sbn) {
  float* Bs = As + BrowA<AK>::kFloats;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kBrowBM * kBrowBK / kBrowThreads; ++i) {
    const int e = tid + i * kBrowThreads;
    int m, k;
    if (AK) { m = e / kBrowBK; k = e % kBrowBK; } else { k = e / kBrowBM; m = e % kBrowBM; }
    const int gm = m0 + m, gk = k0 + k;
    const bool ok = gm < M && gk < ke;
    cp_async4(As + BrowA<AK>::at(m, k), ok ? A + (long long)gm * sam + (long long)gk * sak : A,
              ok);
  }
#pragma unroll
  for (int i = 0; i < kBrowBN * kBrowBK / kBrowThreads; ++i) {
    const int e = tid + i * kBrowThreads;
    int n, k;
    if (BNC) { k = e / kBrowBN; n = e % kBrowBN; } else { n = e / kBrowBK; k = e % kBrowBK; }
    const int gn = n0 + n, gk = k0 + k;
    const bool ok = gn < N && gk < ke;
    cp_async4(Bs + BrowB<BNC>::at(k, n), ok ? B + (long long)gk * sbk + (long long)gn * sbn : B,
              ok);
  }
}

template <bool AK, bool BNC, bool RND, bool ACC>
__global__ void __launch_bounds__(kBrowThreads)
brow_gemm_kernel(int M, int N, int K, int split, int slice, PerIn Am, long long sam,
                 long long sak, PerIn Bm, long long sbk, long long sbn, PerOut Cm, int ldc,
                 PerIn biasm) {
  using LA = BrowA<AK>;
  using LB = BrowB<BNC>;
  constexpr int kStage = LA::kFloats + LB::kFloats;
  static_assert(kBrowStages * kStage >= kBrowBM * kBrowRedPitch, "the partial tile fits");
  __shared__ float smem[kBrowStages * kStage];

  const float* __restrict__ A = Am.at(blockIdx.z);
  const float* __restrict__ B = Bm.at(blockIdx.z);
  float* __restrict__ C = Cm.at(blockIdx.z);
  const float* __restrict__ bias = biasm.p ? biasm.at(blockIdx.z) : nullptr;
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * kBrowBN;
  const int m0 = blockIdx.y * kBrowBM;
  const int kb = rank * slice;
  const int ke = min(K, kb + slice);
  const int nt = ke > kb ? (ke - kb + kBrowBK - 1) / kBrowBK : 0;

  // fp32: rows ty + 16 i, columns tx + 16 j.  bf16: warp w owns rows
  // 16 (w / 2) .. + 16 and columns 16 (w % 2) .. + 16 as two n8 tiles.
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = (warp >> 1) * 16, wc = (warp & 1) * 16;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kBrowStages - 1; ++s) {
    if (s < nt) {
      brow_load<AK, BNC>(smem + s * kStage, m0, n0, kb + s * kBrowBK, ke, M, N, A, sam, sak, B,
                         sbk, sbn);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kBrowStages - 2>();   // stage t has landed
    __syncthreads();                    // ... for every thread; t - 1 is read
    const int nx = t + kBrowStages - 1;
    if (nx < nt) {
      brow_load<AK, BNC>(smem + (nx % kBrowStages) * kStage, m0, n0, kb + nx * kBrowBK, ke, M,
                         N, A, sam, sak, B, sbk, sbn);
    }
    cp_async_commit();
    const float* As = smem + (t % kBrowStages) * kStage;
    const float* Bs = As + LA::kFloats;
    if (RND) {
      uint32_t a[4];
      a[0] = pack_bf16(As[LA::at(wr + g, 2 * t4)], As[LA::at(wr + g, 2 * t4 + 1)]);
      a[1] = pack_bf16(As[LA::at(wr + g + 8, 2 * t4)], As[LA::at(wr + g + 8, 2 * t4 + 1)]);
      a[2] = pack_bf16(As[LA::at(wr + g, 2 * t4 + 8)], As[LA::at(wr + g, 2 * t4 + 9)]);
      a[3] = pack_bf16(As[LA::at(wr + g + 8, 2 * t4 + 8)],
                       As[LA::at(wr + g + 8, 2 * t4 + 9)]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wc + 8 * j + g;
        uint32_t b[2];
        b[0] = pack_bf16(Bs[LB::at(2 * t4, n)], Bs[LB::at(2 * t4 + 1, n)]);
        b[1] = pack_bf16(Bs[LB::at(2 * t4 + 8, n)], Bs[LB::at(2 * t4 + 9, n)]);
        mma_bf16(acc + 4 * j, a, b);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBrowBK; ++kk) {
        float a[4], b[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[LA::at(ty + 16 * i, kk)];
#pragma unroll
        for (int j = 0; j < 2; ++j) b[j] = Bs[LB::at(kk, tx + 16 * j)];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[2 * i + j] = fmaf(a[i], b[j], acc[2 * i + j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the partial tile takes its place

  float* red = smem;
  if (RND) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wc + 8 * j + 2 * t4;
      red[(wr + g) * kBrowRedPitch + c] = acc[4 * j + 0];
      red[(wr + g) * kBrowRedPitch + c + 1] = acc[4 * j + 1];
      red[(wr + g + 8) * kBrowRedPitch + c] = acc[4 * j + 2];
      red[(wr + g + 8) * kBrowRedPitch + c + 1] = acc[4 * j + 3];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) red[(ty + 16 * i) * kBrowRedPitch + tx + 16 * j] = acc[2 * i + j];
  }

  // The sum over the cluster in rank order, by the owner of each row.
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) cluster.sync(); else __syncthreads();
  const int rows = kBrowBM / split;
  for (int e = tid; e < rows * kBrowBN; e += kBrowThreads) {
    const int r = rank * rows + e / kBrowBN;
    const int c = e % kBrowBN;
    const int m = m0 + r, n = n0 + c;
    const int o = r * kBrowRedPitch + c;
    // every partial loaded before the first add, so the S remote reads
    // overlap; then the sum in rank order
    float part[kBrowMaxSplit];
#pragma unroll
    for (int q = 0; q < kBrowMaxSplit; ++q) {
      if (q < split) part[q] = split > 1 ? cluster.map_shared_rank(red, q)[o] : red[o];
    }
    float v = part[0];
#pragma unroll
    for (int q = 1; q < kBrowMaxSplit; ++q) {
      if (q < split) v += part[q];
    }
    if (m < M && n < N) {
      float* cp = C + (long long)m * ldc + n;
      if (ACC) *cp = *cp + v + (bias ? bias[n] : 0.f);
      else *cp = v + (bias ? bias[n] : 0.f);
    }
  }
  if (split > 1) cluster.sync();   // no block leaves while a peer reads it
}

// Launch one product for `members` members (grid z), with plan `p`.
template <bool AK, bool BNC, bool RND, bool ACC>
cudaError_t brow_gemm_launch(const BrowPlan& p, int M, int N, int K, PerIn A, long long sam,
                             long long sak, PerIn B, long long sbk, long long sbn, PerOut C,
                             int ldc, PerIn bias, cudaStream_t s, int members) {
  if (p.split < 1 || p.split > kBrowMaxSplit || (p.split & (p.split - 1)) != 0 ||
      p.slice < 1 || members < 1 || M < 1 || N < 1 || K < 1) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(p.tiles_n * p.split, p.tiles_m, members);
  cfg.blockDim = dim3(kBrowThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, brow_gemm_kernel<AK, BNC, RND, ACC>, M, N, K,
                                           p.split, p.slice, A, sam, sak, B, sbk, sbn, C, ldc,
                                           bias);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// brow_gemm_launch with the operand rounding and the accumulation chosen
// per launch, and the plan of this shape on `sms` SMs unless `split` > 0
// forces S.
template <bool AK, bool BNC>
cudaError_t brow_gemm(bool rnd, bool acc, int sms, int split, int M, int N, int K, PerIn A,
                      long long sam, long long sak, PerIn B, long long sbk, long long sbn,
                      PerOut C, int ldc, PerIn bias, cudaStream_t s, int members = 1) {
  BrowPlan p = brow_plan_for(M, N, K, sms);
  if (split > 0) {
    p.split = split;
    p.slice = (K + split - 1) / split;
  }
  if (rnd) {
    return acc ? brow_gemm_launch<AK, BNC, true, true>(p, M, N, K, A, sam, sak, B, sbk, sbn, C,
                                                       ldc, bias, s, members)
               : brow_gemm_launch<AK, BNC, true, false>(p, M, N, K, A, sam, sak, B, sbk, sbn,
                                                        C, ldc, bias, s, members);
  }
  return acc ? brow_gemm_launch<AK, BNC, false, true>(p, M, N, K, A, sam, sak, B, sbk, sbn, C,
                                                      ldc, bias, s, members)
             : brow_gemm_launch<AK, BNC, false, false>(p, M, N, K, A, sam, sak, B, sbk, sbn, C,
                                                       ldc, bias, s, members);
}

}  // namespace
