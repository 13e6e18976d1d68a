// The residual generator's eval forward as one kernel, fp32 results, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the enhanced designer's
// residual G (pigan_thz_tpu/models/generator.py:ResidualGenerator) to XLA,
// and the port served it through its modules (cuBLAS fp32 SGEMMs, BatchNorm,
// ReLUs and adds, replayed as a CUDA graph).  Added because that module
// stage held ~70 % of the enhanced designer's device time at B = 8192.
//
// The chain (ops/fused_kernels.py:pack_residual packs it): 250 -> 512, three
// residual blocks of two 512 -> 512 layers, 512 -> 256, 256 -> 128, each
// dense layer with its BatchNorm folded into W and b at packing (running
// statistics), ReLU after each; the second layer of a block adds the block's
// input before its ReLU; then the 128 -> 4 tanh head.  1.865 M
// multiply-adds a row: 30.6 GFLOP at B = 8192.  Bounds at B = 8192: 0.062 ms
// for those operations at the 495 TFLOP/s of TF32 on the tensor cores, 0.185
// ms for this design's three TF32 products of each, 0.456 ms at the 67
// TFLOP/s of fp32 outside the tensor cores.
//
// Arithmetic: K5's wgmma shape's (fused_mlp_chain.cu).  Every product of a
// hidden layer is wgmma.mma_async.m64n{64,128}k8.f32.tf32.tf32 with A from
// registers and B from shared memory, as 3xTF32: per k8 step a warpgroup
// splits its A fragment into hi = rna_tf32(a) and lo = rna_tf32(a - hi) and
// runs lo*hi, hi*hi, hi*lo, the two small products into accumulators of
// their own (added to hi*hi at the end); W comes pre-split by the packing.
// One TF32 product alone would miss fp32 by ~5e-4 of the parameters' RMS.
// The head runs on the CUDA cores, one warp a row (fmaf, a butterfly sum,
// IEEE tanhf).  ops/fused_kernels.py:fused_residual_chain_tf32 repeats this
// arithmetic in plain PyTorch.
//
// Work split.  A cluster of 2 blocks owns 128 batch rows; block q computes
// the q-th half of every layer's n8 tiles, in passes of at most 16 tiles
// (m64n128k8; equal passes, as K5's wgmma shape splits them), each of its
// two consumer warpgroups for 64 rows; a producer warpgroup's first thread
// streams the block's hi / lo W stages (one k8 step of a 16-tile pass, or
// two of an 8-tile one, 8 KB) by bulk copy into a ring of 4, as far ahead as
// the ring allows, across passes and layers.  A block keeps its half of the
// columns of the layers' inputs and outputs in two shared-memory buffers
// (swizzled as K5's, wswz): buffer 0 of 128 rows x 128 floats (x's half,
// the 256-wide and narrower layers'), buffer 1 of 128 x 256 (the residual
// blocks' inputs and outputs); with the ring 229,456 of 232,448 bytes.  A
// warpgroup reads A from its own block (ld.shared) and the other half from
// the peer's (ld.shared::cluster).  The residual blocks' inner layers, whose
// halves have no room, go to a global scratch of whole 512-wide rows (16 MB
// at B = 8192) that L2 holds, read back through L2 (ld.global.cg), as K5's
// 1024-wide layer.  The skip needs no buffer of its own: the buffer a
// block's second layer writes is the one that holds the block's input, so
// its epilogue reads x and writes relu(x + h W2 + b2) over it, each element
// by the thread that owns it.  After each layer the cluster's consumers meet
// (mbarriers; the producers never join), so no block writes what a peer
// still reads.
//
// Why 2 blocks and the scratch: clusters of 4 would keep every layer on
// chip (a quarter of a 512-wide layer is 128 floats a row), but an H100
// holds only 30 of them at once (its GPCs' SMs in fours: 120 of 132 SMs), so
// B = 8192 (64 clusters) takes 3 waves; measured on an H100, 0.61 ms back
// to back against 0.37 for clusters of 2, of which it holds 66 at once (B =
// 8192 in one wave).  W read from L2 a call at B = 8192: 64 clusters x 14.9
// MB (hi and lo of every W, once a cluster) = 0.96 GB.  Reruns give the same
// bits (no atomics; every sum in a fixed order).
//
// Interface: plain C, loaded with ctypes.  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success); it refuses a chain of
// other widths than the kernel takes (cudaErrorInvalidValue).  The kernel's
// shared-memory limit is raised once a device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "chain_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 2;         // blocks a cluster
constexpr int kRows = 128;          // batch rows a cluster owns: a 64-row tile a warpgroup
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kBlock = kConsumers + 128;   // and the producer's warpgroup
constexpr int kWarps = kConsumers / 32;
constexpr int kPassTiles = 16;      // n8 tiles a pass at most: m64n128k8
constexpr int kStageFloats = 128 * kPassTiles;   // one k8 step of 16 tiles, hi and lo: 8 KB
constexpr int kStages = 4;          // the ring's stages
constexpr int kWidthPad = 128;      // input and hidden widths: 8 n8 tiles a half at least
constexpr int kMaxLayers = 12;      // hidden layers + head
constexpr int kHeadMax = 8;         // the head's padded outputs
constexpr int kScratch = 2;         // an activation's place: buffer 0, buffer 1 or the scratch

// Buffer b's row stride in floats (the header's sizes).
__host__ __device__ constexpr int width_of(int b) { return b == 0 ? 128 : 256; }

// Passed by value.  Layer l maps dims[l] -> dims[l + 1], padded pdims (to
// kWidthPad; the head's output to 8).  Offsets in floats into the packed
// buffer: a hidden layer's hi / lo W stream (ops/fused_kernels.py:
// wgmma_stream: half by half, pass by pass), the head's W as (in, out)
// row-major; the biases zero-padded to the padded width.  place[a]: where
// activation a (layer a's input; 0 is x) lives: buffer a % 2, or the
// scratch (whole rows at stride sw) where its half is wider than that.
struct ResDesc {
  int n_layers;
  int dims[kMaxLayers + 1];
  int pdims[kMaxLayers + 1];
  long long w_off[kMaxLayers];
  long long b_off[kMaxLayers];
  int place[kMaxLayers];
  int sw;
  unsigned closes;  // bit l: layer l adds the input of layer l - 1 before its ReLU
};

// A hidden layer as a block runs it.
struct Layer {
  const float* in;    // the input: the block's buffer (the peer's half at the same
                      // offset) or the cluster's scratch rows
  int bw_in;          // its row stride
  bool in_scratch;
  int tshift;         // a buffer input: log2 of its n8 tiles a rank
  int nk8;            // k8 steps: the padded input width / 8
  const float* bias;  // global, from the block's first output column
  float* next;        // the output: the block's buffer or the scratch rows
  int bw_next;
  int next_c0;        // the column the output's swizzle counts from: 0, or the
                      // block's first column in the scratch's whole rows
  bool next_scratch;
  bool skip;          // add next's values (the block's input) before the ReLU
};

// The float4 that holds row r's A values of the k8 tiles j, j + 1 (j even)
// for this thread (k = tig, tig + 4 of each): from the scratch (L2), or from
// the rank whose half holds them, this block's shared memory or the peer's.
__device__ __forceinline__ float4 load_a(const Layer& L, int j, int r, int rank) {
  const int tig = threadIdx.x & 3;
  if (L.in_scratch) {
    const int c = 8 * j;
    return __ldcg(reinterpret_cast<const float4*>(L.in + r * L.bw_in +
                                                  ((c ^ ((r & 1) << 4)) + 4 * tig)));
  }
  const int q = j >> L.tshift;
  const int c = 8 * (j - (q << L.tshift));
  const float* p = L.in + r * L.bw_in + ((c ^ ((r & 1) << 4)) + 4 * tig);
  if (q == rank) return *reinterpret_cast<const float4*>(p);
  return ld_cluster4(cluster_addr(p, q));
}

// The products of one k8 step for this warpgroup's 64 rows and the pass's
// NT tiles, issued without waiting: A split into hi and lo in registers, B
// from the ring's stage `slot`, `sub` steps into it.
template <int NT>
__device__ __forceinline__ void issue(float (&acc)[4 * NT], float (&sml)[4 * NT],
                                      const float (&a)[4], uint32_t (&ahi)[4], uint32_t (&alo)[4],
                                      const Ring& ring, int slot, int sub) {
  const uint32_t base = smem_addr(ring.stage + slot * kStageFloats) + sub * NT * 512;
  const uint64_t bhi = wg_desc(base);
  const uint64_t blo = wg_desc(base + NT * 256);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ahi[i], alo[i]);
  wgmma_fence();
  Wgmma<NT>::mma(sml, alo, bhi);
  Wgmma<NT>::mma(acc, ahi, bhi);
  Wgmma<NT>::mma(sml, ahi, blo);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// One pass of a hidden layer, the block's tiles [a, a + NT), for this
// warpgroup's 64 rows: the products over every k8 step (step s's run while
// step s + 1's A is split and issued; a stage is released once the products
// of its last step are done; A is loaded two steps, one float4, ahead),
// then the epilogue: relu((small + hi*hi) + bias [+ skip]) into `next`.
template <int NT>
__device__ __forceinline__ void dense(const Layer& L, int a, int rank, const Ring& ring,
                                      int& it) {
  constexpr int kSteps = kPassTiles / NT;  // k8 steps a stage
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int ra = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + gid;
  const int rb = ra + 8;
  const int nk8 = L.nk8;

  float acc[4 * NT];  // hi*hi
  float sml[4 * NT];  // lo*hi + hi*lo
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) acc[i] = sml[i] = 0.f;
  uint32_t ahi[2][4], alo[2][4];  // the A registers of the two steps in flight

  float4 va = load_a(L, 0, ra, rank);
  float4 vb = load_a(L, 0, rb, rank);
  int sub = 0;         // the step's place in its stage
  int prev_slot = -1;  // the stage to release once the previous step is done
  for (int j = 0; j < nk8; j += 2) {
    float4 na = va, nb = vb;
    if (j + 2 < nk8) {
      na = load_a(L, j + 2, ra, rank);
      nb = load_a(L, j + 2, rb, rank);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = it % kStages;
      if (sub == 0) mbar_wait(ring.full + slot, (it / kStages) & 1);
      const float av[4] = {h ? va.z : va.x, h ? vb.z : vb.x, h ? va.w : va.y,
                           h ? vb.w : vb.y};
      issue<NT>(acc, sml, av, ahi[h], alo[h], ring, slot, sub);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (prev_slot >= 0) release(ring.empty + prev_slot);
      prev_slot = -1;
      if (++sub == kSteps || j + h + 1 == nk8) {
        prev_slot = slot;
        sub = 0;
        ++it;
      }
    }
    va = na;
    vb = nb;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  if (prev_slot >= 0) release(ring.empty + prev_slot);
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) {
    fence_operand(acc[i]);
    fence_operand(sml[i]);
    acc[i] = sml[i] + acc[i];
  }

  // Every bias and skip value first: loads, all in flight at once, ahead of
  // the stores (a load behind a store that may alias it waits out its
  // latency each time).  The bias, then the skip, as the plain version adds
  // them.
  float bias[2 * NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    bias[2 * t] = __ldg(L.bias + 8 * (a + t) + 2 * tig);
    bias[2 * t + 1] = __ldg(L.bias + 8 * (a + t) + 2 * tig + 1);
  }
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) acc[i] += bias[2 * (i >> 2) + (i & 1)];
  if (L.skip) {
    float skip[4 * NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? rb : ra;
        const int c = L.next_c0 + 8 * (a + t) + 2 * tig;
        const float* p0 = L.next + r * L.bw_next + wswz(r, c);
        const float* p1 = L.next + r * L.bw_next + wswz(r, c + 1);
        skip[4 * t + 2 * h] = L.next_scratch ? __ldcg(p0) : *p0;
        skip[4 * t + 2 * h + 1] = L.next_scratch ? __ldcg(p1) : *p1;
      }
    }
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] += skip[i];
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      const int c = L.next_c0 + 8 * (a + t) + 2 * tig;
      L.next[r * L.bw_next + wswz(r, c)] = fmaxf(acc[4 * t + 2 * h], 0.f);
      L.next[r * L.bw_next + wswz(r, c + 1)] = fmaxf(acc[4 * t + 2 * h + 1], 0.f);
    }
  }
}

// The tiles of a pass over a block's t n8 tiles: equal passes of at most
// kPassTiles (ops/fused_kernels.py:wgmma_passes); configure refuses t that
// does not split so.
__host__ __device__ __forceinline__ int pass_tiles(int t) {
  return t / ((t + kPassTiles - 1) / kPassTiles);
}

// The producer: the first thread of the third warpgroup streams the block's
// stages of every pass of every hidden layer, one bulk copy a stage, as far
// ahead as the ring allows.
__device__ void produce(const ResDesc& d, const float* __restrict__ w, int rank,
                        const Ring& ring) {
  int it = 0;
  for (int l = 0; l < d.n_layers - 1; ++l) {
    const int nk8 = d.pdims[l] / 8;
    const int t = d.pdims[l + 1] / (8 * kCluster);
    const int nt = pass_tiles(t);
    const int steps = kPassTiles / nt;
    // the rank before this one holds t tiles of 16 * pdims[l] floats each
    const float* src = w + d.w_off[l] + (size_t)16 * rank * t * d.pdims[l];
    for (int a = 0; a < t; a += nt) {
      for (int k = 0; k < nk8; k += steps, ++it) {
        const int slot = it % kStages;
        if (it >= kStages) mbar_wait(ring.empty + slot, (it / kStages - 1) & 1);
        const unsigned floats = 128u * nt * min(steps, nk8 - k);
        mbar_arrive_expect_tx(ring.full + slot, 4 * floats);
        bulk_copy(ring.stage + slot * kStageFloats, src, 4 * floats, ring.full + slot);
        src += floats;
      }
    }
  }
}

// The tanh head on the CUDA cores: block q the q-th half of the cluster's
// rows, one warp a row at a time; lane k's terms are the columns k, k + 32,
// ... of h (each from the rank whose half holds it), summed in that order,
// then a butterfly.
__device__ void tanh_head(const ResDesc& d, const float* __restrict__ w, const float* h, int bw,
                          float* __restrict__ out, int row0, int rows, int rank) {
  constexpr int kOwn = kRows / kCluster;
  const int l = d.n_layers - 1;
  const int din_p = d.pdims[l];
  const int cpr = din_p / kCluster;  // the columns of h a rank holds
  const int dout = d.dims[l + 1];
  const int dout_p = d.pdims[l + 1];
  const float* __restrict__ W = w + d.w_off[l];
  const float* __restrict__ bias = w + d.b_off[l];
  const int lane = threadIdx.x & 31;
  const int end = min((rank + 1) * kOwn, rows);
  for (int r = rank * kOwn + (threadIdx.x >> 5); r < end; r += kWarps) {
    float s[kHeadMax];
#pragma unroll
    for (int j = 0; j < kHeadMax; ++j) s[j] = 0.f;
    for (int k = lane; k < din_p; k += 32) {
      const int q = k / cpr;
      const float* p = h + r * bw + wswz(r, k - q * cpr);
      const float v = q == rank ? *p : ld_cluster(cluster_addr(p, q));
#pragma unroll
      for (int j = 0; j < kHeadMax; ++j) {
        if (j < dout) s[j] = fmaf(v, __ldg(W + (size_t)k * dout_p + j), s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kHeadMax; ++j) {
      if (j < dout) s[j] = warp_sum(s[j]);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kHeadMax; ++j) {
        if (j < dout) out[(size_t)(row0 + r) * dout + j] = tanhf(s[j] + bias[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock, 1)
residual_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ w, float* __restrict__ scratch, const ResDesc d,
                      int batch) {
  extern __shared__ float4 smem4[];
  Ring ring;
  ring.stage = reinterpret_cast<float*>(smem4);
  float* const buf0 = ring.stage + kStages * kStageFloats;
  float* const buf1 = buf0 + kRows * width_of(0);
  ring.full = reinterpret_cast<uint64_t*>(buf1 + kRows * width_of(1));
  ring.empty = ring.full + kStages;
  uint64_t* const xbar = ring.empty + kStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / kCluster) * kRows;
  const int rows = min(kRows, batch - row0);
  float* const rows_of = scratch + (size_t)row0 * d.sw;  // the cluster's scratch rows

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, kWarps);
    }
    mbar_init(xbar, kCluster);
    mbar_init(xbar + 1, kCluster);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // This block's half of the x tile's columns -> buffer 0; rows past the
  // batch and padded columns are zero.
  {
    const int din = d.dims[0];
    const int xw = d.pdims[0] / kCluster;
    const int c0 = rank * xw;
    for (int i = threadIdx.x; i < kRows * xw; i += kBlock) {
      const int r = i / xw;
      const int c = i - r * xw;
      buf0[r * width_of(0) + wswz(r, c)] =
          r < rows && c0 + c < din ? x[(size_t)(row0 + r) * din + c0 + c] : 0.f;
    }
  }
  cluster.sync();  // the barriers' init and the x halves are visible to the peer

  // The producer's warpgroup gives up registers, the consumers take them.
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) produce(d, w, rank, ring);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  int it = 0;
  int phase = 0;
  for (int l = 0; l < d.n_layers - 1; ++l) {
    const int t = d.pdims[l + 1] / (8 * kCluster);
    const int pin = d.place[l];
    const int pout = d.place[l + 1];
    Layer L;
    L.in_scratch = pin == kScratch;
    L.in = L.in_scratch ? rows_of : pin ? buf1 : buf0;
    L.bw_in = L.in_scratch ? d.sw : width_of(pin);
    L.tshift = __ffs(d.pdims[l] / (8 * kCluster)) - 1;
    L.nk8 = d.pdims[l] / 8;
    L.bias = w + d.b_off[l] + 8 * t * rank;
    L.next_scratch = pout == kScratch;
    L.next = L.next_scratch ? rows_of : pout ? buf1 : buf0;
    L.bw_next = L.next_scratch ? d.sw : width_of(pout);
    L.next_c0 = L.next_scratch ? 8 * t * rank : 0;
    L.skip = (d.closes >> l) & 1u;
    const int nt = pass_tiles(t);
    for (int a = 0; a < t; a += nt) {
      if (nt == 16) {
        dense<16>(L, a, rank, ring, it);
      } else {
        dense<8>(L, a, rank, ring, it);
      }
    }
    cluster_meet<kCluster, kConsumers>(xbar, phase);  // the peer reads this layer's output
  }
  const int ph = d.place[d.n_layers - 1];
  tanh_head(d, w, ph ? buf1 : buf0, width_of(ph), out, row0, rows, rank);
  cluster_meet<kCluster, kConsumers>(xbar, phase);  // no block leaves while the peer reads it
}

constexpr size_t kSmemBytes = sizeof(float) * ((size_t)kStages * kStageFloats +
                                               (size_t)kRows * (width_of(0) + width_of(1))) +
                              sizeof(uint64_t) * (2 * kStages + 2);

// The chain's widths and places into `d`, and the launch of `clusters`
// clusters; refuses (cudaErrorInvalidValue) a chain the kernel does not
// take: equal passes of 8 or 16 n8 tiles over a block's tiles, a power of
// two of n8 tiles a rank for every input in a buffer, x and the head's input
// in buffers, a closing layer whose block input is as wide as its output, a
// head of at most kHeadMax padded outputs.
cudaError_t configure(const int* dims, int n_layers, unsigned closes, int clusters, ResDesc& d,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  if (n_layers < 2 || n_layers > kMaxLayers || (closes >> (n_layers - 1)) != 0 ||
      (closes & 1u) != 0) {
    return cudaErrorInvalidValue;
  }
  d.n_layers = n_layers;
  d.closes = closes;
  d.sw = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1) return cudaErrorInvalidValue;
    d.dims[i] = dims[i];
    const int pad = i < n_layers ? kWidthPad : 8;
    d.pdims[i] = (dims[i] + pad - 1) / pad * pad;
  }
  if (d.pdims[n_layers] > kHeadMax) return cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l) {
    const int half = d.pdims[l] / kCluster;
    d.place[l] = half <= width_of(l & 1) ? (l & 1) : kScratch;
    if (d.place[l] == kScratch) {
      if (l == 0 || l == n_layers - 1) return cudaErrorInvalidValue;
      d.sw = d.pdims[l] > d.sw ? d.pdims[l] : d.sw;
    } else if ((half & (half - 1)) != 0) {
      return cudaErrorInvalidValue;  // tiles a rank: a power of two
    }
    if (l == n_layers - 1) break;
    const int t = d.pdims[l + 1] / (8 * kCluster);
    const int nt = pass_tiles(t);
    if ((nt != 8 && nt != 16) || t % nt != 0) return cudaErrorInvalidValue;
    if (((closes >> l) & 1u) && d.pdims[l - 1] != d.pdims[l + 1]) return cudaErrorInvalidValue;
  }
  static std::atomic<int> cached[kMaxDevices];  // 0 until set
  int limit = 0;
  const cudaError_t e = raise_smem_limit(residual_chain_kernel, cached, &limit);
  if (e != cudaSuccess) return e;
  if (kSmemBytes > (size_t)limit) return cudaErrorInvalidValue;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * kCluster, 1, 1);
  cfg.blockDim = dim3(kBlock, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The residual generator's chain (ops/fused_kernels.py:pack_residual): x
// (batch, dims[0]) -> out (batch, dims[n_layers]); offsets: n_layers rows of
// (W, b) float offsets, a host array; closes, bit l: hidden layer l adds the
// input of layer l - 1 before its ReLU; scratch: (clusters * kRows) rows of
// the widest scratch activation's padded width (ops/fused_kernels.py
// allocates it), or null where the chain puts none there.
int pigan_fused_residual_chain(const float* x, float* out, const float* w, float* scratch,
                               const long long* offsets, const int* dims, int n_layers,
                               unsigned closes, int batch, void* stream) {
  if (batch < 1 || n_layers < 2 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  ResDesc d{};
  for (int l = 0; l < n_layers; ++l) {
    d.w_off[l] = offsets[2 * l];
    d.b_off[l] = offsets[2 * l + 1];
    // the bulk copies move 16-byte units from 16-byte boundaries
    if (d.w_off[l] < 0 || d.b_off[l] < 0 || (d.w_off[l] & 3) != 0) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(dims, n_layers, closes, (batch + kRows - 1) / kRows, d, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  if ((d.sw > 0) != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  cfg.stream = (cudaStream_t)stream;
  e = cudaLaunchKernelEx(&cfg, residual_chain_kernel, x, out, w, scratch, d, batch);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
