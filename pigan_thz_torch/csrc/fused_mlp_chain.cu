// Fused MLP-chain forward kernels for serving, fp32 results, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pigan_thz_tpu/ops/pallas_kernels.py:
//   - fused_mlp_forward (K5): the forward surrogate, per hidden layer
//     h@W+b -> LayerNorm (two-pass variance, eps 1e-6) -> LeakyReLU, then a
//     linear head (4->256->512->1024->512->256->258);
//   - fused_dense_chain (K6): the generator with BatchNorm folded into the
//     dense weights beforehand, ReLU hidden layers, tanh head
//     (250->512->256->4).
// Both are one template, chain_kernel<HIDDEN, HEAD>, launched once per call.
//
// Arithmetic.  Every product of a dense layer runs on the tensor cores as
// 3xTF32: each operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (the rounding of cvt.rna.tf32.f32), and each
// mma.sync.m16n8k8 step accumulates lo*hi, then hi*lo, then hi*hi, as
// CUTLASS's 3xTF32 does (lo*lo is dropped).  The two small products sum
// into accumulators of their own, added to the hi*hi sum at the end: the
// tensor cores' fp32 accumulation drops low bits of the addend, which the
// large sum would otherwise take from the small terms (on an H100, K5 up
// to 1.9e-5 from its plain version with one accumulator, 8.6e-6 with two).  That
// keeps the chain within rounding of fp32 (ops/fused_kernels.py has a plain
// PyTorch twin of this arithmetic); one TF32 product alone would not (1e-3).
// K6's 256 -> 4 head runs on the CUDA cores, one warp per (row, column) dot
// product with a butterfly shuffle sum and IEEE tanhf.
//
// Layout.  The packed weights (ops/fused_kernels.py:pack_chain) hold each
// W as (in, out) row-major, zero-padded to multiples of 8 in both
// dimensions, each tensor at a 64-byte boundary; biases and LayerNorm
// vectors zero-padded to the padded width.  A block owns kRows = 32 batch
// rows (two m16 tiles) and runs them through the whole chain.  Activations
// stay in shared memory in two ping-pong buffers, row-major, with the
// columns of row r permuted by k ^ ((r & 7) << 2) inside each 32-column
// group: the A-fragment loads (8 rows x 4 columns a warp) and the float2
// fragment stores are then free of bank conflicts without padding, which
// K5 has no room for (32 x (512 + 1024) floats = 192 KB).
//
// Weight staging.  A layer's output columns run in passes of at most 256
// (32 n8 tiles; 8 consumer warps, each holding 32 rows x up to 4 tiles of
// accumulators).  A ninth warp, the producer, streams the W columns of
// every pass of every layer, in order, from L2 into a ring of kStages
// shared-memory stages with bulk copies (cp.async.bulk, the copy engine)
// whose completion an mbarrier counts; it runs ahead of the consumers as
// far as the ring allows, across passes and layers.  A consumer warp waits
// for a stage's barrier, loads its B fragments into registers and releases
// the stage (an arrival on its "empty" barrier) before it runs the mma, so
// the refill overlaps the products; the warps never wait for one another
// inside a layer.  A stage holds 16 k-rows of a 256-column pass (16.9 KB)
// or more rows of a narrower one, at a row stride = 8 mod 32 floats, so the
// B-fragment loads are free of bank conflicts.  In the row-tile shape each
// stage is one bulk copy of W stored in stage order (pack_chain's `tiled`
// copy, padding included); one copy a W row streamed at half the rate
// (examples/torch_serving_ablate.py).  Passes share a layer's columns
// evenly: K5's 258 -> 264 head is two passes of 16 and 17 tiles, so no
// warp idles on a ragged tail.
//
// Two launch shapes, one kernel.  The row-tile shape (cluster size 1) gives
// each block its own 32 rows: B = 8192 is 256 blocks, 1.94 waves on 132
// SMs (the tail wave has 124 blocks).  For small batches a thread-block
// cluster of C blocks (2, 4 or 8) shares one row tile: block c computes
// columns [c*T/C, (c+1)*T/C) of every layer's T n8 tiles, so each block
// streams 1/C of the weights; after a hidden layer, cluster.sync(), every
// block copies its peers' column slices out of their shared memory
// (distributed shared memory), cluster.sync() again, and then each block
// runs the LayerNorm on whole rows itself.  Every output element is summed
// in the same order in both shapes (one warp, k in order; LayerNorm by one
// warp a row), so the two shapes give the same bits, and reruns do too: no
// atomics anywhere.
//
// Bounds on the card.  K5 at B = 8192 is 22.6 GFLOP of fp32 products: 0.34
// ms at the 67 TFLOP/s of fp32 outside the tensor cores; as 3xTF32, three
// TF32 products at 495 TFLOP/s, 0.14 ms.  The kernel is bound by its
// products' issue: the two small products of 3xTF32 take about a third of
// its time, the W stream hides mostly under the products
// (examples/torch_serving_ablate.py rebuilds it with one part changed at a
// time).  Each block streams the whole chain's weights from L2 (5.7 MB in
// stage order for K5), so 256 blocks read 1.5 GB of L2: a cluster that
// multicasts W tiles to several row tiles, wgmma and persistent blocks are
// later work.
//
// Interface: plain C, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success).  A launch makes no
// occupancy query: the wrappers pick or check the cluster size against
// pigan_fused_chain_max_clusters' answer, asked once a chain and card, and a
// cluster shape the card cannot schedule fails its launch.  The kernel's
// shared-memory limit is raised once a device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 32;                 // batch rows a block owns: two m16 tiles
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTilesPerWarp = 4;          // n8 tiles of accumulators a warp holds
constexpr int kPassTiles = kWarps * kTilesPerWarp;   // 32 tiles = 256 columns
// K5's activations leave 35 KB of shared memory for the ring: two stages of
// 16 k-rows of a full pass (ops/fused_kernels.py mirrors these two numbers).
constexpr int kStages = 2;
constexpr int kStageFloats = 16 * (8 * kPassTiles + 8);  // 16 k-rows at stride 264
constexpr int kMaxLayers = 8;             // hidden layers + head
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kMaxDevices = 64;

enum Hidden { kLayerNormLeaky = 0, kRelu = 1 };
enum Head { kLinear = 0, kTanh = 1 };

// Passed by value (kernel parameter space).  Offsets are in floats into the
// packed weight buffer; layer l maps dims[l] -> dims[l + 1], padded
// pdims[l] -> pdims[l + 1].
struct ChainDesc {
  int n_layers;
  int dims[kMaxLayers + 1];
  int pdims[kMaxLayers + 1];
  long long w_off[kMaxLayers];
  long long b_off[kMaxLayers];
  long long s_off[kMaxLayers];  // LayerNorm scale (LayerNorm chains only)
  long long t_off[kMaxLayers];  // LayerNorm shift
  long long tiled_off[kMaxLayers];  // W in stage order for the row-tile shape, or -1
  int buf_width[2];             // row stride of each ping-pong buffer, = 0 mod 32
};

// Column swizzle of the activation buffers (see the header).
__device__ __forceinline__ int swz(int r, int c) { return c ^ ((r & 7) << 2); }

// Round to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global to shared memory by the copy
// engine (a bulk copy); completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The consumer warps' own barrier: the producer warp never joins it.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;  // the same bits in every lane: each step adds the same pair
}

// The n8 tiles [t0, t1) of a layer's `ntiles` that cluster rank `rank` owns.
__device__ __forceinline__ void cta_tiles(int ntiles, int rank, int csize, int& t0,
                                          int& t1) {
  t0 = rank * ntiles / csize;
  t1 = (rank + 1) * ntiles / csize;
}

// Pass p of np over the block's tiles [t0, t0 + t): its first column, its
// tile count, the stage row stride (= 8 mod 32) and the k-rows of a stage.
struct Pass {
  int c0, tiles, stride, kt;
};

__device__ __forceinline__ Pass pass_geom(int t0, int t, int np, int p, int din_p) {
  const int a = t0 + p * t / np;
  const int b = t0 + (p + 1) * t / np;
  Pass g;
  g.c0 = 8 * a;
  g.tiles = b - a;
  g.stride = ((8 * g.tiles + 31) & ~31) + 8;
  g.kt = min((kStageFloats / g.stride) & ~7, din_p);
  return g;
}

// The ring of W stages: stage `it` of a block's sequence (over every pass
// of every layer, in order) lands in slot it % kStages; full[slot] completes
// when its bytes are in, empty[slot] when all kWarps consumer warps are
// done with it.
struct Ring {
  float* stage;
  uint64_t* full;
  uint64_t* empty;
};

// A warp's B fragments of S consecutive k8 steps (stage rows kk, kk + 8,
// ...) for its NW tiles, split into hi and lo.
template <int S, int NW>
__device__ __forceinline__ void load_b(const float* st, int stride, int kk, int w0,
                                       uint32_t (&bhi)[S][NW][2], uint32_t (&blo)[S][NW][2]) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int n = 8 * (w0 + j) + gid;
      split(st[(kk + 8 * s + tig) * stride + n], bhi[s][j][0], blo[s][j][0]);
      split(st[(kk + 8 * s + tig + 4) * stride + n], bhi[s][j][1], blo[s][j][1]);
    }
  }
}

// The products of S consecutive k8 steps (activation columns from k) for
// the warp's NW tiles, from B fragments already in registers.
template <int S, int NW>
__device__ __forceinline__ void mma_steps(const float* in, int bw_in, int k,
                                          const uint32_t (&bhi)[S][NW][2],
                                          const uint32_t (&blo)[S][NW][2],
                                          float (&acc)[2][kTilesPerWarp][4],
                                          float (&small)[2][kTilesPerWarp][4]) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int r = 16 * m + gid;
      const float* ra = in + r * bw_in;
      const float* rb = in + (r + 8) * bw_in;
      const int c = k + 8 * s + tig;
      split(ra[swz(r, c)], ahi[m][0], alo[m][0]);
      split(rb[swz(r, c)], ahi[m][1], alo[m][1]);
      split(ra[swz(r, c + 4)], ahi[m][2], alo[m][2]);
      split(rb[swz(r, c + 4)], ahi[m][3], alo[m][3]);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_tf32(small[m][j], alo[m], bhi[s][j][0], bhi[s][j][1]);
        mma_tf32(small[m][j], ahi[m], blo[s][j][0], blo[s][j][1]);
        mma_tf32(acc[m][j], ahi[m], bhi[s][j][0], bhi[s][j][1]);
      }
    }
  }
}

// This warp is done reading a stage.
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// A stage's products for a warp of nw <= NW tiles, in chunks of two k8
// steps (the odd one last).  Each chunk's B fragments go to registers
// first; after the stage's last chunk is loaded the warp releases the
// stage, so the producer refills it while the warp runs the mma.  The tile
// count is a template argument, so that the tile loops have no branch.
template <int NW>
__device__ __forceinline__ void stage_products(int nw, const float* in, int bw_in,
                                               const float* st, int stride, int k0, int rows,
                                               int w0, uint64_t* empty,
                                               float (&acc)[2][kTilesPerWarp][4],
                                               float (&small)[2][kTilesPerWarp][4]) {
  if constexpr (NW == 0) {
    release(empty);
  } else {
    if (nw < NW) {
      stage_products<NW - 1>(nw, in, bw_in, st, stride, k0, rows, w0, empty, acc, small);
      return;
    }
    int kk = 0;
    for (; kk + 16 <= rows; kk += 16) {
      uint32_t bhi[2][NW][2], blo[2][NW][2];
      load_b<2, NW>(st, stride, kk, w0, bhi, blo);
      if (kk + 16 == rows) release(empty);
      mma_steps<2, NW>(in, bw_in, k0 + kk, bhi, blo, acc, small);
    }
    if (kk < rows) {
      uint32_t bhi[1][NW][2], blo[1][NW][2];
      load_b<1, NW>(st, stride, kk, w0, bhi, blo);
      release(empty);
      mma_steps<1, NW>(in, bw_in, k0 + kk, bhi, blo, acc, small);
    }
  }
}

// One dense layer's products for the block's columns: out[r, c] = in[r, :] @
// W[:, c] + b[c] (ReLU for the generator's hidden layers), for c in the
// block's tiles, written to `next` (swizzled).  W arrives through `ring`;
// `it` is the block's stage count so far, advanced here.
template <bool RELU>
__device__ void dense_layer(const float* in, int bw_in, float* next, int bw_next,
                            const float* __restrict__ bias, int din_p, int t0, int t,
                            const Ring& ring, int& it) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int np = (t + kPassTiles - 1) / kPassTiles;

  for (int p = 0; p < np; ++p) {
    const Pass g = pass_geom(t0, t, np, p, din_p);
    const int w0 = warp * g.tiles / kWarps;
    const int nw = (warp + 1) * g.tiles / kWarps - w0;

    float acc[2][kTilesPerWarp][4];    // hi*hi
    float small[2][kTilesPerWarp][4];  // lo*hi + hi*lo
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] = small[m][j][q] = 0.f;

    for (int k0 = 0; k0 < din_p; k0 += g.kt, ++it) {
      const int slot = it % kStages;
      mbar_wait(ring.full + slot, (it / kStages) & 1);
      const float* st = ring.stage + slot * kStageFloats;
      const int rows = min(g.kt, din_p - k0);
      stage_products<kTilesPerWarp>(nw, in, bw_in, st, g.stride, k0, rows, w0,
                                    ring.empty + slot, acc, small);
    }

#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j) {
      if (j < nw) {
        const int c = g.c0 + 8 * (w0 + j) + 2 * tig;
        const float b0 = bias[c];
        const float b1 = bias[c + 1];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * m + gid + 8 * h;
            float v0 = (small[m][j][2 * h] + acc[m][j][2 * h]) + b0;
            float v1 = (small[m][j][2 * h + 1] + acc[m][j][2 * h + 1]) + b1;
            if (RELU) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            *reinterpret_cast<float2*>(next + r * bw_next + swz(r, c)) =
                make_float2(v0, v1);
          }
        }
      }
    }
  }
}

// The producer warp: streams every W stage of the block's sequence, in the
// consumers' order, as far ahead as the ring allows.  In the row-tile shape
// a stage is one bulk copy from the layer's W in stage order (tiled_off:
// each stage's rows at the stage's stride, one after another); in the
// cluster shape, whose column slices depend on the cluster size, one bulk
// copy a W row (one copy a stage streams the chain at twice the rate).  In
// the cluster shape the producer joins the two cluster barriers of each
// hidden layer's gather.
__device__ void produce(const ChainDesc& d, const float* __restrict__ w, int n_mma, int rank,
                        int csize, const Ring& ring, cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31;
  int it = 0;
  for (int l = 0; l < n_mma; ++l) {
    const int din_p = d.pdims[l];
    const int dout_p = d.pdims[l + 1];
    const float* __restrict__ W = w + d.w_off[l];
    const float* __restrict__ tiled =
        csize == 1 && d.tiled_off[l] >= 0 ? w + d.tiled_off[l] : nullptr;
    int t0, t1;
    cta_tiles(dout_p / 8, rank, csize, t0, t1);
    const int t = t1 - t0;
    const int np = (t + kPassTiles - 1) / kPassTiles;
    for (int p = 0; p < np; ++p) {
      const Pass g = pass_geom(t0, t, np, p, din_p);
      const unsigned row_bytes = 32u * g.tiles;
      for (int k0 = 0; k0 < din_p; k0 += g.kt, ++it) {
        const int slot = it % kStages;
        if (it >= kStages) mbar_wait(ring.empty + slot, (it / kStages - 1) & 1);
        const int rows = min(g.kt, din_p - k0);
        float* st = ring.stage + slot * kStageFloats;
        if (tiled) {
          if (lane == 0) {
            const unsigned bytes = 4u * rows * g.stride;
            mbar_arrive_expect_tx(ring.full + slot, bytes);
            bulk_copy(st, tiled, bytes, ring.full + slot);
          }
          tiled += (size_t)rows * g.stride;
          continue;
        }
        if (lane == 0) mbar_arrive_expect_tx(ring.full + slot, rows * row_bytes);
        __syncwarp();
        for (int r = lane; r < rows; r += 32) {
          bulk_copy(st + r * g.stride, W + (size_t)(k0 + r) * dout_p + g.c0, row_bytes,
                    ring.full + slot);
        }
      }
    }
    if (csize > 1 && l < d.n_layers - 1) {
      cluster.sync();
      cluster.sync();
    }
  }
}

// In-place LayerNorm + LeakyReLU over the block's rows of h (real width n):
// each warp takes kRows / kWarps rows, each row's mean then mean((h -
// mean)^2) a lane-strided sum and a butterfly, as the TPU kernel computes
// them (pallas_kernels.py:109-114).  The rows of a warp go through each
// loop together, and each scale / shift value is read once for all of them.
__device__ void layer_norm_leaky(float* h, int bw, int n, const float* __restrict__ scale,
                                 const float* __restrict__ shift, float slope, float eps) {
  constexpr int kR = kRows / kWarps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row[kR];
  int sw[kR];
  float mean[kR], inv[kR], s[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    const int r = warp + kWarps * q;
    row[q] = h + r * bw;
    sw[q] = (r & 7) << 2;
    s[q] = 0.f;
  }
#pragma unroll 4
  for (int c = lane; c < n; c += 32) {
#pragma unroll
    for (int q = 0; q < kR; ++q) s[q] += row[q][c ^ sw[q]];
  }
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    mean[q] = warp_sum(s[q]) / n;
    s[q] = 0.f;
  }
#pragma unroll 4
  for (int c = lane; c < n; c += 32) {
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const float d = row[q][c ^ sw[q]] - mean[q];
      s[q] = fmaf(d, d, s[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kR; ++q) inv[q] = rsqrtf(warp_sum(s[q]) / n + eps);
#pragma unroll 4
  for (int c = lane; c < n; c += 32) {
    const float sc = scale[c];
    const float sh = shift[c];
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      float v = (row[q][c ^ sw[q]] - mean[q]) * inv[q];
      v = v * sc + sh;
      row[q][c ^ sw[q]] = v >= 0.f ? v : slope * v;
    }
  }
}

// Cluster shape: copy every peer's column slice [8 t0(q), 8 t1(q)) of `buf`
// into this block's `buf`, between two cluster barriers (the second keeps a
// peer from changing its slice while others still read it).
__device__ void gather_slices(cg::cluster_group& cluster, float* buf, int bw, int ntiles,
                              int rank, int csize) {
  cluster.sync();
  for (int q = 0; q < csize; ++q) {
    if (q == rank) continue;
    int t0, t1;
    cta_tiles(ntiles, q, csize, t0, t1);
    const int nv = 2 * (t1 - t0);
    const float* peer = cluster.map_shared_rank(buf, q);
    for (int i = threadIdx.x; i < kRows * nv; i += kThreads) {
      const int r = i / nv;
      const int a = r * bw + swz(r, 8 * t0 + 4 * (i - r * nv));
      *reinterpret_cast<float4*>(buf + a) = *reinterpret_cast<const float4*>(peer + a);
    }
  }
  cluster.sync();
}

template <int HIDDEN, int HEAD>
__global__ void __launch_bounds__(kThreads + 32, 1)
chain_kernel(const float* __restrict__ x, float* __restrict__ out,
             const float* __restrict__ w, const ChainDesc d, int batch, int csize,
             float slope, float eps) {
  extern __shared__ float4 smem4[];
  float* const buf0 = reinterpret_cast<float*>(smem4);
  float* const buf1 = buf0 + kRows * d.buf_width[0];
  Ring ring;
  ring.stage = buf1 + kRows * d.buf_width[1];
  ring.full = reinterpret_cast<uint64_t*>(ring.stage + kStages * kStageFloats);
  ring.empty = ring.full + kStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = csize > 1 ? (int)cluster.block_rank() : 0;
  const int row0 = (blockIdx.x / csize) * kRows;
  const int rows = min(kRows, batch - row0);
  const int n_mma = HEAD == kTanh ? d.n_layers - 1 : d.n_layers;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Input tile -> buf0; rows past the batch and padded columns are zero.
  if (threadIdx.x < kThreads) {
    const int din = d.dims[0];
    const int din_p = d.pdims[0];
    const int bw = d.buf_width[0];
    for (int i = threadIdx.x; i < kRows * din_p; i += kThreads) {
      const int r = i / din_p;
      const int k = i - r * din_p;
      buf0[r * bw + swz(r, k)] = r < rows && k < din ? x[(size_t)(row0 + r) * din + k] : 0.f;
    }
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {  // the producer warp
    produce(d, w, n_mma, rank, csize, ring, cluster);
    return;
  }

  int it = 0;
  for (int l = 0; l < n_mma; ++l) {
    const bool head = l == d.n_layers - 1;
    const int dout_p = d.pdims[l + 1];
    const float* in = l & 1 ? buf1 : buf0;
    float* next = l & 1 ? buf0 : buf1;
    const int bw_in = d.buf_width[l & 1];
    const int bw_next = d.buf_width[(l + 1) & 1];
    int t0, t1;
    cta_tiles(dout_p / 8, rank, csize, t0, t1);
    dense_layer<HIDDEN == kRelu>(in, bw_in, next, bw_next, w + d.b_off[l], d.pdims[l], t0,
                                 t1 - t0, ring, it);
    if (head) {
      // K5's linear head: this block's columns, coalesced, real width only.
      consumers_sync();
      const int dout = d.dims[l + 1];
      const int c_lo = 8 * t0;
      const int width = max(0, min(8 * t1, dout) - c_lo);
      for (int i = threadIdx.x; i < rows * width; i += kThreads) {
        const int r = i / width;
        const int c = c_lo + i - r * width;
        out[(size_t)(row0 + r) * dout + c] = next[r * bw_next + swz(r, c)];
      }
      return;
    }
    if (csize > 1) {
      gather_slices(cluster, next, bw_next, dout_p / 8, rank, csize);
    } else {
      consumers_sync();
    }
    if (HIDDEN == kLayerNormLeaky) {
      layer_norm_leaky(next, bw_next, d.dims[l + 1], w + d.s_off[l], w + d.t_off[l],
                       slope, eps);
      consumers_sync();
    }
  }

  // The generator's tanh head on the CUDA cores: one warp per (row, column)
  // dot product, the items spread over every warp of the cluster.
  if (HEAD == kTanh) {
    const int l = d.n_layers - 1;
    const float* h = l & 1 ? buf1 : buf0;
    const int bw = d.buf_width[l & 1];
    const int din = d.dims[l];
    const int dout = d.dims[l + 1];
    const int dout_p = d.pdims[l + 1];
    const float* __restrict__ W = w + d.w_off[l];
    const float* __restrict__ bias = w + d.b_off[l];
    const int lane = threadIdx.x & 31;
    for (int item = rank * kWarps + (threadIdx.x >> 5); item < rows * dout;
         item += csize * kWarps) {
      const int r = item / dout;
      const int j = item - r * dout;
      float s = 0.f;
      for (int k = lane; k < din; k += 32) {
        s = fmaf(h[r * bw + swz(r, k)], W[(size_t)k * dout_p + j], s);
      }
      s = warp_sum(s);
      if (lane == 0) out[(size_t)(row0 + r) * dout + j] = tanhf(s + bias[j]);
    }
  }
}

// The dynamic shared memory a block of the kernel may take on the current
// device, into *limit: the card's opt-in maximum less the kernel's static
// shared memory, to which the kernel's attribute is raised on the first
// call for each device; later calls read the cached value.
template <int HIDDEN, int HEAD>
cudaError_t smem_limit(int* limit) {
  static std::atomic<int> cached[kMaxDevices];  // 0 until set
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < kMaxDevices && (*limit = cached[device].load()) > 0) return cudaSuccess;
  auto kernel = chain_kernel<HIDDEN, HEAD>;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  *limit = optin - (int)fa.sharedSizeBytes;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
  if (e != cudaSuccess) return e;
  if (device < kMaxDevices) cached[device].store(*limit);
  return cudaSuccess;
}

// The chain's widths (dims: n_layers + 1 real widths, a host array) into
// `d`, and the launch configuration of `grid` blocks in clusters of
// `cluster` (1: the row-tile shape; 2, 4 or 8: the cluster shape).
template <int HIDDEN, int HEAD>
cudaError_t configure(const int* dims, int n_layers, int cluster, int grid, ChainDesc& d,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  if (n_layers < 1 || n_layers > kMaxLayers || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || (HEAD == kTanh && n_layers < 2)) {
    return cudaErrorInvalidValue;
  }
  d.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1) return cudaErrorInvalidValue;
    d.dims[i] = dims[i];
    d.pdims[i] = (dims[i] + 7) & ~7;
  }
  // Layer l's output lives in buffer (l + 1) % 2 (K5's head too; K6's head
  // writes straight to global memory).
  int width[2] = {d.pdims[0], 0};
  for (int l = 0; l < n_layers; ++l) {
    if (HEAD == kLinear || l < n_layers - 1) {
      width[(l + 1) & 1] = max(width[(l + 1) & 1], d.pdims[l + 1]);
    }
  }
  for (int p = 0; p < 2; ++p) d.buf_width[p] = (max(width[p], 1) + 31) & ~31;

  const size_t smem =
      sizeof(float) * ((size_t)kRows * (d.buf_width[0] + d.buf_width[1]) +
                       (size_t)kStages * kStageFloats) +
      sizeof(uint64_t) * 2 * kStages;
  int limit = 0;
  const cudaError_t e = smem_limit<HIDDEN, HEAD>(&limit);
  if (e != cudaSuccess) return e;
  if (smem > (size_t)limit) return cudaErrorInvalidValue;

  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kThreads + 32, 1, 1);  // kWarps consumers, one producer
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaSuccess;
}

// offsets: n_layers rows of (W, b, scale, shift) float offsets, -1 unused;
// tiled: n_layers offsets of W in stage order (ops/fused_kernels.py:
// pack_chain), -1 where a layer has none.  Both are host arrays.
template <int HIDDEN, int HEAD>
cudaError_t launch(const float* x, float* out, const float* w, const long long* offsets,
                   const long long* tiled, const int* dims, int n_layers, int batch,
                   int cluster, float slope, float eps, cudaStream_t stream) {
  if (batch < 1 || n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  ChainDesc d{};
  for (int l = 0; l < n_layers; ++l) {
    d.w_off[l] = offsets[4 * l + 0];
    d.b_off[l] = offsets[4 * l + 1];
    d.s_off[l] = offsets[4 * l + 2];
    d.t_off[l] = offsets[4 * l + 3];
    d.tiled_off[l] = tiled[l];
    // the bulk copies move 16-byte units: every W starts on a 16-byte boundary
    if (d.w_off[l] < 0 || d.b_off[l] < 0 || (d.w_off[l] & 3) != 0 ||
        (d.tiled_off[l] >= 0 && (d.tiled_off[l] & 3) != 0)) {
      return cudaErrorInvalidValue;
    }
    if (HIDDEN == kLayerNormLeaky && l < n_layers - 1 &&
        (d.s_off[l] < 0 || d.t_off[l] < 0)) {
      return cudaErrorInvalidValue;
    }
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int tiles = (batch + kRows - 1) / kRows;
  cudaError_t e =
      configure<HIDDEN, HEAD>(dims, n_layers, cluster, tiles * cluster, d, cfg, attr);
  if (e != cudaSuccess) return e;
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, chain_kernel<HIDDEN, HEAD>, x, out, w, d, batch, cluster,
                         slope, eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many clusters of `cluster` blocks of the chain's kernel the card
// holds at once.
template <int HIDDEN, int HEAD>
cudaError_t max_clusters(const int* dims, int n_layers, int cluster, int* active) {
  ChainDesc d{};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  *active = 0;
  if (cluster < 2) return cudaErrorInvalidValue;
  cudaError_t e = configure<HIDDEN, HEAD>(dims, n_layers, cluster, cluster, d, cfg, attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(active, chain_kernel<HIDDEN, HEAD>, &cfg);
}

}  // namespace

extern "C" {

// K5: LayerNorm + LeakyReLU hidden layers, linear head.
int pigan_fused_mlp_forward(const float* x, float* out, const float* w,
                            const long long* offsets, const long long* tiled,
                            const int* dims, int n_layers, int batch, int cluster,
                            float leaky_slope, float ln_eps, void* stream) {
  return (int)launch<kLayerNormLeaky, kLinear>(x, out, w, offsets, tiled, dims, n_layers,
                                               batch, cluster, leaky_slope, ln_eps,
                                               (cudaStream_t)stream);
}

// K6: ReLU hidden layers (BatchNorm folded in), tanh head.
int pigan_fused_dense_chain(const float* x, float* out, const float* w,
                            const long long* offsets, const long long* tiled,
                            const int* dims, int n_layers, int batch, int cluster,
                            void* stream) {
  return (int)launch<kRelu, kTanh>(x, out, w, offsets, tiled, dims, n_layers, batch,
                                   cluster, 0.f, 0.f, (cudaStream_t)stream);
}

// The number of clusters of `cluster` (2, 4 or 8) blocks that the card holds
// at once for the K5 (layer_norm != 0) or K6 kernel of a chain of `dims`,
// into *active; ops/fused_kernels.py:launch_shape reads it.
int pigan_fused_chain_max_clusters(const int* dims, int n_layers, int layer_norm,
                                   int cluster, int* active) {
  return (int)(layer_norm ? max_clusters<kLayerNormLeaky, kLinear>(dims, n_layers, cluster,
                                                                   active)
                          : max_clusters<kRelu, kTanh>(dims, n_layers, cluster, active));
}

const char* pigan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
