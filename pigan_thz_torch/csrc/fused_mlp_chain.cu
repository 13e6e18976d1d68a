// Fused MLP-chain forward kernels for serving, fp32 results, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pigan_thz_tpu/ops/pallas_kernels.py:
//   - fused_mlp_forward (K5): the forward surrogate, per hidden layer
//     h@W+b -> LayerNorm (two-pass variance, eps 1e-6) -> LeakyReLU, then a
//     linear head (4->256->512->1024->512->256->258);
//   - fused_dense_chain (K6): the generator with BatchNorm folded into the
//     dense weights beforehand, ReLU hidden layers, tanh head
//     (250->512->256->4).
// Both are one template, chain_kernel<HIDDEN, HEAD>, launched once per call;
// K5 has a second kernel, wg_chain_kernel, for batches that fill the card
// (the wgmma shape, below).
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
// Two launch shapes of chain_kernel.  The row-tile shape (cluster size 1) gives
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
// The wgmma shape (wg_chain_kernel; K5 only, from the batch that the
// row-tile shape cannot run in one wave: ops/fused_kernels.py:
// wgmma_crossover, 4225 rows on 132 SMs).  A cluster of 2 blocks owns 128
// batch rows; block q computes half of every layer's n8 tiles, each of its
// two consumer warpgroups for 64 rows, in passes of at most 16 tiles, as
// wgmma.mma_async.m64n{64,72,128}k8.f32.tf32.tf32 with A from registers and
// B from shared memory.  Per k8 step a warpgroup splits its A fragment (each
// warp the m16n8k8 fragment of its 16 rows) into hi and lo once, then runs
// lo*hi, hi*hi, hi*lo into the two accumulator sets as above; a step's
// products run while the next step's are issued (wait_group 1, each step its
// own A registers).  B comes split: pack_chain stores each W once more as
// hi = rna_tf32(W) and lo = rna_tf32(W - hi), per rank, pass and k8 step in
// the layout the descriptors read (core matrices of 8 columns x 4 k, no
// swizzle), so that the producer warpgroup lands a stage (one k8 step of 16
// tiles, hi and lo, 8 KB) with one bulk copy into a ring of 4.  A block's
// output columns stay in its shared memory, swizzled so that one float4
// holds a thread's A values of two k8 steps (wswz); a warpgroup reads its
// own block's columns with ld.shared and the peer's with ld.shared::cluster.
// LayerNorm: each block sums its columns of every row (in the epilogue), the
// two blocks' sums meet in rank order through distributed shared memory,
// then the squared deviations likewise (two passes), then each block
// normalises its columns; the consumers of the two blocks meet on mbarriers,
// which the producer never joins.  Shared memory: the ring 32 KB, the
// activations 128 rows x (256 + 128) floats (K5's widest slices, by layer
// parity), the row sums 1 KB: 230,480 of 232,448 bytes.  The 512 -> 1024
// layer's output does not fit (128 x 512 floats a block): it goes to a
// global scratch of 1024 floats a row, which L2 holds, and the next layer
// reads it back through L2 (ld.global.cg).  W read from L2 a call at B =
// 8192: 64 clusters x 11.0 MB (hi and lo of every W, once a cluster) = 0.71
// GB, where the row-tile shape reads 1.46 GB; the scratch adds ~0.26 GB.
// The register file sets the tile: two steps' A and 2 x 64 accumulators a
// thread fill the 232 registers the consumers take from the producer's
// warpgroup (setmaxnreg); with more A in flight ptxas serialises the wgmma.
// The shape sums in another order than chain_kernel (not its bits); reruns
// give the same bits.
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
// later work.  The wgmma shape takes 0.33 ms at B = 8192 back to back (PERF.md
// §6): its products, epilogues and A loads alone 0.26 ms, ~55 % of the TF32
// rate, where the same wgmma alone reach ~95 %; the LayerNorms and their
// meetings 0.06 ms, the W copies ~0.02 ms (examples/torch_serving_ablate.py).
//
// Interface: plain C, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success).  A launch makes no
// occupancy query: the wrappers pick or check the cluster size against
// pigan_fused_chain_max_clusters' (pigan_fused_mlp_wgmma_max_clusters')
// answer, asked once a chain and card, and a cluster shape the card cannot
// schedule fails its launch.  Each kernel's shared-memory limit is raised
// once a device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "chain_common.cuh"

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

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The consumer warps' own barrier: the producer warp never joins it.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// The n8 tiles [t0, t1) of a layer's `ntiles` that cluster rank `rank` owns.
__host__ __device__ __forceinline__ void cta_tiles(int ntiles, int rank, int csize, int& t0,
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

template <int HIDDEN, int HEAD>
cudaError_t smem_limit(int* limit) {
  static std::atomic<int> cached[kMaxDevices];  // 0 until set
  return raise_smem_limit(chain_kernel<HIDDEN, HEAD>, cached, limit);
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


// ---------------------------------------------------------------------------
// The wgmma shape (K5 only; see the header)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;        // batch rows a cluster owns: a 64-row tile a warpgroup
constexpr int kWgCluster = 2;       // blocks a cluster; each computes half of the columns
constexpr int kWgThreads = 256;     // two consumer warpgroups (== kThreads: consumers_sync)
constexpr int kWgBlock = kWgThreads + 128;   // and the producer's warpgroup
constexpr int kWgWarps = kWgThreads / 32;
constexpr int kWgPassTiles = 16;    // n8 tiles a pass at most: m64n128k8
constexpr int kWgStages = 4;
constexpr int kWgStageFloats = 128 * kWgPassTiles;   // one k8 step of 16 tiles, hi and lo: 8 KB
static_assert(kWgThreads == kThreads, "consumers_sync counts kThreads");

// Passed by value.  Offsets in floats into the packed buffer; wg_off[l] is
// layer l's W stream (ops/fused_kernels.py:wgmma_stream): per cluster rank
// in turn, per pass, per k8 step the hi then the lo image of the pass's
// columns, each NT core matrices of 8 columns x 4 k-rows twice (k 0-3, 4-7),
// so that one bulk copy lands a stage as the descriptors read it.
struct WgDesc {
  int n_layers;
  int dims[kMaxLayers + 1];
  int pdims[kMaxLayers + 1];
  long long b_off[kMaxLayers];
  long long s_off[kMaxLayers];
  long long t_off[kMaxLayers];
  long long wg_off[kMaxLayers];
  int buf_width[2];
  int gl;  // the hidden layer whose output lives in the global scratch, or -1
  int sw;  // the scratch's row stride
};

// Pass p of a block's t tiles: its first tile and its tile count (8, 9 or 16
// for the chains configure_wg accepts); k8 steps a stage for nt tiles.
__host__ __device__ __forceinline__ int wg_passes(int t) {
  return (t + kWgPassTiles - 1) / kWgPassTiles;
}
__host__ __device__ __forceinline__ void wg_pass_tiles(int t, int p, int& a, int& nt) {
  const int np = wg_passes(t);
  a = p * t / np;
  nt = (p + 1) * t / np - a;
}
__host__ __device__ __forceinline__ int wg_stage_steps(int nt) {
  return nt >= kWgPassTiles ? 1 : kWgPassTiles / nt;
}

// Where a hidden layer's output lives: in the blocks' shared memory (each
// block its slice, swizzled by the slice's own columns) or, for the one
// layer `d.gl` whose slices do not fit, in the global scratch (whole rows,
// swizzled by the row's columns; read through L2).
struct WgLayer {
  const float* in;       // the input: layer 0 the block's x tile, else the previous output
  int bw_in;             // its row stride
  int in_mode;           // 0: the block's own buffer; 1: the ranks' slices; 2: scratch rows
  int t_prev;            // in_mode 1: the previous layer's n8 tiles (cta_tiles over them)
  int nk8;               // k8 steps: padded input width / 8
  const float* bias;     // global, the padded output width
  int c0;                // the block's first output column
  float* next;           // hidden layer: where its output goes (slice or scratch rows)
  int bw_next;
  int next_c0;           // the column the swizzle of `next` counts from: 0 or c0
  float* out;            // head: the kernel's output, real width dout
  int dout, row0, rows;
};

// The float4 that holds row r's A values of the k8 tiles j, j + 1 (j even)
// for this thread (k = tig, tig + 4 of each): from the block's own shared
// memory, the peer's (distributed shared memory) or the scratch (L2).
__device__ __forceinline__ float4 wg_load_a(const WgLayer& L, int j, int r, int rank) {
  const int tig = threadIdx.x & 3;
  if (L.in_mode == 2) {
    const int c = 8 * j;
    return __ldcg(reinterpret_cast<const float4*>(L.in + r * L.bw_in +
                                                  ((c ^ ((r & 1) << 4)) + 4 * tig)));
  }
  int q = rank;
  int t0 = 0;
  if (L.in_mode == 1) {
    q = kWgCluster - 1;
    while (q > 0 && j < q * L.t_prev / kWgCluster) --q;
    t0 = q * L.t_prev / kWgCluster;
  }
  const int c = 8 * (j - t0);
  const float* p = L.in + r * L.bw_in + ((c ^ ((r & 1) << 4)) + 4 * tig);
  if (q == rank) return *reinterpret_cast<const float4*>(p);
  return ld_cluster4(cluster_addr(p, q));
}

// The products of one k8 step for this warpgroup's 64 rows and the pass's
// NT tiles, issued without waiting: A (this thread's m16n8k8 fragment a)
// split into hi and lo in registers, B from the ring's stage `slot`, `sub`
// steps into it.
template <int NT>
__device__ __forceinline__ void wg_issue(float (&acc)[4 * NT], float (&sml)[4 * NT],
                                         const float (&a)[4], uint32_t (&ahi)[4],
                                         uint32_t (&alo)[4], const Ring& ring, int slot,
                                         int sub) {
  const uint32_t base = smem_addr(ring.stage + slot * kWgStageFloats) + sub * NT * 512;
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

// One pass: the block's tiles [a, a + NT) of the layer for this warpgroup's
// 64 rows, over every k8 step, then the epilogue: (small + hi*hi) + bias
// into `next`, or for the head into the output.  Step s's products run
// while step s + 1's A is split and issued (its own registers); a stage is
// released once the products of its last step are done; A is loaded two
// steps (one float4) ahead.
template <int NT>
__device__ __forceinline__ void wg_pass(const WgLayer& L, int a, int rank, const Ring& ring,
                                        int& it, float* psum, bool first) {
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int ra = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + gid;
  const int rb = ra + 8;
  const int steps = wg_stage_steps(NT);
  const int nk8 = L.nk8;

  float acc[4 * NT];  // hi*hi
  float sml[4 * NT];  // lo*hi + hi*lo
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) acc[i] = sml[i] = 0.f;
  uint32_t ahi[2][4], alo[2][4];  // the A registers of the two steps in flight

  float4 va = wg_load_a(L, 0, ra, rank);
  float4 vb = wg_load_a(L, 0, rb, rank);
  int sub = 0;         // the step's place in its stage
  int prev_slot = -1;  // the stage to release once the previous step is done
  for (int j = 0; j < nk8; j += 2) {
    float4 na = va, nb = vb;
    if (j + 2 < nk8) {
      na = wg_load_a(L, j + 2, ra, rank);
      nb = wg_load_a(L, j + 2, rb, rank);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && j + 1 >= nk8) break;
      const int slot = it % kWgStages;
      if (sub == 0) mbar_wait(ring.full + slot, (it / kWgStages) & 1);
      const float av[4] = {h ? va.z : va.x, h ? vb.z : vb.x, h ? va.w : va.y,
                           h ? vb.w : vb.y};
      wg_issue<NT>(acc, sml, av, ahi[h], alo[h], ring, slot, sub);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (prev_slot >= 0) release(ring.empty + prev_slot);
      prev_slot = -1;
      if (++sub == steps || j + h + 1 == nk8) {
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
  }

  // Every bias first: read-only loads, all in flight at once, ahead of the
  // stores (a load behind a store that may alias it would wait out its
  // latency each time: 0.04 ms a call at B = 8192).
  float bias[2 * NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int gc = L.c0 + 8 * (a + t) + 2 * tig;
    bias[2 * t] = __ldg(L.bias + gc);
    bias[2 * t + 1] = __ldg(L.bias + gc + 1);
  }
  float rs[2] = {0.f, 0.f};  // rows ra, rb: the sum of this thread's columns
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int c = 8 * (a + t) + 2 * tig;  // the block's column
    const int gc = L.c0 + c;
    const float b0 = bias[2 * t];
    const float b1 = bias[2 * t + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      const float v0 = (sml[4 * t + 2 * h] + acc[4 * t + 2 * h]) + b0;
      const float v1 = (sml[4 * t + 2 * h + 1] + acc[4 * t + 2 * h + 1]) + b1;
      if (L.next) {
        const int cn = L.next_c0 + c;
        L.next[r * L.bw_next + wswz(r, cn)] = v0;
        L.next[r * L.bw_next + wswz(r, cn + 1)] = v1;
        rs[h] += v0 + v1;
      } else if (r < L.rows) {
        float* o = L.out + (size_t)(L.row0 + r) * L.dout;
        if (gc < L.dout) o[gc] = v0;
        if (gc + 1 < L.dout) o[gc + 1] = v1;
      }
    }
  }
  // A hidden layer's row sums over the pass's columns (padded columns hold
  // exact zeros), the four lanes of a row in a butterfly, added to the
  // earlier passes': the LayerNorm's first pass, taken from registers.
  if (L.next) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    }
    if (tig == 0) {
      psum[ra] = first ? rs[0] : psum[ra] + rs[0];
      psum[rb] = first ? rs[1] : psum[rb] + rs[1];
    }
  }
}

// LayerNorm + LeakyReLU over the cluster's rows, each block on its columns
// [c0, c0 + w) of h (a slice: cs = 0; scratch rows: cs = c0, the swizzle's
// column origin; the row's real width n): each row's sum over the block's
// columns (psum, from the passes' epilogues), the ranks' sums in rank
// order, the mean; then likewise sum((h - mean)^2), the variance (two
// passes, as the row-tile shape and the TPU kernel compute them); then the
// columns normalised in place.  Each warp takes 16 rows, all at once; a
// lane reads a float4 at a time (four columns: the swizzle is its own
// inverse, so the float4 at position p holds columns wswz(r, p + e)); lane
// i < 16 holds row i's statistics.
__device__ void wg_layer_norm(float* h, int bw, int cs, int c0, int w, int n,
                              const float* __restrict__ scale, const float* __restrict__ shift,
                              float slope, float eps, float* psum, float* psq, uint64_t* xbar,
                              int& phase) {
  constexpr int kR = kWgRows / kWgWarps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = max(0, min(w, n - c0));  // the block's real columns
  float* const h0 = h + warp * kR * bw + cs;   // the warp's first row (an even row)
  float s[kR];

  cluster_meet<kWgCluster, kWgThreads>(xbar, phase);
  float mine = 0.f;  // lane i < 16: row i's mean
#pragma unroll
  for (int q = 0; q < kWgCluster; ++q) {
    mine += ld_cluster(cluster_addr(psum + warp * kR + (lane & (kR - 1)), q));
  }
  mine /= n;
  float m[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    m[q] = __shfl_sync(0xffffffffu, mine, q);
    s[q] = 0.f;
  }
  for (int p = 4 * lane; p < w; p += 128) {
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(h0 + q * bw + p);
      const int c = wswz(q, cs + p) - cs;
      const float d0 = c < wr ? v.x - m[q] : 0.f;
      const float d1 = c + 4 < wr ? v.y - m[q] : 0.f;
      const float d2 = c + 8 < wr ? v.z - m[q] : 0.f;
      const float d3 = c + 12 < wr ? v.w - m[q] : 0.f;
      s[q] = fmaf(d0, d0, s[q]);
      s[q] = fmaf(d1, d1, s[q]);
      s[q] = fmaf(d2, d2, s[q]);
      s[q] = fmaf(d3, d3, s[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kR; ++q) s[q] = warp_sum(s[q]);
  if (lane < kR) {
    float v = s[0];
#pragma unroll
    for (int q = 1; q < kR; ++q) v = lane == q ? s[q] : v;
    psq[warp * kR + lane] = v;
  }
  cluster_meet<kWgCluster, kWgThreads>(xbar, phase);
  float var = 0.f;
#pragma unroll
  for (int q = 0; q < kWgCluster; ++q) {
    var += ld_cluster(cluster_addr(psq + warp * kR + (lane & (kR - 1)), q));
  }
  const float inv = rsqrtf(var / n + eps);
#pragma unroll
  for (int q = 0; q < kR; ++q) s[q] = __shfl_sync(0xffffffffu, inv, q);
  for (int p = 4 * lane; p < w; p += 128) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {  // even rows, then odd: their columns differ
      const int c = wswz(par, cs + p) - cs;
      float sc[4], sh[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[e] = __ldg(scale + c0 + c + 4 * e);
        sh[e] = __ldg(shift + c0 + c + 4 * e);
      }
#pragma unroll
      for (int q = par; q < kR; q += 2) {
        float4* ptr = reinterpret_cast<float4*>(h0 + q * bw + p);
        float4 v = *ptr;
        float* e4 = &v.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float y = (e4[e] - m[q]) * s[q];
          y = y * sc[e] + sh[e];
          e4[e] = y >= 0.f ? y : slope * y;
        }
        *ptr = v;
      }
    }
  }
  cluster_meet<kWgCluster, kWgThreads>(xbar, phase);  // the normalised columns are the peers' next input
}

// The producer: the first thread of the third warpgroup streams the block's stages of every
// pass of every layer, one bulk copy a stage, as far ahead as the ring allows.
__device__ void wg_produce(const WgDesc& d, const float* __restrict__ w, int rank,
                           const Ring& ring) {
  int it = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    const int din_p = d.pdims[l];
    const int nk8 = din_p / 8;
    int t0, t1;
    cta_tiles(d.pdims[l + 1] / 8, rank, kWgCluster, t0, t1);
    // the ranks before this one hold t0 tiles of 16 * din_p floats each
    const float* src = w + d.wg_off[l] + (size_t)16 * t0 * din_p;
    for (int p = 0; p < wg_passes(t1 - t0); ++p) {
      int a, nt;
      wg_pass_tiles(t1 - t0, p, a, nt);
      const int steps = wg_stage_steps(nt);
      for (int k = 0; k < nk8; k += steps, ++it) {
        const int slot = it % kWgStages;
        if (it >= kWgStages) mbar_wait(ring.empty + slot, (it / kWgStages - 1) & 1);
        const unsigned floats = 128u * nt * min(steps, nk8 - k);
        mbar_arrive_expect_tx(ring.full + slot, 4 * floats);
        bulk_copy(ring.stage + slot * kWgStageFloats, src, 4 * floats, ring.full + slot);
        src += floats;
      }
    }
  }
}

__global__ void __launch_bounds__(kWgBlock, 1)
wg_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                const float* __restrict__ w, float* __restrict__ scratch, const WgDesc d,
                int batch, float slope, float eps) {
  extern __shared__ float4 smem4[];
  Ring ring;
  ring.stage = reinterpret_cast<float*>(smem4);
  float* const buf0 = ring.stage + kWgStages * kWgStageFloats;
  float* const buf1 = buf0 + kWgRows * d.buf_width[0];
  float* const psum = buf1 + kWgRows * d.buf_width[1];
  float* const psq = psum + kWgRows;
  ring.full = reinterpret_cast<uint64_t*>(psq + kWgRows);
  ring.empty = ring.full + kWgStages;
  uint64_t* const xbar = ring.empty + kWgStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / kWgCluster) * kWgRows;
  const int rows = min(kWgRows, batch - row0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, kWgWarps);
    }
    mbar_init(xbar, kWgCluster);
    mbar_init(xbar + 1, kWgCluster);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The x tile -> buf0, every block the whole width (padded to 16 columns);
  // rows past the batch and padded columns are zero.
  {
    const int din = d.dims[0];
    const int xw = (d.pdims[0] + 15) & ~15;
    const int bw = d.buf_width[0];
    for (int i = threadIdx.x; i < kWgRows * xw; i += kWgBlock) {
      const int r = i / xw;
      const int k = i - r * xw;
      buf0[r * bw + wswz(r, k)] = r < rows && k < din ? x[(size_t)(row0 + r) * din + k] : 0.f;
    }
  }
  cluster.sync();  // the barriers' init is visible to the peer

  // The producer's warpgroup gives up registers, the consumers take them:
  // two warpgroups' accumulators (2 x 64 of a 16-tile pass) and A in
  // flight, with no spill and no serialised wgmma.
  if (threadIdx.x >= kWgThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kWgThreads) wg_produce(d, w, rank, ring);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  float* const rows_of = scratch + (size_t)row0 * d.sw;  // the cluster's scratch rows
  int it = 0;
  int phase = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    const bool head = l == d.n_layers - 1;
    int t0, t1;
    cta_tiles(d.pdims[l + 1] / 8, rank, kWgCluster, t0, t1);
    WgLayer L;
    L.in_mode = l == 0 ? 0 : l - 1 == d.gl ? 2 : 1;
    L.in = L.in_mode == 2 ? rows_of : l & 1 ? buf1 : buf0;
    L.bw_in = L.in_mode == 2 ? d.sw : d.buf_width[l & 1];
    L.t_prev = d.pdims[l] / 8;
    L.nk8 = d.pdims[l] / 8;
    L.bias = w + d.b_off[l];
    L.c0 = 8 * t0;
    L.next = head ? nullptr : l == d.gl ? rows_of : l & 1 ? buf0 : buf1;
    L.bw_next = l == d.gl ? d.sw : d.buf_width[(l + 1) & 1];
    L.next_c0 = l == d.gl ? L.c0 : 0;
    L.out = out;
    L.dout = d.dims[l + 1];
    L.row0 = row0;
    L.rows = rows;
    for (int p = 0; p < wg_passes(t1 - t0); ++p) {
      int a, nt;
      wg_pass_tiles(t1 - t0, p, a, nt);
      if (nt == 16) {
        wg_pass<16>(L, a, rank, ring, it, psum, p == 0);
      } else if (nt == 9) {
        wg_pass<9>(L, a, rank, ring, it, psum, p == 0);
      } else {
        wg_pass<8>(L, a, rank, ring, it, psum, p == 0);
      }
    }
    if (!head) {
      wg_layer_norm(L.next, L.bw_next, L.next_c0, L.c0, 8 * (t1 - t0), d.dims[l + 1],
                    w + d.s_off[l], w + d.t_off[l], slope, eps, psum, psq, xbar, phase);
    }
  }
  cluster_meet<kWgCluster, kWgThreads>(xbar, phase);  // no block leaves while its peer still reads it
}

cudaError_t wg_smem_limit(int* limit) {
  static std::atomic<int> cached[kMaxDevices];  // 0 until set
  return raise_smem_limit(wg_chain_kernel, cached, limit);
}

// The chain's widths into `d`, with hidden layer `gl`'s output in the global
// scratch (-1: none), and the launch of `clusters` clusters; refuses
// (cudaErrorInvalidValue) a chain the shape does not take: every pass of 8,
// 9 or 16 tiles, a multiple of 4 tiles a block for each hidden layer (its
// columns are read two k8 steps a float4, and whole 32-column groups of the
// swizzle), the other outputs, the ring and the row statistics within the
// block's shared memory.
cudaError_t configure_wg(const int* dims, int n_layers, int gl, int clusters, WgDesc& d,
                         cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  if (n_layers < 2 || n_layers > kMaxLayers || gl < -1 || gl >= n_layers - 1) {
    return cudaErrorInvalidValue;
  }
  d.n_layers = n_layers;
  d.gl = gl;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1) return cudaErrorInvalidValue;
    d.dims[i] = dims[i];
    d.pdims[i] = (dims[i] + 7) & ~7;
  }
  d.sw = gl < 0 ? 0 : (d.pdims[gl + 1] + 31) & ~31;
  int width[2] = {(d.pdims[0] + 15) & ~15, 0};
  for (int l = 0; l < n_layers; ++l) {
    for (int q = 0; q < kWgCluster; ++q) {
      int t0, t1;
      cta_tiles(d.pdims[l + 1] / 8, q, kWgCluster, t0, t1);
      for (int p = 0; p < wg_passes(t1 - t0); ++p) {
        int a, nt;
        wg_pass_tiles(t1 - t0, p, a, nt);
        if (nt != 8 && nt != 9 && nt != 16) return cudaErrorInvalidValue;
      }
      if (l < n_layers - 1) {
        if ((t1 - t0) & 3) return cudaErrorInvalidValue;
        if (l != gl) width[(l + 1) & 1] = max(width[(l + 1) & 1], 8 * (t1 - t0));
      }
    }
  }
  for (int p = 0; p < 2; ++p) d.buf_width[p] = (max(width[p], 1) + 31) & ~31;
  const size_t smem =
      sizeof(float) * ((size_t)kWgStages * kWgStageFloats +
                       (size_t)kWgRows * (d.buf_width[0] + d.buf_width[1] + 2)) +
      sizeof(uint64_t) * (2 * kWgStages + 2);
  int limit = 0;
  const cudaError_t e = wg_smem_limit(&limit);
  if (e != cudaSuccess) return e;
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * kWgCluster, 1, 1);
  cfg.blockDim = dim3(kWgBlock, 1, 1);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kWgCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// scratch: (clusters * kWgRows) rows of layer gl's padded width rounded up
// to 32 (ops/fused_kernels.py allocates it), or null with gl = -1.
cudaError_t launch_wg(const float* x, float* out, const float* w, float* scratch,
                      const long long* offsets, const long long* wg_off, const int* dims,
                      int n_layers, int gl, int batch, float slope, float eps,
                      cudaStream_t stream) {
  if (batch < 1 || n_layers < 2 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  if ((gl >= 0) != (scratch != nullptr)) return cudaErrorInvalidValue;
  WgDesc d{};
  for (int l = 0; l < n_layers; ++l) {
    d.b_off[l] = offsets[4 * l + 1];
    d.s_off[l] = offsets[4 * l + 2];
    d.t_off[l] = offsets[4 * l + 3];
    d.wg_off[l] = wg_off[l];
    // the bulk copies move 16-byte units from 16-byte boundaries
    if (d.b_off[l] < 0 || d.wg_off[l] < 0 || (d.wg_off[l] & 3) != 0) {
      return cudaErrorInvalidValue;
    }
    if (l < n_layers - 1 && (d.s_off[l] < 0 || d.t_off[l] < 0)) return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e =
      configure_wg(dims, n_layers, gl, (batch + kWgRows - 1) / kWgRows, d, cfg, attr);
  if (e != cudaSuccess) return e;
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, wg_chain_kernel, x, out, w, scratch, d, batch, slope, eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

cudaError_t wg_max_clusters(const int* dims, int n_layers, int gl, int* active) {
  WgDesc d{};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  *active = 0;
  cudaError_t e = configure_wg(dims, n_layers, gl, 1, d, cfg, attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(active, wg_chain_kernel, &cfg);
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

// K5 in the wgmma shape: wg_off, n_layers offsets of the layers' hi / lo W
// streams (ops/fused_kernels.py:wgmma_stream), a host array; hidden layer
// global_layer's output in `scratch` (-1 and null: none).
int pigan_fused_mlp_forward_wgmma(const float* x, float* out, const float* w, float* scratch,
                                  const long long* offsets, const long long* wg_off,
                                  const int* dims, int n_layers, int global_layer, int batch,
                                  float leaky_slope, float ln_eps, void* stream) {
  return (int)launch_wg(x, out, w, scratch, offsets, wg_off, dims, n_layers, global_layer,
                        batch, leaky_slope, ln_eps, (cudaStream_t)stream);
}

// The number of clusters of K5's wgmma shape the card holds at once, into
// *active; an error for a chain the shape does not take.
int pigan_fused_mlp_wgmma_max_clusters(const int* dims, int n_layers, int global_layer,
                                       int* active) {
  return (int)wg_max_clusters(dims, n_layers, global_layer, active);
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
