// Device helpers shared by the serving chains' kernels (fused_mlp_chain.cu:
// K5 and K6; fused_residual_chain.cu: the residual generator): the 3xTF32
// split, mbarriers and bulk copies, the ring of W stages, distributed shared
// memory, the cluster's consumer meetings, the wgmma descriptors and
// products, and the shared-memory limit.  Everything is in an anonymous
// namespace: each source that includes this header has its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;

// Round to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;  // the same bits in every lane: each step adds the same pair
}

// The ring of W stages: stage `it` of a block's sequence (over every pass
// of every layer, in order) lands in slot it % (the ring's stages);
// full[slot] completes when its bytes are in, empty[slot] when every
// consumer warp is done with it.
struct Ring {
  float* stage;
  uint64_t* full;
  uint64_t* empty;
};

// This warp is done reading a stage.
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// The dynamic shared memory a block of the kernel may take on the current
// device, into *limit: the card's opt-in maximum less the kernel's static
// shared memory, to which the kernel's attribute is raised on the first
// call for each device; later calls read the cached value.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, std::atomic<int>* cached, int* limit) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < kMaxDevices && (*limit = cached[device].load()) > 0) return cudaSuccess;
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

// Column c of row r in an activation buffer: in each 16-column group the
// order k = 4 i + j holds column j + 4 i (i, j < 4), so that one float4 is a
// thread's A values (k = tig, tig + 4) of two k8 steps; odd rows swap the two
// groups of each 32 columns, so that the float4 loads of a warp (8 rows x 64
// bytes) are free of bank conflicts.  Widths are multiples of 32.
__device__ __forceinline__ int wswz(int r, int c) {
  return ((c & ~15) ^ ((r & 1) << 4)) | ((c & 3) << 2) | ((c >> 2) & 3);
}

// This shared address in cluster rank q's block (distributed shared memory).
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int q) {
  uint32_t a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(q));
  return a;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// The consumer threads of a cluster's kSize blocks (kConsumers threads a
// block, from thread 0) meet: after the block's own consumers meet (named
// barrier 1), thread 0 arrives on the barrier of every block, then every
// consumer waits on its own.  Two barriers in turn, so that an early
// arrival for the next meeting never counts toward this one.  The producer
// warps take no part (a hardware cluster barrier would wait for them while
// they wait for ring slots that only the next layer frees).
template <int kSize, int kConsumers>
__device__ __forceinline__ void cluster_meet(uint64_t* xbar, int& phase) {
  uint64_t* bar = xbar + (phase & 1);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < kSize; ++q) {
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                       cluster_addr(bar, q))
                   : "memory");
    }
  }
  const int parity = (phase >> 1) & 1;
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
  ++phase;
}

// A shared-memory matrix descriptor: no swizzle, K-major core matrices of
// 8 rows x 16 bytes; the next 4 k (16 bytes) 128 bytes on (leading byte
// offset), the next 8 columns 256 bytes on (stride byte offset).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// Keep the compiler from reading an accumulator before the wait.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// wgmma.mma_async m64n(8 NT)k8, f32 += tf32 x tf32, A from registers (the
// m16n8k8 A fragment of each warp's 16 rows), B from shared memory.
template <int NT>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<9> {
  static __device__ __forceinline__ void mma(float (&d)[36], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %41, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35"
        "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

}  // namespace
