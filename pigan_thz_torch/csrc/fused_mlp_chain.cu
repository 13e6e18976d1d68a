// Fused MLP-chain forward kernels for serving, fp32, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pigan_thz_tpu/ops/pallas_kernels.py:
//   - fused_mlp_forward (K5): the forward surrogate, per hidden layer
//     h@W+b -> LayerNorm (two-pass variance, eps 1e-6) -> LeakyReLU, then a
//     linear head (4->256->512->1024->512->256->258);
//   - fused_dense_chain (K6): the generator with BatchNorm folded into the
//     dense weights beforehand, ReLU hidden layers, tanh head
//     (250->512->256->4).
// Both are one template, chain_kernel<HIDDEN, HEAD>.
//
// Design.  Each thread block owns a tile of kTileRows batch rows and runs it
// through the whole chain.  The tile's activations stay in two ping-pong
// buffers in dynamic shared memory, stored column-major within the tile
// (element (r, k) at k * kTileRows + r), so that the kTileRows inputs of
// column k are four float4 broadcast loads.  Thread j owns output column j:
// it reads W[k, j] from the packed (in, out) row-major weights (consecutive
// threads read consecutive addresses) and reuses each weight for all
// kTileRows rows, accumulating with fp32 FMAs on the CUDA cores.  The head
// writes straight to global memory.  The ragged last tile is zero-filled in
// shared memory and its extra rows are never stored, so the batch is not
// padded.  LayerNorm runs per row as mean, then mean((h - mean)^2), exactly
// as the TPU kernel does, with conflict-free block reductions.
//
// Bounds on the card.  Every block streams all weights once (5.5 MB for the
// surrogate, 1.0 MB for the generator; both stay resident in the 50 MB L2)
// and does 2 * kTileRows FLOPs per weight read, so the kernel is bound by L2
// bandwidth and by the shared-memory loads that feed the FMAs (four 16-byte
// loads per sixteen FMAs), not by device memory.  The widest pair of
// surrogate buffers (512 + 1024 floats per row) needs 96 KB of dynamic
// shared memory, above the 48 KB default, so the launcher raises the
// kernel's limit and refuses shapes above the device's opt-in maximum.
// Small batches leave most SMs idle (B = 64 is 4 blocks on 132 SMs);
// tensor cores (wgmma), TMA and that occupancy problem are later work.
//
// Interface: plain C, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 16;
constexpr int kThreads = 256;
constexpr int kColsPerPass = kThreads / kTileRows;
constexpr int kMaxLayers = 8;  // hidden layers + head

enum Hidden { kLayerNormLeaky = 0, kRelu = 1 };
enum Head { kLinear = 0, kTanh = 1 };

// Passed by value (kernel parameter space).  Offsets are in floats into the
// packed weight buffer; layer l maps dims[l] -> dims[l + 1].
struct ChainDesc {
  int n_layers;
  int dims[kMaxLayers + 1];
  long long w_off[kMaxLayers];
  long long b_off[kMaxLayers];
  long long s_off[kMaxLayers];  // LayerNorm scale (LayerNorm chains only)
  long long t_off[kMaxLayers];  // LayerNorm shift
  int buf_width[2];             // per-row width of each ping-pong buffer
};

// In-place LayerNorm + LeakyReLU over the kTileRows rows of h (width n,
// column-major within the tile).  Thread tid handles row tid % kTileRows
// and columns tid / kTileRows + kColsPerPass * i, so a warp reads 32
// consecutive floats.
__device__ void layer_norm_leaky(float* h, int n, const float* __restrict__ scale,
                                 const float* __restrict__ shift, float slope,
                                 float eps, float* red, float* stat) {
  const int tid = threadIdx.x;
  const int r = tid % kTileRows;
  const int c0 = tid / kTileRows;

  float s = 0.f;
  for (int c = c0; c < n; c += kColsPerPass) s += h[c * kTileRows + r];
  red[tid] = s;
  __syncthreads();
  if (tid < kTileRows) {
    float t = 0.f;
    for (int i = 0; i < kColsPerPass; ++i) t += red[i * kTileRows + tid];
    stat[tid] = t / n;
  }
  __syncthreads();
  const float mean = stat[r];

  s = 0.f;
  for (int c = c0; c < n; c += kColsPerPass) {
    const float d = h[c * kTileRows + r] - mean;
    s = fmaf(d, d, s);
  }
  red[tid] = s;
  __syncthreads();
  if (tid < kTileRows) {
    float t = 0.f;
    for (int i = 0; i < kColsPerPass; ++i) t += red[i * kTileRows + tid];
    stat[kTileRows + tid] = rsqrtf(t / n + eps);
  }
  __syncthreads();
  const float inv = stat[kTileRows + r];

  for (int c = c0; c < n; c += kColsPerPass) {
    float v = (h[c * kTileRows + r] - mean) * inv;
    v = v * scale[c] + shift[c];
    h[c * kTileRows + r] = v >= 0.f ? v : slope * v;
  }
  __syncthreads();
}

template <int HIDDEN, int HEAD>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ x, float* __restrict__ out,
             const float* __restrict__ w, const ChainDesc d, int batch,
             float slope, float eps) {
  extern __shared__ float4 smem4[];
  __shared__ float red[kThreads];
  __shared__ float stat[2 * kTileRows];

  float* smem = reinterpret_cast<float*>(smem4);
  float* buf[2] = {smem, smem + kTileRows * d.buf_width[0]};
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, batch - row0);

  // Input tile -> buf[0]; rows past the batch are zero.
  const int d_in = d.dims[0];
  for (int i = tid; i < kTileRows * d_in; i += kThreads) {
    const int r = i / d_in;
    const int k = i - r * d_in;
    buf[0][k * kTileRows + r] = r < rows ? x[(size_t)(row0 + r) * d_in + k] : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < d.n_layers; ++l) {
    const int din = d.dims[l];
    const int dout = d.dims[l + 1];
    const bool head = l == d.n_layers - 1;
    const float* __restrict__ W = w + d.w_off[l];
    const float* __restrict__ bias = w + d.b_off[l];
    const float* in = buf[l & 1];
    float* next = buf[(l + 1) & 1];

    for (int j = tid; j < dout; j += kThreads) {
      float acc[kTileRows];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) acc[r] = 0.f;
      const float* __restrict__ wj = W + j;
#pragma unroll 4
      for (int k = 0; k < din; ++k) {
        const float wk = __ldg(wj + (size_t)k * dout);
        const float4* a = reinterpret_cast<const float4*>(in + k * kTileRows);
#pragma unroll
        for (int q = 0; q < kTileRows / 4; ++q) {
          const float4 v = a[q];
          acc[4 * q + 0] = fmaf(v.x, wk, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v.y, wk, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, wk, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, wk, acc[4 * q + 3]);
        }
      }
      const float bj = bias[j];
      if (head) {
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          if (r < rows) {
            float h = acc[r] + bj;
            if (HEAD == kTanh) h = tanhf(h);
            out[(size_t)(row0 + r) * dout + j] = h;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          float h = acc[r] + bj;
          if (HIDDEN == kRelu) h = fmaxf(h, 0.f);
          next[j * kTileRows + r] = h;
        }
      }
    }
    __syncthreads();
    if (HIDDEN == kLayerNormLeaky && !head) {
      layer_norm_leaky(next, dout, w + d.s_off[l], w + d.t_off[l], slope, eps,
                       red, stat);
    }
  }
}

// offsets: n_layers rows of (W, b, scale, shift) float offsets, -1 unused.
// dims: n_layers + 1 widths.  Both are host arrays.
template <int HIDDEN, int HEAD>
cudaError_t launch(const float* x, float* out, const float* w,
                   const long long* offsets, const int* dims, int n_layers,
                   int batch, float slope, float eps, cudaStream_t stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1) {
    return cudaErrorInvalidValue;
  }
  ChainDesc d{};
  d.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1) return cudaErrorInvalidValue;
    d.dims[i] = dims[i];
  }
  for (int l = 0; l < n_layers; ++l) {
    d.w_off[l] = offsets[4 * l + 0];
    d.b_off[l] = offsets[4 * l + 1];
    d.s_off[l] = offsets[4 * l + 2];
    d.t_off[l] = offsets[4 * l + 3];
    if (d.w_off[l] < 0 || d.b_off[l] < 0) return cudaErrorInvalidValue;
    if (HIDDEN == kLayerNormLeaky && l < n_layers - 1 &&
        (d.s_off[l] < 0 || d.t_off[l] < 0)) {
      return cudaErrorInvalidValue;
    }
    // The activation entering layer l lives in buffer l % 2.
    d.buf_width[l & 1] = d.buf_width[l & 1] > dims[l] ? d.buf_width[l & 1] : dims[l];
  }

  const size_t smem = sizeof(float) * kTileRows * (d.buf_width[0] + d.buf_width[1]);
  int device = 0;
  int optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  const size_t static_smem = sizeof(float) * (kThreads + 2 * kTileRows);
  if (smem + static_smem > (size_t)optin) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(chain_kernel<HIDDEN, HEAD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;

  const int grid = (batch + kTileRows - 1) / kTileRows;
  chain_kernel<HIDDEN, HEAD><<<grid, kThreads, smem, stream>>>(x, out, w, d, batch,
                                                               slope, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5: LayerNorm + LeakyReLU hidden layers, linear head.
int pigan_fused_mlp_forward(const float* x, float* out, const float* w,
                            const long long* offsets, const int* dims,
                            int n_layers, int batch, float leaky_slope,
                            float ln_eps, void* stream) {
  return (int)launch<kLayerNormLeaky, kLinear>(x, out, w, offsets, dims, n_layers,
                                               batch, leaky_slope, ln_eps,
                                               (cudaStream_t)stream);
}

// K6: ReLU hidden layers (BatchNorm folded in), tanh head.
int pigan_fused_dense_chain(const float* x, float* out, const float* w,
                            const long long* offsets, const int* dims,
                            int n_layers, int batch, void* stream) {
  return (int)launch<kRelu, kTanh>(x, out, w, offsets, dims, n_layers, batch, 0.f,
                                   0.f, (cudaStream_t)stream);
}

const char* pigan_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
