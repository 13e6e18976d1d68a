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
// tiled SGEMM (sgemm in train_common.cuh, shared-memory tiles, fp32 FMAs on the CUDA
// cores, no TF32), parameterised by strides so that no operand is
// transposed in memory.  Row kernels (one block per batch row) do bias-free
// LayerNorm + LeakyReLU + dropout forward, saving t - mean, 1/sigma, the
// pre-activation and the dropout factor, and the LayerNorm backward;
// column-sum kernels reduce bias, gamma and beta gradients over the batch in
// a fixed order.  The loss kernel is one block over the (B, S + 8)
// prediction and writes its per-step (loss, spectrum, metrics) row.
//
// bfloat16 operands (bf16 != 0; megakernel.py:2644-2663).  The operands of the
// products the TPU kernel runs on its MXU are rounded to bfloat16 in the
// SGEMM's tile loads and accumulate in fp32 (train_common.cuh): hidden layers
// 1-4 (forward, dW, dx) and the head's spectrum columns.  The input layer
// (forward and dW) and the head's metrics columns run on the TPU's VPU in
// fp32 and stay fp32: in bf16 mode the head is two products each way (the
// metrics columns' forward, dW rows and dx term apart, the dx term added
// after the spectrum columns'), three launches more a step (39).
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
// The SGEMM, the LayerNorm rows, the column sums and clip + Adam are shared
// with gan_train.cu through train_common.cuh.

#include "train_common.cuh"

namespace {

// --------------------------------------------------------------------------
// Loss and its gradient seeds, one block over the (B, S + M) prediction.
// --------------------------------------------------------------------------
struct LossCoef {
  float w_spec, w_met, w_smooth, w_l1;
  float c_spec, c_met, c_smooth;  // w_spec*2, w_met*2, w_smooth*2/(B(S-2))
  float n_spec, n_met, n_smooth;  // B*S, B*M, B*(S-2)
};

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
//   bf16           nonzero: bfloat16 operands of the TPU kernel's MXU products
int pigan_forward_train(float* params, float* m, float* v, const float* x,
                        const float* spec, const float* met, const float* sched,
                        const uint32_t* seeds, float* rows, float* work,
                        long long work_floats, const int* dims, int n_hidden,
                        const long long* offsets, int S, int B, int T,
                        const double* hp, uint32_t thresh, int bf16, void* stream_ptr) {
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
  const bool rnd = bf16 != 0;

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
      // the input layer is the TPU kernel's VPU sum: fp32
      CHECK((gemm_ex<true, false>(rnd && l > 0, false, B, C, din, a, din, 1, params + o[0], 1,
                                  din, tc[l], C, params + o[1], st)));
      ln_forward<<<B, kThreads, 0, st>>>(tc[l], ln[l], sc[l], act[l], ivar[l],
                                         params + o[2], params + o[3], C, ln_eps,
                                         slope, mix32(seed_key ^ (uint32_t)l),
                                         use_drop, thresh, inv_keep);
      CHECK_LAUNCH();
      a = act[l];
    }
    const int dh = dims[n_hidden];
    const long long* oh = offsets + 4 * n_hidden;
    if (rnd) {
      // the spectrum columns in bfloat16, the metrics columns in fp32
      CHECK((gemm<true, false, true>(B, S, dh, a, dh, 1, params + oh[0], 1, dh, pred, D,
                                     params + oh[1], st)));
      CHECK((gemm<true, false>(B, Mdim, dh, a, dh, 1, params + oh[0] + (long long)S * dh, 1,
                               dh, pred + S, D, params + oh[1] + S, st)));
    } else {
      CHECK((gemm<true, false>(B, D, dh, a, dh, 1, params + oh[0], 1, dh, pred, D,
                               params + oh[1], st)));
    }
    loss_kernel<<<1, kThreads, 0, st>>>(pred, spec_t, met_t, dpred, rows + 3LL * t,
                                        B, S, Mdim, lk);
    CHECK_LAUNCH();

    // backward: head
    if (rnd) {
      const long long om = (long long)S * dh;    // the metrics rows of the head
      CHECK((gemm<false, true, true>(S, dh, B, dpred, 1, D, a, dh, 1, grad + oh[0], dh,
                                     nullptr, st)));
      CHECK((gemm<false, true>(Mdim, dh, B, dpred + S, 1, D, a, dh, 1, grad + oh[0] + om, dh,
                               nullptr, st)));
    } else {
      CHECK((gemm<false, true>(D, dh, B, dpred, 1, D, a, dh, 1, grad + oh[0], dh,
                               nullptr, st)));
    }
    column_sum<<<(D + kThreads - 1) / kThreads, kThreads, 0, st>>>(dpred, B, D,
                                                                   grad + oh[1]);
    CHECK_LAUNCH();
    if (rnd) {
      CHECK((gemm<true, true, true>(B, dh, S, dpred, D, 1, params + oh[0], dh, 1, da, dh,
                                    nullptr, st)));
      CHECK((gemm<true, true, false, true>(B, dh, Mdim, dpred + S, D, 1,
                                           params + oh[0] + (long long)S * dh, dh, 1, da, dh,
                                           nullptr, st)));
    } else {
      CHECK((gemm<true, true>(B, dh, D, dpred, D, 1, params + oh[0], dh, 1, da, dh,
                              nullptr, st)));
    }
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
      CHECK((gemm_ex<false, true>(rnd && l > 0, false, C, din, B, dt, 1, C, a_in, din, 1,
                                  grad + o[0], din, nullptr, st)));
      if (l > 0) {
        CHECK((gemm_ex<true, true>(rnd, false, B, din, C, dt, C, 1, params + o[0], din, 1, da,
                                   din, nullptr, st)));
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
