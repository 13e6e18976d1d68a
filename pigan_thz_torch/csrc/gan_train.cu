// PI-GAN training (the fused D-then-G step), fp32, for Hopper (sm_90a), for
// one state (K2) or for M seed-ensemble members at once (K3).
//
// Replaces the Pallas TPU kernel pigan_thz_tpu/ops/megakernel.py:
// _make_kernel (K2), launched by make_pallas_multi_epoch_fn: E epochs of the
// alternating update in one launch.  Per step, at batch B, with G = S -> g1
// -> g2 -> 4 (BatchNorm + ReLU, tanh head), D = S + 4 -> d1 -> d2 -> 1
// (LeakyReLU 0.2, logits) and the frozen F = 4 -> ... -> S + 8 (LayerNorm +
// LeakyReLU, eval mode):
//   G forward  once for both phases; BatchNorm with flax's batch variance
//              max(0, E[x^2] - E[x]^2), eps 1e-5; the running stats take
//              the biased variance with momentum 0.9, once per step;
//   D phase    [real; fake] (2B rows) through D, 2 mean BCE-with-logits
//              against labels 0.9 / 0.1, backward, global-norm clip, Adam
//              (b1 0.5).  On a step whose d_gate lane is 0 only the forward
//              runs (for the metrics): D, its moments and its count stay;
//   G phase    the fake rows through the just-updated D (target 1), F on
//              G's output, the losses (recon, metrics, Maxwell, LC, range
//              [, constraint x scale][, window]) and their adjoints: into
//              G's output directly (adversarial, LC, range, constraint)
//              and, unless detach, through F's input (recon, metrics,
//              Maxwell, LC's F side, window); G's backward with the
//              BatchNorm backward; clip, Adam; the EMA of G when on.
//   second G   with cycle_w > 0 a second pass of G on F's spectrum, and with
//   passes     stability_w > 0 one on a pre-noised spectra stream: each with
//              the batch statistics of its own batch (the running stats
//              stay), its own saved activations and a full BatchNorm
//              backward; loss w mean((second - first)^2) over the 4 outputs,
//              added to g_loss; seeds into the second pass's head and, with
//              the other sign, into the first pass's output; the weight
//              gradients into a flat buffer of their own, added to the main
//              ones after the main backward (main, cycle, stability: a fixed
//              order); cycle's input gradient joins dpred's spectrum columns
//              before F's backward unless detach; stability's is dropped;
//   instance   a (2B, S) noise stream added to the spectrum columns of D's
//   noise      input in the D phase only: the D phase reads a noised copy,
//              the G phase's adversarial pass the clean fake rows.
//   WGAN-GP    (flags bit 2; megakernel.py:986-1014, :1039-1053, :1068-1070)
//              the critic loss mean(z_fake) - mean(z_real), D's seed -+1/B,
//              and on D-update steps gp_weight mean((|grad_x D| - 1)^2) at
//              (clean spectra, params interpolated with the eps stream):
//              D's input gradient gvec = W1 (m1 . (W2 (m2 . w3))) over all
//              S + 4 columns, norm sqrt(sum gvec^2 + 1e-12), the seed
//              Gt = c gvec, c = w 2 (|g| - 1) / (B |g|), and its second-order
//              backward with the LeakyReLU masks constant (XLA's autodiff
//              treats them so): dW1 += a_m^T Gt, dW2 += v^T dU, dw3 +=
//              sum_b dV m2 (dU = m1 . Gt W1^T, dV = dU W2^T), no bias term.
//              G's adversarial seed is -1/B.  14 launches more on a D-update
//              step, none on a skipped one (which reports the critic loss
//              without the penalty);
//   bfloat16   (flags bit 3; megakernel.py:792-798, :840-857) the operands of
//              exactly the products the TPU kernel runs on its MXU are
//              rounded to bfloat16 in the SGEMM's tile loads and accumulate
//              in fp32 (MM below).  What the TPU kernel runs on the VPU in
//              fp32 stays fp32 (GEMM): G's 256->4 head and its backward, D's
//              256->1 head and its dW, F's input layer and its input
//              backward, and the 8 metrics columns of F's head, which the
//              bfloat16 path computes apart from the spectrum columns (one
//              launch more forward, one more through F's backward).
//
// Design.  The TPU kernel keeps ~12 MB of state resident in VMEM on a
// sequential grid; an SM has 227 KB.  Here, as in forward_train.cu, one C
// entry point per chunk of T steps (pigan_gan_train) enqueues every step's
// kernels on the caller's stream from a host loop, over flat fp32 buffers
// that stay in the 50 MB L2 between steps: G's and D's [param, m, v] (3 x
// 262 K floats each), F's parameters (1.38 M floats, read only), two flat
// gradients in the parameters' layout, and ~2.5 MB of activations.  Every
// product is the shared tiled SGEMM (train_common.cuh: fp32 FMAs on the
// CUDA cores, no TF32), strided so that no operand is transposed in memory;
// the 4- and 1-wide heads go through it too.  BatchNorm is a column
// reduction over the B rows: one thread per column, 64 columns a block, two
// passes in row order, the column sums in double (the variance and the
// backward's mean subtraction cancel: with float sums G's gradient was 30x
// further from a float64 evaluation than the plain version's).  F's LayerNorm rows, the column sums of the bias
// gradients and the two-pass clip + Adam are K1's kernels.  The losses are
// kernels of one block (per member) that also write the gradient seeds.  The D-update gate
// is known on the host (it is a lane of the schedule), so a skipped step
// enqueues no D backward at all.  No atomics: reruns are bit-identical.
//
// Bounds on the card.  About 0.65 GFLOP a step at B = 64 with gradients
// through F (half of it F's forward and input-backward), ~10 us at the
// 67 TFLOP/s fp32 peak, and ~13 MB of state and weights read once a step,
// ~4 us at 3.35 TB/s.  Neither bounds a step: on an H100 (80GB HBM3, 700 W)
// it takes ~1.2 ms through F (69 launches) and ~0.9 ms detached (58; a second
// G pass adds 16 and ~0.25 ms, the sum of the passes' gradients 1, cycle's
// input gradient 2, instance noise 1), the
// device busy 90 % of that, four fifths of it in the products of 64 or 128
// rows: 32 x 32 tiles give 16-64 blocks on 132 SMs, each walking the whole
// depth, ~34 us a product.  Split-K or tensor-core tiles for those products,
// fusing the elementwise passes into their epilogues, and CUDA-graph
// capture of a chunk are later work.
//
// Ensemble members (K3).  pigan_gan_ensemble_train replaces the member-packed
// path of the same Pallas kernel (_make_kernel(members=M), launched by
// make_pallas_ensemble_fn): M independent members' steps in one launch per
// chunk, against one shared frozen F and one shared schedule.  The TPU
// kernel runs the members' chains one after the other inside each grid
// step, over state buffers with a leading member axis in VMEM.  Here the
// member is a grid axis of every kernel of the step (train_common.cuh: Per):
// state, moments, BatchNorm stats, streams, rows and one workspace per member
// are contiguous (M, ...) buffers, each kernel offsets its operands by
// member x stride, and a step stays 69 launches (58 detached) whatever M is,
// with M times the blocks on the card.  K2 is the M = 1 case of the same
// code.  No tile choice, reduction or loop reads M or the grid's member
// axis, so member m's state and rows are bit for bit those of K2 on that
// member alone.  Whether a step updates D is one host decision for all
// members (a lane of the shared schedule): the caller holds them at equal
// step and optimiser counts.  Per member the working set is ~13 MB (state,
// moments, gradients, scratch) beside 5.5 MB of F, so past M = 3 it no
// longer fits the 50 MB L2; that shows nowhere, a member reads its state once
// a step.  On an H100 (80GB HBM3, 700 W) an epoch of 15 steps through F takes
// 18.3 ms at M = 1 (K2's time), 20.4 at M = 2, 22.5 at M = 4 and 25.4 at
// M = 8: the B-row products' 16-64 blocks a member were latency-bound, and M
// times the blocks overlap on the 132 SMs.
//
// Interface: plain C, loaded with ctypes.  Both entry points launch on the
// given stream, do not synchronise, allocate nothing (the workspace comes
// from the caller, and a short one is refused), and return the first
// cudaError_t (0 on success), checking cudaGetLastError() after each launch.

#include "train_common.cuh"

namespace {

constexpr int kColThreads = 64;   // columns per block of the BatchNorm kernels
constexpr int kRowWidth = 11;     // metric values per step
constexpr int kSchedLanes = 8;    // lr_g lr_d inv1_g inv2_g inv1_d inv2_d d_gate c_scale

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// --------------------------------------------------------------------------
// BatchNorm (train mode) + ReLU over the batch, one thread per column.  u
// holds the pre-norm values on entry and u - mean on exit.  Without run_mean
// (a null Per: the second G passes) the running stats are left alone.
// --------------------------------------------------------------------------
__global__ void bn_forward(PerOut um, int B, int C, PerIn gammam, PerIn betam, PerOut xhm,
                           PerOut ym, PerOut am, PerOut ivm, PerOut run_meanm,
                           PerOut run_varm, float eps, float mom, float one_minus_mom) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int mem = blockIdx.y;
  float* u = um.at(mem);
  const float* __restrict__ gamma = gammam.at(mem);
  const float* __restrict__ beta = betam.at(mem);
  float* __restrict__ xh = xhm.at(mem);
  float* __restrict__ y = ym.at(mem);
  float* __restrict__ a = am.at(mem);
  float* __restrict__ iv_out = ivm.at(mem);
  float* __restrict__ run_mean = run_meanm.p ? run_meanm.at(mem) : nullptr;
  float* __restrict__ run_var = run_varm.p ? run_varm.at(mem) : nullptr;
  // the column sums in double: E[x^2] - E[x]^2 cancels, and a sequential
  // float sum over the rows would lose what the difference keeps
  double s = 0.0, s2 = 0.0;
  for (int b = 0; b < B; ++b) {
    const double v = u[(long long)b * C + c];
    s += v;
    s2 += v * v;
  }
  const double mean = s / B;
  const float mu = (float)mean;
  const float var = fmaxf(0.f, (float)(s2 / B - mean * mean));
  const float iv = 1.f / sqrtf(var + eps);
  const float g = gamma[c], be = beta[c];
  for (int b = 0; b < B; ++b) {
    const long long o = (long long)b * C + c;
    const float d = u[o] - mu;
    const float x = d * iv;
    const float yy = x * g + be;
    u[o] = d;
    xh[o] = x;
    y[o] = yy;
    a[o] = fmaxf(yy, 0.f);
  }
  iv_out[c] = iv;
  if (run_mean) {
    run_mean[c] = mom * run_mean[c] + one_minus_mom * mu;
    run_var[c] = mom * run_var[c] + one_minus_mom * var;
  }
}

// Adjoint of ReLU(BatchNorm(u)): da at the block's output -> du at u, and
// the column's dgamma and dbeta.  uc = u - mean.
__global__ void bn_backward(PerIn dam, PerIn ym, PerIn xhm, PerIn ucm, PerIn gammam,
                            PerIn ivm, int B, int C, PerOut dum, PerOut dgammam,
                            PerOut dbetam) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int mem = blockIdx.y;
  const float* __restrict__ da = dam.at(mem);
  const float* __restrict__ y = ym.at(mem);
  const float* __restrict__ xh = xhm.at(mem);
  const float* __restrict__ uc = ucm.at(mem);
  const float* __restrict__ gamma = gammam.at(mem);
  const float* __restrict__ iv_in = ivm.at(mem);
  float* __restrict__ du = dum.at(mem);
  float* __restrict__ dgamma = dgammam.at(mem);
  float* __restrict__ dbeta = dbetam.at(mem);
  const float g = gamma[c], iv = iv_in[c];
  // in double: du below subtracts the column mean, which cancels most of
  // a gradient that all rows share
  double sg = 0.0, sb = 0.0, sv = 0.0, st = 0.0;
  for (int b = 0; b < B; ++b) {
    const long long o = (long long)b * C + c;
    const float dy = y[o] > 0.f ? da[o] : 0.f;
    sg += (double)dy * xh[o];
    sb += dy;
    sv += (double)(dy * g) * uc[o];
    st += (double)(dy * g * iv);
  }
  const float dvar = (float)sv * -0.5f * iv * iv * iv;
  const float mean_dt = (float)(st / B);
  for (int b = 0; b < B; ++b) {
    const long long o = (long long)b * C + c;
    const float dy = y[o] > 0.f ? da[o] : 0.f;
    du[o] = dy * g * iv - mean_dt + dvar * 2.f * uc[o] / B;
  }
  dgamma[c] = (float)sg;
  dbeta[c] = (float)sb;
}

// --------------------------------------------------------------------------
// Elementwise passes
// --------------------------------------------------------------------------

// G's output and D's input.  z3 (B, 4) holds the head's pre-activation on
// entry and tanh of it on exit; pn the (squashed) output; x0 (2B, S + 4) is
// [spectra | real params] over [spectra | fake params].
__global__ void g_output(PerOut z3m, PerOut pnm, PerOut x0m, PerIn spectram,
                         PerIn params_physm, int B, int S, float4 lo, float4 hi,
                         int sigmoid) {
  const int mem = blockIdx.y;
  float* z3 = z3m.at(mem);
  float* __restrict__ pn = pnm.at(mem);
  float* __restrict__ x0 = x0m.at(mem);
  const float* __restrict__ spectra = spectram.at(mem);
  const float* __restrict__ params_phys = params_physm.at(mem);
  const int nd = S + 4;
  const float los[4] = {lo.x, lo.y, lo.z, lo.w};
  const float his[4] = {hi.x, hi.y, hi.z, hi.w};
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < B * nd;
       e += blockDim.x * gridDim.x) {
    const int b = e / nd;
    const int c = e - b * nd;
    float real, fake;
    if (c < S) {
      real = fake = spectra[(long long)b * S + c];
    } else {
      const int k = c - S;
      const float tn = tanhf(z3[b * 4 + k]);
      const float p = sigmoid ? sigmoidf(tn) : tn;
      z3[b * 4 + k] = tn;
      pn[b * 4 + k] = p;
      real = params_phys[b * 4 + k];
      fake = (p + 1.f) * 0.5f * (his[k] - los[k]) + los[k];
    }
    x0[(long long)b * nd + c] = real;
    x0[(long long)(B + b) * nd + c] = fake;
  }
}

__global__ void leaky_forward(PerIn pm, PerOut hm, long long n, float slope) {
  const float* __restrict__ p = pm.at(blockIdx.y);
  float* __restrict__ h = hm.at(blockIdx.y);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)blockDim.x * gridDim.x) {
    const float v = p[i];
    h[i] = v >= 0.f ? v : slope * v;
  }
}

__global__ void leaky_backward(PerOut dm, PerIn pm, long long n, float slope) {
  float* __restrict__ d = dm.at(blockIdx.y);
  const float* __restrict__ p = pm.at(blockIdx.y);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)blockDim.x * gridDim.x) {
    if (p[i] < 0.f) d[i] *= slope;
  }
}

// D's head backward: dp2[r, c] = dz[r] w3[c] mask(p2[r, c]).
__global__ void d_head_backward(PerIn dzm, PerIn w3m, PerIn p2m, PerOut dp2m, int R, int C,
                                float slope) {
  const int mem = blockIdx.y;
  const float* __restrict__ dz = dzm.at(mem);
  const float* __restrict__ w3 = w3m.at(mem);
  const float* __restrict__ p2 = p2m.at(mem);
  float* __restrict__ dp2 = dp2m.at(mem);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < R * C;
       e += blockDim.x * gridDim.x) {
    const int r = e / C;
    const int c = e - r * C;
    dp2[e] = dz[r] * w3[c] * (p2[e] >= 0.f ? 1.f : slope);
  }
}

// dz3 = (dpn [+ dfin]) dsq (1 - tn^2), in place over dpn.
__global__ void g_head_seed(PerOut dpnm, PerIn dfinm, PerIn tnm, PerIn pnm, int n,
                            int sigmoid) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int mem = blockIdx.y;
  float* __restrict__ dpn = dpnm.at(mem);
  const float* __restrict__ dfin = dfinm.p ? dfinm.at(mem) : nullptr;
  const float* __restrict__ tn = tnm.at(mem);
  const float* __restrict__ pn = pnm.at(mem);
  float d = dpn[e];
  if (dfin) d += dfin[e];
  const float dsq = sigmoid ? pn[e] * (1.f - pn[e]) : 1.f;
  dpn[e] = d * dsq * (1.f - tn[e] * tn[e]);
}

// D's input for the D phase with instance noise: xn = x0 with noise (2B, S)
// added to the spectrum columns; the parameter columns are copied.
__global__ void add_instance_noise(PerIn x0m, PerIn noisem, PerOut xnm, int R, int S) {
  const int mem = blockIdx.y;
  const float* __restrict__ x0 = x0m.at(mem);
  const float* __restrict__ noise = noisem.at(mem);
  float* __restrict__ xn = xnm.at(mem);
  const int nd = S + 4;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < R * nd;
       e += blockDim.x * gridDim.x) {
    const int r = e / nd;
    const int c = e - r * nd;
    xn[e] = c < S ? x0[e] + noise[(long long)r * S + c] : x0[e];
  }
}

// dst[b, c] += src[b, c] for the first C columns of dst's rows (ld columns).
__global__ void add_columns(PerOut dstm, int ld, PerIn srcm, int B, int C) {
  float* __restrict__ dst = dstm.at(blockIdx.y);
  const float* __restrict__ src = srcm.at(blockIdx.y);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < B * C;
       e += blockDim.x * gridDim.x) {
    const int b = e / C;
    const int c = e - b * C;
    dst[(long long)b * ld + c] += src[e];
  }
}

// g = (g + a) + b, each of a and b only where given: the gradients of the
// second G passes join the main ones in a fixed order.
__global__ void add_gradients(PerOut gm, PerIn am, PerIn bm, long long n) {
  float* __restrict__ g = gm.at(blockIdx.y);
  const float* __restrict__ a = am.p ? am.at(blockIdx.y) : nullptr;
  const float* __restrict__ b = bm.p ? bm.at(blockIdx.y) : nullptr;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)blockDim.x * gridDim.x) {
    float v = g[i];
    if (a) v += a[i];
    if (b) v += b[i];
    g[i] = v;
  }
}

__global__ void ema_lerp(float* __restrict__ ema, const float* __restrict__ p, long long n,
                         float mu, float one_minus_mu) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)blockDim.x * gridDim.x) {
    ema[i] = mu * ema[i] + one_minus_mu * p[i];
  }
}

// --------------------------------------------------------------------------
// Losses, one block per member (blockIdx.x)
// --------------------------------------------------------------------------

__device__ __forceinline__ float bce_softplus(float z) { return log1pf(expf(-fabsf(z))); }

// D's loss over the 2B logits: row[0] = 2 mean BCE, row[2] = accuracy at
// 0.5, dz = (sigmoid(z) - label) / B.
__global__ void __launch_bounds__(kThreads)
d_loss_kernel(PerIn zm, int B, float lab_r, float lab_f, PerOut dzm, PerOut rowm) {
  __shared__ float red[kThreads];
  const float* __restrict__ z = zm.at(blockIdx.x);
  float* __restrict__ dz = dzm.at(blockIdx.x);
  float* __restrict__ row = rowm.at(blockIdx.x);
  float s = 0.f, hit_r = 0.f, hit_f = 0.f;
  for (int r = threadIdx.x; r < 2 * B; r += kThreads) {
    const float v = z[r];
    const float label = r < B ? lab_r : lab_f;
    const float p = sigmoidf(v);
    s += fmaxf(v, 0.f) - v * label + bce_softplus(v);
    if (r < B) hit_r += p > 0.5f ? 1.f : 0.f;
    else hit_f += p <= 0.5f ? 1.f : 0.f;
    dz[r] = (p - label) / B;
  }
  const float total = block_sum(s, red);
  const float cr = block_sum(hit_r, red);
  const float cf = block_sum(hit_f, red);
  if (threadIdx.x == 0) {
    row[0] = 2.f * (total / (2 * B));
    row[2] = 0.5f * (cr / B + cf / B);
  }
}

// G's adversarial loss on the B fake logits (target 1, unsmoothed):
// row[3] = mean BCE, dz = (sigmoid(z) - 1) / B.
__global__ void __launch_bounds__(kThreads)
adv_loss_kernel(PerIn zm, int B, PerOut dzm, PerOut rowm) {
  __shared__ float red[kThreads];
  const float* __restrict__ z = zm.at(blockIdx.x);
  float* __restrict__ dz = dzm.at(blockIdx.x);
  float* __restrict__ row = rowm.at(blockIdx.x);
  float s = 0.f;
  for (int r = threadIdx.x; r < B; r += kThreads) {
    const float v = z[r];
    s += fmaxf(v, 0.f) - v + bce_softplus(v);
    dz[r] = (sigmoidf(v) - 1.f) / B;
  }
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) row[3] = total / B;
}

// The loss of a second G pass against the first: z2 (B, 4) holds the second
// head's pre-activation on entry and tanh of it on exit; with p2 its
// (squashed) output, loss = mean((p2 - pn)^2) over the B x 4 outputs, for
// cycle and for stability alike.  row[1] += w loss;
// dz2 = w 2 (p2 - pn) / (4B) dsq (1 - tanh^2), the seed at the second head;
// dpn -= w 2 (p2 - pn) / (4B), the other side, into the first pass's output.
__global__ void __launch_bounds__(kThreads)
second_pass_loss(PerOut z2m, PerIn pnm, PerOut dz2m, PerOut dpnm, PerOut rowm, int B, float w,
                 int sigmoid) {
  __shared__ float red[kThreads];
  const int mem = blockIdx.x;
  float* __restrict__ z2 = z2m.at(mem);
  const float* __restrict__ pn = pnm.at(mem);
  float* __restrict__ dz2 = dz2m.at(mem);
  float* __restrict__ dpn = dpnm.at(mem);
  float* row = rowm.at(mem);
  const float n = (float)B * 4.f;
  float s = 0.f;
  for (int e = threadIdx.x; e < B * 4; e += kThreads) {
    const float tn = tanhf(z2[e]);
    const float p = sigmoid ? sigmoidf(tn) : tn;
    const float diff = p - pn[e];
    s = fmaf(diff, diff, s);
    const float g = w * 2.f * diff / n;
    const float dsq = sigmoid ? p * (1.f - p) : 1.f;
    z2[e] = tn;
    dz2[e] = g * dsq * (1.f - tn * tn);
    dpn[e] -= g;
  }
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) row[1] += w * (total / n);
}

struct GLossCoef {
  float w_adv, w_recon, w_pmet, w_maxwell, w_lc, w_range, w_constraint, w_window;
  float r_lo, r_hi, c_scale;
  float half_span[4];        // (hi - lo) / 2 per parameter
  float f_lo, f_hi;          // the resonance window
  int detach;
};

// G's losses over F's prediction pred (B, S + 8) and G's output pn (B, 4):
// writes the step's row (g_loss and the seven parts, the constraint loss),
// the direct adjoint dpn (B, 4) and, unless detach, dpred (B, S + 8).
__global__ void __launch_bounds__(kThreads)
g_loss_kernel(PerIn predm, PerIn spectram, PerIn metm, PerIn pnm, PerIn dpphysm,
              PerOut dpnm, PerOut dpredm, PerOut rowm, int B, int S, GLossCoef k) {
  __shared__ float red[kThreads];
  const int mem = blockIdx.x;
  const float* __restrict__ pred = predm.at(mem);
  const float* __restrict__ spectra = spectram.at(mem);
  const float* __restrict__ met = metm.at(mem);
  const float* __restrict__ pn = pnm.at(mem);
  const float* __restrict__ dpphys = dpphysm.at(mem);
  float* __restrict__ dpn = dpnm.at(mem);
  float* __restrict__ dpred = dpredm.at(mem);
  float* row = rowm.at(mem);
  const int M = 8;
  const int D = S + M;
  const float nB = (float)B;
  const float n_spec = (float)((long long)B * S);
  const float n_met = (float)((long long)B * M);
  const float n_smooth = (float)((long long)B * (S - 2));
  const float c_smooth = k.w_maxwell * 2.f / n_smooth;

  float s_spec = 0.f, s_met = 0.f, s_smooth = 0.f, s_invalid = 0.f;
  for (int e = threadIdx.x; e < B * D; e += kThreads) {
    const int b = e / D;
    const int c = e - b * D;
    const float* p = pred + (long long)b * D;
    float g;
    if (c < S) {
      const float d = p[c] - spectra[(long long)b * S + c];
      s_spec = fmaf(d, d, s_spec);
      if (p[c] != p[c] || isinf(p[c])) s_invalid += 1.f;
      float adj = 0.f;
      if (c <= S - 3) {
        const float d2 = second_diff(p, c);
        s_smooth = fmaf(d2, d2, s_smooth);
        adj = d2;
      }
      if (c >= 1 && c - 1 <= S - 3) adj = adj - 2.f * second_diff(p, c - 1);
      if (c >= 2 && c - 2 <= S - 3) adj = adj + second_diff(p, c - 2);
      g = k.w_recon * 2.f * d / n_spec + c_smooth * adj;
    } else {
      const int j = c - S;
      const float d = p[c] - met[(long long)b * M + j];
      s_met = fmaf(d, d, s_met);
      g = k.w_pmet * 2.f * d / n_met;
      if (j < 2) {
        const float* q = pn + b * 4;
        const float th = j == 0 ? 0.4f * q[0] + 0.6f * q[2] : 0.3f * q[1] + 0.7f * q[3];
        g += k.w_lc * 2.f * (p[c] - th) / nB;
        if (j == 0 && k.w_window != 0.f) {
          g += k.w_window * ((p[c] > k.f_hi ? 1.f : 0.f) - (p[c] < k.f_lo ? 1.f : 0.f));
        }
      }
    }
    if (!k.detach) dpred[e] = g;
  }

  // per row: LC, range, violation, constraint, window; the direct adjoint
  float s_lc1 = 0.f, s_lc2 = 0.f, s_range = 0.f, s_viol = 0.f;
  float s_hard = 0.f, s_bound = 0.f, s_sm = 0.f, s_window = 0.f;
  const float wcs = k.w_constraint * k.c_scale;
  for (int b = threadIdx.x; b < B; b += kThreads) {
    const float* q = pn + b * 4;
    const float f1 = pred[(long long)b * D + S];
    const float f2 = pred[(long long)b * D + S + 1];
    const float th1 = 0.4f * q[0] + 0.6f * q[2];
    const float th2 = 0.3f * q[1] + 0.7f * q[3];
    s_lc1 += (f1 - th1) * (f1 - th1);
    s_lc2 += (f2 - th2) * (f2 - th2);
    const float g1 = k.w_lc * 2.f * (th1 - f1) / nB;
    const float g2 = k.w_lc * 2.f * (th2 - f2) / nB;
    const float lc_side[4] = {0.4f * g1, 0.3f * g2, 0.6f * g1, 0.7f * g2};
    bool bad = false;
    for (int j = 0; j < 4; ++j) {
      const float v = q[j];
      const float below = fmaxf(k.r_lo - v, 0.f);
      const float above = fmaxf(v - k.r_hi, 0.f);
      s_range += below * below + above * above;
      bad = bad || v < k.r_lo || v > k.r_hi;
      float g = k.w_adv * dpphys[b * 4 + j] * k.half_span[j] + lc_side[j];
      g += k.w_range * (2.f * above - 2.f * below) / (nB * 4.f);
      if (k.w_constraint != 0.f) {
        const float oor = fmaxf(fmaxf(v - 1.f, -v), 0.f);
        s_hard += oor * oor;
        const float bdist = fminf(v, 1.f - v);
        const float arg = -20.f * bdist;
        const float bexp = expf(fminf(arg, 25.f));
        s_bound += bexp;
        const float dhard = (2.f * oor / nB) * (v > 0.5f ? 1.f : -1.f);
        const float dbound =
            bexp * -20.f * (arg < 25.f ? 1.f : 0.f) * (v < 0.5f ? 1.f : -1.f) / nB;
        float dsm = 0.f;    // sign(v_j - v_{j-1}) - sign(v_{j+1} - v_j)
        if (j > 0) {
          const float dl = v - q[j - 1];
          s_sm += fabsf(dl);
          dsm += (float)((dl > 0.f) - (dl < 0.f));
        }
        if (j < 3) {
          const float dr = q[j + 1] - v;
          dsm -= (float)((dr > 0.f) - (dr < 0.f));
        }
        dsm /= nB * 3.f;
        g += wcs * (10.f * dhard + 0.1f * dbound + 0.05f * dsm);
      }
      dpn[b * 4 + j] = g;
    }
    s_viol += bad ? 1.f : 0.f;
    if (k.w_window != 0.f) s_window += fmaxf(f1 - k.f_hi, 0.f) + fmaxf(k.f_lo - f1, 0.f);
  }

  const float recon_l = block_sum(s_spec, red) / n_spec;
  const float met_l = block_sum(s_met, red) / n_met;
  const float maxwell_l = block_sum(s_smooth, red) / n_smooth;
  const float lc_l = block_sum(s_lc1, red) / nB + block_sum(s_lc2, red) / nB;
  const float range_l = block_sum(s_range, red) / (nB * 4.f);
  const float viol = block_sum(s_viol, red) / nB;
  float loss = k.w_adv * row[3] + k.w_recon * recon_l + k.w_pmet * met_l +
               k.w_maxwell * maxwell_l + k.w_lc * lc_l + k.w_range * range_l;
  float c_loss = 0.f;
  if (k.w_constraint != 0.f) {
    const float hard = block_sum(s_hard, red) / nB;
    const float boundary = block_sum(s_bound, red) / nB;
    const float smooth = block_sum(s_sm, red) / (nB * 3.f);
    const float validity = block_sum(s_invalid, red) / nB;
    c_loss = 10.f * hard + 0.1f * boundary + 0.05f * smooth + 3.f * validity;
    loss += wcs * c_loss;
  }
  if (k.w_window != 0.f) loss += k.w_window * block_sum(s_window, red);
  if (threadIdx.x == 0) {
    row[1] = loss;
    row[4] = recon_l;
    row[5] = met_l;
    row[6] = maxwell_l;
    row[7] = lc_l;
    row[8] = range_l;
    row[9] = viol;
    row[10] = c_loss;
  }
}

// --------------------------------------------------------------------------
// WGAN-GP: the critic loss and the gradient penalty's elementwise passes
// --------------------------------------------------------------------------

// The penalty's input: xg (B, S + 4) = [spectra | eps real + (1 - eps) fake],
// from x0's clean rows ([spectra | real params] over [spectra | fake params]).
__global__ void gp_input(PerIn x0m, PerIn epsm, PerOut xgm, int B, int S) {
  const int mem = blockIdx.y;
  const float* __restrict__ x0 = x0m.at(mem);
  const float* __restrict__ eps = epsm.at(mem);
  float* __restrict__ xg = xgm.at(mem);
  const int nd = S + 4;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < B * nd;
       e += blockDim.x * gridDim.x) {
    const int b = e / nd;
    const int c = e - b * nd;
    const float real = x0[e];
    xg[e] = c < S ? real : eps[b] * real + (1.f - eps[b]) * x0[(long long)(B + b) * nd + c];
  }
}

// v[r, c] = w3[c] m2(p2[r, c]): the head's weights through the second
// layer's LeakyReLU mask (dz/dh2 . m2 at a unit seed).
__global__ void gp_v(PerIn p2m, PerIn w3m, PerOut vm, int R, int C, float slope) {
  const int mem = blockIdx.y;
  const float* __restrict__ p2 = p2m.at(mem);
  const float* __restrict__ w3 = w3m.at(mem);
  float* __restrict__ v = vm.at(mem);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < R * C;
       e += blockDim.x * gridDim.x) {
    const int c = e % C;
    v[e] = w3[c] * (p2[e] >= 0.f ? 1.f : slope);
  }
}

// dw3[c] += sum_b dv[b, c] m2(p2[b, c]), in row order: the penalty's term of
// the head's gradient.
__global__ void gp_w3_grad(PerIn dvm, PerIn p2m, int B, int C, float slope, PerOut gw3m) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float* __restrict__ dv = dvm.at(blockIdx.y);
  const float* __restrict__ p2 = p2m.at(blockIdx.y);
  float* __restrict__ gw3 = gw3m.at(blockIdx.y);
  float s = 0.f;
  for (int b = 0; b < B; ++b) {
    const long long o = (long long)b * C + c;
    s += dv[o] * (p2[o] >= 0.f ? 1.f : slope);
  }
  gw3[c] += s;
}

// The critic's loss over the 2B logits: row[0] = mean(z_fake) - mean(z_real)
// (+ w_gp mean((|gvec| - 1)^2) when gvec is given: a D-update step),
// row[2] = accuracy at 0.5, dz = -1/B on real rows and 1/B on fake rows; with
// gvec also the penalty's seed gt = c gvec, c = w_gp 2 (|g| - 1) / (B |g|),
// |g| = sqrt(sum over the S + 4 columns of gvec^2 + 1e-12), one row a thread.
__global__ void __launch_bounds__(kThreads)
critic_loss_kernel(PerIn zm, PerIn gvecm, int B, int nd, float w_gp, PerOut dzm, PerOut gtm,
                   PerOut rowm) {
  __shared__ float red[kThreads];
  const int mem = blockIdx.x;
  const float* __restrict__ z = zm.at(mem);
  const float* __restrict__ gvec = gvecm.p ? gvecm.at(mem) : nullptr;
  float* __restrict__ dz = dzm.at(mem);
  float* __restrict__ row = rowm.at(mem);
  float s_real = 0.f, s_fake = 0.f, hit_r = 0.f, hit_f = 0.f, s_gp = 0.f;
  for (int r = threadIdx.x; r < 2 * B; r += kThreads) {
    const float v = z[r];
    const float p = sigmoidf(v);
    if (r < B) {
      s_real += v;
      hit_r += p > 0.5f ? 1.f : 0.f;
    } else {
      s_fake += v;
      hit_f += p <= 0.5f ? 1.f : 0.f;
    }
    dz[r] = (r < B ? -1.f : 1.f) / B;
  }
  if (gvec) {
    float* __restrict__ gt = gtm.at(mem);
    for (int b = threadIdx.x; b < B; b += kThreads) {
      const float* gr = gvec + (long long)b * nd;
      float ss = 0.f;
      for (int c = 0; c < nd; ++c) ss = fmaf(gr[c], gr[c], ss);
      const float gn = sqrtf(ss + 1e-12f);
      s_gp += (gn - 1.f) * (gn - 1.f);
      const float coef = w_gp * 2.f * (gn - 1.f) / (B * gn);
      float* gtr = gt + (long long)b * nd;
      for (int c = 0; c < nd; ++c) gtr[c] = coef * gr[c];
    }
  }
  const float real = block_sum(s_real, red);
  const float fake = block_sum(s_fake, red);
  const float cr = block_sum(hit_r, red);
  const float cf = block_sum(hit_f, red);
  const float gp = gvec ? block_sum(s_gp, red) / B : 0.f;
  if (threadIdx.x == 0) {
    row[0] = fake / B - real / B + w_gp * gp;
    row[2] = 0.5f * (cr / B + cf / B);
  }
}

// G's adversarial loss against the critic: row[3] = -mean(z), dz = -1/B.
__global__ void __launch_bounds__(kThreads)
wgan_adv_kernel(PerIn zm, int B, PerOut dzm, PerOut rowm) {
  __shared__ float red[kThreads];
  const float* __restrict__ z = zm.at(blockIdx.x);
  float* __restrict__ dz = dzm.at(blockIdx.x);
  float* __restrict__ row = rowm.at(blockIdx.x);
  float s = 0.f;
  for (int r = threadIdx.x; r < B; r += kThreads) {
    s += z[r];
    dz[r] = -1.f / B;
  }
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) row[3] = -(total / B);
}

// Device kernels enqueued by the last call of gan_train_steps in this
// process (pigan_gan_kernels_enqueued): divided by T, the launches a step.
long long g_kernels_enqueued = 0;

inline int blocks_for(long long n, int threads, int cap = 1024) {
  long long b = (n + threads - 1) / threads;
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

// T training steps over the state of `members` ensemble members in place:
// the body of both entry points.  Every operand that differs by member is a
// Per with that operand's member stride; F's parameters and the schedule
// are shared.  A step enqueues the same 69 launches (58 detached; more with
// the second G passes and instance noise) whatever `members` is: each launch
// carries the member on a grid axis.  inoise, stab and eps are null when off.
int gan_train_steps(int members, PerOut g, PerOut g_m, PerOut g_v, PerOut d, PerOut d_m,
                    PerOut d_v, PerOut bn1_mean, PerOut bn1_var, PerOut bn2_mean,
                    PerOut bn2_var, const float* f, float* g_ema, PerIn spectra, PerIn params,
                    PerIn met, PerIn inoise, PerIn stab, PerIn eps, const float* sched,
                    PerOut rows,
                    float* work,
                    long long work_floats, const int* dims, const int* f_dims,
                    int n_f_hidden, const long long* f_offsets, int B, int T,
                    const double* hp, int flags, cudaStream_t st) {
  const int S = dims[0], g1 = dims[1], g2 = dims[2], d1 = dims[3], d2 = dims[4];
  const int FL = n_f_hidden + 1;
  const int NM = members;
  if (NM < 1 || NM > 65535) return cudaErrorInvalidValue;
  if (n_f_hidden < 1 || FL > kMaxLayers || B < 1 || T < 0 || S < 3) return cudaErrorInvalidValue;
  if (g1 < 1 || g2 < 1 || d1 < 1 || d2 < 1 || f_dims[0] != 4) return cudaErrorInvalidValue;
  int maxc = g1 > g2 ? g1 : g2;
  for (int i = 0; i <= FL; ++i) {
    if (f_dims[i] < 1) return cudaErrorInvalidValue;
    if (f_dims[i] > maxc) maxc = f_dims[i];
  }
  for (int l = 0; l < n_f_hidden; ++l) {
    if (f_dims[l + 1] > kThreads * kMaxPerThread) return cudaErrorInvalidValue;
  }
  const int D = f_dims[FL];
  if (D != S + 8) return cudaErrorInvalidValue;
  const int nd = S + 4;
  const int detach = flags & 1;
  const int sigmoid = (flags >> 1) & 1;
  const bool wgan = (flags >> 2) & 1;
  const bool bf16 = (flags >> 3) & 1;
  const float w_gp = (float)hp[24];
  if (wgan && eps.p == nullptr) return cudaErrorInvalidValue;
  const float ema_decay = (float)hp[12];
  const float w_cycle = (float)hp[22], w_stab = (float)hp[23];
  const bool use_cycle = w_cycle != 0.f, use_stab = w_stab != 0.f;
  const bool use_inoise = inoise.p != nullptr;
  if (use_stab && stab.p == nullptr) return cudaErrorInvalidValue;
  // the EMA track is the one-member kernel's: an ensemble launch has none
  if (ema_decay > 0.f && (g_ema == nullptr || NM != 1)) return cudaErrorInvalidValue;

  // flat layouts of G and D
  const long long gW1 = 0, gb1 = gW1 + (long long)S * g1, ggam1 = gb1 + g1, gbet1 = ggam1 + g1;
  const long long gW2 = gbet1 + g1, gb2 = gW2 + (long long)g1 * g2, ggam2 = gb2 + g2,
                  gbet2 = ggam2 + g2;
  const long long gW3 = gbet2 + g2, gb3 = gW3 + (long long)g2 * 4;
  const long long Pg = gb3 + 4;
  const long long dW1 = 0, db1 = dW1 + (long long)nd * d1;
  const long long dW2 = db1 + d1, db2 = dW2 + (long long)d1 * d2;
  const long long dW3 = db2 + d2, db3 = dW3 + d2;
  const long long Pd = db3 + 1;

  // workspace of one member (ops/gan_train.py: workspace_floats); member m's
  // copy of each buffer lies work_floats further on
  long long pos = 0;
  auto take = [&](long long n) { PerOut p(work + pos, work_floats); pos += n; return p; };
  const int gc[2] = {g1, g2};
  PerOut uc[2], xh[2], y[2], a[2], iv[2];
  for (int l = 0; l < 2; ++l) {
    const long long bc = (long long)B * gc[l];
    uc[l] = take(bc); xh[l] = take(bc); y[l] = take(bc); a[l] = take(bc);
    iv[l] = take(gc[l]);
  }
  PerOut tn = take((long long)B * 4);
  PerOut pn = take((long long)B * 4);
  PerOut dpn = take((long long)B * 4);
  PerOut x0 = take(2LL * B * nd);
  PerOut p1 = take(2LL * B * d1);
  PerOut h1 = take(2LL * B * d1);
  PerOut p2 = take(2LL * B * d2);
  PerOut h2 = take(2LL * B * d2);
  PerOut z = take(2LL * B);
  PerOut dz = take(2LL * B);
  PerOut dp2 = take(2LL * B * d2);
  PerOut dp1 = take(2LL * B * d1);
  PerOut dpphys = take((long long)B * 4);
  PerOut tc[kMaxLayers], ln[kMaxLayers], act[kMaxLayers], ivar[kMaxLayers];
  for (int l = 0; l < n_f_hidden; ++l) {
    const long long bc = (long long)B * f_dims[l + 1];
    tc[l] = take(bc); ln[l] = take(bc); act[l] = take(bc); ivar[l] = take(B);
  }
  PerOut pred = take((long long)B * D);
  PerOut dpred = take((long long)B * D);
  PerOut da = take((long long)B * maxc);
  PerOut dln = take((long long)B * maxc);
  PerOut dt = take((long long)B * maxc);
  PerOut dfin = take((long long)B * 4);
  PerOut gradG = take(Pg);
  PerOut gradD = take(Pd);
  // only what is on takes room: the D phase's noised input; one set of
  // activations for the second G passes (cycle's are done with before
  // stability's begin), cycle's input gradient, a flat gradient for each
  PerOut x0n, uc2[2], xh2[2], y2[2], a2[2], iv2[2], tn2, dz2, drc, gradC, gradS;
  PerOut xg, p1g, h1g, p2g, gv, am, gvec, gt, dug, dvg;
  if (use_inoise) x0n = take(2LL * B * nd);
  if (wgan) {
    xg = take((long long)B * nd);
    p1g = take((long long)B * d1);
    h1g = take((long long)B * d1);
    p2g = take((long long)B * d2);
    gv = take((long long)B * d2);
    am = take((long long)B * d1);
    gvec = take((long long)B * nd);
    gt = take((long long)B * nd);
    dug = take((long long)B * d1);
    dvg = take((long long)B * d2);
  }
  if (use_cycle || use_stab) {
    for (int l = 0; l < 2; ++l) {
      const long long bc = (long long)B * gc[l];
      uc2[l] = take(bc); xh2[l] = take(bc); y2[l] = take(bc); a2[l] = take(bc);
      iv2[l] = take(gc[l]);
    }
    tn2 = take((long long)B * 4);
    dz2 = take((long long)B * 4);
  }
  if (use_cycle && !detach) drc = take((long long)B * S);
  if (use_cycle) gradC = take(Pg);
  if (use_stab) gradS = take(Pg);
  PerOut partial = take(kNormParts);
  if (pos > work_floats) return cudaErrorInvalidValue;

  const float slope = 0.2f, ln_eps = 1e-6f, bn_eps = 1e-5f;
  const float bn_mom = 0.9f, bn_one_minus = (float)(1.0 - 0.9);
  const float4 lo = make_float4((float)hp[14], (float)hp[15], (float)hp[16], (float)hp[17]);
  const float4 hi = make_float4((float)hp[18], (float)hp[19], (float)hp[20], (float)hp[21]);
  GLossCoef gk;
  gk.w_adv = (float)hp[0];
  gk.w_recon = (float)hp[1];
  gk.w_pmet = (float)hp[2];
  gk.w_maxwell = (float)hp[3];
  gk.w_lc = (float)hp[4];
  gk.w_range = (float)hp[5];
  gk.w_constraint = (float)hp[6];
  gk.w_window = (float)hp[7];
  gk.r_lo = (float)hp[8];
  gk.r_hi = (float)hp[9];
  for (int j = 0; j < 4; ++j) gk.half_span[j] = ((float)hp[18 + j] - (float)hp[14 + j]) * 0.5f;
  gk.f_lo = 0.5f;
  gk.f_hi = 3.0f;
  gk.detach = detach;
  const float lab_r = (float)hp[10], lab_f = (float)hp[11];
  AdamCoef ak;
  ak.clip = (float)hp[13];
  ak.b1 = 0.5f;
  ak.c1 = (float)(1.0 - 0.5);
  ak.b2 = 0.999f;
  ak.c2 = (float)(1.0 - 0.999);
  ak.eps = 1e-8f;

  cudaError_t e;
#define CHECK(call)                      \
  do {                                   \
    e = (call);                          \
    if (e != cudaSuccess) return (int)e; \
  } while (0)
#define CHECK_LAUNCH()         \
  do {                         \
    ++g_kernels_enqueued;      \
    CHECK(cudaGetLastError()); \
  } while (0)
// launch shapes, the member on the grid's y axis: columns of a (B, C) buffer
// 64 a block or 256 a block, n elements grid-strided, B rows a block each,
// one block per member
#define COLS(C) dim3(((C) + kColThreads - 1) / kColThreads, NM), kColThreads, 0, st
#define WIDE(C) dim3(((C) + kThreads - 1) / kThreads, NM), kThreads, 0, st
#define ELEMS(n) dim3(blocks_for((n), kThreads), NM), kThreads, 0, st
#define ROWS(R) dim3((R), NM), kThreads, 0, st
#define ONE() NM, kThreads, 0, st
// GEMM: an fp32 product (the TPU kernel's VPU sums); GEMM_ACC: GEMM added to
// its output; MM: a product whose operands the TPU kernel rounds to bfloat16
// (rounded when bf16); MM_ACC: MM added to its output
#define GEMM(AK, BNC, ...)                          \
  do {                                              \
    ++g_kernels_enqueued;                           \
    CHECK((gemm<AK, BNC>(__VA_ARGS__, st, NM)));    \
  } while (0)
#define GEMM_ACC(AK, BNC, ...)                                  \
  do {                                                          \
    ++g_kernels_enqueued;                                       \
    CHECK((gemm<AK, BNC, false, true>(__VA_ARGS__, st, NM)));   \
  } while (0)
#define MM(AK, BNC, ...)                                            \
  do {                                                              \
    ++g_kernels_enqueued;                                           \
    CHECK((gemm_ex<AK, BNC>(bf16, false, __VA_ARGS__, st, NM)));    \
  } while (0)
#define MM_ACC(AK, BNC, ...)                                        \
  do {                                                              \
    ++g_kernels_enqueued;                                           \
    CHECK((gemm_ex<AK, BNC>(bf16, true, __VA_ARGS__, st, NM)));     \
  } while (0)

  const PerIn F(f, 0);
  const PerIn none;
  g_kernels_enqueued = 0;

  // A second pass of G on x (B rows of S values, ldx apart) with the batch
  // statistics of that batch, the running stats untouched; its loss against
  // the first pass (row[1], dpn); its backward into the flat gradient grad2
  // and, with dx, its input gradient (B, S).  Uses da and dt as scratch.
  auto second_pass = [&](PerIn x, int ldx, float w, PerOut row, PerOut grad2,
                         PerOut dx) -> int {
    MM(true, false, B, g1, S, x, ldx, 1, g + gW1, 1, S, uc2[0], g1, g + gb1);
    bn_forward<<<COLS(g1)>>>(uc2[0], B, g1, g + ggam1, g + gbet1, xh2[0], y2[0], a2[0],
                             iv2[0], PerOut(), PerOut(), bn_eps, bn_mom, bn_one_minus);
    CHECK_LAUNCH();
    MM(true, false, B, g2, g1, a2[0], g1, 1, g + gW2, 1, g1, uc2[1], g2, g + gb2);
    bn_forward<<<COLS(g2)>>>(uc2[1], B, g2, g + ggam2, g + gbet2, xh2[1], y2[1], a2[1],
                             iv2[1], PerOut(), PerOut(), bn_eps, bn_mom, bn_one_minus);
    CHECK_LAUNCH();
    GEMM(true, false, B, 4, g2, a2[1], g2, 1, g + gW3, 1, g2, tn2, 4, g + gb3);
    second_pass_loss<<<ONE()>>>(tn2, pn, dz2, dpn, row, B, w, sigmoid);
    CHECK_LAUNCH();
    GEMM(false, true, 4, g2, B, dz2, 1, 4, a2[1], g2, 1, grad2 + gW3, g2, none);
    column_sum<<<WIDE(4)>>>(dz2, B, 4, grad2 + gb3);
    CHECK_LAUNCH();
    GEMM(true, true, B, g2, 4, dz2, 4, 1, g + gW3, g2, 1, da, g2, none);
    bn_backward<<<COLS(g2)>>>(da, y2[1], xh2[1], uc2[1], g + ggam2, iv2[1], B, g2, dt,
                              grad2 + ggam2, grad2 + gbet2);
    CHECK_LAUNCH();
    MM(false, true, g2, g1, B, dt, 1, g2, a2[0], g1, 1, grad2 + gW2, g1, none);
    column_sum<<<WIDE(g2)>>>(dt, B, g2, grad2 + gb2);
    CHECK_LAUNCH();
    MM(true, true, B, g1, g2, dt, g2, 1, g + gW2, g1, 1, da, g1, none);
    bn_backward<<<COLS(g1)>>>(da, y2[0], xh2[0], uc2[0], g + ggam1, iv2[0], B, g1, dt,
                              grad2 + ggam1, grad2 + gbet1);
    CHECK_LAUNCH();
    MM(false, true, g1, S, B, dt, 1, g1, x, ldx, 1, grad2 + gW1, S, none);
    column_sum<<<WIDE(g1)>>>(dt, B, g1, grad2 + gb1);
    CHECK_LAUNCH();
    if (dx.p) MM(true, true, B, S, g1, dt, g1, 1, g + gW1, S, 1, dx, S, none);
    return 0;
  };

  for (int t = 0; t < T; ++t) {
    const PerIn spec_t = spectra + (long long)t * B * S;
    const PerIn par_t = params + (long long)t * B * 4;
    const PerIn met_t = met + (long long)t * B * 8;
    const float* sc = sched + (long long)t * kSchedLanes;
    const PerOut row = rows + (long long)t * kRowWidth;
    // one gate for all members: they sit at the same step count
    const bool update_d = sc[6] > 0.f;

    // ---- G forward, shared by both phases --------------------------------
    MM(true, false, B, g1, S, spec_t, S, 1, g + gW1, 1, S, uc[0], g1, g + gb1);
    bn_forward<<<COLS(g1)>>>(uc[0], B, g1, g + ggam1, g + gbet1, xh[0], y[0], a[0], iv[0],
                             bn1_mean, bn1_var, bn_eps, bn_mom, bn_one_minus);
    CHECK_LAUNCH();
    MM(true, false, B, g2, g1, a[0], g1, 1, g + gW2, 1, g1, uc[1], g2, g + gb2);
    bn_forward<<<COLS(g2)>>>(uc[1], B, g2, g + ggam2, g + gbet2, xh[1], y[1], a[1], iv[1],
                             bn2_mean, bn2_var, bn_eps, bn_mom, bn_one_minus);
    CHECK_LAUNCH();
    GEMM(true, false, B, 4, g2, a[1], g2, 1, g + gW3, 1, g2, tn, 4, g + gb3);
    g_output<<<ELEMS((long long)B * nd)>>>(tn, pn, x0, spec_t, par_t, B, S, lo, hi, sigmoid);
    CHECK_LAUNCH();

    // ---- D phase on [real; fake] -----------------------------------------
    // with instance noise on a noised copy: the G phase below reads x0's
    // fake rows, which stay clean
    PerIn xd = x0;
    if (use_inoise) {
      add_instance_noise<<<ELEMS(2LL * B * nd)>>>(x0, inoise + (long long)t * 2 * B * S, x0n,
                                                  2 * B, S);
      CHECK_LAUNCH();
      xd = x0n;
    }
    MM(true, false, 2 * B, d1, nd, xd, nd, 1, d + dW1, 1, nd, p1, d1, d + db1);
    leaky_forward<<<ELEMS(2LL * B * d1)>>>(p1, h1, 2LL * B * d1, slope);
    CHECK_LAUNCH();
    MM(true, false, 2 * B, d2, d1, h1, d1, 1, d + dW2, 1, d1, p2, d2, d + db2);
    leaky_forward<<<ELEMS(2LL * B * d2)>>>(p2, h2, 2LL * B * d2, slope);
    CHECK_LAUNCH();
    GEMM(true, false, 2 * B, 1, d2, h2, d2, 1, d + dW3, 1, d2, z, 1, d + db3);
    if (wgan) {
      if (update_d) {
        // the penalty's pass at (clean spectra, eps-interpolated params),
        // with D before this step's update: gvec = dz/dx, masks constant
        gp_input<<<ELEMS((long long)B * nd)>>>(x0, eps + (long long)t * B, xg, B, S);
        CHECK_LAUNCH();
        MM(true, false, B, d1, nd, xg, nd, 1, d + dW1, 1, nd, p1g, d1, d + db1);
        leaky_forward<<<ELEMS((long long)B * d1)>>>(p1g, h1g, (long long)B * d1, slope);
        CHECK_LAUNCH();
        MM(true, false, B, d2, d1, h1g, d1, 1, d + dW2, 1, d1, p2g, d2, d + db2);
        gp_v<<<ELEMS((long long)B * d2)>>>(p2g, d + dW3, gv, B, d2, slope);
        CHECK_LAUNCH();
        MM(true, true, B, d1, d2, gv, d2, 1, d + dW2, d1, 1, am, d1, none);
        leaky_backward<<<ELEMS((long long)B * d1)>>>(am, p1g, (long long)B * d1, slope);
        CHECK_LAUNCH();
        MM(true, true, B, nd, d1, am, d1, 1, d + dW1, nd, 1, gvec, nd, none);
      }
      critic_loss_kernel<<<ONE()>>>(z, update_d ? PerIn(gvec) : none, B, nd, w_gp, dz, gt, row);
      CHECK_LAUNCH();
    } else {
      d_loss_kernel<<<ONE()>>>(z, B, lab_r, lab_f, dz, row);
      CHECK_LAUNCH();
    }
    if (update_d) {
      GEMM(false, true, 1, d2, 2 * B, dz, 1, 1, h2, d2, 1, gradD + dW3, d2, none);
      column_sum<<<WIDE(1)>>>(dz, 2 * B, 1, gradD + db3);
      CHECK_LAUNCH();
      d_head_backward<<<ELEMS(2LL * B * d2)>>>(dz, d + dW3, p2, dp2, 2 * B, d2, slope);
      CHECK_LAUNCH();
      MM(false, true, d2, d1, 2 * B, dp2, 1, d2, h1, d1, 1, gradD + dW2, d1, none);
      if (wgan) {
        column_sum_f64<<<WIDE(d2)>>>(dp2, 2 * B, d2, gradD + db2);
      } else {
        column_sum<<<WIDE(d2)>>>(dp2, 2 * B, d2, gradD + db2);
      }
      CHECK_LAUNCH();
      MM(true, true, 2 * B, d1, d2, dp2, d2, 1, d + dW2, d1, 1, dp1, d1, none);
      leaky_backward<<<ELEMS(2LL * B * d1)>>>(dp1, p1, 2LL * B * d1, slope);
      CHECK_LAUNCH();
      MM(false, true, d1, nd, 2 * B, dp1, 1, d1, xd, nd, 1, gradD + dW1, nd, none);
      if (wgan) {
        column_sum_f64<<<WIDE(d1)>>>(dp1, 2 * B, d1, gradD + db1);
      } else {
        column_sum<<<WIDE(d1)>>>(dp1, 2 * B, d1, gradD + db1);
      }
      CHECK_LAUNCH();
      if (wgan) {
        // the penalty's second-order backward: W1 twice, W2, w3; no bias
        MM(true, false, B, d1, nd, gt, nd, 1, d + dW1, 1, nd, dug, d1, none);
        leaky_backward<<<ELEMS((long long)B * d1)>>>(dug, p1g, (long long)B * d1, slope);
        CHECK_LAUNCH();
        MM(true, false, B, d2, d1, dug, d1, 1, d + dW2, 1, d1, dvg, d2, none);
        MM_ACC(false, true, d1, nd, B, am, 1, d1, gt, nd, 1, gradD + dW1, nd, none);
        MM_ACC(false, true, d2, d1, B, gv, 1, d2, dug, d1, 1, gradD + dW2, d1, none);
        gp_w3_grad<<<WIDE(d2)>>>(dvg, p2g, B, d2, slope, gradD + dW3);
        CHECK_LAUNCH();
      }
      sumsq_partial<<<ROWS(kNormParts)>>>(gradD, Pd, partial);
      CHECK_LAUNCH();
      ak.lr = sc[1];
      ak.inv1 = sc[4];
      ak.inv2 = sc[5];
      adam_update<<<ROWS(kAdamBlocks)>>>(d, d_m, d_v, gradD, Pd, partial, ak);
      CHECK_LAUNCH();
    }

    // ---- G phase: the fake rows through the updated D --------------------
    const PerIn fake_in = x0 + (long long)B * nd;
    MM(true, false, B, d1, nd, fake_in, nd, 1, d + dW1, 1, nd, p1, d1, d + db1);
    leaky_forward<<<ELEMS((long long)B * d1)>>>(p1, h1, (long long)B * d1, slope);
    CHECK_LAUNCH();
    MM(true, false, B, d2, d1, h1, d1, 1, d + dW2, 1, d1, p2, d2, d + db2);
    leaky_forward<<<ELEMS((long long)B * d2)>>>(p2, h2, (long long)B * d2, slope);
    CHECK_LAUNCH();
    GEMM(true, false, B, 1, d2, h2, d2, 1, d + dW3, 1, d2, z, 1, d + db3);
    if (wgan) {
      wgan_adv_kernel<<<ONE()>>>(z, B, dz, row);
    } else {
      adv_loss_kernel<<<ONE()>>>(z, B, dz, row);
    }
    CHECK_LAUNCH();
    d_head_backward<<<ELEMS((long long)B * d2)>>>(dz, d + dW3, p2, dp2, B, d2, slope);
    CHECK_LAUNCH();
    MM(true, true, B, d1, d2, dp2, d2, 1, d + dW2, d1, 1, dp1, d1, none);
    leaky_backward<<<ELEMS((long long)B * d1)>>>(dp1, p1, (long long)B * d1, slope);
    CHECK_LAUNCH();
    // only the four parameter columns of D's input gradient are needed
    MM(true, true, B, 4, d1, dp1, d1, 1, d + (dW1 + S), nd, 1, dpphys, 4, none);

    // ---- the frozen F, eval mode -------------------------------------------
    PerIn fa = pn;
    for (int l = 0; l < n_f_hidden; ++l) {
      const int din = f_dims[l], C = f_dims[l + 1];
      const long long* o = f_offsets + 4 * l;
      if (l == 0) {   // the TPU kernel's VPU sum over the 4 params: fp32
        GEMM(true, false, B, C, din, fa, din, 1, F + o[0], 1, din, tc[l], C, F + o[1]);
      } else {
        MM(true, false, B, C, din, fa, din, 1, F + o[0], 1, din, tc[l], C, F + o[1]);
      }
      ln_forward<<<ROWS(B)>>>(tc[l], ln[l], PerOut(), act[l], ivar[l], F + o[2], F + o[3], C,
                              ln_eps, slope, 0u, 0, 0u, 1.f);
      CHECK_LAUNCH();
      fa = act[l];
    }
    const int dh = f_dims[n_f_hidden];
    const long long* oh = f_offsets + 4 * n_f_hidden;
    if (bf16) {
      // the spectrum columns in bfloat16, the 8 metrics columns in fp32
      MM(true, false, B, S, dh, fa, dh, 1, F + oh[0], 1, dh, pred, D, F + oh[1]);
      GEMM(true, false, B, D - S, dh, fa, dh, 1, F + (oh[0] + (long long)S * dh), 1, dh,
           pred + S, D, F + (oh[1] + S));
    } else {
      GEMM(true, false, B, D, dh, fa, dh, 1, F + oh[0], 1, dh, pred, D, F + oh[1]);
    }

    // ---- losses and their seeds -------------------------------------------
    gk.c_scale = sc[7];
    g_loss_kernel<<<ONE()>>>(pred, spec_t, met_t, pn, dpphys, dpn, dpred, row, B, S, gk);
    CHECK_LAUNCH();

    // ---- the second G passes: cycle on F's spectrum, stability on the
    // noised stream; both before F's backward, which carries cycle's input
    // gradient on ----------------------------------------------------------
    if (use_cycle) {
      const int rc = second_pass(pred, D, w_cycle, row, gradC, detach ? PerOut() : drc);
      if (rc != 0) return rc;
      if (!detach) {
        add_columns<<<ELEMS((long long)B * S)>>>(dpred, D, drc, B, S);
        CHECK_LAUNCH();
      }
    }
    if (use_stab) {
      const int rc = second_pass(stab + (long long)t * B * S, S, w_stab, row, gradS, PerOut());
      if (rc != 0) return rc;
    }

    // ---- through F's input ---------------------------------------------------
    if (!detach) {
      if (bf16) {
        // the spectrum columns' term in bfloat16, then the metrics columns'
        MM(true, true, B, dh, S, dpred, D, 1, F + oh[0], dh, 1, da, dh, none);
        GEMM_ACC(true, true, B, dh, D - S, dpred + S, D, 1, F + (oh[0] + (long long)S * dh),
                 dh, 1, da, dh, none);
      } else {
        GEMM(true, true, B, dh, D, dpred, D, 1, F + oh[0], dh, 1, da, dh, none);
      }
      for (int l = n_f_hidden - 1; l >= 0; --l) {
        const int din = f_dims[l], C = f_dims[l + 1];
        const long long* o = f_offsets + 4 * l;
        ln_backward<<<ROWS(B)>>>(da, none, ln[l], tc[l], ivar[l], F + o[2], dln, dt, C, slope,
                                 0);
        CHECK_LAUNCH();
        if (l == 0) {   // the TPU kernel's VPU sums into the 4 params: fp32
          GEMM(true, true, B, din, C, dt, C, 1, F + o[0], din, 1, dfin, din, none);
        } else {
          MM(true, true, B, din, C, dt, C, 1, F + o[0], din, 1, da, din, none);
        }
      }
    }

    // ---- G backward -----------------------------------------------------------
    g_head_seed<<<ELEMS((long long)B * 4)>>>(dpn, detach ? none : PerIn(dfin), tn, pn, B * 4,
                                             sigmoid);
    CHECK_LAUNCH();
    GEMM(false, true, 4, g2, B, dpn, 1, 4, a[1], g2, 1, gradG + gW3, g2, none);
    column_sum<<<WIDE(4)>>>(dpn, B, 4, gradG + gb3);
    CHECK_LAUNCH();
    GEMM(true, true, B, g2, 4, dpn, 4, 1, g + gW3, g2, 1, da, g2, none);
    bn_backward<<<COLS(g2)>>>(da, y[1], xh[1], uc[1], g + ggam2, iv[1], B, g2, dt,
                              gradG + ggam2, gradG + gbet2);
    CHECK_LAUNCH();
    MM(false, true, g2, g1, B, dt, 1, g2, a[0], g1, 1, gradG + gW2, g1, none);
    column_sum<<<WIDE(g2)>>>(dt, B, g2, gradG + gb2);
    CHECK_LAUNCH();
    MM(true, true, B, g1, g2, dt, g2, 1, g + gW2, g1, 1, da, g1, none);
    bn_backward<<<COLS(g1)>>>(da, y[0], xh[0], uc[0], g + ggam1, iv[0], B, g1, dt,
                              gradG + ggam1, gradG + gbet1);
    CHECK_LAUNCH();
    MM(false, true, g1, S, B, dt, 1, g1, spec_t, S, 1, gradG + gW1, S, none);
    column_sum<<<WIDE(g1)>>>(dt, B, g1, gradG + gb1);
    CHECK_LAUNCH();
    if (use_cycle || use_stab) {
      // G's gradient is the sum over its passes: main, cycle, stability
      add_gradients<<<ELEMS(Pg)>>>(gradG, gradC, gradS, Pg);
      CHECK_LAUNCH();
    }
    sumsq_partial<<<ROWS(kNormParts)>>>(gradG, Pg, partial);
    CHECK_LAUNCH();
    ak.lr = sc[0];
    ak.inv1 = sc[2];
    ak.inv2 = sc[3];
    adam_update<<<ROWS(kAdamBlocks)>>>(g, g_m, g_v, gradG, Pg, partial, ak);
    CHECK_LAUNCH();
    if (ema_decay > 0.f) {
      ema_lerp<<<blocks_for(Pg, kThreads), kThreads, 0, st>>>(g_ema, g.p, Pg, ema_decay,
                                                               (float)(1.0 - hp[12]));
      CHECK_LAUNCH();
    }
  }
#undef MM_ACC
#undef GEMM_ACC
#undef MM
#undef GEMM
#undef ONE
#undef ROWS
#undef ELEMS
#undef WIDE
#undef COLS
#undef CHECK_LAUNCH
#undef CHECK
  return 0;
}

}  // namespace

extern "C" {

// The number of device kernels the last pigan_gan_train or
// pigan_gan_ensemble_train call of this process enqueued.
long long pigan_gan_kernels_enqueued() { return g_kernels_enqueued; }

// T training steps over one state in place (K2).
//   g, g_m, g_v    (Pg,) device, updated; layout W1 b1 gamma1 beta1 W2 b2
//                  gamma2 beta2 W3 b3, each W as (out, in)
//   d, d_m, d_v    (Pd,) device, updated; layout W1 b1 W2 b2 W3 b3
//   bn1_mean ...   G's BatchNorm running stats, device, updated
//   f              F's parameters in forward_train.cu's layout, read only
//   g_ema          (Pg,) device, updated when hp[12] > 0, else unused
//   spectra, params, met   (T, B, S), (T, B, 4) physical, (T, B, 8) device
//   inoise         (T, 2B, S) device, the D phase's instance noise, or null
//   stab           (T, B, S) device, the noised spectra of the stability
//                  pass; needed when hp[23] > 0, else null
//   eps            (T, B) device, WGAN-GP's interpolation weights (read on
//                  D-update steps); needed with flags bit 2, else null
//   sched          (T, 8) host: lr_g lr_d inv1_g inv2_g inv1_d inv2_d d_gate c_scale
//   rows           (T, 11) device out: d_loss g_loss d_accuracy adv recon
//                  metrics maxwell lc range violation_rate constraint
//   work           device scratch of work_floats floats
//   dims           host: S, g1, g2, d1, d2
//   f_dims         n_f_hidden + 2 widths of F (host); f_offsets 4 per layer
//   hp             host: w_adv w_recon w_pmet w_maxwell w_lc w_range
//                  w_constraint w_window range_lo range_hi label_real
//                  label_fake ema_decay clip lo[4] hi[4] w_cycle w_stability
//                  gp_weight
//   flags          bit 0 detach_forward, bit 1 sigmoid_squash, bit 2 WGAN-GP,
//                  bit 3 bfloat16 operands
int pigan_gan_train(float* g, float* g_m, float* g_v, float* d, float* d_m, float* d_v,
                    float* bn1_mean, float* bn1_var, float* bn2_mean, float* bn2_var,
                    const float* f, float* g_ema, const float* spectra,
                    const float* params, const float* met, const float* inoise,
                    const float* stab, const float* eps, const float* sched,
                    float* rows, float* work, long long work_floats, const int* dims,
                    const int* f_dims, int n_f_hidden, const long long* f_offsets, int B,
                    int T, const double* hp, int flags, void* stream_ptr) {
  return gan_train_steps(1, g, g_m, g_v, d, d_m, d_v, bn1_mean, bn1_var, bn2_mean, bn2_var, f,
                         g_ema, spectra, params, met, inoise, stab, eps, sched, rows, work,
                         work_floats, dims,
                         f_dims, n_f_hidden, f_offsets, B, T, hp, flags,
                         (cudaStream_t)stream_ptr);
}

// T training steps over the states of `members` ensemble members in place,
// all members in every launch (K3).  As pigan_gan_train, with a leading
// member axis on everything that differs by member, each contiguous:
//   g, g_m, g_v    (members, Pg);  d, d_m, d_v  (members, Pd)
//   bn1_mean, bn1_var (members, g1);  bn2_mean, bn2_var (members, g2)
//   spectra, params, met   (members, T, B, S), (members, T, B, 4), (members, T, B, 8)
//   inoise, stab   (members, T, 2B, S), (members, T, B, S), or null
//   eps            (members, T, B), or null
//   rows           (members, T, 11) out
//   work           members x work_floats floats: work_floats is one member's
// and shared by all members: f, sched (all members sit at the same step and
// optimiser counts), dims, hp, flags.  No EMA track: hp[12] must be 0.
int pigan_gan_ensemble_train(int members, float* g, float* g_m, float* g_v, float* d,
                             float* d_m, float* d_v, float* bn1_mean, float* bn1_var,
                             float* bn2_mean, float* bn2_var, const float* f,
                             const float* spectra, const float* params, const float* met,
                             const float* inoise, const float* stab, const float* eps,
                             const float* sched, float* rows, float* work,
                             long long work_floats, const int* dims, const int* f_dims,
                             int n_f_hidden, const long long* f_offsets, int B, int T,
                             const double* hp, int flags, void* stream_ptr) {
  if (hp[12] > 0.0) return cudaErrorInvalidValue;
  const int S = dims[0], g1 = dims[1], g2 = dims[2], d1 = dims[3], d2 = dims[4];
  const long long Pg = (long long)S * g1 + 3LL * g1 + (long long)g1 * g2 + 3LL * g2 + 4LL * g2 + 4;
  const long long Pd = (long long)(S + 4) * d1 + d1 + (long long)d1 * d2 + d2 + d2 + 1;
  const long long TB = (long long)T * B;
  return gan_train_steps(
      members, PerOut(g, Pg), PerOut(g_m, Pg), PerOut(g_v, Pg), PerOut(d, Pd), PerOut(d_m, Pd),
      PerOut(d_v, Pd), PerOut(bn1_mean, g1), PerOut(bn1_var, g1), PerOut(bn2_mean, g2),
      PerOut(bn2_var, g2), f, nullptr, PerIn(spectra, TB * S), PerIn(params, TB * 4),
      PerIn(met, TB * 8), inoise ? PerIn(inoise, 2 * TB * S) : PerIn(),
      stab ? PerIn(stab, TB * S) : PerIn(), eps ? PerIn(eps, TB) : PerIn(), sched,
      PerOut(rows, (long long)T * kRowWidth), work, work_floats,
      dims, f_dims, n_f_hidden, f_offsets, B, T, hp, flags, (cudaStream_t)stream_ptr);
}

}  // extern "C"
