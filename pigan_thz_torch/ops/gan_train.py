"""PI-GAN training in one launch per chunk: the port of the GAN half of
``pigan_thz_tpu/ops/megakernel.py`` (:87-127, :779-1953).

The TPU kernel ``_make_kernel`` (K2) runs E epochs of the fused D-then-G
step in one Pallas launch with G, D, their Adam moments and the frozen F
resident in VMEM.  Its counterpart here is ``csrc/gan_train.cu``: one C call
per chunk of T steps, which enqueues every step's kernels on the current
stream over the state's flat buffers in place.  Per step, at batch B:

- G's forward once for both phases: 2 x [Dense -> BatchNorm (flax's: batch
  variance max(0, E[x²] − E[x]²), eps 1e-5; the sums over the batch in
  float64) -> ReLU], Dense(4), tanh
  [, sigmoid on top with ``sigmoid_squash``]; the running stats move once,
  with the biased variance and momentum 0.9;
- D phase on [real; fake] (2B rows, the fake params gradient-blocked):
  2 x [Dense -> LeakyReLU 0.2], Dense(1); loss 2·mean BCE-with-logits
  against labels 0.9 / 0.1; backward; global-norm clip and Adam (b1 0.5)
  over D's six tensors.  With ``d_update_every`` = k > 1 only the steps
  whose global step count divides by k update D (and advance D's Adam
  count); the others run D's forward for the metrics only;
- G phase: the adversarial pass through the just-updated D (target 1,
  unsmoothed), the frozen F in eval mode on G's output, the losses
  (recon + physics spectrum MSE, metrics MSE, Maxwell smoothness, LC, range
  [, constraint x per-epoch scale][, window]) and their hand-derived
  adjoints: always the direct ones into G's output (adversarial, LC's G
  side, range, constraint), and, unless ``detach_forward``, the ones that
  reach G through F's input (recon, metrics, Maxwell, LC's F side, window);
  G's backward with the BatchNorm backward; clip and Adam over G's ten
  tensors; the EMA of G's parameters when ``ema_decay`` > 0;
- the second G passes (megakernel.py:1179-1242, :1274-1375): with
  ``cycle_w`` > 0 G runs again on F's spectrum, with ``stability_w`` > 0 on
  the noised spectra stream, each time with the batch statistics of that
  batch (the running stats stay), its own saved activations and the full
  BatchNorm backward.  The loss w · mean((second − first)²) over the four
  outputs joins ``g_loss``; it seeds the second pass's head and, with the
  other sign, the first pass's output.  G's gradient is the sum over its
  passes, added in a fixed order (main, cycle, stability).  Cycle's input
  gradient joins the spectrum columns of F's output gradient before F's
  backward, unless ``detach_forward``; stability's is dropped;
- instance noise: a (2B, S) stream added to the spectrum columns of D's
  input in the D phase only; the G phase's adversarial pass reads the clean
  fake rows;
- ``gan_loss="wgan_gp"`` (megakernel.py:986-1014, :1039-1053, :1068-1070): the
  critic loss mean(z_fake) − mean(z_real), D's seed ∓1/B, plus on D-update
  steps ``gp_weight`` · mean((‖∇ₓD‖ − 1)²) taken at (clean spectra,
  params interpolated with the ε stream), the norm sqrt(Σ gvec² + 1e-12)
  over all S + 4 input columns.  Its backward is hand-derived to second
  order with the LeakyReLU masks of the penalty's pass held constant, as
  XLA's autodiff treats them: dW1 += Gtᵀ·a_m (and a_mᵀ·Gt in the (out, in)
  layout), dW2 += dUᵀ·v, dW3 += Σ dV·m2g, no bias term.  A skipped D step
  reports the critic loss without the penalty.  G's adversarial seed is
  −1/B;
- ``compute_dtype="bfloat16"`` (megakernel.py:792-798, :840-857): the operands
  of exactly the products the TPU kernel writes as ``mm`` / ``dotT0`` /
  ``dotT1`` are rounded to bfloat16 (round to nearest even) and the products
  accumulate in float32.  The products the TPU kernel runs on the VPU in
  float32 stay float32: G's head 256→4 and its backward, D's head 256→1
  and its dW, F's input layer 4→256 and its input backward, and the 8
  metrics columns of F's head (forward and input backward), which the
  bfloat16 path computes apart from the spectrum columns and adds after.
  Parameters, Adam, the norm statistics and every elementwise op stay
  float32.

Everything the kernel reads besides the state is built outside it
(``build_streams``, the TPU kernel's ``_build_streams``): the gathered
batches of every step of the chunk, augmented when the augmentation knobs
are on (the recon target then is the augmented batch); the instance-noise
stream and the noised spectra of the stability pass; and the per-step
schedule lanes lr_g, lr_d, the two bias corrections of each optimiser at
that optimiser's own count, ``d_gate`` and the epoch's constraint scale.
The noise is drawn step by step as the eager step draws it
(``train/steps.py``: a CPU generator seeded with the step's seed;
augmentation, instance noise, the WGAN-GP ε on D-update steps only,
stability noise), so one seed gives the eager step and the kernel the same
step.

Every setting the TPU kernel computes in its body is taken.  What it refuses
(``adam_state_dtype="bfloat16"``, an XLA-path optimiser in the JAX package)
is a reason of ``supports_gan_kernel``; the eager step runs it.

``gan_train`` is the wrapper: for CUDA tensors it launches the kernel or
raises, for CPU tensors it runs ``gan_train_plain`` (the kernel's math in
torch ops with the hand-derived backward and no autograd), the port's
analogue of Pallas interpret mode.  ``LAUNCHES["gan_train"]`` counts
launches, one per chunk.

Batch-row products.  Every product of the step whose rows are the batch
(B or 2B rows: G's, D's and F's forward layers and input gradients) goes
through the kernel of ``csrc/brow_gemm.cuh``: split-K across a thread-block
cluster, the partial tiles summed in rank order through distributed shared
memory, a ``cp.async`` ring, fp32 FMAs or bf16 ``mma.sync`` on bfloat16
operands.  ``brow_products`` lists a step's such products; the kernel's
Python side (``brow_plan``, ``brow_gemm_plain``, ``brow_gemm``, ...) lives
in ``brow.py``, which K1 shares, and is re-exported here.

Seed ensembles (K3).  The member-packed path of the same TPU kernel
(``_make_kernel(members=M)``, launched by ``make_pallas_ensemble_fn``,
:1956-2224) trains M independent members in one launch against one shared
frozen F and one shared schedule.  Its counterpart is the second entry
point of ``csrc/gan_train.cu``: every kernel of the step takes the member
from a grid axis, over the stacked (M, ...) buffers of
``parallel/state_utils.EnsembleState``.  ``gan_ensemble_train`` is its
wrapper (``LAUNCHES["gan_ensemble_train"]``, one launch per chunk whatever
M is), ``gan_ensemble_train_plain`` its plain version, a loop of
``gan_train_plain`` over the members' rows, and ``make_gan_ensemble_fn`` the
multi-epoch function.  Member m's rows and state are bit for bit those of
``gan_train`` on that member alone with the same streams.  It takes what
``gan_train`` takes, less the EMA.  What bounds M is memory: a chunk's
streams are M x E x spe x B x 262 floats on the card (25 MB a member at
25 epochs of 15 steps, B = 64), and with instance noise and stability on
up to M x E x spe x 3B x S floats more (18 M floats, 72 MB, a member there:
288 MB at M = 4), beside ~13 MB a member of state, gradients and scratch
(~17 MB with both second passes).  From M = 4 on the members' working sets no longer fit the
50 MB L2 together; the kernel's time does not show it (PERF.md).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch

from ..config import PiGanConfig
from ..data.dataset import ThzDataset
from ._cuda_build import BROW_LAUNCHES, LAUNCHES, check_capability, launch
from .brow import (  # noqa: F401  (re-exported: gan_train.brow_* as before)
    BROW_MAX_SPLIT, BROW_MIN_DEPTH, BROW_STAGES, BROW_TILE, H100_SMS, BrowPlan, BrowProduct,
    bf16_rounder, brow_gemm, brow_gemm_plain, brow_kernels_enqueued, brow_plan,
    brow_plan_on_card)
from .forward_train import BASELINE_HIDDEN, ForwardTrainSpec, resolve_draws

GD_HIDDEN = (512, 256)
METRIC_KEYS = (
    "d_loss", "g_loss", "d_accuracy", "adv_loss", "recon_spec_loss",
    "recon_metrics_loss", "maxwell_loss", "lc_loss", "param_range_loss",
    "violation_rate",
)
ROW_WIDTH = len(METRIC_KEYS) + 1     # + constraint_loss (0 when off)
SCHED_LANES = ("lr_g", "lr_d", "inv1_g", "inv2_g", "inv1_d", "inv2_d", "d_gate", "c_scale")
_B1, _B2, _EPS = 0.5, 0.999, 1e-8
_BN_EPS, _LN_EPS, _BN_MOM = 1e-5, 1e-6, 0.9
_SLOPE = 0.2
_F_LO, _F_HI = 0.5, 3.0      # physics_window_loss's window as the step calls it
_NORM_PARTS = 256            # blocks of the kernel's first gradient-norm pass


# ---------------------------------------------------------------------------
# Support envelope
# ---------------------------------------------------------------------------


def supports_gan_kernel(cfg: PiGanConfig, settings) -> str | None:
    """None when the kernel trains (cfg, settings) exactly, else the reason
    it does not: a configuration outside the kernel family's envelope
    (``supports_megakernel`` without the TPU's batch % 8 tiling), or bfloat16
    Adam moments, which the JAX package's kernels refuse too."""
    s = settings
    if cfg.generator.name != "mlp" or tuple(cfg.generator.hidden_dims) != GD_HIDDEN:
        return "generator is not the baseline MLP(512,256)"
    if cfg.generator.norm != "batch":
        return "generator norm is not batchnorm"
    if cfg.discriminator.name != "mlp" or tuple(cfg.discriminator.hidden_dims) != GD_HIDDEN:
        return "discriminator is not the baseline MLP(512,256)"
    if cfg.forward_model.name != "mlp" or tuple(cfg.forward_model.hidden_dims) != (
        BASELINE_HIDDEN
    ):
        return "forward model is not the baseline MLP"
    if cfg.train.compute_dtype not in ("float32", "bfloat16"):
        return f"compute_dtype {cfg.train.compute_dtype!r} unsupported"
    if cfg.train.adam_state_dtype != "float32":
        return ("adam_state_dtype != float32 (bfloat16 Adam moments are the eager "
                "step's, as in the JAX package)")
    if cfg.data.param_dim != 4 or cfg.data.metrics_dim != 8:
        return "non-default param/metrics dims"
    if cfg.discriminator.leaky_slope != _SLOPE or cfg.forward_model.leaky_slope != _SLOPE:
        return "non-default leaky_slope (the kernel hardcodes 0.2)"
    if cfg.train.grad_clip <= 0:
        return "grad_clip <= 0 (the kernel assumes the clip stage exists)"
    if cfg.data.spectrum_dim < 3:
        return "spectrum_dim < 3"
    if s.gan_loss not in ("bce", "wgan_gp"):
        return f"gan_loss {s.gan_loss!r} unsupported"
    if s.d_update_every < 1:
        return "d_update_every < 1"
    # kl_w needs nothing: bnn_kl_loss is identically zero
    return None


# ---------------------------------------------------------------------------
# Network description
# ---------------------------------------------------------------------------


def _offsets(dims: Sequence[int], norm: bool) -> tuple[tuple[int, ...], int]:
    """Float offsets of each layer's tensors in a flat buffer that follows
    ``named_parameters()``: (W, b) per layer, W as (out, in), and with
    ``norm`` the norm's weight and bias after each hidden layer's.  Returns
    (the offsets, flattened, 4 or 2 per layer, -1 where the head has no
    norm; the parameter count)."""
    out, pos = [], 0
    last = len(dims) - 2
    for l in range(len(dims) - 1):
        din, dout = dims[l], dims[l + 1]
        out += [pos, pos + din * dout]
        pos += din * dout + dout
        if norm:
            out += [pos, pos + dout] if l < last else [-1, -1]
            pos += 2 * dout if l < last else 0
    return tuple(out), pos


@dataclass(frozen=True)
class GanTrainSpec:
    """What the kernel computes: the trio's widths, the loss weights, the
    step's semantics, the clip and the constants."""

    spectrum_dim: int = 250
    g_hidden: tuple[int, int] = GD_HIDDEN
    d_hidden: tuple[int, int] = GD_HIDDEN
    f_hidden: tuple[int, ...] = BASELINE_HIDDEN
    adv_w: float = 1.0
    recon_w: float = 110.0           # recon + physics spectrum (double count)
    pmet_w: float = 1.0
    maxwell_w: float = 1.0
    lc_w: float = 1.0
    range_w: float = 0.1
    constraint_w: float = 0.0
    window_w: float = 0.0
    range_lo: float = 0.0
    range_hi: float = 1.0
    label_real: float = 0.9
    label_fake: float = 0.1
    detach_forward: bool = True
    sigmoid_squash: bool = False
    ema_decay: float = 0.0
    clip: float = 1.0
    cycle_w: float = 0.0             # second G pass on F's spectrum
    stability_w: float = 0.0         # second G pass on the noised stream
    use_inoise: bool = False         # the D phase reads the instance-noise stream
    wgan: bool = False               # gan_loss="wgan_gp": critic loss + gradient penalty
    gp_weight: float = 10.0
    bf16: bool = False               # bfloat16 operands of the TPU kernel's MXU products

    @property
    def g_dims(self) -> tuple[int, ...]:
        return (self.spectrum_dim, *self.g_hidden, 4)

    @property
    def d_dims(self) -> tuple[int, ...]:
        return (self.spectrum_dim + 4, *self.d_hidden, 1)

    @property
    def f_spec(self) -> ForwardTrainSpec:
        return ForwardTrainSpec(dims=(4, *self.f_hidden, self.spectrum_dim + 8),
                                spectrum_dim=self.spectrum_dim)

    @property
    def g_offsets(self) -> tuple[int, ...]:
        return _offsets(self.g_dims, True)[0]

    @property
    def d_offsets(self) -> tuple[int, ...]:
        return _offsets(self.d_dims, False)[0]

    @property
    def num_g(self) -> int:
        return _offsets(self.g_dims, True)[1]

    @property
    def num_d(self) -> int:
        return _offsets(self.d_dims, False)[1]

    def g_views(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """G's ten tensors as views into its flat buffer: W1, b1, gamma1,
        beta1, W2, b2, gamma2, beta2, W3, b3 (W as (out, in))."""
        dims, o = self.g_dims, self.g_offsets
        out = []
        for l in range(3):
            din, dout = dims[l], dims[l + 1]
            out.append(flat[o[4 * l]: o[4 * l] + din * dout].view(dout, din))
            out.append(flat[o[4 * l + 1]: o[4 * l + 1] + dout])
            if l < 2:
                out.append(flat[o[4 * l + 2]: o[4 * l + 2] + dout])
                out.append(flat[o[4 * l + 3]: o[4 * l + 3] + dout])
        return out

    def d_views(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """D's six tensors as views into its flat buffer: W1, b1, W2, b2, W3, b3."""
        dims, o = self.d_dims, self.d_offsets
        out = []
        for l in range(3):
            din, dout = dims[l], dims[l + 1]
            out.append(flat[o[2 * l]: o[2 * l] + din * dout].view(dout, din))
            out.append(flat[o[2 * l + 1]: o[2 * l + 1] + dout])
        return out

    # G's two Dense biases feed BatchNorm, which removes any per-column
    # constant: their true gradient is zero, the computed one is rounding
    # noise, and Adam's normalisation turns that into steps of ±lr ("gauge
    # leaves").  They move nothing downstream and are left out of parameter
    # comparisons.
    def gauge_mask(self, device: torch.device | str) -> torch.Tensor:
        """(num_g,) bool, True on the gauge leaves of G's flat buffer."""
        mask = torch.zeros(self.num_g, dtype=torch.bool, device=device)
        dims, o = self.g_dims, self.g_offsets
        for l in range(2):
            mask[o[4 * l + 1]: o[4 * l + 1] + dims[l + 1]] = True
        return mask


def gan_train_spec(cfg: PiGanConfig, settings) -> GanTrainSpec:
    """The kernel's description of (cfg, settings); where
    ``supports_gan_kernel`` gives a reason it raises ``ValueError``."""
    reason = supports_gan_kernel(cfg, settings)
    if reason is not None:
        raise ValueError(f"GAN-training kernel unsupported here: {reason}")
    s = settings
    return GanTrainSpec(
        spectrum_dim=cfg.data.spectrum_dim,
        g_hidden=tuple(cfg.generator.hidden_dims),
        d_hidden=tuple(cfg.discriminator.hidden_dims),
        f_hidden=tuple(cfg.forward_model.hidden_dims),
        adv_w=float(s.adv_w), recon_w=float(s.recon_w + s.physics_spec_w),
        pmet_w=float(s.physics_metrics_w), maxwell_w=float(s.maxwell_w),
        lc_w=float(s.lc_w), range_w=float(s.range_w),
        constraint_w=float(s.constraint_w), window_w=float(s.window_w),
        range_lo=float(s.range_lo), range_hi=float(s.range_hi),
        label_real=float(s.label_real), label_fake=float(s.label_fake),
        detach_forward=bool(s.detach_forward), sigmoid_squash=bool(s.sigmoid_squash),
        ema_decay=float(s.ema_decay), clip=float(cfg.train.grad_clip),
        cycle_w=float(s.cycle_w), stability_w=float(s.stability_w),
        use_inoise=float(s.instance_noise) > 0.0,
        wgan=s.gan_loss == "wgan_gp", gp_weight=float(s.gp_weight),
        bf16=cfg.train.compute_dtype == "bfloat16",
    )


# ---------------------------------------------------------------------------
# State buffers and streams
# ---------------------------------------------------------------------------


class GanBuffers(NamedTuple):
    """The memory a chunk updates in place (all on one device)."""

    g: torch.Tensor            # (num_g,) G's parameters
    g_m: torch.Tensor
    g_v: torch.Tensor
    d: torch.Tensor            # (num_d,) D's parameters
    d_m: torch.Tensor
    d_v: torch.Tensor
    bn: tuple                  # running mean, var of BatchNorm 1, then of 2
    f: torch.Tensor            # F's parameters, read only
    g_ema: torch.Tensor | None


def state_buffers(state) -> GanBuffers:
    """A ``PiGanState``'s buffers, as the kernel takes them."""
    bn = tuple(t for m in state.batch_norms() for t in (m.running_mean, m.running_var))
    return GanBuffers(state.g_params, state.g_opt.m, state.g_opt.v, state.d_params,
                      state.d_opt.m, state.d_opt.v, bn, state.f_params, state.g_ema)


class GanStreams(NamedTuple):
    """One chunk's inputs, T = E · spe steps.  For an ensemble the batch
    and noise streams carry a leading member axis, (M, T, B, ·); the
    schedule and the bounds are shared."""

    spectra: torch.Tensor       # (T, B, S) on the state's device; augmented when on
    params: torch.Tensor        # (T, B, 4) physical units
    metrics_norm: torch.Tensor  # (T, B, 8)
    sched: torch.Tensor         # (T, 8) float32 on the CPU: SCHED_LANES
    param_lo: torch.Tensor      # (4,) float32 on the CPU
    param_hi: torch.Tensor      # (4,)
    inoise: torch.Tensor | None = None   # (T, 2B, S) sigma · N(0, 1), the D phase's
    stab: torch.Tensor | None = None     # (T, B, S) spectra + sigma · N(0, 1)
    eps: torch.Tensor | None = None      # (T, B, 1) U(0, 1), WGAN-GP; 0 on skipped D steps


def _noise_streams(spectra: torch.Tensor, seeds: torch.Tensor, gate: torch.Tensor,
                   settings, draws):
    """One member's stochastic streams from its gathered (T, B, S) spectra:
    (spectra, augmented when on; inoise or None; stab or None; eps or
    None).  Step t draws from a CPU generator seeded with ``seeds[t]`` in
    the eager step's order (``train/steps.py``): the augmentation, the
    instance noise, the WGAN-GP ε (only where ``gate[t]``, the steps that
    update D: a skipped step draws none, so the stability noise after it
    comes from another place of the generator), the stability noise;
    ``draws[t]`` may give the two noises at unit scale and ε instead, as it
    may give them to the eager step."""
    from .augment import augment_spectra

    steps, batch, width = spectra.shape
    dev = spectra.device
    sigma_in, sigma_st = float(settings.instance_noise), float(settings.stability_noise)
    use_in, use_st = sigma_in > 0.0, float(settings.stability_w) > 0.0
    wgan = settings.gan_loss == "wgan_gp"
    augmented, inoise, stab_noise, eps = [], [], [], []
    for t in range(steps):
        gen = torch.Generator().manual_seed(int(seeds[t]))
        given = {} if draws is None else draws[t]

        def draw(name, shape, uniform=False):
            if name in given:
                return given[name].to("cpu", torch.float32)
            return (torch.rand if uniform else torch.randn)(shape, generator=gen)

        if settings.augments:
            augmented.append(augment_spectra(
                gen, spectra[t], noise_level=settings.augment_noise,
                freq_shift=settings.augment_shift, amp_scale=settings.augment_scale))
        if use_in:
            inoise.append(sigma_in * draw("instance_noise", (2 * batch, width)))
        if wgan:
            eps.append(draw("gp_eps", (batch, 1), uniform=True) if int(gate[t])
                       else torch.zeros((batch, 1)))
        if use_st:
            stab_noise.append(sigma_st * draw("stability_noise", (batch, width)))
    if settings.augments:
        spectra = torch.stack(augmented).contiguous()
    return (spectra,
            torch.stack(inoise).to(dev).contiguous() if use_in else None,
            (spectra + torch.stack(stab_noise).to(dev)).contiguous() if use_st else None,
            torch.stack(eps).to(dev).contiguous() if wgan else None)


def build_streams(ds: ThzDataset, indices: torch.Tensor, scales: torch.Tensor,
                  step: int, g_count: int, d_count: int, d_update_every: int,
                  g_schedule, d_schedule, *, settings=None,
                  seeds: torch.Tensor | None = None, draws=None) -> GanStreams:
    """Gather every step's batch and precompute the per-step schedule lanes
    of a chunk that starts at global step ``step`` with the optimisers at
    ``g_count`` and ``d_count``.  G and D count separately: with
    ``d_update_every`` = k > 1, D's count advances only on the steps whose
    global step divides by k (``d_gate`` 1), so its learning rate and bias
    corrections are read at the number of updates it has really taken.
    ``indices`` is (E, spe, B), or (M, E, spe, B) for M ensemble members at
    the same counts: the batch streams then are (M, T, B, ·).

    With ``settings`` (a ``StepSettings``) whose augmentation, instance
    noise, stability term or WGAN-GP is on, the spectra stream is the
    augmented one and the ``inoise`` / ``stab`` / ``eps`` streams are built,
    from ``seeds`` (T,) or (M, T), the chunk's step seeds, and optionally
    ``draws``, one mapping per step (per member a sequence of them): see
    ``_noise_streams``."""
    epochs, spe, batch = indices.shape[-3:]
    steps = epochs * spe
    idx = indices.reshape(*indices.shape[:-3], steps, batch).to(ds.spectra.device)
    t = torch.arange(steps, dtype=torch.int64)
    if d_update_every > 1:
        gate = ((step + t) % d_update_every == 0).to(torch.int64)
        before = torch.cumsum(gate, 0) - gate
    else:
        gate, before = torch.ones_like(t), t
    tg, td = g_count + t, d_count + before
    tgf, tdf = (tg + 1).to(torch.float32), (td + 1).to(torch.float32)
    b1 = torch.tensor(_B1, dtype=torch.float32)
    b2 = torch.tensor(_B2, dtype=torch.float32)
    sched = torch.stack([
        g_schedule(tg).to(torch.float32), d_schedule(td).to(torch.float32),
        1.0 / (1.0 - torch.pow(b1, tgf)), 1.0 / (1.0 - torch.pow(b2, tgf)),
        1.0 / (1.0 - torch.pow(b1, tdf)), 1.0 / (1.0 - torch.pow(b2, tdf)),
        gate.to(torch.float32),
        torch.repeat_interleave(torch.as_tensor(scales, dtype=torch.float32).cpu(), spe),
    ], dim=1)
    spectra, inoise, stab, eps = ds.spectra[idx].contiguous(), None, None, None
    if settings is not None and (settings.augments or float(settings.instance_noise) > 0.0
                                 or float(settings.stability_w) > 0.0
                                 or settings.gan_loss == "wgan_gp"):
        if seeds is None:
            raise ValueError("build_streams: the stochastic settings need the steps' seeds")
        seeds = torch.as_tensor(seeds, dtype=torch.int64).cpu()
        if tuple(seeds.shape) != tuple(idx.shape[:-1]):
            raise ValueError(f"seeds {tuple(seeds.shape)}, expected {tuple(idx.shape[:-1])}")
        if idx.ndim == 2:
            spectra, inoise, stab, eps = _noise_streams(spectra, seeds, gate, settings, draws)
        else:
            per = [_noise_streams(spectra[m], seeds[m], gate, settings,
                                  None if draws is None else draws[m])
                   for m in range(idx.shape[0])]
            spectra, inoise, stab, eps = (
                None if col[0] is None else torch.stack(col).contiguous()
                for col in zip(*per))
    return GanStreams(
        spectra, ds.params[idx].contiguous(),
        ds.metrics_norm[idx].contiguous(), sched.contiguous(),
        ds.param_lo.to("cpu", torch.float32), ds.param_hi.to("cpu", torch.float32),
        inoise, stab, eps)


def to_double(x):
    """A ``GanBuffers`` or ``GanStreams`` with every tensor in float64: the
    plain version then computes the step in double precision, the yardstick
    that tells a float32 implementation's rounding from an error."""
    return type(x)(*(
        None if t is None else tuple(u.double() for u in t) if isinstance(t, tuple)
        else t.double() for t in x))


def _parts(bufs: GanBuffers, keep: torch.Tensor) -> dict[str, torch.Tensor]:
    """A ``GanBuffers``' updated memory by part, in float64, G's parts
    without the gauge leaves."""
    out = {"g": bufs.g[keep], "d": bufs.d, "g_m": bufs.g_m[keep], "d_m": bufs.d_m,
           "g_v": bufs.g_v[keep], "d_v": bufs.d_v, "bn": torch.cat(list(bufs.bn))}
    if bufs.g_ema is not None:
        out["ema"] = bufs.g_ema[keep]
    return {k: t.double() for k, t in out.items()}


def state_diffs(a: GanBuffers, b: GanBuffers, start: GanBuffers,
                spec: GanTrainSpec) -> dict[str, tuple[float, float]]:
    """How far two runs ``a`` and ``b`` of the same steps from ``start`` are
    apart, by part: {part: (max |a - b|, ‖a - b‖₂ / ‖b - start‖₂)} for G's
    and D's parameters (``g``, ``d``), Adam's moments (``g_m``, ``g_v``,
    ``d_m``, ``d_v``), the BatchNorm running stats (``bn``) and the EMA
    (``ema``), G's parts without the gauge leaves.  The distance is measured
    against what the steps changed, not against the state's own norm, which
    a few steps at a small learning rate hardly move."""
    keep = ~spec.gauge_mask(a.g.device)
    pa, pb, p0 = (_parts(x, keep) for x in (a, b, start))
    out = {}
    for k in pa:
        if k in pb and k in p0:
            moved = torch.linalg.norm(pb[k] - p0[k]).clamp(min=1e-30)
            out[k] = (float((pa[k] - pb[k]).abs().max()),
                      float(torch.linalg.norm(pa[k] - pb[k]) / moved))
    return out


def step_errors(got: GanBuffers, exact: GanBuffers, start: GanBuffers,
                spec: GanTrainSpec) -> dict[str, float]:
    """The error of a float32 run ``got`` against the float64 run ``exact``
    of the same few steps from ``start``, tensor by tensor and relative to
    what the steps changed: {"g_m[0]": ‖got - exact‖₂ / ‖exact - start‖₂,
    ...} over Adam's two moments (``m``, ``v``) and the parameter update
    (``p``) of each of G's tensors outside the gauge leaves and of D's, the
    EMA's update (``ema``) and the BatchNorm stats' (``bn``).

    Adam divides each entry's first moment by the root of its second, so an
    entry whose gradients are at the rounding level can step by up to the
    learning rate in either direction whatever the implementation.  Each
    tensor is therefore read where float64's second moment is above 1e-6 of
    the tensor's mean (gradients above 1e-3 of the root mean square): there
    the update is a smooth function of the gradient, and a wrong learning
    rate, eps, bias correction or decay shows at its full size."""
    out = {}

    def rel(x, y, y0, mask):
        moved = torch.linalg.norm((y - y0)[mask])
        if float(moved) > 0.0:
            return float(torch.linalg.norm((x.double() - y)[mask]) / moved)
        return float(torch.linalg.norm((x.double() - y)[mask]))

    for name, views in (("g", spec.g_views), ("d", spec.d_views)):
        fields = [("m", f"{name}_m"), ("v", f"{name}_v"), ("p", name)]
        if name == "g" and exact.g_ema is not None:
            fields.append(("ema", "g_ema"))
        v_exact = views(getattr(exact, f"{name}_v"))
        for short, field in fields:
            triples = zip(*(views(getattr(b, field)) for b in (got, exact, start)))
            for j, (x, y, y0) in enumerate(triples):
                if name == "g" and j in (1, 5):      # the gauge leaves
                    continue
                mask = v_exact[j] > 1e-6 * v_exact[j].mean()
                if bool(mask.any()):
                    out[f"{name}_{short}[{j}]"] = rel(x, y, y0, mask)
    for j, (x, y, y0) in enumerate(zip(got.bn, exact.bn, start.bn)):
        out[f"bn[{j}]"] = rel(x, y, y0, torch.ones_like(y, dtype=torch.bool))
    return out


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _leaky(x):
    return torch.where(x >= 0.0, x, _SLOPE * x)


def _leaky_mask(x):
    # in x's own type: two Python scalars would make a float32 mask, whose
    # 0.2 is 1.5e-8 off in the float64 mode
    return torch.where(x >= 0.0, torch.ones_like(x), torch.full_like(x, _SLOPE))


def _bn_forward(u, gamma, beta):
    """flax's train-mode BatchNorm + ReLU: (mean, var, 1/sigma, xhat, y,
    relu(y)).  The column sums are taken in float64, as the kernel takes
    them: E[x²] − E[x]² cancels, and float32 sums would lose what the
    difference keeps."""
    ud = u.double()
    mean = ud.mean(dim=0, keepdim=True)
    var = torch.clamp((ud * ud).mean(dim=0, keepdim=True) - mean * mean, min=0.0).to(u.dtype)
    mu = mean.to(u.dtype)
    iv = torch.rsqrt(var + _BN_EPS)
    xh = (u - mu) * iv
    y = xh * gamma + beta
    return mu, var, iv, xh, y, torch.clamp(y, min=0.0)


def _bn_backward(da, y, xh, u_c, iv, gamma):
    """Adjoint of ReLU(BatchNorm(u)): (du, dgamma, dbeta); u_c = u - mean.
    Column sums in float64, as in the forward."""
    b = da.shape[0]
    dy = da * (y > 0.0).to(da.dtype)
    dgam = torch.sum(dy.double() * xh.double(), dim=0).to(da.dtype)
    dbet = torch.sum(dy.double(), dim=0).to(da.dtype)
    dyg = dy * gamma
    dt = dyg * iv
    sv = torch.sum(dyg.double() * u_c.double(), dim=0, keepdim=True).to(da.dtype)
    dvar = sv * (-0.5) * iv * iv * iv
    mean_dt = dt.double().mean(dim=0, keepdim=True).to(da.dtype)
    du = dt - mean_dt + dvar * 2.0 * u_c / b
    return du, dgam, dbet


def _softplus_neg_abs(z):
    return torch.log1p(torch.exp(-z.abs()))


def _clip_adam_(p, m, v, g, lr, inv1, inv2, clip):
    norm = torch.sqrt(torch.sum(g * g))
    g = g * torch.where(norm < clip, 1.0, clip / norm)
    m.copy_(_B1 * m + (1.0 - _B1) * g)
    v.copy_(_B2 * v + (1.0 - _B2) * g * g)
    p.sub_(lr * (m * inv1) / (torch.sqrt(v * inv2) + _EPS))


# Deliberately wrong variants of the plain version, one per path: a check
# that holds the kernel (or the eager step) against the plain version must
# fail against each, else it could not have seen that fault in the kernel.
FAULTS = (
    "second_pass_moves_running_stats",   # a second G pass updates the BatchNorm stats
    "cycle_seed_dropped",                # cycle's adjoint into the first pass's output
    "stability_seed_dropped",            # stability's adjoint into the first pass's output
    "drecon_c_when_detached",            # cycle's input gradient through F although detached
    "noised_fake_rows",                  # the G phase reads the D phase's noised fake rows
    "wgan_gp_w1_second_term_dropped",    # the penalty's dW1 += a_m^T Gt left out
    "wgan_gp_seed_sign",                 # the penalty's seed with the wrong sign
    "bf16_head_rounded",                 # G's 256->4 head product rounded to bfloat16
    "bf16_hidden_fp32",                  # D's first-layer product left in float32
    "bf16_backward_fp32",                # D's backward product dp2 . W2 left in float32
)


@torch.no_grad()
def gan_train_plain(bufs: GanBuffers, streams: GanStreams, spec: GanTrainSpec,
                    faults: Sequence[str] = ()) -> torch.Tensor:
    """The kernel's math in torch ops, with its hand-derived backward and no
    autograd: T steps over ``bufs`` in place.  Returns the (T, 11) per-step
    rows: ``METRIC_KEYS`` then ``constraint_loss`` (0 when off).  ``faults``
    (names of ``FAULTS``) makes it wrong on purpose, for checks of checks.

    With ``spec.bf16`` the operands of the products the TPU kernel runs on
    its MXU are rounded to bfloat16 (``bf16_rounder``) before each product, in
    float64 mode too: the float64 run then accumulates the same rounded
    operands in double."""
    unknown = set(faults) - set(FAULTS)
    if unknown:
        raise ValueError(f"unknown faults {sorted(unknown)}: use {FAULTS}")
    rb = bf16_rounder(spec.bf16)
    rb_head = rb if "bf16_head_rounded" in faults else (lambda x: x)
    rb_d1 = (lambda x: x) if "bf16_hidden_fp32" in faults else rb
    rb_back = (lambda x: x) if "bf16_backward_fp32" in faults else rb
    steps, B, S = streams.spectra.shape
    dev = bufs.g.device
    fs = spec.f_spec
    nh = fs.n_hidden
    gW1, gb1, gam1, bet1, gW2, gb2, gam2, bet2, gW3, gb3 = spec.g_views(bufs.g)
    dW1, db1, dW2, db2, dW3, db3 = spec.d_views(bufs.d)
    g_grad, d_grad = torch.empty_like(bufs.g), torch.empty_like(bufs.d)
    ggW1, ggb1, ggam1, gbet1, ggW2, ggb2, ggam2, gbet2, ggW3, ggb3 = spec.g_views(g_grad)
    gdW1, gdb1, gdW2, gdb2, gdW3, gdb3 = spec.d_views(d_grad)
    rm1, rv1, rm2, rv2 = bufs.bn
    dtype = bufs.g.dtype        # float32; float64 through ``to_double``
    rows = torch.zeros((steps, ROW_WIDTH), dtype=dtype, device=dev)
    sched = streams.sched.to(device=dev, dtype=dtype)
    lo = streams.param_lo.to(dev)
    hi = streams.param_hi.to(dev)
    half_span = (hi - lo) * 0.5
    labels = torch.cat([torch.full((B, 1), spec.label_real, dtype=dtype, device=dev),
                        torch.full((B, 1), spec.label_fake, dtype=dtype, device=dev)])

    def update_running_stats(mu1, var1, mu2, var2):
        rm1.copy_(_BN_MOM * rm1 + (1.0 - _BN_MOM) * mu1[0])
        rv1.copy_(_BN_MOM * rv1 + (1.0 - _BN_MOM) * var1[0])
        rm2.copy_(_BN_MOM * rm2 + (1.0 - _BN_MOM) * mu2[0])
        rv2.copy_(_BN_MOM * rv2 + (1.0 - _BN_MOM) * var2[0])

    def second_pass(x, pn, weight):
        """G again on ``x`` with that batch's statistics, against the first
        pass's output ``pn``: (loss, its adjoint at the second output (the
        first output takes the negative), the flat gradient of G's tensors,
        the input gradient)."""
        u1 = rb(x) @ rb(gW1).T + gb1
        mu1, var1, iv1, xh1, y1, a1 = _bn_forward(u1, gam1, bet1)
        u2 = rb(a1) @ rb(gW2).T + gb2
        mu2, var2, iv2, xh2, y2, a2 = _bn_forward(u2, gam2, bet2)
        if "second_pass_moves_running_stats" in faults:
            update_running_stats(mu1, var1, mu2, var2)
        tn2 = torch.tanh(rb_head(a2) @ rb_head(gW3).T + gb3)
        p2 = torch.sigmoid(tn2) if spec.sigmoid_squash else tn2
        diff = p2 - pn
        loss = torch.sum(diff * diff) / (B * 4)
        adj = weight * 2.0 * diff / (B * 4)
        dsq2 = p2 * (1.0 - p2) if spec.sigmoid_squash else 1.0
        dz = adj * dsq2 * (1.0 - tn2 * tn2)
        grad = torch.empty_like(bufs.g)
        hW1, hb1, hgam1, hbet1, hW2, hb2, hgam2, hbet2, hW3, hb3 = spec.g_views(grad)
        hW3.copy_(dz.T @ a2)
        hb3.copy_(dz.sum(dim=0))
        du2, dg2, dbt2 = _bn_backward(dz @ gW3, y2, xh2, u2 - mu2, iv2, gam2)
        hgam2.copy_(dg2)
        hbet2.copy_(dbt2)
        hW2.copy_(rb(du2).T @ rb(a1))
        hb2.copy_(du2.sum(dim=0))
        du1, dg1, dbt1 = _bn_backward(rb(du2) @ rb(gW2), y1, xh1, u1 - mu1, iv1, gam1)
        hgam1.copy_(dg1)
        hbet1.copy_(dbt1)
        hW1.copy_(rb(du1).T @ rb(x))
        hb1.copy_(du1.sum(dim=0))
        return loss, adj, grad, rb(du1) @ rb(gW1)

    for t in range(steps):
        lr_g, lr_d, inv1_g, inv2_g, inv1_d, inv2_d, d_gate, c_scale = sched[t]
        spectra, params_phys, met = streams.spectra[t], streams.params[t], streams.metrics_norm[t]

        # ---- G forward, shared by both phases -----------------------------
        u1 = rb(spectra) @ rb(gW1).T + gb1
        mu1, var1, iv1, xh1, y1, a1 = _bn_forward(u1, gam1, bet1)
        u2 = rb(a1) @ rb(gW2).T + gb2
        mu2, var2, iv2, xh2, y2, a2 = _bn_forward(u2, gam2, bet2)
        tn = torch.tanh(rb_head(a2) @ rb_head(gW3).T + gb3)
        pn = torch.sigmoid(tn) if spec.sigmoid_squash else tn
        pphys = (pn + 1.0) * 0.5 * (hi - lo) + lo
        update_running_stats(mu1, var1, mu2, var2)

        # ---- D phase on [real; fake] --------------------------------------
        fake_in = torch.cat([spectra, pphys], dim=1)
        x0 = torch.cat([torch.cat([spectra, params_phys], dim=1), fake_in], dim=0)
        if spec.use_inoise:
            # on the spectrum columns, for this phase only: the G phase below
            # reads the clean fake rows
            x0 = torch.cat([x0[:, :S] + streams.inoise[t], x0[:, S:]], dim=1)
            if "noised_fake_rows" in faults:
                fake_in = x0[B:]
        p1 = rb_d1(x0) @ rb_d1(dW1).T + db1
        h1 = _leaky(p1)
        p2 = rb(h1) @ rb(dW2).T + db2
        h2 = _leaky(p2)
        z = h2 @ dW3.T + db3                                   # (2B, 1)
        probs = torch.sigmoid(z)
        d_acc = 0.5 * ((probs[:B] > 0.5).to(dtype).mean()
                       + (probs[B:] <= 0.5).to(dtype).mean())
        update_d = float(d_gate) > 0.0
        if spec.wgan:
            d_loss = torch.mean(z[B:]) - torch.mean(z[:B])
            if update_d:
                # the penalty at (clean spectra, eps-interpolated params):
                # gvec = dz/dx with the LeakyReLU masks m1g, m2g constants
                eps = streams.eps[t]                               # (B, 1)
                interp = eps * params_phys + (1.0 - eps) * pphys
                xg = torch.cat([spectra, interp], dim=1)           # (B, S + 4)
                p1g = rb(xg) @ rb(dW1).T + db1
                m1g = _leaky_mask(p1g)
                p2g = rb(_leaky(p1g)) @ rb(dW2).T + db2
                m2g = _leaky_mask(p2g)
                v = m2g * dW3                                      # (B, d2)
                a_m = m1g * (rb(v) @ rb(dW2))                      # (B, d1)
                gvec = rb(a_m) @ rb(dW1)                           # (B, S + 4)
                gn = torch.sqrt(torch.sum(gvec * gvec, dim=1, keepdim=True) + 1e-12)
                d_loss = d_loss + spec.gp_weight * torch.sum((gn - 1.0) ** 2) / B
                c = spec.gp_weight * 2.0 * (gn - 1.0) / (B * gn)  # (B, 1)
                if "wgan_gp_seed_sign" in faults:
                    c = -c
                gt_ = c * gvec
            dz = torch.cat([torch.full((B, 1), -1.0 / B, dtype=dtype, device=dev),
                            torch.full((B, 1), 1.0 / B, dtype=dtype, device=dev)])
        else:
            d_loss = 2.0 * torch.mean(torch.clamp(z, min=0.0) - z * labels
                                      + _softplus_neg_abs(z))
            dz = (probs - labels) / B
        if update_d:
            gdW3.copy_(dz.T @ h2)
            gdb3.copy_(dz.sum(dim=0))
            dp2 = (dz * dW3) * _leaky_mask(p2)
            gdW2.copy_(rb(dp2).T @ rb(h1))
            gdb2.copy_(dp2.sum(dim=0))
            dp1 = (rb_back(dp2) @ rb_back(dW2)) * _leaky_mask(p1)
            gdW1.copy_(rb(dp1).T @ rb(x0))
            gdb1.copy_(dp1.sum(dim=0))
            if spec.wgan:
                # the penalty's second-order backward: W1 twice (gvec's outer
                # factor and a_m's inner chain), W2 and w3; no bias term
                d_u = m1g * (rb(gt_) @ rb(dW1).T)                  # (B, d1)
                d_v = rb(d_u) @ rb(dW2).T                          # (B, d2)
                if "wgan_gp_w1_second_term_dropped" not in faults:
                    gdW1.add_(rb(a_m).T @ rb(gt_))
                gdW2.add_(rb(v).T @ rb(d_u))
                gdW3.add_(torch.sum(d_v * m2g, dim=0, keepdim=True))
            _clip_adam_(bufs.d, bufs.d_m, bufs.d_v, d_grad, lr_d, inv1_d, inv2_d, spec.clip)

        # ---- G phase: the adversarial pass through the updated D ----------
        q1 = rb_d1(fake_in) @ rb_d1(dW1).T + db1
        q2 = rb(_leaky(q1)) @ rb(dW2).T + db2
        zg = _leaky(q2) @ dW3.T + db3                          # (B, 1)
        if spec.wgan:
            adv = -torch.mean(zg)
            dzg = torch.full_like(zg, -1.0 / B)
        else:
            adv = torch.mean(torch.clamp(zg, min=0.0) - zg + _softplus_neg_abs(zg))
            dzg = (torch.sigmoid(zg) - 1.0) / B
        dq2 = (dzg * dW3) * _leaky_mask(q2)
        dq1 = (rb(dq2) @ rb(dW2)) * _leaky_mask(q1)
        dpphys = rb(dq1) @ rb(dW1[:, S:])                      # (B, 4)
        dpn = spec.adv_w * dpphys * half_span

        # ---- the frozen F, eval mode --------------------------------------
        a = pn
        saved = []
        for l in range(nh):
            W, b, gamma, beta = fs.views(bufs.f, l)
            tt = (a @ W.T if l == 0 else rb(a) @ rb(W).T) + b      # layer 0: float32
            mu = tt.mean(dim=-1, keepdim=True)
            var = torch.clamp((tt * tt).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
            ivar = torch.rsqrt(var + _LN_EPS)
            tc = tt - mu
            ln = tc * ivar * gamma + beta
            saved.append((tc, ivar, ln))
            a = _leaky(ln)
        Wh, bh = fs.views(bufs.f, nh)
        if spec.bf16:
            # the spectrum columns in bfloat16, the 8 metrics columns in float32
            pred = torch.cat([rb(a) @ rb(Wh[:S]).T + bh[:S], a @ Wh[S:].T + bh[S:]], dim=1)
        else:
            pred = a @ Wh.T + bh
        recon, pmet = pred[:, :S], pred[:, S:]

        # ---- losses --------------------------------------------------------
        dr = recon - spectra
        dm = pmet - met
        recon_l = torch.sum(dr * dr) / (B * S)
        met_l = torch.sum(dm * dm) / (B * 8)
        d2 = (recon[:, 2:] - recon[:, 1:-1]) - (recon[:, 1:-1] - recon[:, :-2])
        maxwell_l = torch.sum(d2 * d2) / (B * (S - 2))
        f1, f2 = pmet[:, 0:1], pmet[:, 1:2]
        th1 = 0.4 * pn[:, 0:1] + 0.6 * pn[:, 2:3]
        th2 = 0.3 * pn[:, 1:2] + 0.7 * pn[:, 3:4]
        e1, e2 = f1 - th1, f2 - th2
        lc_l = torch.sum(e1 * e1) / B + torch.sum(e2 * e2) / B
        below = torch.clamp(spec.range_lo - pn, min=0.0)
        above = torch.clamp(pn - spec.range_hi, min=0.0)
        range_l = torch.sum(below * below + above * above) / (B * 4)
        bad = ((pn < spec.range_lo) | (pn > spec.range_hi)).any(dim=1)
        viol = bad.to(dtype).sum() / B
        g_loss = (spec.adv_w * adv + spec.recon_w * recon_l + spec.pmet_w * met_l
                  + spec.maxwell_w * maxwell_l + spec.lc_w * lc_l + spec.range_w * range_l)

        # ---- direct adjoints into G's output ------------------------------
        g1 = spec.lc_w * 2.0 * (th1 - f1) / B
        g2 = spec.lc_w * 2.0 * (th2 - f2) / B
        dpn = dpn + torch.cat([0.4 * g1, 0.3 * g2, 0.6 * g1, 0.7 * g2], dim=1)
        dpn = dpn + spec.range_w * (2.0 * above - 2.0 * below) / (B * 4)
        c_loss = torch.zeros((), dtype=dtype, device=dev)
        if spec.constraint_w:
            oor = torch.clamp(torch.maximum(pn - 1.0, -pn), min=0.0)
            hard = torch.sum(oor * oor) / B
            bdist = torch.minimum(pn, 1.0 - pn)
            bexp = torch.exp(torch.clamp(-20.0 * bdist, max=25.0))
            boundary = torch.sum(bexp) / B
            dpar = pn[:, 1:] - pn[:, :-1]
            smooth = torch.sum(dpar.abs()) / (B * 3)
            invalid = torch.isnan(recon) | torch.isinf(recon)
            validity = invalid.to(dtype).sum() / B
            c_loss = 10.0 * hard + 0.1 * boundary + 0.05 * smooth + 3.0 * validity
            wcs = spec.constraint_w * c_scale
            g_loss = g_loss + wcs * c_loss
            # max / min branches: pn - 1 wins the inner max iff pn > 0.5, pn
            # wins the boundary min iff pn < 0.5; validity carries no gradient
            dhard = (2.0 * oor / B) * torch.where(pn > 0.5, 1.0, -1.0)
            noclip = (-20.0 * bdist < 25.0).to(dtype)
            dbound = bexp * (-20.0) * noclip * torch.where(pn < 0.5, 1.0, -1.0) / B
            sgn = torch.sign(dpar)
            zc = torch.zeros((B, 1), dtype=dtype, device=dev)
            dsm = (torch.cat([zc, sgn], dim=1) - torch.cat([sgn, zc], dim=1)) / (B * 3)
            dpn = dpn + wcs * (10.0 * dhard + 0.1 * dbound + 0.05 * dsm)
        if spec.window_w:
            window_l = torch.sum(torch.clamp(f1 - _F_HI, min=0.0)
                                 + torch.clamp(_F_LO - f1, min=0.0))
            g_loss = g_loss + spec.window_w * window_l

        def f_backward(dpred):
            """d(loss)/d(F's input) from d(loss)/d(F's output)."""
            if spec.bf16:
                da = rb(dpred[:, :S]) @ rb(Wh[:S]) + dpred[:, S:] @ Wh[S:]
            else:
                da = dpred @ Wh
            for l in range(nh - 1, -1, -1):
                W, _, gamma, _ = fs.views(bufs.f, l)
                tc, ivar, ln = saved[l]
                dxh = da * _leaky_mask(ln) * gamma
                dvar = torch.sum(dxh * tc, dim=-1, keepdim=True) * (-0.5) * ivar * ivar * ivar
                dt = dxh * ivar
                dt = dt - dt.mean(dim=-1, keepdim=True) + dvar * 2.0 * tc / tc.shape[1]
                da = dt @ W if l == 0 else rb(dt) @ rb(W)
            return da

        # ---- the second G passes: cycle on F's spectrum, stability on the
        # noised stream; G's gradient is the sum over its passes ------------
        extra_grads = []
        drecon_c = None
        if spec.cycle_w:
            cycle_l, adj, grad_c, drecon_c = second_pass(recon, pn, spec.cycle_w)
            g_loss = g_loss + spec.cycle_w * cycle_l
            if "cycle_seed_dropped" not in faults:
                dpn = dpn - adj
            extra_grads.append(grad_c)
            if spec.detach_forward and "drecon_c_when_detached" in faults:
                zeros = torch.zeros((B, 8), dtype=dtype, device=dev)
                dpn = dpn + f_backward(torch.cat([drecon_c, zeros], dim=1))
        if spec.stability_w:
            stab_l, adj, grad_s, _ = second_pass(streams.stab[t], pn, spec.stability_w)
            g_loss = g_loss + spec.stability_w * stab_l
            if "stability_seed_dropped" not in faults:
                dpn = dpn - adj
            extra_grads.append(grad_s)

        # ---- adjoints that reach G through F's input ----------------------
        if not spec.detach_forward:
            dmet = spec.pmet_w * 2.0 * dm / (B * 8)
            dmet[:, 0:1] += spec.lc_w * 2.0 * e1 / B
            dmet[:, 1:2] += spec.lc_w * 2.0 * e2 / B
            if spec.window_w:
                dmet[:, 0:1] += spec.window_w * ((f1 > _F_HI).to(dtype)
                                                 - (f1 < _F_LO).to(dtype))
            drecon = spec.recon_w * 2.0 * dr / (B * S)
            d2p = torch.nn.functional.pad(d2, (0, 2))
            sh1 = torch.nn.functional.pad(d2p[:, :-1], (1, 0))
            sh2 = torch.nn.functional.pad(d2p[:, :-2], (2, 0))
            drecon = drecon + (spec.maxwell_w * 2.0 / (B * (S - 2))) * (d2p - 2.0 * sh1 + sh2)
            if drecon_c is not None:
                drecon = drecon + drecon_c     # cycle's second pass read recon
            dpn = dpn + f_backward(torch.cat([drecon, dmet], dim=1))   # F's input is pn

        # ---- G backward -----------------------------------------------------
        dsq = pn * (1.0 - pn) if spec.sigmoid_squash else 1.0
        dz3 = dpn * dsq * (1.0 - tn * tn)
        ggW3.copy_(dz3.T @ a2)
        ggb3.copy_(dz3.sum(dim=0))
        du2, dg2, dbt2 = _bn_backward(dz3 @ gW3, y2, xh2, u2 - mu2, iv2, gam2)
        ggam2.copy_(dg2)
        gbet2.copy_(dbt2)
        ggW2.copy_(rb(du2).T @ rb(a1))
        ggb2.copy_(du2.sum(dim=0))
        du1, dg1, dbt1 = _bn_backward(rb(du2) @ rb(gW2), y1, xh1, u1 - mu1, iv1, gam1)
        ggam1.copy_(dg1)
        gbet1.copy_(dbt1)
        ggW1.copy_(rb(du1).T @ rb(spectra))
        ggb1.copy_(du1.sum(dim=0))
        for extra in extra_grads:              # main, then cycle, then stability
            g_grad.add_(extra)
        _clip_adam_(bufs.g, bufs.g_m, bufs.g_v, g_grad, lr_g, inv1_g, inv2_g, spec.clip)
        if spec.ema_decay > 0.0:
            bufs.g_ema.copy_(spec.ema_decay * bufs.g_ema + (1.0 - spec.ema_decay) * bufs.g)

        rows[t] = torch.stack([d_loss, g_loss, d_acc, adv, recon_l, met_l, maxwell_l,
                               lc_l, range_l, viol, c_loss])
    return rows


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def workspace_layout(spec: GanTrainSpec, batch: int) -> list[tuple[str, int]]:
    """The kernel's scratch of one member, buffer by buffer as
    ``csrc/gan_train.cu`` lays it out: (name, floats).  G's layers are
    ``uc`` (u - mean), ``xh``, ``y``, ``a`` (relu(y)), ``iv`` (1/sigma); F's
    ``tc`` (t - mean), ``ln`` (pre-activation), ``act``, ``ivar``."""
    B, S = batch, spec.spectrum_dim
    g1, g2 = spec.g_hidden
    d1, d2 = spec.d_hidden
    fdims = spec.f_spec.dims
    out = []
    for l, c in enumerate((g1, g2)):
        out += [(f"uc{l}", B * c), (f"xh{l}", B * c), (f"y{l}", B * c), (f"a{l}", B * c),
                (f"iv{l}", c)]
    # tanh; the squashed output; d(loss)/d(output), then the head's seed dz3
    out += [("tn", B * 4), ("pn", B * 4), ("dpn", B * 4)]
    out += [("x0", 2 * B * (S + 4))]                       # D's input [real; fake]
    out += [("p1", 2 * B * d1), ("h1", 2 * B * d1), ("p2", 2 * B * d2), ("h2", 2 * B * d2)]
    out += [("z", 2 * B), ("dz", 2 * B)]
    out += [("dp2", 2 * B * d2), ("dp1", 2 * B * d1)]     # D's backward
    out += [("dpphys", B * 4)]                             # d(adv)/d(fake params)
    for l, c in enumerate(fdims[1:-1]):
        out += [(f"tc{l}", B * c), (f"ln{l}", B * c), (f"act{l}", B * c), (f"ivar{l}", B)]
    out += [("pred", B * fdims[-1]), ("dpred", B * fdims[-1])]
    widest = B * max(*fdims, g1, g2)
    out += [("da", widest), ("dln", widest), ("dt", widest)]
    out += [("dfin", B * 4)]                               # d(loss)/d(F's input)
    out += [("grad_g", spec.num_g), ("grad_d", spec.num_d)]
    # only what is on takes room: the D phase's noised input; one set of
    # activations for the second G passes (cycle's are done with before
    # stability's begin), cycle's input gradient, a flat gradient for each
    if spec.use_inoise:
        out += [("x0n", 2 * B * (S + 4))]
    if spec.wgan:
        # the penalty's pass: its input, D's two layers and their masks' sources,
        # v = m2g w3, a_m, gvec and Gt, then dU and dV of its backward
        out += [("xg", B * (S + 4)), ("p1g", B * d1), ("h1g", B * d1), ("p2g", B * d2),
                ("gv", B * d2), ("am", B * d1), ("gvec", B * (S + 4)), ("gt", B * (S + 4)),
                ("du_g", B * d1), ("dv_g", B * d2)]
    if spec.cycle_w or spec.stability_w:
        for l, c in enumerate((g1, g2)):
            out += [(f"uc{l}_2", B * c), (f"xh{l}_2", B * c), (f"y{l}_2", B * c),
                    (f"a{l}_2", B * c), (f"iv{l}_2", c)]
        out += [("tn_2", B * 4), ("dz_2", B * 4)]
    if spec.cycle_w and not spec.detach_forward:
        out += [("drecon_c", B * S)]
    if spec.cycle_w:
        out += [("grad_cycle", spec.num_g)]
    if spec.stability_w:
        out += [("grad_stability", spec.num_g)]
    out += [("norm_partials", _NORM_PARTS)]
    return out


def workspace_floats(spec: GanTrainSpec, batch: int) -> int:
    """Scratch the kernel needs for one member, in floats (``csrc/gan_train.cu``
    computes the same layout and refuses a smaller buffer)."""
    return sum(n for _, n in workspace_layout(spec, batch))


def workspace_views(work: torch.Tensor, spec: GanTrainSpec, batch: int) -> dict:
    """The named buffers of ``workspace_layout`` as flat views into ``work``:
    what the last step of a ``gan_train(..., work=work)`` call left there."""
    out, pos = {}, 0
    for name, n in workspace_layout(spec, batch):
        out[name] = work[pos: pos + n]
        pos += n
    return out


def _check(bufs: GanBuffers, streams: GanStreams, spec: GanTrainSpec,
           members: int | None = None) -> bool:
    """Validate the call; True when it goes to the kernel (CUDA tensors).
    With ``members`` every buffer that differs by member, and the three batch
    streams, carry that leading axis."""
    who = "gan_train" if members is None else "gan_ensemble_train"
    lead = () if members is None else (members,)
    dev = bufs.g.device
    want = {"g": spec.num_g, "g_m": spec.num_g, "g_v": spec.num_g,
            "d": spec.num_d, "d_m": spec.num_d, "d_v": spec.num_d}
    if spec.ema_decay > 0.0:
        if bufs.g_ema is None:
            raise ValueError(f"{who}: ema_decay > 0 needs the g_ema buffer "
                             "(init_pigan_state(..., ema=True))")
        want["g_ema"] = spec.num_g
    tensors = {name: (getattr(bufs, name), (*lead, n)) for name, n in want.items()}
    tensors["f"] = (bufs.f, (spec.f_spec.num_params,))
    g1, g2 = spec.g_hidden
    if len(bufs.bn) != 4:
        raise ValueError(f"{who}: bn must hold running mean and var of two BatchNorms")
    for name, t, c in zip(("bn1_mean", "bn1_var", "bn2_mean", "bn2_var"), bufs.bn,
                          (g1, g1, g2, g2)):
        tensors[name] = (t, (*lead, c))
    if streams.spectra.ndim != len(lead) + 3:
        raise ValueError(f"{who}: stream spectra must have {len(lead) + 3} axes, got "
                         f"{tuple(streams.spectra.shape)}")
    steps, batch, _ = streams.spectra.shape[-3:]
    tensors["stream spectra"] = (streams.spectra, (*lead, steps, batch, spec.spectrum_dim))
    tensors["stream params"] = (streams.params, (*lead, steps, batch, 4))
    tensors["stream metrics_norm"] = (streams.metrics_norm, (*lead, steps, batch, 8))
    for name, t, on, shape in (
            ("inoise", streams.inoise, spec.use_inoise, (2 * batch, spec.spectrum_dim)),
            ("stab", streams.stab, spec.stability_w > 0.0, (batch, spec.spectrum_dim)),
            ("eps", streams.eps, spec.wgan, (batch, 1))):
        if on != (t is not None):
            raise ValueError(f"{who}: stream {name} is {'missing' if on else 'given'} but "
                             f"the spec has it {'on' if on else 'off'}")
        if on:
            tensors[f"stream {name}"] = (t, (*lead, steps, *shape))
    for name, (t, shape) in tensors.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{who}: {name} on {t.device}, state on {dev}")
    if tuple(streams.sched.shape) != (steps, len(SCHED_LANES)):
        raise ValueError(f"{who}: sched must be (T, {len(SCHED_LANES)})")
    if streams.param_lo.numel() != 4 or streams.param_hi.numel() != 4:
        raise ValueError(f"{who}: param_lo and param_hi must hold 4 values")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {dev}")
    check_capability(dev.index)
    return True


def gan_train(bufs: GanBuffers, streams: GanStreams, spec: GanTrainSpec,
              work: torch.Tensor | None = None) -> torch.Tensor:
    """T training steps over ``bufs`` in place, one kernel launch per call
    on the card; returns the (T, 11) per-step metric rows.  ``work``
    optionally supplies the kernel's scratch (``workspace_floats`` floats),
    which then holds the last step's intermediates (``workspace_views``)."""
    if not _check(bufs, streams, spec):
        return gan_train_plain(bufs, streams, spec)
    steps, batch, _ = streams.spectra.shape
    dev = bufs.g.device
    rows = torch.zeros((steps, ROW_WIDTH), dtype=torch.float32, device=dev)
    if steps == 0:
        return rows
    n_work = workspace_floats(spec, batch)
    if work is None:
        work = torch.empty(n_work, dtype=torch.float32, device=dev)
    elif (work.dtype != torch.float32 or work.device != dev or not work.is_contiguous()
          or work.numel() < n_work):
        raise ValueError(f"gan_train: work must be contiguous float32 with at least "
                         f"{n_work} floats on {dev}")
    launch(
        "gan_train", dev, *_state_pointers(bufs),
        bufs.f.data_ptr(), bufs.g_ema.data_ptr() if spec.ema_decay > 0.0 else None,
        *_stream_arguments(streams, spec, rows, work, n_work, batch, steps),
    )
    BROW_LAUNCHES["brow_gemm"] += brow_kernels_enqueued()
    return rows


def kernels_enqueued() -> int:
    """The device kernels that this process's last ``gan_train`` or
    ``gan_ensemble_train`` launch enqueued, as the C loop counted them: over
    the call's steps, the launches a step (69 through F and 58 detached;
    +19 with cycle through F, +17 with stability, +1 with instance noise,
    +14 with WGAN-GP; in bfloat16 +2 through F and +1 detached, F's head in
    two products; a step whose D update is gated off enqueues 11 fewer, and
    none of WGAN-GP's)."""
    from ._cuda_build import load_library

    return int(load_library().pigan_gan_kernels_enqueued())


def _state_pointers(bufs: GanBuffers) -> list[int]:
    return [t.data_ptr() for t in (bufs.g, bufs.g_m, bufs.g_v, bufs.d, bufs.d_m, bufs.d_v,
                                   *bufs.bn)]


def _stream_arguments(streams: GanStreams, spec: GanTrainSpec, rows, work, n_work: int,
                      batch: int, steps: int) -> tuple:
    """The arguments both C entry points share after the state's: streams,
    schedule, rows, workspace, widths, constants and flags."""
    fs = spec.f_spec
    sched = streams.sched.to(torch.float32).contiguous().reshape(-1).tolist()
    dims = (spec.spectrum_dim, *spec.g_hidden, *spec.d_hidden)
    hp = (spec.adv_w, spec.recon_w, spec.pmet_w, spec.maxwell_w, spec.lc_w, spec.range_w,
          spec.constraint_w, spec.window_w, spec.range_lo, spec.range_hi,
          spec.label_real, spec.label_fake, spec.ema_decay, spec.clip,
          *streams.param_lo.tolist(), *streams.param_hi.tolist(),
          spec.cycle_w, spec.stability_w, spec.gp_weight)
    flags = (int(spec.detach_forward) | (int(spec.sigmoid_squash) << 1)
             | (int(spec.wgan) << 2) | (int(spec.bf16) << 3))
    return (
        streams.spectra.data_ptr(), streams.params.data_ptr(),
        streams.metrics_norm.data_ptr(),
        None if streams.inoise is None else streams.inoise.data_ptr(),
        None if streams.stab is None else streams.stab.data_ptr(),
        None if streams.eps is None else streams.eps.data_ptr(),
        (ctypes.c_float * len(sched))(*sched),
        rows.data_ptr(), work.data_ptr(), n_work,
        (ctypes.c_int * len(dims))(*dims),
        (ctypes.c_int * len(fs.dims))(*fs.dims), fs.n_hidden,
        (ctypes.c_longlong * (4 * (fs.n_hidden + 1)))(*(o for offs in fs.offsets for o in offs)),
        batch, steps, (ctypes.c_double * len(hp))(*hp), flags,
    )


# ---------------------------------------------------------------------------
# Seed ensembles: M members in one launch (K3)
# ---------------------------------------------------------------------------

_NO_EMA = "the member-packed kernel: ema_decay > 0 unsupported"


def ensemble_buffers(states) -> GanBuffers:
    """An ``EnsembleState``'s stacked buffers, as the member-packed kernel
    takes them: each of ``GanBuffers``' fields with a leading member axis,
    one shared ``f``, no EMA."""
    return GanBuffers(states.g_params, states.g_m, states.g_v, states.d_params, states.d_m,
                      states.d_v, tuple(states.bn), states.f_params, None)


def _member(bufs: GanBuffers, streams: GanStreams, m: int) -> tuple[GanBuffers, GanStreams]:
    """Member m's rows of stacked buffers and streams, as views."""
    one = GanBuffers(bufs.g[m], bufs.g_m[m], bufs.g_v[m], bufs.d[m], bufs.d_m[m], bufs.d_v[m],
                     tuple(t[m] for t in bufs.bn), bufs.f, None)
    return one, streams._replace(
        spectra=streams.spectra[m], params=streams.params[m],
        metrics_norm=streams.metrics_norm[m],
        inoise=None if streams.inoise is None else streams.inoise[m],
        stab=None if streams.stab is None else streams.stab[m],
        eps=None if streams.eps is None else streams.eps[m])


def gan_ensemble_train_plain(bufs: GanBuffers, streams: GanStreams,
                             spec: GanTrainSpec) -> torch.Tensor:
    """The member-packed kernel's plain version: ``gan_train_plain`` on each
    member's rows in turn.  Deliberately a loop and no batched product, so
    that member m is exactly what it is alone.  Returns (M, T, 11) rows."""
    if spec.ema_decay > 0.0:
        raise ValueError(_NO_EMA)
    return torch.stack([gan_train_plain(*_member(bufs, streams, m), spec)
                        for m in range(bufs.g.shape[0])])


def gan_ensemble_train(bufs: GanBuffers, streams: GanStreams,
                       spec: GanTrainSpec) -> torch.Tensor:
    """T training steps over M members' stacked buffers in place, one kernel
    launch per call on the card whatever M is; returns the (M, T, 11)
    per-step metric rows.  ``bufs`` as ``ensemble_buffers`` gives them,
    ``streams`` with (M, T, B, ·) batch streams and one shared schedule: all
    members sit at the same step and optimiser counts."""
    if spec.ema_decay > 0.0:
        raise ValueError(_NO_EMA)
    if bufs.g.ndim != 2 or bufs.g.shape[0] < 1:
        raise ValueError("gan_ensemble_train: buffers need a leading member axis of at "
                         f"least 1, got g {tuple(bufs.g.shape)}")
    members = int(bufs.g.shape[0])
    if not _check(bufs, streams, spec, members):
        return gan_ensemble_train_plain(bufs, streams, spec)
    steps, batch, _ = streams.spectra.shape[-3:]
    dev = bufs.g.device
    rows = torch.zeros((members, steps, ROW_WIDTH), dtype=torch.float32, device=dev)
    if steps == 0:
        return rows
    n_work = workspace_floats(spec, batch)          # one member's
    work = torch.empty(members * n_work, dtype=torch.float32, device=dev)
    launch(
        "gan_ensemble_train", dev, members, *_state_pointers(bufs), bufs.f.data_ptr(),
        *_stream_arguments(streams, spec, rows, work, n_work, batch, steps),
    )
    BROW_LAUNCHES["brow_gemm"] += brow_kernels_enqueued()
    return rows


# ---------------------------------------------------------------------------
# The batch-row products (csrc/brow_gemm.cuh; the kernel's Python side: brow.py)
# ---------------------------------------------------------------------------


def brow_products(spec: GanTrainSpec, batch: int, update_d: bool = True) -> list[BrowProduct]:
    """The batch-row products one step of ``csrc/gan_train.cu`` launches
    through ``brow_gemm.cuh``, in its order (a step with D's update gated
    off when not ``update_d``): the forward layers and input gradients of G,
    D and F with M = B or 2B rows.  The heads (4 or 1 wide), F's 4-wide
    input layer and its input gradient, the 8 metrics columns of F's head
    under bfloat16 and every weight gradient stay on the tiled SGEMM."""
    B, S = batch, spec.spectrum_dim
    g1, g2 = spec.g_hidden
    d1, d2 = spec.d_hidden
    nd = S + 4
    fd = spec.f_spec.dims
    r = spec.bf16
    out = []

    def fwd(name, m, n, k, rnd=r, bias=True):
        out.append(BrowProduct(name, m, n, k, True, False, rnd, bias))

    def dx(name, m, n, k, rnd=r):
        out.append(BrowProduct(name, m, n, k, True, True, rnd, False))

    def second_pass(tag, with_dx):
        fwd(f"{tag} G layer 1", B, g1, S)
        fwd(f"{tag} G layer 2", B, g2, g1)
        dx(f"{tag} G dx layer 2", B, g1, g2)
        if with_dx:
            dx(f"{tag} G dx layer 1", B, S, g1)

    fwd("G layer 1", B, g1, S)
    fwd("G layer 2", B, g2, g1)
    fwd("D layer 1 [real; fake]", 2 * B, d1, nd)
    fwd("D layer 2 [real; fake]", 2 * B, d2, d1)
    if spec.wgan and update_d:
        fwd("penalty D layer 1", B, d1, nd)
        fwd("penalty D layer 2", B, d2, d1)
        dx("penalty dx layer 2", B, d1, d2)
        dx("penalty dx layer 1", B, nd, d1)
    if update_d:
        dx("D dx layer 2 [real; fake]", 2 * B, d1, d2)
        if spec.wgan:
            fwd("penalty backward W1", B, d1, nd, bias=False)
            fwd("penalty backward W2", B, d2, d1, bias=False)
    fwd("G phase D layer 1", B, d1, nd)
    fwd("G phase D layer 2", B, d2, d1)
    dx("G phase D dx layer 2", B, d1, d2)
    for l in range(1, len(fd) - 2):
        fwd(f"F layer {l + 1}", B, fd[l + 1], fd[l])
    if spec.bf16:
        fwd("F head, spectrum columns", B, S, fd[-2])
    else:
        fwd("F head", B, fd[-1], fd[-2], rnd=False)
    if spec.cycle_w:
        second_pass("cycle", not spec.detach_forward)
    if spec.stability_w:
        second_pass("stability", False)
    if not spec.detach_forward:
        if spec.bf16:
            dx("F dx head, spectrum columns", B, fd[-2], S)
        else:
            dx("F dx head", B, fd[-2], fd[-1], rnd=False)
        for l in range(len(fd) - 3, 0, -1):
            dx(f"F dx layer {l + 1}", B, fd[l], fd[l + 1])
    dx("G dx layer 2", B, g1, g2)
    return out


# ---------------------------------------------------------------------------
# The multi-epoch function
# ---------------------------------------------------------------------------


def epoch_means(rows: torch.Tensor, epochs: int, constraint: bool) -> dict[str, torch.Tensor]:
    """(T, 11) per-step rows -> {key: (E,) per-epoch means}, with
    ``constraint_loss`` only when the constraint term is on."""
    per_epoch = rows.reshape(epochs, -1, ROW_WIDTH).mean(dim=1)
    out = {k: per_epoch[:, j] for j, k in enumerate(METRIC_KEYS)}
    if constraint:
        out["constraint_loss"] = per_epoch[:, ROW_WIDTH - 1]
    return out


def make_gan_epoch_fn(cfg: PiGanConfig, settings, *, lr_g: float | None = None,
                      lr_d: float | None = None, schedule_g: str | None = None,
                      schedule_d: str | None = None, horizon_epochs: int | None = None):
    """multi_epoch(state, ds, scales, indices=None, seeds=None, draws=None) ->
    (state, {key: (E,) per-epoch means}) through ``gan_train``, one launch
    per call: the contract of the eager
    ``make_multi_epoch_fn(make_pigan_step(...), B)``.

    ``scales`` (E,) is each epoch's constraint multiplier (read only when
    ``settings.constraint_w`` > 0).  ``lr_g`` / ``lr_d`` / ``schedule_g`` /
    ``schedule_d`` are the Trainer's per-phase optimiser overrides: an
    overridden optimiser's schedule spans ``horizon_epochs`` and its Adam
    state is started afresh by the Trainer.  Without overrides the
    schedules are the config's (cosine to 0.01x for G, halving every
    quarter for D, both over ``cfg.train.num_epochs``).  The state is
    updated in place and returned.  ``seeds`` (drawn from the state's
    generator as the eager path draws them, unless given) key each step's
    augmentation, instance noise and stability noise; ``draws``, one mapping
    per step, may hand the two noises over instead, as to the eager
    ``make_multi_epoch_fn``."""
    from ..train.schedules import cosine_schedule, make_schedule, step_schedule

    spec = gan_train_spec(cfg, settings)
    g_over = lr_g is not None or schedule_g is not None
    d_over = lr_d is not None or schedule_d is not None
    if (g_over or d_over) and horizon_epochs is None:
        raise ValueError("optimizer overrides need horizon_epochs")
    batch = cfg.train.batch_size
    k_d = int(settings.d_update_every)

    def g_sched_of(spe: int):
        if g_over:
            return make_schedule(schedule_g or "cosine",
                                 cfg.train.lr_g if lr_g is None else lr_g,
                                 horizon_epochs, spe)
        return cosine_schedule(cfg.train.lr_g, cfg.train.num_epochs, spe, 0.01)

    def d_sched_of(spe: int):
        if d_over:
            return make_schedule(schedule_d or "step",
                                 cfg.train.lr_d if lr_d is None else lr_d,
                                 horizon_epochs, spe)
        return step_schedule(cfg.train.lr_d, cfg.train.num_epochs, spe, 0.5, 0.25)

    def multi_epoch(state, ds: ThzDataset, scales: Sequence[float] | torch.Tensor,
                    indices: torch.Tensor | None = None,
                    seeds: torch.Tensor | None = None, draws=None):
        scales = torch.as_tensor(scales, dtype=torch.float32).reshape(-1)
        epochs = int(scales.numel())
        spe = max(1, ds.num_samples // batch)
        indices, seeds = resolve_draws(state.generator, ds.num_samples, batch, epochs,
                                       indices, seeds)
        streams = build_streams(ds, indices, scales, state.step, state.g_opt.count,
                                state.d_opt.count, k_d, g_sched_of(spe), d_sched_of(spe),
                                settings=settings, seeds=seeds, draws=draws)
        for bn in state.batch_norms():
            bn.num_batches_tracked += epochs * spe
        rows = gan_train(state_buffers(state), streams, spec)
        steps = epochs * spe
        state.step += steps
        state.g_opt.count += steps
        state.d_opt.count += int(streams.sched[:, 6].sum())
        return state, epoch_means(rows, epochs, bool(settings.constraint_w))

    return multi_epoch


def make_gan_ensemble_fn(cfg: PiGanConfig, settings, num_members: int):
    """ensemble_epoch(states, ds, scales, indices=None, draws=None, seeds=None) ->
    (states, [{key: (E,) per-epoch means} per member]) through ``gan_ensemble_train``,
    one launch per call for all ``num_members`` members: the counterpart of
    ``make_pallas_ensemble_fn``.

    ``states`` is an ``EnsembleState`` (``parallel/state_utils.py``) or a
    sequence of ``PiGanState``s, which is stacked first (re-homing them in
    place); the ``EnsembleState`` is updated in place and returned.  Member
    m's shuffles and step seeds come from member m's own generator, drawn as
    the one-member function draws them (the shuffles also from ``indices``
    (M, E, spe, B), the step seeds from ``seeds`` (M, E·spe), or (E·spe,)
    shared by every member); the seeds key that member's noise streams,
    which ``draws`` (per member a sequence of per-step mappings) may give
    instead.
    Member m then is bit for bit what ``make_gan_epoch_fn`` makes of it
    alone with the same draws, and ``num_members=1`` is that path exactly.

    Checked on every call: ``len(states) == num_members``; every member's
    ``step``, ``g_opt.count`` and ``d_opt.count`` equal member 0's (the
    launch carries one schedule stream: a member elsewhere in its training
    would run at the wrong learning rate and bias corrections); one frozen F
    for all (compared exactly).  The schedules are the config's; the EMA is
    refused, as by the TPU kernel."""
    from ..parallel.state_utils import EnsembleState, tree_stack
    from ..train.schedules import cosine_schedule, step_schedule

    spec = gan_train_spec(cfg, settings)
    if num_members < 1:
        raise ValueError("num_members must be >= 1")
    if spec.ema_decay > 0.0:
        raise ValueError(_NO_EMA)
    batch = cfg.train.batch_size
    k_d = int(settings.d_update_every)
    count = int(num_members)

    def ensemble_epoch(states, ds: ThzDataset, scales: Sequence[float] | torch.Tensor,
                       indices: torch.Tensor | None = None, draws=None,
                       seeds: torch.Tensor | None = None):
        if len(states) != count:
            raise ValueError(f"expected {count} states, got {len(states)}")
        first = states[0]
        for i in range(1, count):
            st = states[i]
            if (st.step, st.g_opt.count, st.d_opt.count) != (
                    first.step, first.g_opt.count, first.d_opt.count):
                raise ValueError(
                    f"member {i} step/opt counts differ from member 0 ({st.step} vs "
                    f"{first.step}): packed members share one schedule stream and must "
                    "sit at the same training position (fresh or equally-resumed "
                    "seed-ensemble members)")
            if st.f_params is not first.f_params and not torch.equal(
                    st.f_params, first.f_params.to(st.f_params.device)):
                raise ValueError(
                    f"member {i}'s frozen F differs from member 0's: the packed launch "
                    "carries one shared surrogate (member 0's), so all members must be "
                    "built from the same forward_model")
        if not isinstance(states, EnsembleState):
            states = tree_stack(states)
        scales = torch.as_tensor(scales, dtype=torch.float32).reshape(-1)
        epochs = int(scales.numel())
        spe = max(1, ds.num_samples // batch)
        if indices is not None and tuple(indices.shape) != (count, epochs, spe, batch):
            raise ValueError(f"indices {tuple(indices.shape)}, expected "
                             f"{(count, epochs, spe, batch)}")
        # each member draws as the one-member function does: the E shuffles
        # that are not given, then the chunk's step seeds
        if seeds is not None:
            seeds = torch.as_tensor(seeds, dtype=torch.int64).cpu()
            if seeds.ndim == 1:
                seeds = seeds.expand(count, -1)
        drawn = [resolve_draws(st.generator, ds.num_samples, batch, epochs,
                               None if indices is None else indices[m],
                               None if seeds is None else seeds[m])
                 for m, st in enumerate(states)]
        indices = torch.stack([d[0] for d in drawn])
        streams = build_streams(
            ds, indices, scales, first.step, first.g_opt.count,
            first.d_opt.count, k_d,
            cosine_schedule(cfg.train.lr_g, cfg.train.num_epochs, spe, 0.01),
            step_schedule(cfg.train.lr_d, cfg.train.num_epochs, spe, 0.5, 0.25),
            settings=settings, seeds=torch.stack([d[1] for d in drawn]), draws=draws)
        rows = gan_ensemble_train(ensemble_buffers(states), streams, spec)
        steps = epochs * spe
        d_steps = int(streams.sched[:, 6].sum())
        for st in states:
            for bn in st.batch_norms():
                bn.num_batches_tracked += steps
            st.step += steps
            st.g_opt.count += steps
            st.d_opt.count += d_steps
        constraint = bool(settings.constraint_w)
        return states, [epoch_means(rows[m], epochs, constraint) for m in range(count)]

    return ensemble_epoch
