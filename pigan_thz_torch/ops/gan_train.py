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
  tensors; the EMA of G's parameters when ``ema_decay`` > 0.

Everything the kernel reads besides the state is built outside it
(``build_streams``, the TPU kernel's ``_build_streams``): the gathered
batches of every step of the chunk and the per-step schedule lanes lr_g,
lr_d, the two bias corrections of each optimiser at that optimiser's own
count, ``d_gate`` and the epoch's constraint scale.

What the kernel does not take yet is a reason of ``supports_gan_kernel`` and
raises ``NotImplementedError`` from ``gan_train_spec``, with the ROADMAP.md
row it waits for: ``wgan_gp``,
``stability_w``, ``cycle_w``, ``instance_noise``, the augmentation knobs and
``compute_dtype="bfloat16"`` (the eager step has them all).

``gan_train`` is the wrapper: for CUDA tensors it launches the kernel or
raises, for CPU tensors it runs ``gan_train_plain`` (the kernel's math in
torch ops with the hand-derived backward and no autograd), the port's
analogue of Pallas interpret mode.  ``LAUNCHES["gan_train"]`` counts
launches, one per chunk.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch

from ..config import PiGanConfig
from ..data.dataset import ThzDataset
from ._cuda_build import LAUNCHES, check_capability, launch
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

_NOT_IN_KERNEL = "ROADMAP.md queue 2, K2's remaining paths"


# ---------------------------------------------------------------------------
# Support envelope
# ---------------------------------------------------------------------------


def supports_gan_kernel(cfg: PiGanConfig, settings) -> str | None:
    """None when the kernel trains (cfg, settings) exactly, else the reason
    it does not: a configuration outside the kernel family's envelope
    (``supports_megakernel`` without the TPU's batch % 8 tiling), or a
    setting inside it that this package's kernel does not take yet; those
    reasons end with the ROADMAP.md row they wait for."""
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
        return "adam_state_dtype != float32"
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
    gaps = [name for name, on in (
        ("compute_dtype='bfloat16'", cfg.train.compute_dtype == "bfloat16"),
        ("gan_loss='wgan_gp'", s.gan_loss == "wgan_gp"),
        ("stability_w > 0", float(s.stability_w) > 0.0),
        ("cycle_w > 0", float(s.cycle_w) > 0.0),
        ("instance_noise > 0", float(s.instance_noise) > 0.0),
        ("data augmentation", s.augment_noise or s.augment_shift or s.augment_scale),
    ) if on]
    if gaps:
        return f"the kernel does not take {', '.join(gaps)} yet ({_NOT_IN_KERNEL})"
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
    ``supports_gan_kernel`` gives a reason it raises ``NotImplementedError``
    for what the kernel does not take yet and ``ValueError`` otherwise."""
    reason = supports_gan_kernel(cfg, settings)
    if reason is not None:
        kind = NotImplementedError if _NOT_IN_KERNEL in reason else ValueError
        raise kind(f"GAN-training kernel unsupported here: {reason}")
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
    """One chunk's inputs, T = E · spe steps."""

    spectra: torch.Tensor       # (T, B, S) on the state's device
    params: torch.Tensor        # (T, B, 4) physical units
    metrics_norm: torch.Tensor  # (T, B, 8)
    sched: torch.Tensor         # (T, 8) float32 on the CPU: SCHED_LANES
    param_lo: torch.Tensor      # (4,) float32 on the CPU
    param_hi: torch.Tensor      # (4,)


def build_streams(ds: ThzDataset, indices: torch.Tensor, scales: torch.Tensor,
                  step: int, g_count: int, d_count: int, d_update_every: int,
                  g_schedule, d_schedule) -> GanStreams:
    """Gather every step's batch and precompute the per-step schedule lanes
    of a chunk that starts at global step ``step`` with the optimisers at
    ``g_count`` and ``d_count``.  G and D count separately: with
    ``d_update_every`` = k > 1, D's count advances only on the steps whose
    global step divides by k (``d_gate`` 1), so its learning rate and bias
    corrections are read at the number of updates it has really taken."""
    epochs, spe, batch = indices.shape
    steps = epochs * spe
    idx = indices.reshape(steps, batch).to(ds.spectra.device)
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
    return GanStreams(
        ds.spectra[idx].contiguous(), ds.params[idx].contiguous(),
        ds.metrics_norm[idx].contiguous(), sched.contiguous(),
        ds.param_lo.to("cpu", torch.float32), ds.param_hi.to("cpu", torch.float32))


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
    return torch.where(x >= 0.0, 1.0, _SLOPE)


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


@torch.no_grad()
def gan_train_plain(bufs: GanBuffers, streams: GanStreams,
                    spec: GanTrainSpec) -> torch.Tensor:
    """The kernel's math in torch ops, with its hand-derived backward and no
    autograd: T steps over ``bufs`` in place.  Returns the (T, 11) per-step
    rows: ``METRIC_KEYS`` then ``constraint_loss`` (0 when off)."""
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
    for t in range(steps):
        lr_g, lr_d, inv1_g, inv2_g, inv1_d, inv2_d, d_gate, c_scale = sched[t]
        spectra, params_phys, met = streams.spectra[t], streams.params[t], streams.metrics_norm[t]

        # ---- G forward, shared by both phases -----------------------------
        u1 = spectra @ gW1.T + gb1
        mu1, var1, iv1, xh1, y1, a1 = _bn_forward(u1, gam1, bet1)
        u2 = a1 @ gW2.T + gb2
        mu2, var2, iv2, xh2, y2, a2 = _bn_forward(u2, gam2, bet2)
        tn = torch.tanh(a2 @ gW3.T + gb3)
        pn = torch.sigmoid(tn) if spec.sigmoid_squash else tn
        pphys = (pn + 1.0) * 0.5 * (hi - lo) + lo
        rm1.copy_(_BN_MOM * rm1 + (1.0 - _BN_MOM) * mu1[0])
        rv1.copy_(_BN_MOM * rv1 + (1.0 - _BN_MOM) * var1[0])
        rm2.copy_(_BN_MOM * rm2 + (1.0 - _BN_MOM) * mu2[0])
        rv2.copy_(_BN_MOM * rv2 + (1.0 - _BN_MOM) * var2[0])

        # ---- D phase on [real; fake] --------------------------------------
        fake_in = torch.cat([spectra, pphys], dim=1)
        x0 = torch.cat([torch.cat([spectra, params_phys], dim=1), fake_in], dim=0)
        p1 = x0 @ dW1.T + db1
        h1 = _leaky(p1)
        p2 = h1 @ dW2.T + db2
        h2 = _leaky(p2)
        z = h2 @ dW3.T + db3                                   # (2B, 1)
        probs = torch.sigmoid(z)
        d_acc = 0.5 * ((probs[:B] > 0.5).to(dtype).mean()
                       + (probs[B:] <= 0.5).to(dtype).mean())
        d_loss = 2.0 * torch.mean(torch.clamp(z, min=0.0) - z * labels + _softplus_neg_abs(z))
        if float(d_gate) > 0.0:
            dz = (probs - labels) / B
            gdW3.copy_(dz.T @ h2)
            gdb3.copy_(dz.sum(dim=0))
            dp2 = (dz * dW3) * _leaky_mask(p2)
            gdW2.copy_(dp2.T @ h1)
            gdb2.copy_(dp2.sum(dim=0))
            dp1 = (dp2 @ dW2) * _leaky_mask(p1)
            gdW1.copy_(dp1.T @ x0)
            gdb1.copy_(dp1.sum(dim=0))
            _clip_adam_(bufs.d, bufs.d_m, bufs.d_v, d_grad, lr_d, inv1_d, inv2_d, spec.clip)

        # ---- G phase: the adversarial pass through the updated D ----------
        q1 = fake_in @ dW1.T + db1
        q2 = _leaky(q1) @ dW2.T + db2
        zg = _leaky(q2) @ dW3.T + db3                          # (B, 1)
        adv = torch.mean(torch.clamp(zg, min=0.0) - zg + _softplus_neg_abs(zg))
        dzg = (torch.sigmoid(zg) - 1.0) / B
        dq2 = (dzg * dW3) * _leaky_mask(q2)
        dq1 = (dq2 @ dW2) * _leaky_mask(q1)
        dpphys = dq1 @ dW1[:, S:]                              # (B, 4)
        dpn = spec.adv_w * dpphys * half_span

        # ---- the frozen F, eval mode --------------------------------------
        a = pn
        saved = []
        for l in range(nh):
            W, b, gamma, beta = fs.views(bufs.f, l)
            tt = a @ W.T + b
            mu = tt.mean(dim=-1, keepdim=True)
            var = torch.clamp((tt * tt).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
            ivar = torch.rsqrt(var + _LN_EPS)
            tc = tt - mu
            ln = tc * ivar * gamma + beta
            saved.append((tc, ivar, ln))
            a = _leaky(ln)
        Wh, bh = fs.views(bufs.f, nh)
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
            da = torch.cat([drecon, dmet], dim=1) @ Wh
            for l in range(nh - 1, -1, -1):
                W, _, gamma, _ = fs.views(bufs.f, l)
                tc, ivar, ln = saved[l]
                dxh = da * _leaky_mask(ln) * gamma
                dvar = torch.sum(dxh * tc, dim=-1, keepdim=True) * (-0.5) * ivar * ivar * ivar
                dt = dxh * ivar
                dt = dt - dt.mean(dim=-1, keepdim=True) + dvar * 2.0 * tc / tc.shape[1]
                da = dt @ W
            dpn = dpn + da                                     # F's input is pn

        # ---- G backward -----------------------------------------------------
        dsq = pn * (1.0 - pn) if spec.sigmoid_squash else 1.0
        dz3 = dpn * dsq * (1.0 - tn * tn)
        ggW3.copy_(dz3.T @ a2)
        ggb3.copy_(dz3.sum(dim=0))
        du2, dg2, dbt2 = _bn_backward(dz3 @ gW3, y2, xh2, u2 - mu2, iv2, gam2)
        ggam2.copy_(dg2)
        gbet2.copy_(dbt2)
        ggW2.copy_(du2.T @ a1)
        ggb2.copy_(du2.sum(dim=0))
        du1, dg1, dbt1 = _bn_backward(du2 @ gW2, y1, xh1, u1 - mu1, iv1, gam1)
        ggam1.copy_(dg1)
        gbet1.copy_(dbt1)
        ggW1.copy_(du1.T @ spectra)
        ggb1.copy_(du1.sum(dim=0))
        _clip_adam_(bufs.g, bufs.g_m, bufs.g_v, g_grad, lr_g, inv1_g, inv2_g, spec.clip)
        if spec.ema_decay > 0.0:
            bufs.g_ema.copy_(spec.ema_decay * bufs.g_ema + (1.0 - spec.ema_decay) * bufs.g)

        rows[t] = torch.stack([d_loss, g_loss, d_acc, adv, recon_l, met_l, maxwell_l,
                               lc_l, range_l, viol, c_loss])
    return rows


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def workspace_floats(spec: GanTrainSpec, batch: int) -> int:
    """Scratch the kernel needs, in floats (``csrc/gan_train.cu`` computes
    the same layout and refuses a smaller buffer)."""
    B, S = batch, spec.spectrum_dim
    g1, g2 = spec.g_hidden
    d1, d2 = spec.d_hidden
    fdims = spec.f_spec.dims
    n = 0
    for c in (g1, g2):                     # u - mean, xhat, y, relu(y); 1/sigma
        n += 4 * B * c + c
    n += 3 * B * 4                         # tanh, squashed output, d(loss)/d(output)
    n += 2 * B * (S + 4)                   # D's input [real; fake]
    n += 2 * (2 * B * d1) + 2 * (2 * B * d2)   # p1, h1, p2, h2
    n += 2 * (2 * B)                       # z, dz
    n += 2 * B * d2 + 2 * B * d1           # dp2, dp1 of D's backward
    n += B * 4                             # d(adv)/d(fake params)
    for c in fdims[1:-1]:                  # t - mean, pre-activation, activation; 1/sigma
        n += 3 * B * c + B
    n += 2 * B * fdims[-1]                 # F's prediction and its gradient
    n += 3 * B * max(*fdims, g1, g2)       # da, dln, dt
    n += B * 4                             # d(loss)/d(F's input)
    n += spec.num_g + spec.num_d           # the two flat gradients
    n += _NORM_PARTS                       # norm partials
    return n


def _check(bufs: GanBuffers, streams: GanStreams, spec: GanTrainSpec) -> bool:
    """Validate the call; True when it goes to the kernel (CUDA tensors)."""
    dev = bufs.g.device
    want = {"g": spec.num_g, "g_m": spec.num_g, "g_v": spec.num_g,
            "d": spec.num_d, "d_m": spec.num_d, "d_v": spec.num_d,
            "f": spec.f_spec.num_params}
    if spec.ema_decay > 0.0:
        if bufs.g_ema is None:
            raise ValueError("gan_train: ema_decay > 0 needs the g_ema buffer "
                             "(init_pigan_state(..., ema=True))")
        want["g_ema"] = spec.num_g
    tensors = {name: (getattr(bufs, name), (n,)) for name, n in want.items()}
    g1, g2 = spec.g_hidden
    if len(bufs.bn) != 4:
        raise ValueError("gan_train: bn must hold running mean and var of two BatchNorms")
    for name, t, c in zip(("bn1_mean", "bn1_var", "bn2_mean", "bn2_var"), bufs.bn,
                          (g1, g1, g2, g2)):
        tensors[name] = (t, (c,))
    steps, batch, _ = streams.spectra.shape
    tensors["stream spectra"] = (streams.spectra, (steps, batch, spec.spectrum_dim))
    tensors["stream params"] = (streams.params, (steps, batch, 4))
    tensors["stream metrics_norm"] = (streams.metrics_norm, (steps, batch, 8))
    for name, (t, shape) in tensors.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"gan_train: {name} must be contiguous float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"gan_train: {name} on {t.device}, state on {dev}")
    if tuple(streams.sched.shape) != (steps, len(SCHED_LANES)):
        raise ValueError(f"gan_train: sched must be (T, {len(SCHED_LANES)})")
    if streams.param_lo.numel() != 4 or streams.param_hi.numel() != 4:
        raise ValueError("gan_train: param_lo and param_hi must hold 4 values")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"gan_train: no kernel for device {dev}")
    check_capability(dev.index)
    return True


def gan_train(bufs: GanBuffers, streams: GanStreams, spec: GanTrainSpec) -> torch.Tensor:
    """T training steps over ``bufs`` in place, one kernel launch per call
    on the card; returns the (T, 11) per-step metric rows."""
    if not _check(bufs, streams, spec):
        return gan_train_plain(bufs, streams, spec)
    steps, batch, _ = streams.spectra.shape
    dev = bufs.g.device
    rows = torch.zeros((steps, ROW_WIDTH), dtype=torch.float32, device=dev)
    if steps == 0:
        return rows
    n_work = workspace_floats(spec, batch)
    work = torch.empty(n_work, dtype=torch.float32, device=dev)
    fs = spec.f_spec
    sched = streams.sched.to(torch.float32).contiguous().reshape(-1).tolist()
    dims = (spec.spectrum_dim, *spec.g_hidden, *spec.d_hidden)
    hp = (spec.adv_w, spec.recon_w, spec.pmet_w, spec.maxwell_w, spec.lc_w, spec.range_w,
          spec.constraint_w, spec.window_w, spec.range_lo, spec.range_hi,
          spec.label_real, spec.label_fake, spec.ema_decay, spec.clip,
          *streams.param_lo.tolist(), *streams.param_hi.tolist())
    flags = int(spec.detach_forward) | (int(spec.sigmoid_squash) << 1)
    launch(
        "gan_train", dev,
        bufs.g.data_ptr(), bufs.g_m.data_ptr(), bufs.g_v.data_ptr(),
        bufs.d.data_ptr(), bufs.d_m.data_ptr(), bufs.d_v.data_ptr(),
        *(t.data_ptr() for t in bufs.bn),
        bufs.f.data_ptr(), bufs.g_ema.data_ptr() if spec.ema_decay > 0.0 else None,
        streams.spectra.data_ptr(), streams.params.data_ptr(),
        streams.metrics_norm.data_ptr(),
        (ctypes.c_float * len(sched))(*sched),
        rows.data_ptr(), work.data_ptr(), n_work,
        (ctypes.c_int * len(dims))(*dims),
        (ctypes.c_int * len(fs.dims))(*fs.dims), fs.n_hidden,
        (ctypes.c_longlong * (4 * (fs.n_hidden + 1)))(*(o for offs in fs.offsets for o in offs)),
        batch, steps, (ctypes.c_double * len(hp))(*hp), flags,
    )
    return rows


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
    """multi_epoch(state, ds, scales, indices=None, seeds=None) ->
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
    updated in place and returned; ``seeds`` are drawn (the eager path draws
    them too) and not used: the kernel has no stochastic knob yet."""
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
                    seeds: torch.Tensor | None = None):
        scales = torch.as_tensor(scales, dtype=torch.float32).reshape(-1)
        epochs = int(scales.numel())
        spe = max(1, ds.num_samples // batch)
        indices, _ = resolve_draws(state.generator, ds.num_samples, batch, epochs,
                                   indices, seeds)
        streams = build_streams(ds, indices, scales, state.step, state.g_opt.count,
                                state.d_opt.count, k_d, g_sched_of(spe), d_sched_of(spe))
        for bn in state.batch_norms():
            bn.num_batches_tracked += epochs * spe
        rows = gan_train(state_buffers(state), streams, spec)
        steps = epochs * spe
        state.step += steps
        state.g_opt.count += steps
        state.d_opt.count += int(streams.sched[:, 6].sum())
        return state, epoch_means(rows, epochs, bool(settings.constraint_w))

    return multi_epoch
