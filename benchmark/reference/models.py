"""The plain reference of the trio: G, D and F as lists of layers, run by one
interpreter in plain PyTorch, float32.

A frozen copy of the published models' math (jianghu105/PI-GAN-THz
``core/models/{generator,discriminator,forward_model}.py`` and
``enhanced_generator.py``), written from the configuration file alone.  It
imports nothing of the program.  Weights are a dict {name: tensor}; the
names and their order are the program's torch layout (``main.0.weight``
...), which is also the published PyTorch code's, so that the benchmark can
hand both sides the same tensors.

Every product goes through ``linear``, whose ``precision`` is "fp32" (TF32
off: the reference) or "tf32" (the operands rounded to TF32's 10-bit
mantissa, forward and backward: the control that a check has to refuse).
"""

from __future__ import annotations

import torch

LAYER_NORM_EPS = 1e-6
BATCH_NORM_EPS = 1e-5
BATCH_NORM_MOMENTUM = 0.1


def fp32_only() -> None:
    """Keep cuBLAS and cuDNN off TF32, as the reference requires."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Products in a stated precision
# ---------------------------------------------------------------------------


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (1 + 8 + 10 bits), to nearest, as float32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = to_tf32(x), to_tf32(w)
        ctx.save_for_backward(xr, wr)
        return torch.addmm(b, xr, wr.t())

    @staticmethod
    def backward(ctx, dy):
        xr, wr = ctx.saved_tensors
        dyr = to_tf32(dy)
        return dyr @ wr, dyr.t() @ xr, dy.sum(dim=0)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return torch.addmm(b, x, w.t())
    if precision == "tf32":
        return _Tf32Linear.apply(x, w, b)
    raise ValueError(f"precision {precision!r}")


# ---------------------------------------------------------------------------
# The models as layer lists
# ---------------------------------------------------------------------------


def generator_layers(cfg: dict) -> list:
    g = cfg["generator"]
    s, p = cfg["spectrum_dim"], cfg["param_dim"]
    if g["name"] == "mlp":
        ops, i, d = [], 0, s
        for h in g["hidden_dims"]:
            ops += [("dense", f"main.{i}", d, h), ("bn", f"main.{i + 1}", h), ("relu",)]
            i, d = i + 3, h
        return ops + [("dense", f"main.{i}", d, p), ("tanh",)]
    if g["name"] == "residual":
        w = g["width"]
        ops = [("dense", "main.0", s, w), ("bn", "main.1", w), ("relu",)]
        i = 3
        for _ in range(g["residual_blocks"]):
            pre = f"main.{i}.body"
            ops.append(("res", [("dense", f"{pre}.0", w, w), ("bn", f"{pre}.1", w), ("relu",),
                                ("dropout", g["residual_dropout"]),
                                ("dense", f"{pre}.4", w, w), ("bn", f"{pre}.5", w)]))
            i += 1
        d = w
        for h, rate in zip(g["head_dims"], g["head_dropout"]):
            ops += [("dense", f"main.{i}", d, h), ("bn", f"main.{i + 1}", h), ("relu",),
                    ("dropout", rate)]
            i, d = i + 4, h
        return ops + [("dense", f"main.{i}", d, p), ("tanh",)]
    raise ValueError(f"no reference for generator {g['name']!r}")


def discriminator_layers(cfg: dict) -> list:
    dc = cfg["discriminator"]
    if dc["name"] != "mlp":
        raise ValueError(f"no reference for discriminator {dc['name']!r}")
    ops, i, d = [], 0, cfg["spectrum_dim"] + cfg["param_dim"]
    for h in dc["hidden_dims"]:
        ops += [("dense", f"main.{i}", d, h), ("lrelu", dc["leaky_slope"])]
        i, d = i + 2, h
    return ops + [("dense", f"main.{i}", d, 1)]


def forward_layers(cfg: dict) -> list:
    fc = cfg["forward_model"]
    if fc["name"] != "mlp":
        raise ValueError(f"no reference for forward model {fc['name']!r}")
    ops, i, d = [], 0, cfg["param_dim"]
    for h in fc["hidden_dims"]:
        ops += [("dense", f"model.{i}", d, h), ("ln", f"model.{i + 1}", h),
                ("lrelu", fc["leaky_slope"]), ("dropout", fc["dropout_rate"])]
        i, d = i + 4, h
    return ops + [("dense", f"model.{i}", d, cfg["spectrum_dim"] + cfg["metrics_dim"])]


def _walk(ops):
    for op in ops:
        if op[0] == "res":
            yield from _walk(op[1])
        else:
            yield op


def param_layout(ops) -> list:
    """(name, shape, kind) of every parameter, in the program's order."""
    out = []
    for op in _walk(ops):
        if op[0] == "dense":
            _, pre, din, dout = op
            out += [(f"{pre}.weight", (dout, din), "dense_w"), (f"{pre}.bias", (dout,), "dense_b")]
        elif op[0] in ("bn", "ln"):
            _, pre, n = op
            out += [(f"{pre}.weight", (n,), "norm_w"), (f"{pre}.bias", (n,), "norm_b")]
    return out


def buffer_layout(ops) -> list:
    """(name, shape, kind) of every floating buffer (BatchNorm's running
    statistics), in the program's order."""
    out = []
    for op in _walk(ops):
        if op[0] == "bn":
            _, pre, n = op
            out += [(f"{pre}.running_mean", (n,), "bn_mean"),
                    (f"{pre}.running_var", (n,), "bn_var")]
    return out


def num_params(ops) -> int:
    total = 0
    for _, shape, _ in param_layout(ops):
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


# ---------------------------------------------------------------------------
# The interpreter
# ---------------------------------------------------------------------------


def run(ops, w: dict, x: torch.Tensor, *, train: bool = False, masks=None,
        precision: str = "fp32", stats: dict | None = None) -> torch.Tensor:
    """The model ``ops`` with weights ``w`` on ``x``.  ``train``: BatchNorm
    on the batch's statistics (two-pass biased variance; ``stats``, when
    given, receives each layer's (mean, var)), dropout by ``masks(i, shape,
    rate)`` for the i-th dropout layer; else BatchNorm on the running
    statistics and no dropout."""
    counter = [0]

    def go(ops, h):
        for op in ops:
            kind = op[0]
            if kind == "dense":
                pre = op[1]
                h = linear(h, w[f"{pre}.weight"], w[f"{pre}.bias"], precision)
            elif kind == "bn":
                pre = op[1]
                if train:
                    mean = h.mean(dim=0)
                    var = ((h - mean) ** 2).mean(dim=0)
                    if stats is not None:
                        stats[pre] = (mean.detach(), var.detach())
                else:
                    mean, var = w[f"{pre}.running_mean"], w[f"{pre}.running_var"]
                h = (h - mean) * torch.rsqrt(var + BATCH_NORM_EPS) * w[f"{pre}.weight"] \
                    + w[f"{pre}.bias"]
            elif kind == "ln":
                pre = op[1]
                mean = h.mean(dim=-1, keepdim=True)
                var = ((h - mean) ** 2).mean(dim=-1, keepdim=True)
                h = (h - mean) * torch.rsqrt(var + LAYER_NORM_EPS) * w[f"{pre}.weight"] \
                    + w[f"{pre}.bias"]
            elif kind == "relu":
                h = torch.relu(h)
            elif kind == "lrelu":
                h = torch.where(h >= 0, h, op[1] * h)
            elif kind == "tanh":
                h = torch.tanh(h)
            elif kind == "dropout":
                i = counter[0]
                counter[0] += 1
                if train and op[1] > 0:
                    h = h * masks(i, tuple(h.shape), op[1])
            elif kind == "res":
                h = torch.relu(h + go(op[1], h))
            else:
                raise ValueError(f"unknown layer {kind!r}")
        return h

    return go(ops, x)


def normalize_params(params: torch.Tensor, cfg: dict) -> torch.Tensor:
    lo, hi = cfg["param_min"], cfg["param_max"]
    return (params - lo) / (hi - lo) * 2.0 - 1.0


def denormalize_params(params_norm: torch.Tensor, cfg: dict) -> torch.Tensor:
    lo, hi = cfg["param_min"], cfg["param_max"]
    return (params_norm + 1.0) / 2.0 * (hi - lo) + lo


def normalize_metrics(metrics: torch.Tensor) -> torch.Tensor:
    """Min-max per column over the set, NaN and zero-span columns -> 0.5."""
    lo, hi = metrics.amin(dim=0), metrics.amax(dim=0)
    span = hi - lo
    unit = torch.where(span > 1e-6, (metrics - lo) / torch.where(span > 1e-6, span, 1.0), 0.5)
    return torch.where(torch.isnan(unit), 0.5, unit)
