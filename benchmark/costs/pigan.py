"""Operations and bytes of each stage, counted from its shapes.

A stage's count is the same whatever implements it (a kernel of the
program, its modules, a library), so that a roofline of a stage stays
comparable when a later change replaces what runs it.

Operations are 2 x the multiply-adds of the dense layers (norms and
activations are left out: a few per cent of a layer's work at these widths).
Bytes count each input byte once and each output byte once for each call the
user makes, and the weights once a call: what a call could not avoid moving.

The training counts are a frozen copy of the program's
``ops/costs.py:pigan_step_costs`` model FLOPs (the JAX package's inventory):
a D-then-G step is G forward, D forward and backward on 2B rows, then D
forward and input gradient, G backward and F forward (and F's input gradient
without ``detach_forward``); a full backward costs twice its forward.  F's
pretraining step is a forward and a full backward of F.  A training phase's
state (parameters, Adam's two moments, BatchNorm statistics, the frozen F)
counts once a phase: a kernel that keeps it on chip across steps must not
read over 100 %.
"""

from __future__ import annotations

from ..reference import models as M

F32 = 4


def chain_macs(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def layer_macs(ops) -> int:
    """Multiply-adds per row of a reference layer list."""
    total = 0
    for op in ops:
        if op[0] == "dense":
            total += op[2] * op[3]
        elif op[0] == "res":
            total += layer_macs(op[1])
    return total


def stage_costs(cfg: dict, rows: int) -> dict:
    """{"gen": (flops, bytes), "fwd": (flops, bytes)} of one design call of
    ``rows`` spectra: G on the spectra, F on G's parameters."""
    s, p, m = cfg["spectrum_dim"], cfg["param_dim"], cfg["metrics_dim"]
    g_ops, f_ops = M.generator_layers(cfg), M.forward_layers(cfg)
    gen = (2 * layer_macs(g_ops) * rows,
           F32 * (rows * (s + p) + M.num_params(g_ops) + 2 * _bn_width(g_ops)))
    fwd = (2 * layer_macs(f_ops) * rows,
           F32 * (rows * (p + s + m) + M.num_params(f_ops)))
    return {"gen": gen, "fwd": fwd}


def _bn_width(ops) -> int:
    return sum(n for _, _, n in (op for op in M._walk(ops) if op[0] == "bn"))


def design_flops(cfg: dict, rows: int) -> float:
    c = stage_costs(cfg, rows)
    return c["gen"][0] + c["fwd"][0]


def _dims(cfg: dict):
    s, p, m = cfg["spectrum_dim"], cfg["param_dim"], cfg["metrics_dim"]
    g = (s, *cfg["generator"]["hidden_dims"], p)
    d = (s + p, *cfg["discriminator"]["hidden_dims"], 1)
    f = (p, *cfg["forward_model"]["hidden_dims"], s + m)
    return g, d, f


def forward_step_flops(cfg: dict) -> int:
    """Model FLOPs of one F pretraining step at the configured batch."""
    _, _, f = _dims(cfg)
    return 2 * 3 * chain_macs(f) * cfg["batch_size"]


def gan_step_flops(cfg: dict) -> int:
    """Model FLOPs of one typed D-then-G step (BCE, no second G pass)."""
    g, d, f = (chain_macs(x) for x in _dims(cfg))
    macs = g + 2 * d + 4 * d            # D phase: G fwd, D fwd 2B, D bwd 2B
    macs += d + d + 2 * g + f           # G phase: D fwd + dX, G bwd, F fwd
    if not cfg["train"]["detach_forward"]:
        macs += f                       # F's input gradient
    return 2 * macs * cfg["batch_size"]


def forward_phase_bytes(cfg: dict, steps: int) -> int:
    """Bytes a stretch of ``steps`` F steps cannot avoid: each step's batch
    once, F's state (parameters and two moments) once."""
    s, p, m = cfg["spectrum_dim"], cfg["param_dim"], cfg["metrics_dim"]
    n = M.num_params(M.forward_layers(cfg))
    return F32 * (steps * cfg["batch_size"] * (s + p + m) + 2 * 3 * n)


def gan_phase_bytes(cfg: dict, steps: int, members: int = 1) -> int:
    """The same for ``steps`` D-then-G steps of ``members`` members: the
    batches, G's and D's state read and written once, the frozen F once."""
    s, p, m = cfg["spectrum_dim"], cfg["param_dim"], cfg["metrics_dim"]
    ng = M.num_params(M.generator_layers(cfg))
    nd = M.num_params(M.discriminator_layers(cfg))
    nf = M.num_params(M.forward_layers(cfg))
    per_member = steps * cfg["batch_size"] * (s + p + m) + 2 * 3 * (ng + nd)
    return F32 * (members * per_member + nf)
