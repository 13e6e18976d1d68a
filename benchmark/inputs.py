"""Everything a run feeds the program, made by the benchmark from ``--seed``.

The program under test and the plain reference get the same tensors from
here; neither makes its own.  Three kinds of input:

- a training set (parameters, spectra, metrics) of a synthetic THz
  metamaterial: two Lorentzian transmission dips in dB whose centres, widths
  and depths follow the four structural parameters, plus measurement noise;
- a pool of request spectra for the design cells, from the same oracle;
- model weights, laid out as ``reference.models`` lists them, drawn on the
  device in one call from a ``torch.Generator`` on that device.

Seeds: a run's seed (any whole number, also above 2**63) is folded with a tag
into a 63-bit seed for each draw (``derive``), so that the draws are
independent of each other and the same seed always gives the same inputs.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the draw named by ``tags`` under the run's ``seed``."""
    text = repr((int(seed),) + tuple(tags)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def host_rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))


def frequencies(cfg: dict, device) -> torch.Tensor:
    return torch.linspace(cfg["freq_min"], cfg["freq_max"], cfg["spectrum_dim"],
                          dtype=torch.float32, device=device)


def oracle(params: torch.Tensor, cfg: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(spectra (N, S) in dB, metrics (N, 8)) of physical parameters (N, 4):
    dip k at f_k with half width w_k and depth d_k; the metrics are
    f1, f2, Q1, FoM1, S1, Q2, FoM2, S2 (Q = f / 2w, FoM = depth / 2w,
    S = depth / f)."""
    lo, hi = cfg["param_min"], cfg["param_max"]
    u = (params - lo) / (hi - lo)                       # (N, 4) in [0, 1]
    r1, r2, w, g = u.unbind(dim=1)
    f1 = 0.8 + 1.2 * (0.4 * r1 + 0.6 * w)
    f2 = 1.6 + 1.2 * (0.3 * r2 + 0.7 * g)
    w1 = 0.03 + 0.04 * w
    w2 = 0.03 + 0.04 * g
    d1 = 15.0 + 10.0 * r1
    d2 = 12.0 + 10.0 * r2
    f = frequencies(cfg, params.device)[None, :]
    spectra = -(d1[:, None] / (1.0 + ((f - f1[:, None]) / w1[:, None]) ** 2)
                + d2[:, None] / (1.0 + ((f - f2[:, None]) / w2[:, None]) ** 2))
    metrics = torch.stack([f1, f2, f1 / (2 * w1), d1 / (2 * w1), d1 / f1,
                           f2 / (2 * w2), d2 / (2 * w2), d2 / f2], dim=1)
    return spectra, metrics


def draw_params(n: int, cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    lo, hi = cfg["param_min"], cfg["param_max"]
    return lo + (hi - lo) * torch.rand((n, cfg["param_dim"]), generator=gen, device=device)


def training_set(cfg: dict, seed: int, device) -> dict:
    """The cell's training set: {"params", "spectra", "metrics"}, float32 on
    ``device``, ``cfg["num_samples"]`` rows."""
    gen = generator(device, seed, "training-set")
    n = cfg["num_samples"]
    params = draw_params(n, cfg, gen, device)
    spectra, metrics = oracle(params, cfg)
    spectra = spectra + cfg["noise_level"] * torch.randn(spectra.shape, generator=gen,
                                                         device=device)
    return {"params": params, "spectra": spectra, "metrics": metrics}


def request_pool(cfg: dict, rows: int, seed: int, device) -> torch.Tensor:
    """``rows`` request spectra (rows, S) on ``device``."""
    gen = generator(device, seed, "request-pool")
    spectra, _ = oracle(draw_params(rows, cfg, gen, device), cfg)
    return spectra + cfg["noise_level"] * torch.randn(spectra.shape, generator=gen,
                                                      device=device)


def make_weights(layout, seed: int, device, *tags, trained_stats: bool = False) -> dict:
    """{name: tensor} for ``layout`` ((name, shape, kind) in the program's
    parameter order, then the buffers), drawn in one call: a dense kernel
    N(0, 1 / fan_in), a bias N(0, 0.02^2), a norm's scale 1 + N(0, 0.05^2)
    and shift N(0, 0.05^2); BatchNorm running statistics 0 and 1, or with
    ``trained_stats`` a mean N(0, 0.2^2) and a variance 1 + |N(0, 0.3^2)|, as
    a trained model carries."""
    sizes = [math.prod(shape) for _, shape, _ in layout]
    z = torch.randn(sum(sizes), generator=generator(device, seed, "weights", *tags),
                    device=device)
    out, pos = {}, 0
    for (name, shape, kind), size in zip(layout, sizes):
        t = z[pos:pos + size].view(shape)
        pos += size
        if kind == "dense_w":
            t = t / math.sqrt(shape[1])
        elif kind == "dense_b":
            t = 0.02 * t
        elif kind == "norm_w":
            t = 1.0 + 0.05 * t
        elif kind == "norm_b":
            t = 0.05 * t
        elif kind == "bn_mean":
            t = 0.2 * t if trained_stats else torch.zeros_like(t)
        elif kind == "bn_var":
            t = 1.0 + 0.3 * t.abs() if trained_stats else torch.ones_like(t)
        else:
            raise ValueError(f"unknown kind {kind!r} of {name}")
        out[name] = t.contiguous()
    return out
