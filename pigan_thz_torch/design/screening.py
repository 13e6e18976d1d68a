"""Large-scale inverse-design screening.

The port of ``pigan_thz_tpu/design/screening.py`` (BASELINE.json config #5:
"generate 1e6 candidate (r1,r2,w,g) sets and rank by surrogate Q/FoM"):

1. draw candidate parameters uniformly in the normalised design box from
   one ``torch.Generator`` on the device;
2. run the frozen forward surrogate on each chunk, either its eval-mode
   module forward (in fp32, or with ``compute_dtype="bfloat16"`` its bf16
   twin, whose parameters are rounded to bf16 once, as the JAX package
   casts the variables; the spectra go back to fp32) or, with
   ``use_pallas``, the fused forward kernel (``ops/fused_kernels.py``, K5;
   the name is the JAX package's; fp32 only);
3. derive the physics metrics (f_res, Q, FoM, S) from the PREDICTED spectra
   with the peak analysis (``ops/peaks.py``, the K4 kernel on the card);
4. keep a running top-k over the chunks: a stable descending sort of the
   kept and the new scores, so that equal scores keep the earlier
   candidate, as ``jax.lax.top_k`` breaks ties by index.

The chunk loop is a Python loop; every chunk stays on the device and the
host never waits on it.  ``screen_designs`` returns physical-unit
parameters with their scores.

Over the ranks of a mesh (``parallel/mesh.py``) every rank draws every
chunk's candidates from its generator, the draw sequence of one rank, and
screens the chunks c with c mod W = its rank, at the same chunk size, so
each candidate gets the same bits as on one rank; the ranks then gather
their top-k (with each candidate's index) and merge them by score and
index: the result is the one-rank screen's, row for row.  Unlike the JAX
package, which refuses ``use_pallas`` with a mesh (``pallas_call`` has no
SPMD partitioning rule), each rank here launches the fused kernel on whole
chunks of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch import nn

from ..config import METRIC_NAMES
from ..data.dataset import denormalize_params
from ..models.blocks import bf16_twin
from ..ops.fused_kernels import forward_surrogate_fused, pack_forward_model
from ..ops.peaks import batched_peak_metrics

METRIC_INDEX = {name: i for i, name in enumerate(METRIC_NAMES)}


class ScreeningResult(NamedTuple):
    params: torch.Tensor     # (top_k, 4) physical units
    scores: torch.Tensor     # (top_k,)
    metrics: torch.Tensor    # (top_k, 8) spectrum-derived metrics
    spectra: torch.Tensor    # (top_k, S) predicted spectra of the winners
    valid: torch.Tensor      # (top_k,) bool: score > -inf (False rows are
    # filler when fewer than top_k candidates scored)


@dataclass(frozen=True)
class ScreeningConfig:
    num_candidates: int = 1_000_000
    chunk_size: int = 8192
    top_k: int = 100
    objective: str = "FoM1"      # any METRIC_INDEX key or "FoM1+FoM2"
    min_prominence: float = 1.0
    # Run the surrogate through the fused forward kernel (baseline
    # ForwardMLP only) instead of the module's forward.
    use_pallas: bool = False
    # "float32" | "bfloat16" (the surrogate's forward; rankings may differ
    # near ties)
    compute_dtype: str = "float32"


def _score(metrics: torch.Tensor, objective: str) -> torch.Tensor:
    """NaN-safe objective: missing peaks score -inf."""
    def one(name):
        v = metrics[:, METRIC_INDEX[name]]
        return torch.where(torch.isnan(v), -torch.inf, v)

    return sum(one(p) for p in objective.split("+"))


def screen_chunk(
    surrogate: Callable[[torch.Tensor], torch.Tensor],
    params_norm: torch.Tensor,
    frequencies: torch.Tensor,
    cfg: ScreeningConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk: candidates (C, 4) -> predicted spectra (C, S) -> metrics
    (C, 8) -> scores (C,), NaN scores set to -inf."""
    spectra = surrogate(params_norm).contiguous()
    metrics = batched_peak_metrics(
        frequencies, spectra, min_prominence=cfg.min_prominence
    )
    scores = _score(metrics, cfg.objective)
    # NaN scores (e.g. a ±inf-mixing composite objective) must sort last
    scores = torch.where(torch.isnan(scores), -torch.inf, scores)
    return spectra, metrics, scores


def make_surrogate(
    forward_model: nn.Module, use_pallas: bool, device: torch.device, spectrum_dim: int,
    compute_dtype: str = "float32",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """params_norm -> predicted spectra (fp32): the fused kernel on weights
    packed once here, the module's forward (call it in eval mode) or, in
    bfloat16, the module's bf16 twin with its parameters rounded to bf16."""
    if use_pallas:
        packed = pack_forward_model(forward_model, device)
        return lambda pn: forward_surrogate_fused(packed, pn, spectrum_dim)[0]
    if compute_dtype == "bfloat16":
        twin = bf16_twin(forward_model, round_params=True).eval()
        return lambda pn: twin(pn)[0].to(torch.float32)
    return lambda pn: forward_model(pn)[0]


def _best(k: int, scores: torch.Tensor, *rows: torch.Tensor) -> tuple:
    """The k best of ``scores`` and the matching rows of ``rows``: a stable
    descending sort, so equal scores keep their order."""
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    return (scores[order], *(r[order] for r in rows))


def screen_designs(
    forward_model: nn.Module,
    frequencies: torch.Tensor,
    param_lo: torch.Tensor,
    param_hi: torch.Tensor,
    generator: torch.Generator,
    cfg: ScreeningConfig = ScreeningConfig(),
    mesh=None,
) -> ScreeningResult:
    """Screen ``cfg.num_candidates`` candidates on the device of
    ``param_lo`` (where the forward model and ``generator`` live too);
    returns the global top-k designs.  The forward model runs in eval mode
    and is left in the mode it came in.  With ``mesh`` every rank calls
    this with the same arguments and gets the whole result."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: use float32 | bfloat16")
    if cfg.compute_dtype == "bfloat16" and cfg.use_pallas:
        raise ValueError("use_pallas supports float32 only")
    world, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    device = param_lo.device
    frequencies = torch.as_tensor(frequencies, dtype=torch.float32, device=device)
    n_chunks = -(-cfg.num_candidates // cfg.chunk_size)
    k, p, s = cfg.top_k, param_lo.shape[0], frequencies.shape[0]
    rows = torch.arange(cfg.chunk_size, device=device)

    # (scores, candidate index, params_norm, metrics, spectra); filler rows
    # come first among equal scores (index -1)
    top = (torch.full((k,), -torch.inf, device=device),
           torch.full((k,), -1, dtype=torch.int64, device=device),
           torch.zeros((k, p), device=device),
           torch.zeros((k, len(METRIC_NAMES)), device=device),
           torch.zeros((k, s), device=device))
    was_training = forward_model.training
    forward_model.eval()
    try:
        with torch.inference_mode():
            surrogate = make_surrogate(forward_model, cfg.use_pallas, device, s,
                                       cfg.compute_dtype)
            for c in range(n_chunks):
                n_valid = min(cfg.chunk_size, cfg.num_candidates - c * cfg.chunk_size)
                params_norm = torch.rand(
                    (cfg.chunk_size, p), generator=generator, device=device
                ) * 2.0 - 1.0
                if c % world != rank:
                    continue            # another rank's chunk: drawn, not screened
                spectra, metrics, scores = screen_chunk(
                    surrogate, params_norm, frequencies, cfg
                )
                # ceil-divide chunking: rows past num_candidates in the final
                # chunk are padding, not extra free screening
                scores = torch.where(rows < n_valid, scores, -torch.inf)
                new = (scores, c * cfg.chunk_size + rows, params_norm, metrics, spectra)
                top = _best(k, *(torch.cat([a, b]) for a, b in zip(top, new)))
        if world > 1:
            # every rank's top-k in candidate order, then by score: the
            # order of one rank's running merge
            every = [torch.cat(mesh.all_gather(t)) for t in top]
            by_index = torch.sort(every[1], stable=True).indices
            top = _best(k, *(t[by_index] for t in every))
    finally:
        forward_model.train(was_training)
    top_scores, _, top_params, top_metrics, top_spectra = top
    return ScreeningResult(
        params=denormalize_params(top_params, param_lo, param_hi),
        scores=top_scores, metrics=top_metrics, spectra=top_spectra,
        valid=top_scores > -torch.inf,
    )


def screening_throughput(num_candidates: int, seconds: float) -> float:
    return num_candidates / seconds
