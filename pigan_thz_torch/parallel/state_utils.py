"""The member-stacked PI-GAN state: the port of
``pigan_thz_tpu/parallel/state_utils.py`` (``tree_stack`` / ``tree_unstack``
of ``PiGanState`` pytrees).

A JAX ``PiGanState`` is a pytree, so stacking N of them gives every leaf a
leading member axis.  The port's ``PiGanState`` holds modules over flat
buffers, so its stacked form, ``EnsembleState``, is one contiguous (M, P)
buffer per part (G's and D's parameters, Adam's two moments of each, the
four BatchNorm running stats, the optional EMA) whose row m member m's
``PiGanState`` views: the member-packed kernel takes the stacked buffers,
and the one-member kernel or the eager step can take any member alone, in
place, with no copy either way.  Members that were built from one frozen F
share one F module and buffer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import torch
from torch import nn

from ..train.state import PiGanState, bind_flat_
from ..utils.profiling import host_bool


@dataclass(frozen=True)
class MemberBlock:
    """Members ``start`` ... ``start + k - 1`` of ``total``, this rank's
    share of an ensemble split over the ranks of ``mesh``."""

    mesh: object
    start: int
    total: int


@dataclass
class EnsembleState:
    """M ``PiGanState``s over stacked buffers.

    ``members[m]``'s buffers are row m of ``g_params`` (M, Pg), ``d_params``
    (M, Pd), ``g_m``, ``g_v``, ``d_m``, ``d_v``, the four ``bn`` stats
    (M, C) and ``g_ema`` ((M, Pg) or None).  ``shared_f`` says that every
    member's ``f`` is the one module over ``f_params``; without it each
    member keeps a frozen F of its own.  Counts, generators and
    ``num_batches_tracked`` stay on the members."""

    members: list[PiGanState]
    g_params: torch.Tensor
    d_params: torch.Tensor
    g_m: torch.Tensor
    g_v: torch.Tensor
    d_m: torch.Tensor
    d_v: torch.Tensor
    bn: tuple[torch.Tensor, ...]
    g_ema: torch.Tensor | None
    shared_f: bool
    # set by ``parallel/ensemble.py:shard_ensemble``: this rank's members
    # are ``block.start`` ... of ``block.total`` over ``block.mesh``
    block: "MemberBlock | None" = None

    def __len__(self) -> int:
        return len(self.members)

    def __getitem__(self, m: int) -> PiGanState:
        return self.members[m]

    def __iter__(self) -> Iterator[PiGanState]:
        return iter(self.members)

    @property
    def device(self) -> torch.device:
        return self.g_params.device

    @property
    def f(self) -> nn.Module:
        """The shared frozen F (member 0's when the members' differ)."""
        return self.members[0].f

    @property
    def f_params(self) -> torch.Tensor:
        return self.members[0].f_params

    def clone(self) -> "EnsembleState":
        """An independent copy: stacked buffers of its own."""
        out = tree_stack([m.clone() for m in self.members])
        out.block = self.block
        return out

    def is_finite(self) -> bool:
        tensors = [self.g_params, self.d_params, self.g_m, self.g_v, self.d_m, self.d_v,
                   *self.bn]
        if self.g_ema is not None:
            tensors.append(self.g_ema)
        return all(host_bool(torch.isfinite(t).all()) for t in tensors)


def _rows(like: torch.Tensor, count: int, device) -> torch.Tensor:
    return torch.empty((count, like.numel()), dtype=like.dtype, device=device)


def tree_stack(states: Sequence[PiGanState],
               device: torch.device | str | None = None) -> EnsembleState:
    """Stack member states into contiguous (M, ...) buffers on ``device``
    (default: the first member's) and make each member a view of its row.

    The given states are re-homed in place: afterwards their modules,
    moments, BatchNorm stats and EMA live in the stacked buffers, so
    training a member alone updates the stack and the reverse.  Members
    whose frozen F holds the same weights exactly end up sharing member 0's
    F module and buffer.  All members carry an EMA track or none does."""
    states = list(states)
    if not states:
        raise ValueError("tree_stack: no states")
    if len({st.g_ema is None for st in states}) > 1:
        raise ValueError("tree_stack: members must agree on the EMA track (g_ema)")
    first = states[0]
    device = first.device if device is None else torch.device(device)
    count = len(states)
    norms = first.batch_norms()
    ens = EnsembleState(
        members=states,
        g_params=_rows(first.g_params, count, device),
        d_params=_rows(first.d_params, count, device),
        g_m=_rows(first.g_opt.m, count, device), g_v=_rows(first.g_opt.v, count, device),
        d_m=_rows(first.d_opt.m, count, device), d_v=_rows(first.d_opt.v, count, device),
        bn=tuple(_rows(t, count, device) for n in norms
                 for t in (n.running_mean, n.running_var)),
        g_ema=None if first.g_ema is None else _rows(first.g_ema, count, device),
        shared_f=False)
    with torch.no_grad():
        f_host = [st.f_params.to(device) for st in states]
        ens.shared_f = all(torch.equal(f_host[0], t) for t in f_host[1:])
        for m, st in enumerate(states):
            for module, flat in ((st.g, ens.g_params), (st.d, ens.d_params)):
                bind_flat_(module, flat[m])     # copies the values in, then views
            st.g_params, st.d_params = ens.g_params[m], ens.d_params[m]
            for opt, rows_m, rows_v in ((st.g_opt, ens.g_m, ens.g_v),
                                        (st.d_opt, ens.d_m, ens.d_v)):
                rows_m[m].copy_(opt.m)
                rows_v[m].copy_(opt.v)
                opt.m, opt.v = rows_m[m], rows_v[m]
            k = 0
            for norm in st.batch_norms():
                for name in ("running_mean", "running_var"):
                    buf = getattr(norm, name)
                    ens.bn[k][m].copy_(buf)
                    buf.data = ens.bn[k][m]
                    k += 1
                norm.num_batches_tracked.data = norm.num_batches_tracked.data.to(device)
            if st.g_ema is not None:
                ens.g_ema[m].copy_(st.g_ema)
                st.g_ema = ens.g_ema[m]
            if ens.shared_f and m > 0:
                st.f, st.f_params = first.f, first.f_params
            elif st.f_params.device != device:
                st.f_params = f_host[m].contiguous()
                bind_flat_(st.f, st.f_params)
    return ens


def tree_unstack(states: EnsembleState) -> list[PiGanState]:
    """The members, each a ``PiGanState`` over its row of the stack."""
    return list(states.members)
