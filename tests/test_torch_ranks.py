"""Rank worker of tests/test_torch_parallel.py: imports torch and the port,
never JAX, and holds no test of its own.

    python tests/test_torch_ranks.py WORLD DIR

spawns WORLD gloo ranks on the CPU (``parallel/mesh.py:spawn_ranks``).
Every rank reads ``DIR/inputs.pt`` (written by the test: the narrow config's
overrides, the dataset, the initial states, the draws), runs every case
below over the mesh and writes what it got to ``DIR/rank<r>.pt``.  The test
runs the same functions with ``mesh=None`` in its own process for world 1.
A rank that raises makes the script exit non-zero.
"""

from __future__ import annotations

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch import nn  # noqa: E402

from pigan_thz_torch import apply_overrides, default_config  # noqa: E402
from pigan_thz_torch.data.dataset import ThzDataset, gather_batch  # noqa: E402
from pigan_thz_torch.models.registry import build_trio  # noqa: E402
from pigan_thz_torch.parallel import mesh as mesh_mod  # noqa: E402
from pigan_thz_torch.parallel.ensemble import (  # noqa: E402
    EnsembleSettings,
    gather_ensemble,
    init_ensemble_states,
    make_ensemble_multi_epoch_fn,
    make_ensemble_pigan_step,
    member_generator,
    shard_ensemble,
)
from pigan_thz_torch.parallel.sharding import (  # noqa: E402
    make_parallel_epoch_fn,
    make_parallel_multi_epoch_fn,
    shard_state,
)
from pigan_thz_torch.train import steps as S  # noqa: E402
from pigan_thz_torch.train.state import (  # noqa: E402
    init_forward_state,
    init_pigan_state,
    make_optimizers,
)
from pigan_thz_torch.train.trainer import Trainer  # noqa: E402


def config(inp: dict, *extra: str):
    return apply_overrides(default_config(), [*inp["overrides"], *extra])


def dataset(inp: dict) -> ThzDataset:
    return ThzDataset(*(t.clone() for t in inp["ds"]))


def tensors(payload: dict) -> dict:
    """A state's payload with its tensors copied out (no views of the state)."""
    return {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in payload.items()}


def pigan_state(inp: dict, cfg, mesh):
    g, d, f = build_trio(cfg, device="cpu")
    spe = inp["ds"][0].shape[0] // cfg.train.batch_size
    g_tx, d_tx, _ = make_optimizers(cfg, spe)
    st = init_pigan_state(g, d, f, g_tx, d_tx, 0, device="cpu")
    st.load_state_dict_(inp["pigan"])
    if mesh is not None:
        shard_state(st, mesh)
    return st, g_tx, d_tx


def forward_state(inp: dict, cfg, mesh, key: str):
    _, _, f = build_trio(cfg, device="cpu")
    spe = inp["ds"][0].shape[0] // cfg.train.batch_size
    _, _, f_tx = make_optimizers(cfg, spe)
    st = init_forward_state(f, f_tx, 0, device="cpu")
    st.load_state_dict_(inp[key])
    if mesh is not None:
        shard_state(st, mesh)
    return st, f_tx


def epochs_fn(step, batch, mesh):
    if mesh is None:
        return S.make_multi_epoch_fn(step, batch)
    return make_parallel_multi_epoch_fn(step, batch, mesh)


def first_step(step, st, inp, ds, batch, mesh, scale=None):
    """One step on the first batch of the draws (through the shard under a
    mesh); the state's payload and the metrics, averaged over the ranks."""
    b = gather_batch(ds, inp["indices"][0, 0])
    seed = int(inp["seeds"][0])
    if mesh is None:
        _, m = step(st, b, scale, seed)
    else:
        _, m = step(st, b, scale, seed, shard=mesh_mod.batch_sharding(mesh, batch))
        m = {k: mesh.mean(v) for k, v in m.items()}
    return tensors(st.state_dict()), {k: v.clone() for k, v in m.items()}


def pigan_cases(inp: dict, mesh) -> dict:
    cfg = config(inp)
    ds, bsz = dataset(inp), cfg.train.batch_size
    out = {}
    settings = S.StepSettings.from_config(cfg, detach_forward=False)
    st, g_tx, d_tx = pigan_state(inp, cfg, mesh)
    step = S.make_pigan_step(g_tx, d_tx, settings, ds.param_lo, ds.param_hi)
    out["pigan_first"] = first_step(step, st, inp, ds, bsz, mesh, 1.0)
    st, g_tx, d_tx = pigan_state(inp, cfg, mesh)
    step = S.make_pigan_step(g_tx, d_tx, settings, ds.param_lo, ds.param_hi)
    st, rows = epochs_fn(step, bsz, mesh)(st, ds, torch.ones(2), inp["indices"], inp["seeds"])
    out["pigan_epochs"] = (tensors(st.state_dict()), rows)
    if mesh is not None:
        st, g_tx, d_tx = pigan_state(inp, cfg, mesh)
        step = S.make_pigan_step(g_tx, d_tx, settings, ds.param_lo, ds.param_hi)
        spe = inp["indices"].shape[1]
        _, rows = make_parallel_epoch_fn(step, bsz, mesh)(
            st, ds, 1.0, inp["indices"][0], inp["seeds"][:spe])
        out["pigan_one_epoch"] = rows
        out.update(planted_faults(inp, cfg, ds, settings, mesh))
    return out


def planted_faults(inp, cfg, ds, settings, mesh) -> dict:
    """The first step with BatchNorm's statistics wrong under the mesh:
    each rank's own rows ("local"), or every rank's rows in the forward but
    no sum over ranks in the backward ("local_backward")."""
    out = {}
    sharded = S._sharded
    sum_ = mesh_mod.BatchShard.sum
    try:
        S._sharded = lambda shard, *modules: contextlib.nullcontext()
        st, g_tx, d_tx = pigan_state(inp, cfg, mesh)
        step = S.make_pigan_step(g_tx, d_tx, settings, ds.param_lo, ds.param_hi)
        out["fault_local"] = first_step(step, st, inp, ds, cfg.train.batch_size, mesh, 1.0)
        S._sharded = sharded
        mesh_mod.BatchShard.sum = lambda self, t: mesh_mod.Mesh.mean(self.mesh, t) * self.world
        st, g_tx, d_tx = pigan_state(inp, cfg, mesh)
        step = S.make_pigan_step(g_tx, d_tx, settings, ds.param_lo, ds.param_hi)
        out["fault_local_backward"] = first_step(step, st, inp, ds, cfg.train.batch_size,
                                                 mesh, 1.0)
    finally:
        S._sharded = sharded
        mesh_mod.BatchShard.sum = sum_
    return out


def forward_cases(inp: dict, mesh) -> dict:
    """The forward step at F's dropout 0.2 (the masks: this rank's rows of
    the global batch's) and at dropout 0 (the JAX comparison)."""
    out = {}
    for key, rate in (("forward", 0.2), ("forward_nodrop", 0.0)):
        cfg = config(inp, f"forward_model.dropout_rate={rate}")
        ds, bsz = dataset(inp), cfg.train.batch_size
        st, f_tx = forward_state(inp, cfg, mesh, key)
        step = S.make_forward_step(f_tx)
        out[f"{key}_first"] = first_step(step, st, inp, ds, bsz, mesh)
        st, f_tx = forward_state(inp, cfg, mesh, key)
        st, rows = epochs_fn(S.make_forward_step(f_tx), bsz, mesh)(
            st, ds, torch.ones(2), inp["indices"], inp["seeds"])
        out[f"{key}_epochs"] = (tensors(st.state_dict()), rows)
    seed, shape = int(inp["seeds"][0]), (inp["indices"].shape[2], 16)
    if mesh is None:
        out["masks"] = S._masks(None, seed, S.FORWARD)(0, shape, 0.2, "cpu")
        out["masks_d_phase"] = S._masks(None, seed, S.D_IN_D_PHASE)(
            0, (2 * shape[0], shape[1]), 0.2, "cpu")
    else:
        shard = mesh_mod.batch_sharding(mesh, shape[0])
        local = (shard.local, shape[1])
        out["masks"] = S._masks(None, seed, S.FORWARD, shard)(0, local, 0.2, "cpu")
        d_phase = (2 * shard.local, shape[1])
        out["masks_d_phase"] = S._masks(None, seed, S.D_IN_D_PHASE, shard)(0, d_phase, 0.2,
                                                                           "cpu")
    return out


def trainer_case(inp: dict, mesh, workdir: str) -> dict:
    cfg = config(inp)
    t = Trainer(cfg, ds=dataset(inp), epochs_per_call=2, engine="auto", device="cpu",
                mesh=mesh)
    hist = t.train(mode="full", forward_epochs=3, gan_epochs=3)
    t.save_final(workdir)
    out = {"trainer_history": hist, "trainer_pigan": tensors(t.pigan_state.state_dict())}
    if mesh is not None:
        try:
            Trainer(cfg, ds=dataset(inp), engine="kernel", device="cpu",
                    mesh=mesh).pretrain_forward(epochs=1)
        except ValueError as e:
            out["kernel_refused"] = str(e)
        if mesh.size == 2:
            # the two ranks as a model axis: the same training, its wide
            # layers split over the ranks (every hidden layer at 16)
            tp_mesh = mesh_mod.make_mesh(data=1, model=2, min_shard_dim=16)
            t = Trainer(cfg, ds=dataset(inp), epochs_per_call=2, engine="auto", device="cpu",
                        mesh=tp_mesh)
            out["model_axis_history"] = t.train(mode="full", forward_epochs=3, gan_epochs=3)
            out["model_axis_shape"] = tuple(t.pigan_state.f.model[8].weight.shape)
    return out


def ensemble_case(inp: dict, mesh) -> dict:
    cfg = config(inp)
    ds, bsz = dataset(inp), cfg.train.batch_size
    spe = ds.num_samples // bsz
    g, d, f = build_trio(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    g_tx, d_tx, _ = make_optimizers(cfg, spe)
    out = {}
    for n in (4, 3):
        states = init_ensemble_states(g, d, f, g_tx, d_tx,
                                      [member_generator(5, m) for m in range(n)],
                                      device="cpu")
        if mesh is not None:
            states = shard_ensemble(states, mesh)
        step = make_ensemble_pigan_step(g_tx, d_tx, EnsembleSettings(detach_forward=False),
                                        ds.param_lo, ds.param_hi)
        states, rows = make_ensemble_multi_epoch_fn(step, bsz)(
            states, ds, torch.Generator().manual_seed(3), inp["weights"][:n], 1)
        local = len(states)
        full = gather_ensemble(states)
        out[f"ensemble_{n}"] = {"local": local, "rows": rows,
                                "g": full.g_params.clone(), "d": full.d_params.clone(),
                                "g_m": full.g_m.clone(), "bn": [t.clone() for t in full.bn]}
    return out


class Staircase(nn.Module):
    """A surrogate whose spectra depend on the parameters only through a
    coarse grid: many candidates tie exactly.  One of the parameters below
    a threshold gives NaN spectra (NaN scores)."""

    def __init__(self, freq: torch.Tensor):
        super().__init__()
        self.register_buffer("freq", freq)

    def forward(self, pn):
        q = torch.round(pn * 3.0) / 3.0
        centre = 1.0 + q[:, :1] + 0.3 * q[:, 1:2]
        width = 0.05 + 0.02 * (q[:, 2:3] + 1.0)
        depth = 10.0 + 5.0 * q[:, 3:4]
        spec = -depth * torch.exp(-((self.freq[None, :] - centre) / width) ** 2)
        spec = torch.where(pn[:, :1] < -0.9, torch.nan, spec)
        return spec, torch.zeros(pn.shape[0], 8)


def screen_case(inp: dict, mesh) -> dict:
    from pigan_thz_torch.design import ScreeningConfig, screen_designs
    from pigan_thz_torch.models.registry import build_forward_model

    ds = dataset(inp)
    out = {}
    cfg = config(inp)
    f = build_forward_model(cfg.forward_model, 250, 8, 4, device="cpu",
                            generator=torch.Generator().manual_seed(4))
    for name, model, objective in (("screen_f", f, "FoM1"),
                                   ("screen_ties", Staircase(ds.frequencies), "Q1")):
        sc = ScreeningConfig(num_candidates=2500, chunk_size=512, top_k=24,
                             objective=objective)
        res = screen_designs(model, ds.frequencies, ds.param_lo, ds.param_hi,
                             torch.Generator().manual_seed(9), sc, mesh=mesh)
        out[name] = {k: getattr(res, k).clone() for k in res._fields}
    return out


def run_all(inp: dict, mesh, workdir: str) -> dict:
    out = {}
    world = 1 if mesh is None else mesh.size
    if inp["indices"].shape[2] % world == 0:
        out.update(pigan_cases(inp, mesh))
        out.update(forward_cases(inp, mesh))
        out.update(trainer_case(inp, mesh, workdir))
    else:
        try:
            make_parallel_multi_epoch_fn(lambda *a: None, inp["indices"].shape[2], mesh)
        except ValueError as e:
            out["indivisible"] = str(e)
    out.update(ensemble_case(inp, mesh))
    out.update(screen_case(inp, mesh))
    return out


def rank_main(rank: int, world: int, address: str, directory: str) -> None:
    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(address, world, rank, device="cpu")
    mesh = mesh_mod.make_mesh()
    inp = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    out = run_all(inp, mesh, os.path.join(directory, f"models{world}"))
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))


if __name__ == "__main__":
    mesh_mod.spawn_ranks(rank_main, int(sys.argv[1]), sys.argv[2])
