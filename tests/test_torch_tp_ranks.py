"""Rank worker of tests/test_torch_tensor_parallel.py: imports torch and the
port, never JAX, and holds no test of its own.

    python tests/test_torch_tp_ranks.py DATA MODEL DIR

spawns DATA x MODEL gloo ranks on the CPU (``parallel/mesh.py:spawn_ranks``)
over ``make_mesh(data=DATA, model=MODEL, min_shard_dim=...)``.  Every rank
reads ``DIR/inputs.pt`` (written by the test: the narrow config's overrides,
the dataset, the initial states, the draws, ``min_shard_dim``), runs every
case below and writes what it got to ``DIR/rank<r>.pt``: the states whole
(``gather_state``), so that the test holds them against world 1's.  The
test runs the same functions with ``mesh=None`` for world 1.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import test_torch_ranks as R  # noqa: E402
from pigan_thz_torch.data.dataset import gather_batch  # noqa: E402
from pigan_thz_torch.parallel import mesh as mesh_mod  # noqa: E402
from pigan_thz_torch.parallel import tensor as tp  # noqa: E402
from pigan_thz_torch.train import checkpoint as ckpt  # noqa: E402
from pigan_thz_torch.train import steps as S  # noqa: E402
from pigan_thz_torch.train.trainer import Trainer  # noqa: E402

TRAINER_EPOCHS = 3


def whole(st) -> dict:
    """The state's payload whole (its split leaves gathered), copied out."""
    return R.tensors(tp.gather_state(st).state_dict())


def shard_of(mesh, batch):
    return None if mesh is None or mesh.data_size == 1 else mesh_mod.batch_sharding(mesh, batch)


def first_step(step, st, inp, ds, batch, mesh, scale):
    b = gather_batch(ds, inp["indices"][0, 0])
    kw = {} if shard_of(mesh, batch) is None else {"shard": shard_of(mesh, batch)}
    _, m = step(st, b, scale, int(inp["seeds"][0]), **kw)
    if mesh is not None:
        m = {k: mesh.mean(v) for k, v in m.items()}
    return whole(st), {k: v.clone() for k, v in m.items()}


def step_cases(inp: dict, mesh) -> dict:
    """The PI-GAN step through F and the forward step at dropout 0.2 and 0:
    the first step and two epochs."""
    out = {}
    cfg = R.config(inp)
    ds, bsz = R.dataset(inp), cfg.train.batch_size
    settings = S.StepSettings.from_config(cfg, detach_forward=False)
    for name in ("first", "epochs"):
        st, g_tx, d_tx = R.pigan_state(inp, cfg, mesh)
        step = S.make_pigan_step(g_tx, d_tx, settings, ds.param_lo, ds.param_hi)
        if name == "first":
            out["pigan_first"] = first_step(step, st, inp, ds, bsz, mesh, 1.0)
        else:
            st, rows = R.epochs_fn(step, bsz, mesh)(st, ds, torch.ones(2), inp["indices"],
                                                    inp["seeds"])
            out["pigan_epochs"] = (whole(st), rows)
    for key, rate in (("forward", 0.2), ("forward_nodrop", 0.0)):
        fcfg = R.config(inp, f"forward_model.dropout_rate={rate}")
        st, f_tx = R.forward_state(inp, fcfg, mesh, key)
        out[f"{key}_first"] = first_step(S.make_forward_step(f_tx), st, inp, ds, bsz, mesh,
                                         None)
        st, f_tx = R.forward_state(inp, fcfg, mesh, key)
        st, rows = R.epochs_fn(S.make_forward_step(f_tx), bsz, mesh)(
            st, ds, torch.ones(2), inp["indices"], inp["seeds"])
        out[f"{key}_epochs"] = (whole(st), rows)
    if mesh is not None:
        out.update(planted_clip_fault(inp, cfg, ds, settings, mesh))
        out.update(flop_counts(inp, cfg, ds, mesh))
    return out


def planted_clip_fault(inp, cfg, ds, settings, mesh) -> dict:
    """The first step with the clip's norm counting every leaf over the
    model group: the replicated leaves M times."""
    sq_norm = tp.ShardPlan.sq_norm
    try:
        tp.ShardPlan.sq_norm = lambda self, g: self.axis.all_reduce(
            torch.sum(g * g).reshape(1))[0]
        st, g_tx, d_tx = R.pigan_state(inp, cfg, mesh)
        step = S.make_pigan_step(g_tx, d_tx, settings, ds.param_lo, ds.param_hi)
        return {"fault_clip": first_step(step, st, inp, ds, cfg.train.batch_size, mesh, 1.0)}
    finally:
        tp.ShardPlan.sq_norm = sq_norm


def flop_counts(inp, cfg, ds, mesh) -> dict:
    """FlopCounterMode's count of F's eval forward and of a train-mode
    forward and backward of G on this rank, split (the mesh's plan) and as
    the plain module computes it (a replicated plan)."""
    out = {}
    st, _, _ = R.pigan_state(inp, cfg, mesh)
    x = ds.params_norm[:cfg.train.batch_size]
    spectra = ds.spectra[:cfg.train.batch_size]
    plain = tp.gather_module(st.f).eval()
    plain_g = tp.gather_module(st.g).train()
    for name, f in (("split", st.f.eval()), ("replicated", plain)):
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            f(x)
        out[f"flops_f_{name}"] = counter.get_total_flops()
    for name, g in (("split", st.g.train()), ("replicated", plain_g)):
        counter = FlopCounterMode(display=False)
        with counter:
            g(spectra).sum().backward()
        out[f"flops_g_{name}"] = counter.get_total_flops()
    out["local_shapes_f"] = {n: tuple(p.shape) for n, p in st.f.named_parameters()}
    return out


def trainer_case(inp: dict, mesh, workdir: str) -> dict:
    """``Trainer(mesh=...).train(mode="full")``, 3 + 3 epochs in chunks of
    2, a checkpoint every 2 epochs and the finals, written from rank 0."""
    cfg = R.config(inp)
    t = Trainer(cfg, ds=R.dataset(inp), epochs_per_call=2, engine="auto", device="cpu",
                mesh=mesh)
    mgr = ckpt.CheckpointManager(os.path.join(workdir, "ckpt"), save_interval=2)
    t.pretrain_forward(epochs=TRAINER_EPOCHS)
    t.init_pigan()
    t.train_pigan(epochs=TRAINER_EPOCHS, checkpoint_manager=mgr)
    t.save_final(workdir)
    # a fresh trainer on the same mesh resumes from the world-1 files
    again = Trainer(cfg, ds=R.dataset(inp), epochs_per_call=2, engine="auto", device="cpu",
                    mesh=mesh)
    step = again.resume_from(ckpt.CheckpointManager(os.path.join(workdir, "ckpt"),
                                                    save_interval=2), "pigan")
    return {"trainer_history": t.train_history, "trainer_pigan": whole(t.pigan_state),
            "trainer_eval_r2": t.evaluate()["pigan_evaluation"]["parameter_prediction"]["r2"],
            "resumed": (step, whole(again.pigan_state))}


ENHANCED = ("generator.name=residual", "discriminator.name=dual_encoder",
            "discriminator.use_spectral_norm=true")


def enhanced_case(inp: dict, mesh) -> dict:
    """The first PI-GAN step of the residual G and the spectral-norm
    dual-encoder D (no split path: their split leaves are gathered for each
    call, their BatchNorm stats and spectral norm's u written back by
    block), from one seeded state."""
    from pigan_thz_torch.models.registry import build_trio
    from pigan_thz_torch.parallel.sharding import shard_state
    from pigan_thz_torch.train.state import init_pigan_state, make_optimizers

    cfg = R.config(inp, *ENHANCED)
    ds, bsz = R.dataset(inp), cfg.train.batch_size
    g, d, f = build_trio(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    g_tx, d_tx, _ = make_optimizers(cfg, ds.num_samples // bsz)
    st = init_pigan_state(g, d, f, g_tx, d_tx, 0, device="cpu")
    if mesh is not None:
        shard_state(st, mesh)
    step = S.make_pigan_step(g_tx, d_tx, S.StepSettings.from_config(cfg, detach_forward=False),
                             ds.param_lo, ds.param_hi)
    out = {"enhanced_first": first_step(step, st, inp, ds, bsz, mesh, 1.0)}
    if mesh is not None:
        out["enhanced_split"] = (tp.plan_of(st.g).split, tp.plan_of(st.d).split,
                                 tuple(st.g.main[0].weight.shape))
    return out


def run_all(inp: dict, mesh, workdir: str) -> dict:
    out = step_cases(inp, mesh)
    out.update(enhanced_case(inp, mesh))
    out.update(trainer_case(inp, mesh, workdir))
    return out


def rank_main(rank: int, world: int, address: str, data: int, model: int,
              directory: str) -> None:
    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(address, world, rank, device="cpu")
    inp = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    mesh = mesh_mod.make_mesh(data=data, model=model, min_shard_dim=inp["min_shard_dim"])
    out = run_all(inp, mesh, os.path.join(directory, "models"))
    out["rank"], out["data_rank"], out["model_rank"] = rank, mesh.data_rank, mesh.model_rank
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))


if __name__ == "__main__":
    d, m = int(sys.argv[1]), int(sys.argv[2])
    mesh_mod.spawn_ranks(rank_main, d * m, d, m, sys.argv[3])
