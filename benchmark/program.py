"""The one place where the benchmark touches the program under test.

It takes from ``pigan_thz_torch`` only the system and its public entry
points: the config and its presets, ``build_dataset``, the model registry,
``Trainer``, ``train_seed_ensemble`` and the packed multi-epoch function
it drives, the draw function of the multi-epoch functions,
``serve.make_inverse_design_fn``, and the modules' own parameter order, by
which the benchmark's weights are copied in.  It hands the program the
benchmark's inputs and reads back only what the program returns or holds
as its state.
"""

from __future__ import annotations

import torch

from .reference import models as M


def port_config(cfg: dict):
    """The program's ``PiGanConfig`` for the configuration file ``cfg``,
    checked against the file's widths."""
    from pigan_thz_torch.config import apply_overrides, default_config

    pc = default_config()
    port = cfg.get("port", {})
    if port.get("preset") == "optimized":
        from pigan_thz_torch.config_presets import apply_optimization_config

        pc = apply_optimization_config(pc)
    elif port.get("preset") is not None:
        raise ValueError(f"unknown preset {port['preset']!r}")
    pc = apply_overrides(pc, port.get("set", []))
    d, g, f = pc.data, pc.generator, pc.forward_model
    want = {
        "spectrum_dim": d.spectrum_dim, "param_dim": d.param_dim,
        "metrics_dim": d.metrics_dim, "num_samples": d.num_samples,
        "param_min": d.param_min, "param_max": d.param_max,
        "freq_min": d.freq_min, "freq_max": d.freq_max,
        "batch_size": pc.train.batch_size,
    }
    for key, got in want.items():
        if cfg[key] != got:
            raise ValueError(f"config {cfg['name']}: {key} is {cfg[key]} in the file, "
                             f"{got} in the program's config")
    checks = [(cfg["generator"]["name"], g.name),
              (list(cfg["forward_model"]["hidden_dims"]), list(f.hidden_dims)),
              (cfg["forward_model"]["dropout_rate"], f.dropout_rate),
              (cfg["discriminator"]["name"], pc.discriminator.name)]
    if g.name == "mlp":
        checks.append((list(cfg["generator"]["hidden_dims"]), list(g.hidden_dims)))
    elif g.name == "residual":
        checks.append((cfg["generator"]["residual_blocks"], g.num_residual_blocks))
    if "train" in cfg:
        tc = cfg["train"]
        checks += [(tc["forward_epochs"], pc.train.fwd_pretrain_epochs),
                   (tc["gan_epochs"], pc.train.num_epochs),
                   (tc["fwd_lr"], pc.train.fwd_pretrain_lr), (tc["lr_g"], pc.train.lr_g),
                   (tc["lr_d"], pc.train.lr_d), (tc["grad_clip"], pc.train.grad_clip),
                   (tc["label_real"], pc.train.label_smooth_real),
                   (tc["label_fake"], pc.train.label_smooth_fake),
                   (tc["detach_forward"], pc.train.detach_forward)]
    for want_v, got_v in checks:
        if want_v != got_v:
            raise ValueError(f"config {cfg['name']}: {want_v!r} in the file, {got_v!r} in "
                             "the program's config")
    return pc


def dataset(pc, train_set: dict, device):
    """The program's dataset of the benchmark's training set."""
    from pigan_thz_torch.data.dataset import build_dataset

    return build_dataset(train_set["spectra"], train_set["params"], train_set["metrics"],
                         pc.data, device=device)


def replay_draws(before: torch.Tensor, after: torch.Generator, num_samples: int,
                 batch: int, epochs: int) -> tuple:
    """(indices (E, spe, B), step seeds (E·spe,)) that a chunk of ``epochs``
    drew from a generator whose state was ``before`` when it began, made
    again by the program's draw function.  ``after`` is that generator as
    the chunk left it: a replay that does not end in its state raises, so
    the rows read back are the rows the chunk trained on."""
    from pigan_thz_torch.ops.forward_train import resolve_draws

    g = torch.Generator(device=after.device)
    g.set_state(before)
    indices, seeds = resolve_draws(g, num_samples, batch, epochs)
    if not torch.equal(g.get_state(), after.get_state()):
        raise RuntimeError("the replayed draws do not end where the chunk left its generator")
    return indices, seeds


def _params(module) -> list:
    return list(module.named_parameters())


def _float_buffers(module) -> list:
    return [(n, b) for n, b in module.named_buffers() if b.is_floating_point()]


@torch.no_grad()
def load_(module, w: dict, ops) -> None:
    """Copy the benchmark's weights ``w`` (laid out as ``ops``) into the
    program's ``module``, parameter by parameter in the module's order and
    then its BatchNorm statistics; a shape or count that differs raises."""
    for what, got, layout in (("parameters", _params(module), M.param_layout(ops)),
                              ("buffers", _float_buffers(module), M.buffer_layout(ops))):
        if len(got) != len(layout):
            raise ValueError(f"{len(got)} {what} in the program's model, {len(layout)} in "
                             "the reference's layout")
        for (pname, t), (rname, shape, _) in zip(got, layout):
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{pname} {tuple(t.shape)} against {rname} {shape}")
            t.copy_(w[rname])


def leaves(module, flat: torch.Tensor, ops) -> dict:
    """{reference name: tensor} of a flat buffer laid out in ``module``'s
    parameter order (the program's flat training state)."""
    out, pos = {}, 0
    for (_, t), (rname, _, _) in zip(_params(module), M.param_layout(ops)):
        n = t.numel()
        out[rname] = flat[pos:pos + n].view(t.shape).detach().clone()
        pos += n
    if pos != flat.numel():
        raise ValueError(f"flat buffer of {flat.numel()} floats, layout of {pos}")
    return out
