"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``).

``tiny`` shrinks a cell's configuration for the CPU: fewer samples, a
shorter spectrum, a smaller batch and two epochs a phase.  The hidden widths
stay the published ones, which the port's kernels (and their plain versions
on the CPU) require.  Tests marked ``cuda`` decide in the ``card`` fixture
whether there is a card, never while the module is imported."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import harness


def tiny_cell(name: str) -> dict:
    c = harness.cell(name)
    cfg = copy.deepcopy(c["config"])
    cfg.update(spectrum_dim=20, num_samples=128, batch_size=16)
    s = ["data.spectrum_dim=20", "data.num_samples=128", "train.batch_size=16"]
    if "train" in cfg:
        cfg["train"].update(forward_epochs=2, gan_epochs=2)
        s += ["train.fwd_pretrain_epochs=2", "train.num_epochs=2"]
    cfg["port"] = dict(cfg["port"], set=s)
    traffic = dict(c["traffic"])
    if traffic["driver"] == "design":
        traffic.update(batch=64, pool_rows=512, sample_range=20, warmup_requests=1)
    return {**c, "config": cfg, "traffic": traffic}


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs the cell at its own size on the card")
    return torch.device("cuda")
