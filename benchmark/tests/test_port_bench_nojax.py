"""The forbidden-module check compares whole top-level names: a planted
``pigan_thz_tpu`` module is found, the port ``pigan_thz_torch`` is not."""

from __future__ import annotations

import sys
import types

import pytest

from benchmark import harness


@pytest.mark.parametrize("name,found", [
    ("pigan_thz_tpu", True), ("pigan_thz_tpu.ops", True), ("jax", True),
    ("jaxlib.xla_client", True), ("flax", True), ("optax", True),
    ("pigan_thz_torch", False), ("pigan_thz_torch.ops", False), ("jax_like", False),
    ("pigan_thz_tpux", False),
])
def test_whole_top_level_names(monkeypatch, name, found):
    for mod in list(sys.modules):
        if mod.partition(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    top = name.partition(".")[0]
    assert (top in harness.forbidden_modules()) is found


def test_the_harness_loads_none(monkeypatch):
    for mod in list(sys.modules):
        if mod.partition(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, mod)
    import benchmark.drivers.design  # noqa: F401
    import benchmark.drivers.seed_ensemble  # noqa: F401
    import benchmark.drivers.train_full  # noqa: F401
    import pigan_thz_torch.serve  # noqa: F401
    import pigan_thz_torch.train.trainer  # noqa: F401

    assert harness.forbidden_modules() == []
