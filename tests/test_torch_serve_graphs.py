"""A module stage's CUDA graphs (``serve.py:ModuleStage``) on the CPU.

On the CPU a module stage runs eagerly, its output the module's own bit
for bit, and keeps no bookkeeping; ``_capturable`` refuses a CPU tensor and
a fake CUDA tensor.  With ``_capturable`` stubbed to admit every call and
``_Graph`` replaced by a fake that counts its captures and calls, the
stage's bookkeeping: a one-off shape never captures, the second call with
a shape captures and every later one replays; at most
``GRAPHS_PER_STAGE`` graphs, least recently used out, and an evicted shape
runs eagerly from then on, so traffic cycling through more shapes than
that captures each once; ``SHAPES_SEEN`` shapes remembered; ``replayed``
after each call; a module in train mode never captures.  The export of
an enhanced trio (residual G, uncertainty F) still traces and runs.  The
graphs themselves on the card are in test_torch_cuda.py."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pigan_thz_torch import default_config
from pigan_thz_torch import serve
from pigan_thz_torch.config import ForwardModelConfig, GeneratorConfig, apply_overrides
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.serve import ModuleStage

torch.set_num_threads(1)

MODELS = {
    "residual": lambda gen: build_generator(GeneratorConfig(name="residual"), device="cpu",
                                            generator=gen),
    "conv_attn": lambda gen: build_generator(GeneratorConfig(name="conv_attn"), device="cpu",
                                             generator=gen),
    "uncertainty": lambda gen: build_forward_model(ForwardModelConfig(name="uncertainty"),
                                                   device="cpu", generator=gen),
    "branched": lambda gen: build_forward_model(ForwardModelConfig(name="branched"),
                                                device="cpu", generator=gen),
}


def _model(name):
    return MODELS[name](torch.Generator().manual_seed(0)).eval().requires_grad_(False)


def _input(name, b, seed=1):
    width = 250 if name in ("residual", "conv_attn") else 4
    return torch.rand((b, width), generator=torch.Generator().manual_seed(seed)) * 2 - 1


@pytest.mark.parametrize("name", list(MODELS))
def test_cpu_stage_is_eager_and_equals_the_module(name):
    model = _model(name)
    stage = ModuleStage(model)
    x = _input(name, 8)
    with torch.inference_mode():
        want = model(x)
        for _ in range(3):
            got = stage(x)
    want = want[:2] if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not stage._graphs and not stage._seen


def test_capturable_refuses_a_cpu_and_a_fake_cuda_tensor():
    with torch.inference_mode():
        assert not serve._capturable(torch.zeros(2, 3))
    with FakeTensorMode():
        fake = torch.empty(2, 3, device="cuda")
    assert fake.is_cuda
    with torch.inference_mode():
        assert not serve._capturable(fake)


class FakeGraph:
    """Stands in for ``_Graph``: the eager forward, counted."""

    made: list = []

    def __init__(self, forward, x):
        self.forward, self.shape, self.calls = forward, tuple(x.shape), 0
        FakeGraph.made.append(self)

    def __call__(self, x):
        self.calls += 1
        return self.forward(x)


@pytest.fixture
def stubbed(monkeypatch):
    FakeGraph.made = []
    monkeypatch.setattr(serve, "_capturable", lambda x: True)
    monkeypatch.setattr(serve, "_Graph", FakeGraph)
    return FakeGraph.made


def _shapes(stage):
    return [k[0][0] for k in stage._graphs]


def test_a_one_off_shape_never_captures_and_the_second_call_does(stubbed):
    model = _model("residual")
    stage = ModuleStage(model)
    for b in (1, 2, 3):
        stage(_input("residual", b))
    assert stubbed == [] and len(stage._seen) == 3
    x = _input("residual", 2, seed=5)
    got = stage(x)
    (graph,) = stubbed
    assert graph.shape == (2, 250) and graph.calls == 1
    assert torch.equal(got, model(x))
    stage(x)
    stage(_input("residual", 2, seed=6))
    assert graph.calls == 3 and len(stubbed) == 1
    assert [(k[0][0], v) for k, v in stage._seen.items()] == [
        (1, False), (3, False), (2, True)]           # the captured shape remembered last


def test_graphs_are_kept_least_recently_used(stubbed):
    stage = ModuleStage(_model("residual"))
    n = serve.GRAPHS_PER_STAGE
    for b in range(1, n + 2):
        for _ in range(2):
            stage(_input("residual", b))
    assert len(stubbed) == n + 1
    assert _shapes(stage) == list(range(2, n + 2))   # the first out
    stage(_input("residual", 2))                     # a replay: now the most recent
    assert stubbed[1].calls == 2
    assert _shapes(stage) == [*range(3, n + 2), 2]
    for _ in range(2):                               # the evicted shape: eager from now on
        stage(_input("residual", 1))
        assert not stage.replayed
    assert len(stubbed) == n + 1
    assert _shapes(stage) == [*range(3, n + 2), 2]


@pytest.mark.parametrize("extra", [0, 2])
def test_a_rotation_of_shapes_captures_each_once(stubbed, extra):
    """Shapes called in turn, round after round: every shape captured on its
    second round and never again; from the third round on the stage replays
    ``GRAPHS_PER_STAGE`` of them (all, where there are no more) and runs the
    rest eagerly."""
    stage = ModuleStage(_model("residual"))
    n = serve.GRAPHS_PER_STAGE + extra
    xs = [_input("residual", b) for b in range(1, n + 1)]
    replays = []
    for _ in range(6):
        for x in xs:
            stage(x)
            replays.append(stage.replayed)
    assert sorted(g.shape[0] for g in stubbed) == list(range(1, n + 1))
    steady = replays[2 * n:]
    assert sum(steady) == 4 * min(n, serve.GRAPHS_PER_STAGE)
    assert len(stage._graphs) == min(n, serve.GRAPHS_PER_STAGE)


def test_the_shapes_seen_once_are_bounded(stubbed):
    stage = ModuleStage(_model("residual"))
    n = serve.SHAPES_SEEN
    for b in range(1, n + 2):
        stage(_input("residual", b))
    assert len(stage._seen) == n
    stage(_input("residual", 1))                     # forgotten: seen anew, not captured
    assert stubbed == []
    stage(_input("residual", n + 1))                 # remembered: captured
    assert [g.shape for g in stubbed] == [(n + 1, 250)]


def test_a_module_in_train_mode_never_captures(stubbed):
    model = _model("residual")
    stage = ModuleStage(model)
    model.train()
    x = _input("residual", 4)
    for _ in range(3):
        stage(x)
    assert stubbed == [] and not stage._seen
    model.eval()
    for _ in range(2):
        stage(x)
    assert len(stubbed) == 1


def test_keys_take_the_dtype(stubbed):
    stage = serve._stage(_model("residual"), "cpu", "bfloat16", fused=False)
    x = _input("residual", 4)
    for t in (x, x.bfloat16(), x, x.bfloat16()):
        assert stage(t).dtype == torch.float32
    assert [k[1] for k in stage._graphs] == [torch.float32, torch.bfloat16]
    assert [g.calls for g in stubbed] == [1, 1]


def test_export_of_an_enhanced_trio_traces_and_runs(tmp_path):
    cfg = apply_overrides(default_config(), ["data.num_samples=64"])
    ds = synthetic_dataset(cfg.data, device="cpu")
    g, f = _model("residual"), _model("uncertainty")
    x = ds.spectra[:16].contiguous()
    want = serve.make_inverse_design_fn(g, f, ds)(x)
    design = serve.load_exported(
        serve.export_inverse_design(g, f, ds, str(tmp_path / "d.pt2"), batch_size=16),
        device="cpu")
    for a, b in zip(design(x), want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    gen = serve.load_exported(
        serve.export_generator(g, ds, str(tmp_path / "g.pt2"), batch_size=16), device="cpu")
    torch.testing.assert_close(gen(x), want[0], atol=1e-5, rtol=1e-5)
