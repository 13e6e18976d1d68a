"""The residual generator's fused chain (``fused_kernels.pack_residual``,
``csrc/fused_residual_chain.cu``) and its routing in ``serve.py``, on the CPU.

The packing against the module in float64: every BatchNorm folded with its
running statistics (flax's biased variance) and its eps, 250 padded to 256
and the head's 4 to 8, the residual blocks' boundaries, and each hidden
layer's hi / lo W stream as the kernel's descriptors read it (K5's wgmma
layout); which activations the kernel keeps in its scratch.  The 3xTF32
twin (the kernel's arithmetic in plain PyTorch) against float64 within
K6's tolerance, where one TF32 product alone falls outside it.  The wrapper
on the CPU is the plain version; on the card (the launch stubbed) one launch
with the chain's layout.  The routing: the default fp32 designer on the
card gives a ``ResidualGenerator`` with BatchNorm a ``ResidualStage``, and
every other model, dtype, path and device the stage it had; a residual
stage on the card (``_capturable`` stubbed to its conditions but the
device, the launch stubbed) launches the kernel from its crossover up, and
below it, in train mode, for another dtype, under ``torch.export`` or a
``FakeTensorMode`` and for a call on the CPU runs its module stage; the
G span names the path.  The kernel itself is held on the card in
test_torch_cuda.py."""

import copy
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _get_current_dispatch_mode

from pigan_thz_torch import default_config, serve
from pigan_thz_torch.config import ForwardModelConfig, GeneratorConfig, apply_overrides
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.ops import fused_kernels as fk
from pigan_thz_torch.utils import profiling

torch.set_num_threads(1)

K6_TOL = 2e-5       # (B, 4) tanh output, as K6's; tests/test_torch_serving_tiles.py
CROSSOVER = 16      # the stubbed crossover: small batches keep the CPU runs short
RES_ROWS = fk.RES_ROWS
DIMS = (250, 512, 512, 512, 512, 512, 512, 512, 256, 128, 4)
CLOSES = (False, False, True, False, True, False, True, False, False)


def _generator(seed=0, dtype="float32", **cfg):
    gen = torch.Generator().manual_seed(seed)
    g = build_generator(GeneratorConfig(name="residual", **cfg), device="cpu", generator=gen,
                        dtype=dtype)
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean += 0.1 * torch.randn(m.num_features, generator=gen)
                m.running_var += (0.1 * torch.randn(m.num_features, generator=gen)) ** 2
                m.weight += 0.1 * torch.randn(m.num_features, generator=gen)
                m.bias += 0.1 * torch.randn(m.num_features, generator=gen)
    return g.eval().requires_grad_(False)


def _spectra(b, seed=1):
    return torch.randn((b, 250), generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def g64():
    return _generator().double()


def test_packing_folds_batchnorm_pads_and_marks_the_blocks(g64):
    packed = fk.pack_residual(g64, dtype=torch.float64)
    assert packed.dims == DIMS and packed.closes == CLOSES
    assert packed.padded_dims == (256, *DIMS[1:-1], 8)
    x = _spectra(64).double()
    with torch.no_grad():
        want = g64(x)
    assert float((fk.fused_residual_chain_plain(x, packed) - want).abs().max()) <= 1e-12
    # each layer is its Dense with its BatchNorm folded in, by the formula
    dense, norm = g64.main[3].body[4], g64.main[3].body[5]
    s = norm.weight / torch.sqrt(norm.running_var + norm.eps)
    W, b = packed.layer(2)
    torch.testing.assert_close(W, dense.weight.T * s, rtol=0, atol=1e-15)
    torch.testing.assert_close(b, (dense.bias - norm.running_mean) * s + norm.bias,
                               rtol=0, atol=1e-15)
    # the padding is zero: W's rows 250-255 and the head's columns 4-7
    pdims = packed.padded_dims
    for l in (0, packed.n_layers - 1):
        w_off, b_off, _ = packed.offsets[l]
        Wp = packed.weights[w_off:w_off + pdims[l] * pdims[l + 1]].view(pdims[l], pdims[l + 1])
        assert not Wp[DIMS[l]:].any() and not Wp[:, DIMS[l + 1]:].any()
        assert not packed.weights[b_off + DIMS[l + 1]:b_off + pdims[l + 1]].any()


def test_each_hidden_layer_streams_its_split_w_as_k5_does():
    """Each hidden layer's W stream is K5's wgmma layout over the cluster's
    two ranks: rank by rank, pass by pass (equal passes of at most 16 n8
    tiles), k8 step by step, the hi then the lo image of the pass's
    columns."""
    packed = fk.pack_residual(_generator())
    pdims = packed.padded_dims
    for l in range(packed.n_layers):
        w_off, _, stream = packed.offsets[l]
        pin, pout = pdims[l], pdims[l + 1]
        if l == packed.n_layers - 1:
            assert stream == -1
            continue
        assert stream % fk.ALIGN == 0
        Wp = packed.weights[w_off:w_off + pin * pout].view(pin, pout)
        got = packed.weights[stream:stream + 2 * pin * pout]
        assert torch.equal(got, fk.wgmma_stream(Wp))
        # rank q's last pass: hi + lo of its columns, k8 step j, core matrix (g, c)
        t = pout // 8 // 2
        a, nt = fk.wgmma_passes(t)[-1]
        assert nt in (8, 16) and t % nt == 0
        q, j, g, c = 1, 5, 2, 1
        base = 16 * (q * t + a) * pin + j * 2 * nt * 64
        hi = got[base + (g * 2 + c) * 32: base + (g * 2 + c + 1) * 32].view(8, 4)
        lo = got[base + nt * 64 + (g * 2 + c) * 32:
                 base + nt * 64 + (g * 2 + c + 1) * 32].view(8, 4)
        cols = slice(8 * (q * t + a + g), 8 * (q * t + a + g + 1))
        want = Wp[8 * j + 4 * c: 8 * j + 4 * c + 4, cols].T
        torch.testing.assert_close(hi + lo, want, rtol=2 ** -20, atol=1e-30)
        assert torch.equal(hi, fk.tf32_round(want))


@pytest.mark.parametrize("terms,within", [(3, True), (1, False)])
def test_tf32_twin_against_float64(g64, terms, within):
    """3xTF32 holds K6's tolerance over the nine products of the chain; one
    TF32 product breaks it, so the check can fail."""
    packed = fk.pack_residual(copy.deepcopy(g64).float())
    x = _spectra(512, seed=7)
    with torch.no_grad():
        want = g64(x.double())
    err = float((fk.fused_residual_chain_tf32(x, packed, terms).double() - want).abs().max())
    assert (err <= K6_TOL) == within, err
    if within:   # and as close as fp32 itself, within a factor
        fp32 = float((fk.fused_residual_chain_plain(x, packed).double() - want).abs().max())
        assert err <= 4 * fp32 + 1e-7, (err, fp32)


def test_the_packing_refuses_other_generators():
    for g in (_generator(norm="layer"), _generator(norm="none"),
              build_generator(GeneratorConfig(name="mlp"), device="cpu"),
              build_generator(GeneratorConfig(name="conv_attn"), device="cpu")):
        with pytest.raises(ValueError, match="ResidualGenerator with BatchNorm"):
            fk.pack_residual(g)


def test_the_wrapper_launches_once_with_the_chain_s_layout(monkeypatch):
    """On the CPU the wrapper is the plain version; its launch (stubbed, as
    test_torch_profiling.py stubs K5's) is one launch, counted, with each
    hidden layer's W stream, the head's W, the biases and the closing
    layers' bits, and the scratch of the residual blocks' inner layers."""
    packed = fk.pack_residual(_generator())
    x = _spectra(8)
    assert torch.equal(fk.fused_residual_chain(x, packed),
                       fk.fused_residual_chain_plain(x, packed))
    calls = []

    def fake_launch(name, device, *args, count_as=None):
        calls.append((name, args))
        fk.LAUNCHES[count_as or name] += 1

    monkeypatch.setattr(fk, "launch", fake_launch)
    before = fk.LAUNCHES["fused_residual_chain"]
    for b in (8, 8192, 8192 + 37):
        assert fk._launch_residual(_spectra(b), packed).shape == (b, 4)
    assert fk.LAUNCHES["fused_residual_chain"] == before + 3
    want = [o for w_off, b_off, stream in packed.offsets
            for o in (stream if stream >= 0 else w_off, b_off)]
    assert want[-2] == packed.offsets[-1][0]
    for (name, args), b in zip(calls, (8, 8192, 8192 + 37)):
        _, _, _, sc, offsets, dims, n_layers, closes, batch = args
        assert name == "fused_residual_chain" and (n_layers, batch) == (10, b)
        assert list(dims) == list(DIMS) and closes == 0b1010100 and list(offsets) == want
        assert sc is not None
    for bad in (x.double(), x[:, :200], x.t()):
        with pytest.raises((TypeError, ValueError)):
            fk.fused_residual_chain(bad, packed)


@pytest.mark.parametrize("dims, width", [
    (DIMS, 512),                        # the residual blocks' inner layers
    ((250, 512, 512, 4), 512),          # the second hidden layer's input
    ((250, 256, 256, 256, 4), 0),       # every half fits its buffer
])
def test_the_scratch_holds_what_outgrows_its_buffer(dims, width):
    """A block keeps half of each activation's columns, activation a in
    buffer a % 2 of 128 or 256 floats a row; a wider half lives in the
    scratch, whose rows are as wide as the widest such activation."""
    assert fk.residual_scratch_width(dims) == width


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model, device, kind, use_pallas, want", [
    ("residual", "cuda", "float32", None, True),
    ("residual", "cuda:0", "float32", None, True),
    ("residual", "cpu", "float32", None, False),
    ("residual", "cuda", "float32", False, False),
    ("residual", "cuda", "bfloat16", None, False),
    ("residual", "cuda", "int8", None, False),
    ("residual_bf16", "cuda", "float32", None, False),
    ("residual_layer", "cuda", "float32", None, False),
    ("residual_none", "cuda", "float32", None, False),
    ("conv_attn", "cuda", "float32", None, False),
    ("mlp", "cuda", "float32", None, False),
])
def test_which_designer_stage_takes_the_residual_kernel(model, device, kind, use_pallas, want):
    """The default fp32 designer on the card, for a ResidualGenerator with
    BatchNorm computing in float32; nothing else."""
    models = {
        "residual": lambda: _generator(),
        "residual_bf16": lambda: _generator(dtype="bfloat16"),
        "residual_layer": lambda: _generator(norm="layer"),
        "residual_none": lambda: _generator(norm="none"),
        "conv_attn": lambda: build_generator(GeneratorConfig(name="conv_attn"), device="cpu"),
        "mlp": lambda: build_generator(GeneratorConfig(name="mlp"), device="cpu"),
    }
    assert serve.serves_residual(models[model](), device, kind, use_pallas) is want


def test_the_cpu_designer_keeps_the_module_stage():
    cfg = apply_overrides(default_config(), ["data.num_samples=64"])
    ds = synthetic_dataset(cfg.data, device="cpu")
    f = build_forward_model(ForwardModelConfig(), device="cpu").eval()
    designer = serve._designer(_generator(), f, ds, None, None)
    assert type(designer.generator) is serve.ModuleStage
    bf16 = serve._designer(_generator(), f, ds, None, "bfloat16")
    assert type(bf16.generator) is serve.ModuleStage


class FakeGraph:
    """Stands in for ``_Graph``: the eager forward."""

    def __init__(self, forward, x):
        self.forward = forward

    def __call__(self, x):
        return self.forward(x)


def _capturable_but_the_device(x):
    """``serve._capturable`` without its ``x.is_cuda``."""
    return (not torch.compiler.is_compiling() and type(x) is torch.Tensor
            and torch.is_inference_mode_enabled() and _get_current_dispatch_mode() is None)


@pytest.fixture
def launches(monkeypatch):
    """A residual stage as on the card: the crossover stubbed to CROSSOVER,
    ``_capturable`` to its conditions but the device, graphs to the eager
    forward, the launch to the plain version, recorded."""
    calls = []

    def fake_chain(x, packed):
        calls.append(x.shape[0])
        return fk.fused_residual_chain_plain(x, packed)

    monkeypatch.setattr(serve.ResidualStage, "crossover", CROSSOVER)
    monkeypatch.setattr(serve, "_capturable", _capturable_but_the_device)
    monkeypatch.setattr(serve, "_Graph", FakeGraph)
    monkeypatch.setattr(serve, "fused_residual_chain", fake_chain)
    return calls


def _residual_stage():
    g = _generator()
    return serve.ResidualStage(serve._copy(g, "cpu", "float32"), fk.pack_residual(g)), g


def test_the_kernel_serves_from_the_crossover_up(launches):
    stage, g = _residual_stage()
    with torch.inference_mode():
        for b in (CROSSOVER, CROSSOVER + 1, 3 * CROSSOVER + 5):
            x = _spectra(b)
            got = stage(x)
            assert stage.launched and not stage.replayed
            torch.testing.assert_close(got, g(x), rtol=1e-5, atol=1e-6)
        for _ in range(3):
            x = _spectra(CROSSOVER - 1)
            assert torch.equal(stage(x), g(x)) and not stage.launched
    assert launches == [CROSSOVER, CROSSOVER + 1, 3 * CROSSOVER + 5]
    assert stage.replayed        # the module stage's graph below the crossover


def test_other_calls_take_the_module_stage(launches):
    """Train mode, another dtype, a non-contiguous input, a fake tensor and
    torch.export, all at the crossover."""
    stage, g = _residual_stage()
    x = _spectra(CROSSOVER)
    with torch.inference_mode():
        stage.module.train()
        stage(x)
        assert not stage.launched
        stage.module.eval()
        assert stage(x.double().float()) is not None and stage.launched
        assert not stage.takes_kernel(x.double())
        assert not stage.takes_kernel(_spectra(2 * CROSSOVER)[::2])
    with FakeTensorMode():
        fake = torch.empty(CROSSOVER, 250)
    assert not stage.takes_kernel(fake)
    launches.clear()
    stage, g = _residual_stage()      # the train-mode call moved the running stats
    program = torch.export.export(stage.eval(), (x,))
    assert launches == []
    with torch.inference_mode():
        torch.testing.assert_close(program.module()(x), g(x), rtol=1e-5, atol=1e-6)


def test_a_cpu_call_takes_the_module_stage(monkeypatch):
    """With the real ``_capturable``: a CPU call never launches."""
    monkeypatch.setattr(serve.ResidualStage, "crossover", CROSSOVER)
    stage, g = _residual_stage()
    x = _spectra(4 * CROSSOVER)
    with torch.inference_mode():
        assert torch.equal(stage(x), g(x))
    assert not stage.launched and not stage._graphs


def test_the_g_span_names_the_path(launches):
    cfg = apply_overrides(default_config(), ["data.num_samples=512"])
    ds = synthetic_dataset(cfg.data, device="cpu")
    f = build_forward_model(ForwardModelConfig(), device="cpu").eval()
    stage, _ = _residual_stage()
    designer = serve.Designer(stage, serve._stage(f, "cpu", "float32", True, ds.spectrum_dim),
                              ds)
    fn = serve._serving_fn(designer)
    profiling.reset()
    with profiling.recording():
        for b in (CROSSOVER, 3 * RES_ROWS, CROSSOVER - 1):
            fn(ds.spectra[:b].contiguous())
        snap = profiling.snapshot()
    spans = [r for r in snap["recent"] if r["name"] == "pigan.serve.gen_stage"]
    assert [r["attrs"] for r in spans] == [{"replayed": 0, "shape": "wgmma"},
                                           {"replayed": 0, "shape": "wgmma"},
                                           {"replayed": 0, "shape": "module"}]
