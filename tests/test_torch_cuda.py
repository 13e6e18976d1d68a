"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Weights are full-width, seeded, with flax's initialisation and non-trivial
generator BatchNorm stats, so the folding is exercised.  The
dip-qualification kernel (K4) is held against both of its plain versions on
the spectra classes of tests/test_peaks.py and the screen's spectra, and its
metrics entry bit for bit against ``spectrum_metrics`` on the lattice's
qualification, hostile rows (tests/peak_rows.py) among them.  The
forward-training kernel
(K1) is held against its plain version and the eager step over 2 epochs of
a 1000-sample dataset, with the tolerances of ``chip_smoke.py``, its first
float32 step against the float64 plain version (with a planted fault of its
batch-row products seen), and its C loop's launches a step; so is the
GAN-training kernel (K2), for both ``detach_forward`` modes and a mix of its
knobs.  The member-packed kernel (K3) is held bit for bit against K2 on each
member alone, and against its plain version with K2's tolerances.  The
batch-row product kernel that K1, K2 and K3 launch (``csrc/brow_gemm.cuh``)
is held against its plain version and float64 for every product shape and
flag of a step, at M = 1 and 4, and each step's count of its launches
against ``brow_products``; so are the deep narrow and batch-depth kernels
of ``csrc/train_common.cuh`` (the batch-depth one bit for bit against the
tiled SGEMM), and each step's launches by route against
``gemm_products``.  The serving kernels' custom ops
(``torch.ops.pigan_thz.*``) are held bit for bit against their wrappers,
and a ``use_pallas`` designer artifact written on the CPU runs on the card
through one launch of each kernel a call; the int8 products and the bf16 /
int8 cycles are held against the CPU.  A module stage's CUDA graphs (the
residual and conv-attention generators, the uncertainty surrogate, a bf16
twin; B = 1 and 8192) replay its eager forward bit for bit, leave earlier
answers and the module's state alone, keep a graph a shape, free an
evicted graph's memory, and stand aside outside inference mode, under a
dispatch mode and in train mode; an enhanced trio's designer replays both
stages and its export on the card still traces.  The residual G's stage
(the residual chain kernel, ``csrc/fused_residual_chain.cu``) is held
against the plain fp32 module within the design cells' ``params_gap``
limit on both sides of its crossover, bit for bit on a rerun, and at B =
8192 an enhanced designer launches it once a request with its shape on
the G span.  Training killed after a chunk and
resumed from a checkpoint in a fresh trainer ends bit for bit where the
uninterrupted run ends, through K1 and K2; a checkpoint written on the card
restores on the CPU with equal tensors; the shadow replay passes on a clean
run and raises on a planted first-epoch fault.
"""

import copy
import time

import pytest
import torch

import dataclasses

from pigan_thz_torch import default_config
from peak_rows import hostile_rows
from pigan_thz_torch.data import (
    build_dataset,
    denormalize_params,
    dip_centers,
    sample_params,
    synthesize_spectra,
    synthetic_dataset,
)
from pigan_thz_torch.design import ScreeningConfig, screen_designs
from pigan_thz_torch.models import build_forward_model, build_generator, build_trio
from pigan_thz_torch.ops import brow
from pigan_thz_torch.ops import forward_train as ft
from pigan_thz_torch.ops import gan_train as gt
from pigan_thz_torch.ops._cuda_build import LAUNCHES, report_of, span_attrs
from pigan_thz_torch.ops import fused_kernels as fk
from pigan_thz_torch.ops import peaks as pk
from pigan_thz_torch import serve
from pigan_thz_torch.config import ForwardModelConfig, GeneratorConfig
from pigan_thz_torch.serve import make_inverse_design_fn
from pigan_thz_torch.train.schedules import make_schedule
from pigan_thz_torch.train.state import (
    init_forward_state,
    init_pigan_state,
    make_optimizers,
)
from pigan_thz_torch.train.steps import (
    ForwardStepSettings,
    StepSettings,
    make_forward_step,
    make_multi_epoch_fn,
    make_pigan_step,
)
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_torch.utils import profiling

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

BATCHES = [1, 64, 77, 257, fk.crossover_batch(132) - 1, fk.crossover_batch(132), 8192, 65536]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def models():
    cfg = default_config()
    gen = torch.Generator().manual_seed(0)
    g = build_generator(cfg.generator, generator=gen, device="cpu")
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean += 0.1 * torch.randn(m.num_features, generator=gen) ** 2
                m.running_var += 0.1 * torch.randn(m.num_features, generator=gen) ** 2
    f = build_forward_model(cfg.forward_model, generator=gen, device="cpu")
    return g.eval(), f.eval()


@pytest.mark.parametrize("batch", BATCHES)
def test_forward_kernel_matches_plain(batch, dev, models):
    packed = fk.pack_forward_model(models[1], dev)
    x = torch.rand((batch, 4), device=dev) * 2 - 1
    before = fk.LAUNCHES["fused_mlp_forward"]
    got = fk.fused_mlp_forward(x, packed)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_mlp_forward"] == before + 1
    want = fk.fused_mlp_forward_plain(x, packed)
    assert got.shape == (batch, 258)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("batch", BATCHES)
def test_generator_kernel_matches_plain(batch, dev, models):
    packed = fk.pack_generator(models[0], dev)
    x = torch.randn((batch, 250), device=dev)
    before = fk.LAUNCHES["fused_dense_chain"]
    got = fk.fused_dense_chain(x, packed)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_dense_chain"] == before + 1
    want = fk.fused_dense_chain_plain(x, packed)
    assert got.shape == (batch, 4)
    assert float((got - want).abs().max()) <= 2e-5


def test_small_odd_chain_matches_plain(dev):
    """Widths that are no multiple of the tile or the block: 7 -> 33 -> 5."""
    gen = torch.Generator().manual_seed(1)
    layer = (torch.randn(7, 33, generator=gen), *torch.randn(3, 33, generator=gen))
    head = (torch.randn(33, 5, generator=gen), torch.randn(5, generator=gen))
    packed = fk.pack_chain([layer], head, dev)
    x = torch.randn(19, 7, device=dev)
    got = fk.fused_mlp_forward(x, packed)
    torch.cuda.synchronize()
    assert float((got - fk.fused_mlp_forward_plain(x, packed)).abs().max()) <= 1e-4


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [1, 64, 257])
@pytest.mark.parametrize("kernel", ["fused_mlp_forward", "fused_dense_chain"])
def test_serving_kernel_shapes_agree_bitwise(kernel, batch, cluster, dev, models):
    """Each launch shape: one launch a call, within tolerance, a rerun
    bit-identical, and the same bits as the row-tile shape (every output is
    summed in the same order in both)."""
    if kernel == "fused_mlp_forward":
        packed, fn, plain, tol = (fk.pack_forward_model(models[1], dev), fk.fused_mlp_forward,
                                  fk.fused_mlp_forward_plain, 1e-4)
        x = torch.rand((batch, 4), device=dev) * 2 - 1
    else:
        packed, fn, plain, tol = (fk.pack_generator(models[0], dev), fk.fused_dense_chain,
                                  fk.fused_dense_chain_plain, 2e-5)
        x = torch.randn((batch, 250), device=dev)
    before = fk.LAUNCHES[kernel]
    got = fn(x, packed, cluster=cluster)
    assert fk.LAUNCHES[kernel] == before + 1
    again = fn(x, packed, cluster=cluster)
    row_tile = fn(x, packed, cluster=1)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[kernel] == before + 3
    assert torch.equal(got, again)
    assert torch.equal(got, row_tile)
    assert float((got - plain(x, packed)).abs().max()) <= tol


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_small_odd_chain_every_shape(cluster, dev):
    """7 -> 33 -> 5 in the cluster shape: some blocks own no head column."""
    gen = torch.Generator().manual_seed(1)
    layer = (torch.randn(7, 33, generator=gen), *torch.randn(3, 33, generator=gen))
    head = (torch.randn(33, 5, generator=gen), torch.randn(5, generator=gen))
    packed = fk.pack_chain([layer], head, dev)
    x = torch.randn(19, 7, device=dev)
    got = fk.fused_mlp_forward(x, packed, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.fused_mlp_forward(x, packed, cluster=1))
    assert float((got - fk.fused_mlp_forward_plain(x, packed)).abs().max()) <= 1e-4


@pytest.mark.parametrize("batch", ["crossover", 8192, 8192 + 37, 65536])
def test_wgmma_shape_matches_plain(batch, dev, models):
    """K5's wgmma shape from its crossover up (8192 + 37: a ragged last
    cluster): one launch a call, counted under its shape too; a rerun
    bit-identical; within K5's 1e-4 of the plain version and within 5e-5 of
    its 3xTF32 twin (the same products summed in another order: fp32
    rounding, about 1e-5).  Not held to the mma.sync shapes' bits."""
    packed = fk.pack_forward_model(models[1], dev)
    cross = fk.wgmma_crossover(fk.chain_limits(packed)[0])
    if batch == "crossover":
        batch = cross
    x = torch.rand((batch, 4), device=dev) * 2 - 1
    assert fk.chosen_shape(x, packed) == fk.WGMMA
    assert fk.chosen_shape(x[:cross - 1], packed) == 1
    before = dict(fk.LAUNCHES)
    got = fk.fused_mlp_forward(x, packed)
    again = fk.fused_mlp_forward(x, packed)
    torch.cuda.synchronize()
    assert {k: fk.LAUNCHES[k] - before[k] for k in ("fused_mlp_forward",
                                                    "fused_mlp_forward.wgmma")} == {
        "fused_mlp_forward": 2, "fused_mlp_forward.wgmma": 2}
    assert torch.equal(got, again)
    assert got.shape == (batch, 258)
    assert float((got - fk.fused_mlp_forward_plain(x, packed)).abs().max()) <= 1e-4
    assert float((got - fk.fused_mlp_forward_tf32(x, packed)).abs().max()) <= 5e-5


def test_custom_op_and_exported_designer_take_the_wgmma_shape(dev, models, tmp_path):
    """At B = 8192 the custom op (bit for bit the wrapper) and a ``use_pallas``
    designer exported on the CPU and loaded on the card launch K5 in its
    wgmma shape, once a call."""

    g, f = models
    fp = fk.pack_forward_model(f, dev)
    pn = torch.rand((8192, 4), device=dev) * 2 - 1
    before = fk.LAUNCHES["fused_mlp_forward.wgmma"]
    out = torch.ops.pigan_thz.fused_mlp_forward(pn, fp.weights, *fk.packed_op_args(fp),
                                                0.2, 1e-6)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_mlp_forward.wgmma"] == before + 1
    assert torch.equal(out, fk.fused_mlp_forward(pn, fp))

    cfg = default_config()
    gen = torch.Generator().manual_seed(3)
    p = sample_params(gen, 8192, cfg.data, device="cpu")
    spectra = synthesize_spectra(cfg.data.frequencies, p, gen, cfg.data.noise_level)
    ds = build_dataset(spectra, p, torch.full((8192, 8), float("nan")), cfg.data, device="cpu")
    path = serve.export_inverse_design(g, f, ds, str(tmp_path / "designer.pt2"), 8192,
                                       use_pallas=True)
    fn = serve.load_exported(path, device=dev)
    before = dict(fk.LAUNCHES)
    got = fn(spectra.to(dev))
    torch.cuda.synchronize()
    assert {k: fk.LAUNCHES[k] - before[k] for k in ("fused_mlp_forward",
                                                    "fused_mlp_forward.wgmma")} == {
        "fused_mlp_forward": 1, "fused_mlp_forward.wgmma": 1}
    assert all(bool(torch.isfinite(a).all()) for a in got)


def test_chosen_shape_follows_the_batch(dev, models):
    for packed, din in ((fk.pack_forward_model(models[1], dev), 4),
                        (fk.pack_generator(models[0], dev), 250)):
        sms, resident = fk.chain_limits(packed)
        assert all(n > 0 for n in resident.values()), resident
        cross = fk.crossover_for(packed)
        assert cross == fk.crossover_batch(sms, resident)
        assert fk.chosen_shape(torch.zeros((cross - 1, din), device=dev), packed) == 2
        assert fk.chosen_shape(torch.zeros((cross, din), device=dev), packed) == 1
        x = torch.randn((cross, din), device=dev)
        fn = fk.fused_mlp_forward if packed.layer_norm else fk.fused_dense_chain
        torch.testing.assert_close(fn(x[:-1], packed), fn(x, packed)[:-1], rtol=0, atol=0)


def test_empty_batch_launches_nothing(dev, models):
    packed = fk.pack_generator(models[0], dev)
    before = dict(fk.LAUNCHES)
    out = fk.fused_dense_chain(torch.empty((0, 250), device=dev), packed)
    assert out.shape == (0, 4) and fk.LAUNCHES == before


def test_weights_on_another_device_raise(dev, models):
    packed = fk.pack_forward_model(models[1])          # CPU weights
    with pytest.raises(ValueError):
        fk.fused_mlp_forward(torch.zeros((2, 4), device=dev), packed)


def test_cycle_matches_unfused_modules(dev, models):
    cfg = default_config()
    g, f = (copy.deepcopy(m).to(dev) for m in models)
    gen = torch.Generator(device=dev).manual_seed(2)
    p = sample_params(gen, 64, cfg.data, device=dev)
    spectra = synthesize_spectra(cfg.data.frequencies, p, gen, cfg.data.noise_level)
    ds = build_dataset(spectra, p, torch.full((64, 8), float("nan")), cfg.data,
                       device=dev)
    fn = make_inverse_design_fn(g, f, ds)
    before = dict(fk.LAUNCHES)
    got = fn(spectra)
    torch.cuda.synchronize()
    assert {k: fk.LAUNCHES[k] - before[k] for k in before} == {
        "fused_mlp_forward": 1, "fused_mlp_forward.wgmma": 0, "fused_dense_chain": 1,
        "fused_residual_chain": 0, "dip_qualification": 0, "forward_train": 0, "gan_train": 0,
        "gan_ensemble_train": 0, "brow_gemm": 0, "deep_narrow_gemm": 0, "batch_depth_gemm": 0,
        "sgemm": 0}
    with torch.no_grad():
        pn = g(spectra)
        want = (denormalize_params(pn, ds.param_lo, ds.param_hi), *f(pn))
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4
    assert bool(((got[0] >= 2.2) & (got[0] <= 2.8)).all())



@pytest.mark.parametrize("batch", [1, 64, 8192])
def test_custom_ops_equal_the_wrappers(batch, dev, models):
    """``torch.ops.pigan_thz.*``: the kernels' wrappers, bit for bit, one
    launch a call."""
    g, f = models
    gp, fp = fk.pack_generator(g, dev), fk.pack_forward_model(f, dev)
    gen = torch.Generator(device=dev).manual_seed(batch)
    x = torch.randn((batch, 250), generator=gen, device=dev)
    before = dict(fk.LAUNCHES)
    pn = torch.ops.pigan_thz.fused_dense_chain(x, gp.weights, *fk.packed_op_args(gp))
    out = torch.ops.pigan_thz.fused_mlp_forward(pn, fp.weights, *fk.packed_op_args(fp),
                                                0.2, 1e-6)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_dense_chain"] - before["fused_dense_chain"] == 1
    assert fk.LAUNCHES["fused_mlp_forward"] - before["fused_mlp_forward"] == 1
    assert torch.equal(pn, fk.fused_dense_chain(x, gp))
    assert torch.equal(out, fk.fused_mlp_forward(pn, fp))


def test_pallas_artifact_runs_the_kernels(dev, models, tmp_path):
    """A ``use_pallas`` designer written on the CPU, loaded on the card: one
    launch of K6 and one of K5 a call, bit for bit the in-process cycle."""
    from pigan_thz_torch import serve

    cfg = default_config()
    g, f = models
    gen = torch.Generator().manual_seed(3)
    p = sample_params(gen, 64, cfg.data, device="cpu")
    spectra = synthesize_spectra(cfg.data.frequencies, p, gen, cfg.data.noise_level)
    ds = build_dataset(spectra, p, torch.full((64, 8), float("nan")), cfg.data, device="cpu")
    path = serve.export_inverse_design(g, f, ds, str(tmp_path / "designer.pt2"), 64,
                                       use_pallas=True)
    fn = serve.load_exported(path, device=dev)
    x = spectra.to(dev)
    before = dict(fk.LAUNCHES)
    got = fn(x)
    torch.cuda.synchronize()
    assert {k: fk.LAUNCHES[k] - before[k] for k in ("fused_dense_chain",
                                                     "fused_mlp_forward")} == {
        "fused_dense_chain": 1, "fused_mlp_forward": 1}
    # the in-process cycle on the same packing: weights read on the CPU (the
    # card's division folds BatchNorm an ulp apart from the CPU's)
    ds_dev = type(ds)(*(t.to(dev) for t in ds))
    want = serve.make_inverse_design_fn(g, f, ds_dev)(x)
    for a, b in zip(got, want):
        assert a.device == x.device and torch.equal(a, b)
    with pytest.raises(ValueError, match="exported for inputs"):
        fn(x[:7])


INT8_CHAIN = [(250, 512), (512, 256), (256, 4), (4, 256), (256, 512), (512, 1024),
              (1024, 512), (256, 258)]


@pytest.mark.parametrize("b", [1, 3, 17, 64, 65, 8192])
@pytest.mark.parametrize("k, n", INT8_CHAIN)
def test_int_mm_on_the_card_equals_the_cpu(k, n, b, dev):
    """The int8 chain's products through ``torch._int_mm`` on the card, with
    the padding to its shape rules: exact."""
    from pigan_thz_torch.ops.quantized import int_mm

    gen = torch.Generator().manual_seed(b + k + n)
    x = torch.randint(-127, 128, (b, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    assert torch.equal(int_mm(x.to(dev), w.to(dev)).cpu(), int_mm(x, w))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_serving_dtypes_on_the_card_match_the_cpu(dtype, dev, models):
    """Within 2e-2 of each output's largest magnitude: bf16 by the bf16
    models' bound; int8's products are exact on both, the fp32 sums around
    them may move a rounding of an int8 row by one step, which
    tests/test_torch_quantized.py bounds far inside this."""
    cfg = default_config()
    g, f = models
    gen = torch.Generator().manual_seed(4)
    p = sample_params(gen, 64, cfg.data, device="cpu")
    spectra = synthesize_spectra(cfg.data.frequencies, p, gen, cfg.data.noise_level)
    ds = build_dataset(spectra, p, torch.full((64, 8), float("nan")), cfg.data, device="cpu")
    ds_dev = type(ds)(*(t.to(dev) for t in ds))
    want = make_inverse_design_fn(g, f, ds, compute_dtype=dtype)(spectra)
    before = dict(fk.LAUNCHES)
    got = make_inverse_design_fn(copy.deepcopy(g).to(dev), copy.deepcopy(f).to(dev), ds_dev,
                                 compute_dtype=dtype)(spectra.to(dev))
    torch.cuda.synchronize()
    assert fk.LAUNCHES == before
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        assert float((a.cpu() - b).abs().max()) <= 2e-2 * float(b.abs().max())
    assert bool(((got[0] >= 2.2) & (got[0] <= 2.8)).all())



# ---------------------------------------------------------------------------
# module stages as CUDA graphs (serve.py:ModuleStage)
# ---------------------------------------------------------------------------

GRAPHED = {"residual": GeneratorConfig(name="residual"),
           "conv_attn": GeneratorConfig(name="conv_attn"),
           "mlp_g": GeneratorConfig(name="mlp"),
           "mlp_f": ForwardModelConfig(name="mlp"),
           "branched": ForwardModelConfig(name="branched"),
           "physics": ForwardModelConfig(name="physics"),
           "uncertainty": ForwardModelConfig(name="uncertainty")}


@pytest.fixture(scope="module")
def enhanced():
    """The enhanced models at the published widths, seeded, the generators'
    BatchNorm with non-trivial running stats."""
    gen = torch.Generator().manual_seed(5)
    out = {}
    for name, c in GRAPHED.items():
        build = build_generator if isinstance(c, GeneratorConfig) else build_forward_model
        m = build(c, generator=gen, device="cpu")
        with torch.no_grad():
            for bn in m.modules():
                if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                    bn.running_mean += 0.1 * torch.randn(bn.num_features, generator=gen)
                    bn.running_var += 0.1 * torch.randn(bn.num_features, generator=gen) ** 2
        out[name] = m.eval()
    return out


def _graph_counts():
    c = profiling.snapshot()["counters"]
    return c.get(profiling.GRAPH_CAPTURES, 0), c.get(profiling.GRAPH_REPLAYS, 0)


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


def _stage_inputs(name, batch, dev, n):
    width = 4 if isinstance(GRAPHED[name], ForwardModelConfig) else 250
    gen = torch.Generator(device=dev).manual_seed(batch)
    return [torch.rand((batch, width), generator=gen, device=dev) * 2 - 1 for _ in range(n)]


@pytest.mark.parametrize("batch", [1, 8192])
@pytest.mark.parametrize("name, kind", [
    ("residual", "float32"), ("conv_attn", "float32"), ("mlp_g", "float32"),
    ("mlp_f", "float32"), ("branched", "float32"), ("physics", "float32"),
    ("uncertainty", "float32"), ("residual", "bfloat16")])
def test_module_stage_replays_its_eager_forward(name, kind, batch, dev, enhanced):
    """The first call eager, the second captures, the rest replay: each
    answer the eager forward's bit for bit, checked after every call (no
    answer aliases a later one's), the module's state unchanged.  The
    baseline MLPs are module stages under ``use_pallas=False``."""
    stage = serve._stage(enhanced[name], dev, kind, fused=False)
    state = {k: v.clone() for k, v in stage.state_dict().items()}
    xs = _stage_inputs(name, batch, dev, 3)
    profiling.reset()
    with profiling.recording(), torch.inference_mode():
        want = [_tensors(stage._eager(x)) for x in xs]
        got = [_tensors(stage(x)) for x in (*xs, xs[0])]
    torch.cuda.synchronize()
    assert _graph_counts() == (1, 3)
    for out, ref in zip(got, [*want, want[0]]):
        for a, b in zip(out, ref, strict=True):
            assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(got[1][0], got[2][0])
    assert len({t.data_ptr() for out in got for t in out}) == len(got) * len(got[0])
    for k, v in stage.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_module_stage_keeps_a_graph_per_shape(dev, enhanced):
    """A third shape captured leaves the first two replaying their own."""
    stage = serve._stage(enhanced["residual"], dev, "float32", fused=False)
    batches = (64, 257, 8192)
    xs = {b: _stage_inputs("residual", b, dev, 1)[0] for b in batches}
    profiling.reset()
    with profiling.recording(), torch.inference_mode():
        want = {b: stage._eager(x) for b, x in xs.items()}
        for b in batches:
            stage(xs[b])
            stage(xs[b])
        got = {b: stage(xs[b]) for b in batches}
    assert _graph_counts() == (3, 6)
    assert [k[0][0] for k in stage._graphs] == list(batches)
    for b in batches:
        assert torch.equal(got[b], want[b]), b


def test_an_evicted_graph_frees_its_memory(dev, enhanced):
    """And its shape, called again, runs eagerly: it is not captured twice."""
    stage = serve._stage(enhanced["residual"], dev, "float32", fused=False)
    big = _stage_inputs("residual", 65536, dev, 1)[0]

    def reserved():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    base = reserved()
    with torch.inference_mode():
        stage(big)
        stage(big)
    held = reserved() - base
    with torch.inference_mode():
        for b in range(1, serve.GRAPHS_PER_STAGE + 1):
            x = _stage_inputs("residual", b, dev, 1)[0]
            stage(x)
            stage(x)
    assert (65536, 250) not in [tuple(k[0]) for k in stage._graphs]
    left = reserved() - base
    assert held > 256 * 2**20 and left < held / 4, (held, left)
    profiling.reset()
    with profiling.recording(), torch.inference_mode():
        want = stage._eager(big)
        got = [stage(big) for _ in range(2)]
    assert _graph_counts() == (0, 0) and not stage.replayed
    assert all(torch.equal(g, want) for g in got)


def test_module_stage_stays_eager_where_it_must(dev, enhanced):
    """Outside inference mode, under a dispatch mode (``FlopCounterMode``),
    in train mode: eager, with the graph for the shape already captured."""
    from torch.utils.flop_counter import FlopCounterMode

    stage = serve._stage(enhanced["residual"], dev, "float32", fused=False)
    (x,) = _stage_inputs("residual", 64, dev, 1)
    profiling.reset()
    with profiling.recording():
        with torch.inference_mode():
            want = stage(x)
            stage(x)
        assert _graph_counts() == (1, 1)
        with torch.no_grad():
            assert torch.equal(stage(x), want)
        counter = FlopCounterMode(display=False)
        with torch.inference_mode(), counter:
            stage(x)
        stage.module.train()
        with torch.inference_mode():
            stage(x)
        stage.module.eval()
        assert _graph_counts() == (1, 1)
    assert counter.get_total_flops() == 2 * 64 * sum(
        m.in_features * m.out_features for m in stage.module.modules()
        if isinstance(m, torch.nn.Linear))


def test_designer_serves_an_enhanced_trio_through_graphs(dev, enhanced, tmp_path):
    """The residual G and the uncertainty F as module stages: a request
    replays both graphs, equal to the first (eager) request bit for bit, its
    answers intact after later requests; the trio's export on the card
    still traces and runs."""
    cfg = default_config()
    g, f = (copy.deepcopy(enhanced[n]).to(dev) for n in ("residual", "uncertainty"))
    gen = torch.Generator(device=dev).manual_seed(6)
    p = sample_params(gen, 64, cfg.data, device=dev)
    spectra = synthesize_spectra(cfg.data.frequencies, p, gen, cfg.data.noise_level)
    ds = build_dataset(spectra, p, torch.full((64, 8), float("nan")), cfg.data, device=dev)
    fn = make_inverse_design_fn(g, f, ds)
    profiling.reset()
    with profiling.recording():
        first = fn(spectra)
        kept = [t.clone() for t in first]
        later = [fn(spectra) for _ in range(3)]
        other = fn(spectra.flip(0))
    torch.cuda.synchronize()
    assert _graph_counts() == (2, 8)
    for out in (first, *later):
        for a, b in zip(out, kept):
            assert torch.equal(a, b)
    assert not torch.equal(other[0], first[0])
    art = serve.load_exported(
        serve.export_inverse_design(g, f, ds, str(tmp_path / "d.pt2"), batch_size=64),
        device=dev)
    for a, b in zip(art(spectra), kept):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


RESIDUAL_GAP = 3e-5     # of the module's RMS: the design cells' params_gap limit


def _gap(got, want):
    return float((got - want).abs().max()) / float(want.pow(2).mean().sqrt())


@pytest.mark.parametrize("batch", ["below", "crossover", 8192, 8192 + 37, 65536])
def test_residual_stage_matches_the_module(batch, dev, enhanced):
    """The residual G's stage (the default fp32 designer's on the card): from
    its crossover up one launch of the residual chain kernel a call, within
    the design cells' ``params_gap`` limit of the plain fp32 module (TF32
    off), a rerun bit-identical (8192 + 37: a ragged last cluster); below it
    the module stage, the module's own answer."""
    g = copy.deepcopy(enhanced["residual"]).to(dev)
    stage = serve._stage(g, dev, "float32", fused=False, residual=True)
    assert isinstance(stage, serve.ResidualStage)
    b = {"below": stage.crossover - 1, "crossover": stage.crossover}.get(batch, batch)
    x = torch.randn((b, 250), generator=torch.Generator(device=dev).manual_seed(b), device=dev)
    with torch.inference_mode():
        want = g(x)
        before = fk.LAUNCHES["fused_residual_chain"]
        got = stage(x)
        again = stage(x)
        torch.cuda.synchronize()
        launched = b >= stage.crossover
        assert stage.launched == launched
        assert fk.LAUNCHES["fused_residual_chain"] - before == 2 * launched
        assert torch.equal(got, again)
        assert _gap(got, want) <= RESIDUAL_GAP
        if not launched:
            assert torch.equal(got, want)


def test_enhanced_designer_launches_the_residual_kernel_once_a_request(dev, enhanced):
    """At B = 8192 the enhanced designer's G stage is one launch of the
    residual chain kernel a request, its span names the kernel's launch
    shape and reads ``replayed`` 0; the parameters within the design cells'
    ``params_gap`` limit of the ``use_pallas=False`` designer's."""
    cfg = default_config()
    g, f = (copy.deepcopy(enhanced[n]).to(dev) for n in ("residual", "mlp_f"))
    gen = torch.Generator(device=dev).manual_seed(8)
    p = sample_params(gen, 8192, cfg.data, device=dev)
    spectra = synthesize_spectra(cfg.data.frequencies, p, gen, cfg.data.noise_level)
    ds = build_dataset(spectra, p, torch.full((8192, 8), float("nan")), cfg.data, device=dev)
    designer = serve._designer(g, f, ds, None, None)       # make_inverse_design_fn's
    fn = serve._serving_fn(designer)
    want = make_inverse_design_fn(g, f, ds, use_pallas=False)(spectra)
    profiling.reset()
    before = fk.LAUNCHES["fused_residual_chain"]
    with profiling.recording():
        outs = [fn(spectra) for _ in range(3)]
        torch.cuda.synchronize()
        snap = profiling.snapshot()
    assert fk.LAUNCHES["fused_residual_chain"] - before == 3
    spans = [r["attrs"] for r in snap["recent"] if r["name"] == "pigan.serve.gen_stage"]
    assert spans == [{"replayed": 0, "shape": fk.WGMMA}] * 3
    for out in outs:
        assert torch.equal(out[0], outs[0][0])
        assert _gap(out[0], want[0]) <= RESIDUAL_GAP


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_ensemble_designer_replays_its_surrogate(kind, dev, enhanced):
    """The ensemble designer: its members' mean eager, its F a module stage
    that replays, each request equal to the first (eager) one bit for bit
    and intact after later ones."""
    cfg = default_config()
    gen = torch.Generator(device=dev).manual_seed(7)
    p = sample_params(gen, 64, cfg.data, device=dev)
    spectra = synthesize_spectra(cfg.data.frequencies, p, gen, cfg.data.noise_level)
    ds = build_dataset(spectra, p, torch.full((64, 8), float("nan")), cfg.data, device=dev)
    members = [build_generator(cfg.generator, generator=torch.Generator().manual_seed(s),
                               device="cpu").eval() for s in range(3)]
    fn = serve.make_ensemble_inverse_design_fn(members, enhanced["mlp_f"], ds,
                                               compute_dtype=kind)
    profiling.reset()
    with profiling.recording():
        first = fn(spectra)
        kept = [t.clone() for t in first]
        later = [fn(spectra) for _ in range(3)]
    torch.cuda.synchronize()
    assert _graph_counts() == (1, 3)
    for out in (first, *later):
        for a, b in zip(out, kept, strict=True):
            assert torch.equal(a, b)


def _spectra(kind, b, n, dev, seed=0, f=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "screen":
        # the screen's spectra: K5 on random candidates, rows of n cut from
        # consecutive predictions
        reps = -(-n // 250)
        pn = torch.rand((b * reps, 4), generator=gen, device=dev) * 2 - 1
        spec = fk.forward_surrogate_fused(fk.pack_forward_model(f, dev), pn)[0]
        return spec.reshape(b, reps * 250)[:, :n].contiguous()
    noise = torch.randn((b, n), generator=gen, device=dev)
    if kind == "random_walk":
        return torch.cumsum(0.8 * noise, dim=1).clamp(max=0.0)
    if kind == "white_noise":
        return (-1.0 + 0.6 * noise).clamp(max=0.0)
    if kind == "quantized":
        return torch.round((-2.0 + 1.5 * noise).clamp(max=0.0) * 2.0) / 2.0
    cfg = default_config().data
    freq = torch.linspace(cfg.freq_min, cfg.freq_max, n)
    p = sample_params(gen, b, cfg, device=dev)
    return synthesize_spectra(freq, p, gen, cfg.noise_level)


def _assert_k4_equal(got, want, equal_nan=False):
    """equal_nan: a NaN measure (a window holding a NaN sample) equals NaN."""
    assert torch.equal(got.qualified, want.qualified)
    assert torch.equal(got.is_peak, want.is_peak)
    pkm = want.is_peak
    torch.testing.assert_close(got.prominence[pkm], want.prominence[pkm],
                               rtol=1e-6, atol=0, equal_nan=equal_nan)
    torch.testing.assert_close(got.width[pkm], want.width[pkm], rtol=1e-5, atol=0,
                               equal_nan=equal_nan)


def _lattice(t, *thresholds):
    """The lattice on row slices of at most 2^26 lattice entries."""
    rows = max(1, 2**26 // t.shape[1] ** 2)
    parts = [pk.dip_qualification(t[s:s + rows], *thresholds)
             for s in range(0, t.shape[0], rows)]
    return pk.DipQualification(*(torch.cat(f) for f in zip(*parts)))


K4_KINDS = ["synthetic", "random_walk", "white_noise", "quantized", "screen"]


@pytest.mark.parametrize("batch", [1, 7, 333, 8192])
@pytest.mark.parametrize("n", [250, 199, 64, 300, 4096])
@pytest.mark.parametrize("kind", K4_KINDS)
def test_dip_kernel_matches_both_plain_versions(kind, n, batch, dev, models):
    """Ragged N (199, 64: a warp's last candidates idle), odd N (199: scalar
    row loads), N = 4096 (two warps a block); a batch of one, a ragged last
    block (7, 333)."""
    t = _spectra(kind, batch, n, dev, f=models[1])
    before = fk.LAUNCHES["dip_qualification"]
    got = pk.batched_dip_qualification(t)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["dip_qualification"] == before + 1
    assert got.qualified.dtype == torch.bool and got.qualified.shape == (batch, n)
    _assert_k4_equal(got, _lattice(t))
    _assert_k4_equal(got, pk._dip_qualification_lifted(t))
    if batch >= 7:
        assert bool(got.qualified.any())


def test_dip_kernel_edges(dev):
    """N above the cap raises; an empty batch launches nothing; other
    thresholds reach the kernel."""
    with pytest.raises(ValueError, match="N"):
        pk.batched_dip_qualification(torch.zeros((2, pk.MAX_N + 1), device=dev))
    before = dict(fk.LAUNCHES)
    out = pk.batched_dip_qualification(torch.zeros((0, 250), device=dev))
    assert out.width.shape == (0, 250) and fk.LAUNCHES == before
    t = _spectra("white_noise", 64, 250, dev, seed=3)
    got = pk.batched_dip_qualification(t, min_prominence=0.5, min_width=2.0)
    _assert_k4_equal(got, pk.dip_qualification(t, 0.5, 2.0))


def _metrics_plain(freq, t, c1, c2, prominence=1.0):
    """The metrics entry's plain version on the card: spectrum_metrics on
    the lattice's qualification."""
    q = _lattice(t, prominence).qualified
    return pk.spectrum_metrics(freq, t, c1, c2, qualified=q)


def _assert_bit_equal(got, want):
    """Equal NaN pattern, every other value equal (== : -0 equals +0)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def _metrics_centres(kind, c1, c2):
    if kind == "none":
        return None, None
    if kind == "nan_mixed":
        c1, c2 = c1.clone(), c2.clone()
        c1[::3] = torch.nan
        c2[1::3] = torch.nan
    if kind == "scalar":
        return 0.9, 2.1
    return c1, c2


@pytest.mark.parametrize("prominence", [1.0, 0.5, 2.0])
@pytest.mark.parametrize("centres", ["none", "per_row", "nan_mixed", "scalar"])
@pytest.mark.parametrize("kind", ["synthetic", "white_noise", "quantized", "screen"])
def test_peak_metrics_kernel_matches_plain(kind, centres, prominence, dev, models):
    cfg = default_config().data
    b, n = 2000, cfg.spectrum_dim
    freq = cfg.frequencies.to(dev)
    if kind == "synthetic":
        gen = torch.Generator(device=dev).manual_seed(5)
        p = sample_params(gen, b, cfg, device=dev)
        t = synthesize_spectra(freq, p, gen, cfg.noise_level)
        c1, c2 = dip_centers(p)
    else:
        t = _spectra(kind, b, n, dev, seed=5, f=models[1])
        gen = torch.Generator(device=dev).manual_seed(6)
        c1, c2 = (freq[torch.randint(0, n, (b,), generator=gen, device=dev)]
                  for _ in range(2))
    c1, c2 = _metrics_centres(centres, c1, c2)
    before = fk.LAUNCHES["dip_qualification"]
    got = pk.batched_peak_metrics(freq, t, c1, c2, min_prominence=prominence)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["dip_qualification"] == before + 1
    _assert_bit_equal(got, _metrics_plain(freq, t, c1, c2, prominence))
    assert bool(got[:, 2].isfinite().any())


@pytest.mark.parametrize("n", [64, 250, 4096])
@pytest.mark.parametrize("centres", ["none", "per_row", "nan_mixed", "scalar"])
def test_peak_metrics_kernel_on_hostile_rows(centres, n, dev):
    """tests/peak_rows.py: NaN and +-inf samples, an all-equal row, border
    plateaus, dips at the borders, ties in depth and centre distance."""
    freq, t, c1, c2 = (torch.from_numpy(a).to(dev) for a in hostile_rows(n))
    c1, c2 = _metrics_centres(centres, c1, c2)
    got = pk.batched_peak_metrics(freq, t, c1, c2)
    _assert_bit_equal(got, _metrics_plain(freq, t, c1, c2))
    four = pk.batched_dip_qualification(t)
    _assert_k4_equal(four, _lattice(t), equal_nan=True)


def test_peak_metrics_kernel_edges(dev):
    """An empty batch launches nothing; a grid of another length raises;
    the dataset's centres (B,) on the CPU are moved to the card."""
    freq = default_config().data.frequencies
    before = dict(fk.LAUNCHES)
    out = pk.batched_peak_metrics(freq, torch.zeros((0, 250), device=dev))
    assert out.shape == (0, 8) and fk.LAUNCHES == before
    t = _spectra("synthetic", 64, 250, dev, seed=2)
    with pytest.raises(ValueError, match="freq"):
        pk.batched_peak_metrics(freq[:-1], t)
    c = torch.full((64,), 1.1)
    got = pk.batched_peak_metrics(freq, t, c, c + 1.0)
    _assert_bit_equal(got, _metrics_plain(freq.to(dev), t, c.to(dev), c.to(dev) + 1.0))


def test_card_metrics_match_cpu(dev):
    t = _spectra("synthetic", 512, 250, dev, seed=4)
    freq = default_config().data.frequencies
    got = pk.batched_peak_metrics(freq, t)
    want = pk.batched_peak_metrics(freq, t.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0, equal_nan=True)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "module"])
def test_screening_launches_per_chunk(use_pallas, dev, models):
    cfg = default_config()
    f = copy.deepcopy(models[1]).to(dev)
    lo = torch.full((4,), 2.2, device=dev)
    hi = torch.full((4,), 2.8, device=dev)
    sc = ScreeningConfig(num_candidates=20000, chunk_size=8192, top_k=16,
                         use_pallas=use_pallas)
    before = dict(fk.LAUNCHES)
    res = screen_designs(f, cfg.data.frequencies, lo, hi,
                         torch.Generator(device=dev).manual_seed(42), sc)
    torch.cuda.synchronize()
    assert {k: fk.LAUNCHES[k] - before[k] for k in before} == {
        "fused_mlp_forward": 3 if use_pallas else 0,
        "fused_mlp_forward.wgmma": 3 if use_pallas else 0,      # chunks of 8192
        "fused_dense_chain": 0, "fused_residual_chain": 0, "dip_qualification": 3,
        "forward_train": 0, "gan_train": 0,
        "gan_ensemble_train": 0, "brow_gemm": 0, "deep_narrow_gemm": 0, "batch_depth_gemm": 0,
        "sgemm": 0}
    v = res.valid
    assert bool(v.any()) and bool(torch.isfinite(res.scores[v]).all())
    assert bool((res.scores[:-1] >= res.scores[1:]).all())
    assert bool(((res.params >= 2.2) & (res.params <= 2.8)).all())


# -- K1: forward-surrogate pretraining ---------------------------------------
# Tolerances and their reasons: chip_smoke.py (K1_*).
K1_ROWS_RTOL, K1_PARAM_ATOL, K1_M_ATOL, K1_V_ATOL = 5e-4, 1e-3, 1e-5, 1e-8


@pytest.fixture(scope="module")
def train_ds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return synthetic_dataset(default_config().data, device=torch.device("cuda", 0))


def _k1_setup(ds, rate, epochs=2, seed=0):
    cfg = default_config()
    cfg = cfg.replace(forward_model=dataclasses.replace(cfg.forward_model,
                                                        dropout_rate=rate))
    _, _, ftx = make_optimizers(cfg, 15)
    state = init_forward_state(build_forward_model(cfg.forward_model, device="cpu"), ftx, seed,
                               device=ds.spectra.device)
    idx, seeds = ft.resolve_draws(torch.Generator().manual_seed(seed), ds.num_samples, 64,
                                  epochs)
    sched = make_schedule("cosine", 1e-3, 500, 15, schedule_alpha=0.0)
    streams = ft.build_streams(ds, idx, seeds, torch.ones(epochs), 0, sched)
    return cfg, state, ftx, idx, seeds, streams


def _assert_k1_close(rows, state, want_rows, want_state):
    assert float(((rows - want_rows).abs() / want_rows.abs()).max()) <= K1_ROWS_RTOL
    for a, b, tol in zip(state, want_state, (K1_PARAM_ATOL, K1_M_ATOL, K1_V_ATOL)):
        assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("settings", [ForwardStepSettings(),
                                      ForwardStepSettings(5.0, 2.0, 0.5, 0.5)],
                         ids=["mse", "weighted_smooth_l1"])
@pytest.mark.parametrize("rate", [0.2, 0.0])
def test_forward_train_kernel_matches_plain(rate, settings, dev, train_ds):
    cfg, state, _, _, seeds, streams = _k1_setup(train_ds, rate)
    spec = ft.forward_train_spec(cfg, settings)
    kern = [state.params.clone(), state.opt.m.clone(), state.opt.v.clone()]
    plain = [t.clone() for t in kern]
    work = torch.empty(ft.workspace_floats(spec, 64), device=dev)
    before = ft.LAUNCHES["forward_train"]
    rows = ft.forward_train(*kern, streams, spec, work=work)
    torch.cuda.synchronize()
    assert ft.LAUNCHES["forward_train"] == before + 1
    if rate:
        for l, mk in enumerate(ft.saved_dropout(work, spec, 64)):
            assert torch.equal(mk, ft.dropout_scale(int(seeds[-1]), l, 64, mk.shape[1],
                                                    rate, dev))
    want = ft.forward_train_plain(*plain, streams, spec)
    assert rows.shape == (30, 3) and bool(torch.isfinite(rows).all())
    _assert_k1_close(rows, kern, want, plain)


def test_forward_train_kernel_rerun_is_bit_identical(dev, train_ds):
    cfg, state, _, _, _, streams = _k1_setup(train_ds, 0.2, epochs=1)
    spec = ft.forward_train_spec(cfg, ForwardStepSettings())
    runs = []
    for _ in range(2):
        s = [state.params.clone(), state.opt.m.clone(), state.opt.v.clone()]
        runs.append((ft.forward_train(*s, streams, spec), s))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(map(torch.equal, runs[0][1], runs[1][1]))


def test_forward_train_kernel_matches_eager_step(dev, train_ds):
    cfg, state, ftx, idx, seeds, streams = _k1_setup(train_ds, 0.0)
    settings = ForwardStepSettings()
    spec = ft.forward_train_spec(cfg, settings)
    kern = [state.params.clone(), state.opt.m.clone(), state.opt.v.clone()]
    rows = ft.epoch_means(ft.forward_train(*kern, streams, spec), 2)
    eager = make_multi_epoch_fn(make_forward_step(ftx, settings), 64)
    state, ms = eager(state, train_ds, torch.ones(2), indices=idx, seeds=seeds)
    torch.cuda.synchronize()
    got = torch.stack([rows[k] for k in ft.METRIC_KEYS])
    want = torch.stack([ms[k] for k in ft.METRIC_KEYS])
    _assert_k1_close(got, kern, want, (state.params, state.opt.m, state.opt.v))


def test_forward_train_wrapper_refuses(dev, train_ds):
    cfg, state, _, _, _, streams = _k1_setup(train_ds, 0.2, epochs=1)
    spec = ft.forward_train_spec(cfg, ForwardStepSettings())
    s = [state.params, state.opt.m, state.opt.v]
    with pytest.raises(ValueError, match="work"):
        ft.forward_train(*s, streams, spec, work=torch.empty(16, device=dev))
    cpu_streams = streams._replace(spectra=streams.spectra.cpu())
    with pytest.raises(ValueError):
        ft.forward_train(*s, cpu_streams, spec)


def test_trainer_launches_the_kernel_once_per_chunk(dev, train_ds):
    trainer = Trainer(default_config(), ds=train_ds, epochs_per_call=2, device=dev)
    before = ft.LAUNCHES["forward_train"]
    hist = trainer.pretrain_forward(epochs=5)
    assert ft.LAUNCHES["forward_train"] == before + 3
    loss = hist["forward/loss"]
    assert len(loss) == 5 and all(x == x for x in loss) and loss[-1] < loss[0]


@pytest.mark.parametrize("dtype, rate, per_step", [
    ("float32", 0.2, 36), ("float32", 0.0, 36), ("bfloat16", 0.2, 39)])
def test_forward_kernel_enqueues_the_launches_a_step_it_says(dtype, rate, per_step, dev,
                                                             train_ds):
    """The C loop's own counts over one epoch, in its report: 36 launches a
    step (39 with bfloat16 operands), of them ``brow_products`` through the
    batch-row kernel (10 a step), which ``launch_loop`` adds to
    ``LAUNCHES["brow_gemm"]``."""
    cfg, state, _, _, _, streams = _k1_setup(train_ds, rate, epochs=1)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))
    spec = ft.forward_train_spec(cfg, ForwardStepSettings())
    want = len(ft.brow_products(spec, 64)) * 15
    before = LAUNCHES["brow_gemm"]
    rows = ft.forward_train(state.params, state.opt.m, state.opt.v, streams, spec)
    torch.cuda.synchronize()
    report = report_of(rows)
    assert report.kernels == per_step * 15
    assert report.brow == want == 10 * 15
    assert LAUNCHES["brow_gemm"] == before + want


def test_forward_train_kernel_first_step_against_float64(dev, train_ds):
    """K1's first float32 step (dropout 0.2) from the published-width state:
    its rows and Adam's first moments, tensor by tensor, within K2_ROUNDING
    times the float32 plain version's distance from the float64 plain
    version, or K2_STEP_FLOOR[1]; the float64 run with the last K slice of
    layer 3's input gradient dropped (``dx_layer3_last_slice_dropped``) is
    K1_BF16_FAULT_RATIO times further from the kernel on some tensor."""
    cfg, state, _, _, _, streams = _k1_setup(train_ds, 0.2, epochs=1)
    spec = ft.forward_train_spec(cfg, ForwardStepSettings())
    one = streams._replace(params_norm=streams.params_norm[:1].contiguous(),
                           spectra=streams.spectra[:1].contiguous(),
                           metrics_norm=streams.metrics_norm[:1].contiguous(),
                           sched=streams.sched[:1], seeds=streams.seeds[:1])
    start = (state.params, state.opt.m, state.opt.v)

    def run(dbl=False, faults=(), kernel=False):
        bufs = [t.clone().double() if dbl else t.clone() for t in start]
        fn = ft.forward_train if kernel else (
            lambda *a: ft.forward_train_plain(*a, faults=faults))
        rows = fn(*bufs, one, spec)
        torch.cuda.synchronize()
        return rows.double(), {k: t.double().reshape(-1)
                              for k, t in spec.named_tensors(bufs[1]).items()}

    rows_k, mk = run(kernel=True)
    rows_p, mp = run()
    rows_x, mx = run(dbl=True)
    _, mw = run(dbl=True, faults=("dx_layer3_last_slice_dropped",))

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(min=1e-30))

    e_k = {k: rel(mk[k], mx[k]) for k in mx}
    e_p = {k: rel(mp[k], mx[k]) for k in mx}
    floor = K2_STEP_FLOOR[1]
    bad = {k: (e_k[k], e_p[k]) for k in mx if not e_k[k] <= max(K2_ROUNDING * e_p[k], floor)}
    row_k = float(((rows_k - rows_x).abs() / rows_x.abs()).max())
    row_p = float(((rows_p - rows_x).abs() / rows_x.abs()).max())
    ratio = {k: rel(mk[k], mw[k]) / max(e_k[k], e_p[k], 1e-9) for k in mx}
    worst, seen = max(e_k, key=e_k.get), max(ratio, key=ratio.get)
    print(f"K1 first step vs float64: rows kernel {row_k:.3e} (float32 plain {row_p:.3e}); "
          f"worst tensor {worst} {e_k[worst]:.3e} (float32 plain {e_p[worst]:.3e}); "
          f"the fault seen {ratio[seen]:.1f}x on {seen}")
    assert not bad, bad
    assert row_k <= max(K2_ROUNDING * row_p, floor)
    assert ratio[seen] > 4.0


# -- K2: PI-GAN training -------------------------------------------------------
# Tolerances and their reasons: chip_smoke.py (K2_*).
K2_ROUNDING, K2_STEP_FLOOR = 8.0, {1: 1e-6, 3: 1e-2}
# the first steps with cycle on, by kind of tensor: chip_smoke.py
K2_CYCLE_STEP_FLOOR = {"m": 5e-3, "v": 5e-3, "p": 2e-2, "ema": 2e-2, "bn": 1e-6}
K2_PATHS_3_STEP_FLOOR = 5e-2      # three steps on the new paths: chip_smoke.py
K2_TODAY = ("through_f", "detached", "knob_mix")


def _k2_floor(case, settings, steps, key):
    if steps == 3 and case not in K2_TODAY:
        return K2_PATHS_3_STEP_FLOOR
    if settings.cycle_w and steps == 1:
        return K2_CYCLE_STEP_FLOOR[key.split("[")[0].split("_")[-1]]
    return K2_STEP_FLOOR[steps]
K2_ROWS_RTOL, K2_COUNT_ATOL = 5e-2, 2 / 64
K2_PART_RTOL = {"g": 0.25, "d": 0.25, "ema": 0.25, "bn": 2e-2, "v": 0.1, "m": 0.5}
K2_MIX = dict(detach_forward=False, d_update_every=2, constraint_w=0.7, window_w=0.3,
              sigmoid_squash=True, ema_decay=0.99)
K2_AUGMENT = dict(augment_noise=0.05, augment_shift=0.02, augment_scale=0.1)
# the second G passes and the noise streams, path by path, then all at once
K2_PATHS = {
    "through_f": dict(detach_forward=False),
    "detached": dict(detach_forward=True),
    "knob_mix": K2_MIX,
    "cycle_through_f": dict(detach_forward=False, cycle_w=1.0, adv_w=0.0, d_update_every=2),
    "cycle_detached": dict(detach_forward=True, cycle_w=1.0),
    "stability": dict(detach_forward=False, stability_w=1.0),
    "second_passes_mix": dict(detach_forward=False, stability_w=1.0, cycle_w=1.0,
                              sigmoid_squash=True, constraint_w=3.0),
    "instance_noise": dict(detach_forward=False, instance_noise=0.05),
    "augmentation": dict(detach_forward=False, **K2_AUGMENT),
    "all_four": dict(detach_forward=False, cycle_w=1.0, stability_w=1.0, instance_noise=0.05,
                     d_update_every=2, ema_decay=0.99, **K2_AUGMENT),
    # WGAN-GP: the critic loss, the penalty and its second-order backward
    "wgan_gp_through_f": dict(detach_forward=False, gan_loss="wgan_gp"),
    "wgan_gp_mix": dict(detach_forward=True, gan_loss="wgan_gp", d_update_every=2,
                        stability_w=1.0, instance_noise=0.05),
}
# bfloat16 operands: the kernel against its float32-accumulating plain
# version with the same rounding (chip_smoke.py: K2_BF16_*)
K2_BF16_PATHS = {
    "bf16_through_f": dict(detach_forward=False),
    "bf16_detached": dict(detach_forward=True),
    "bf16_wgan_gp_cycle_stability": dict(detach_forward=False, gan_loss="wgan_gp", cycle_w=1.0,
                                         stability_w=1.0, d_update_every=2),
}
K2_BF16_PART_RTOL = {"g": 0.4, "d": 0.4, "ema": 0.4, "bn": 3e-2, "v": 0.1, "m": 0.4}
K2_BF16_STEP_RTOL = {"lc_loss": 5e-3, "recon_metrics_loss": 1e-3, "maxwell_loss": 1e-3}
K2_BF16_STEP_FLOOR = 2e-4
K2_BF16_TENSOR_FLOOR = 5e-4
# WGAN-GP trajectories over their first steps only (chip_smoke.py: K2_WGAN_WINDOW)
K2_WGAN_WINDOW = 8


@pytest.fixture(scope="module")
def trained_f(train_ds):
    """F after 30 epochs through K1: losses of a realistic size."""
    trainer = Trainer(default_config(), ds=train_ds, device=train_ds.spectra.device)
    trainer.pretrain_forward(epochs=30)
    return trainer.forward_state.f


def _k2_setup(ds, f, epochs=2, seed=0, compute_dtype="float32", **knobs):
    cfg = default_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=compute_dtype))
    settings = StepSettings.from_config(cfg, **knobs)
    gtx, dtx, _ = make_optimizers(cfg, 15)
    g, d, _ = build_trio(cfg, device="cpu")
    state = init_pigan_state(g, d, f, gtx, dtx, seed, device=ds.spectra.device,
                             ema=settings.ema_decay > 0)
    idx, seeds = ft.resolve_draws(torch.Generator().manual_seed(seed), ds.num_samples, 64,
                                  epochs)
    return cfg, settings, state, gtx, dtx, idx, seeds


def _k2_streams(ds, cfg, settings, idx, seeds, scales, steps=None):
    """The chunk's streams from step 0, optionally its first ``steps`` only."""
    if steps is not None:
        idx, seeds = idx[:, :steps], seeds.reshape(idx.shape[0], -1)[:, :steps].reshape(-1)
    return gt.build_streams(ds, idx, scales, 0, 0, 0, settings.d_update_every,
                            _k2_schedule(cfg, "g"), _k2_schedule(cfg, "d"),
                            settings=settings, seeds=seeds)


def _row_errors(rows, want, keys, wgan):
    """|rows - want| relative to |want| (at least 1e-3); under WGAN-GP the
    critic loss, a difference of two means, relative to their size
    (|adv_loss| where that is the larger): chip_smoke.py ``row_errors``."""
    scale = want.abs().clamp(min=1e-3)
    if wgan:
        j, a = keys.index("d_loss"), keys.index("adv_loss")
        scale[:, j] = torch.maximum(scale[:, j], want[:, a].abs())
    return (rows - want).abs() / scale


def _k2_yardstick(state, streams, spec):
    """The float32 plain version's run of ``streams`` from ``state`` and how
    far it ends from the float64 run, by part (``state_diffs``)."""
    plain = state.clone()
    exact = gt.to_double(gt.state_buffers(state.clone()))
    want = gt.gan_train_plain(gt.state_buffers(plain), streams, spec)
    want64 = gt.gan_train_plain(exact, gt.to_double(streams), spec)
    yard = gt.state_diffs(gt.state_buffers(plain), exact, gt.state_buffers(state), spec)
    # and of its rows (per step), relative, the two counts left out
    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    floats = [j for j, k in enumerate(keys) if k not in ("d_accuracy", "violation_rate")]
    yard["rows"] = float(_row_errors(want, want64, keys, spec.wgan)[:, floats].max())
    return want, plain, yard


def _assert_k2_close(got_rows, got, want_rows, want, start, yard, spec, keys):
    """Rows are (T or E, len(keys)); each part of the state within its
    K2_PART_RTOL in L2 relative to what the steps changed (``yard``, the
    float32 plain version's own distance from float64, is printed beside)."""
    counts = [keys.index(k) for k in ("d_accuracy", "violation_rate")]
    floats = [j for j in range(len(keys)) if j not in counts]
    assert float((got_rows[:, counts] - want_rows[:, counts]).abs().max()) <= K2_COUNT_ATOL
    rel = _row_errors(got_rows, want_rows, keys, spec.wgan)[:, floats]
    diffs = gt.state_diffs(gt.state_buffers(got), gt.state_buffers(want),
                           gt.state_buffers(start), spec)
    worst = {keys[j]: f"{float(rel[:, i].max()):.2e}" for i, j in enumerate(floats)}
    print("K2 rows rel", float(rel.max()), worst,
          {k: f"{r:.3e} (yardstick {yard[k][1]:.3e})" for k, (_, r) in diffs.items()})
    # where float32 itself drifts further from float64 than K2_ROWS_RTOL, the
    # rows are held to four times that drift
    assert float(rel.max()) <= max(K2_ROWS_RTOL, 4.0 * yard["rows"]), yard["rows"]
    for k, (_, r) in diffs.items():
        assert r <= K2_PART_RTOL[k.split("_")[-1]], (k, diffs, yard)


@pytest.mark.parametrize("case", list(K2_PATHS))
def test_gan_train_kernel_matches_plain(case, dev, train_ds, trained_f):
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, **K2_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    if spec.wgan:
        streams = _k2_streams(train_ds, cfg, settings, idx[:1], seeds[:15], torch.ones(1),
                              K2_WGAN_WINDOW)
    else:
        streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.tensor([1.0, 0.5]))
    assert (streams.inoise is not None) == (settings.instance_noise > 0)
    assert (streams.stab is not None) == (settings.stability_w > 0)
    kern = state.clone()
    before = gt.LAUNCHES["gan_train"]
    rows = gt.gan_train(gt.state_buffers(kern), streams, spec)
    torch.cuda.synchronize()
    assert gt.LAUNCHES["gan_train"] == before + 1
    want, plain, yard = _k2_yardstick(state, streams, spec)
    assert gt.LAUNCHES["gan_train"] == before + 1
    assert rows.shape == (streams.spectra.shape[0], gt.ROW_WIDTH)
    assert bool(torch.isfinite(rows).all())
    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    exact = [keys.index(k) for k in ("d_accuracy", "violation_rate")]
    assert torch.equal(rows[0, exact], want[0, exact])
    _assert_k2_close(rows, kern, want, plain, state, yard, spec, keys)
    if settings.constraint_w:
        assert float(rows[:, -1].min()) > 0.0


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("case", list(K2_PATHS))
def test_gan_train_kernel_first_step_matches_plain(case, steps, dev, train_ds, trained_f):
    """The first step and the first three (bias corrections at counts above
    1; in the knob mix the second step's D update is gated off) from one
    state, with the plain version in float64 as the yardstick: the kernel's
    rows, and tensor by tensor outside the gauge leaves Adam's two moments,
    the parameter update, the EMA's update and the BatchNorm stats', are as
    close to it as the float32 plain version is, within K2_ROUNDING."""
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1,
                                                       **K2_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.tensor([0.5]), steps)
    start = gt.state_buffers(state)
    kern, plain = gt.state_buffers(state.clone()), gt.state_buffers(state.clone())
    exact = gt.to_double(gt.state_buffers(state.clone()))
    rows = gt.gan_train(kern, streams, spec)
    rows_p = gt.gan_train_plain(plain, streams, spec)
    rows64 = gt.gan_train_plain(exact, gt.to_double(streams), spec)
    counts = [gt.METRIC_KEYS.index(k) for k in ("d_accuracy", "violation_rate")]
    assert torch.equal(rows[:, counts].double(), rows64[:, counts])
    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    off_k = float(_row_errors(rows, rows64, keys, spec.wgan).max())
    off_p = float(_row_errors(rows_p, rows64, keys, spec.wgan).max())
    print(f"K2 first {steps} step(s) {case} rows: kernel {off_k:.3e}, plain fp32 {off_p:.3e}")
    assert off_k <= 1e-4
    e_k = gt.step_errors(kern, exact, start, spec)
    e_p = gt.step_errors(plain, exact, start, spec)
    # (under WGAN-GP the critic's head bias has gradient 0: no d_v[5])
    assert {"g_m[0]", "g_v[9]", "g_p[4]", "d_p[0]", "bn[3]"} <= set(e_k)
    assert ("d_v[5]" in e_k) != (settings.gan_loss == "wgan_gp")
    assert ("g_ema[0]" in e_k) == (settings.ema_decay > 0)
    for key, e in e_k.items():
        print(f"K2 first {steps} step(s) {key}: kernel {e:.3e}, plain fp32 {e_p[key]:.3e}")
        assert e <= max(K2_ROUNDING * e_p[key], _k2_floor(case, settings, steps, key)), (
            key, e, e_p[key])


# path -> the fault of the plain version that the first-step check must see
K2_FAULTS = {
    "cycle_through_f": ["cycle_seed_dropped", "second_pass_moves_running_stats"],
    "cycle_detached": ["drecon_c_when_detached"],
    "stability": ["stability_seed_dropped", "second_pass_moves_running_stats"],
    "instance_noise": ["noised_fake_rows"],
    "wgan_gp_through_f": ["wgan_gp_w1_second_term_dropped", "wgan_gp_seed_sign"],
}


@pytest.mark.parametrize("case,fault", [(c, f) for c, fs in K2_FAULTS.items() for f in fs])
def test_first_step_check_sees_a_faulty_plain_version(case, fault, dev, train_ds, trained_f):
    """The kernel against a float64 plain version that is wrong on purpose:
    some tensor must be outside what the first-step check allows, with the
    float32 plain version's distance from the right float64 run as the
    yardstick, as in the check."""
    knobs = dict(K2_PATHS[case])
    if "instance_noise" in knobs:
        # of the size of the spectra's own features, and detached: the
        # adversarial term then is most of G's gradient
        knobs.update(instance_noise=1.0, detach_forward=True)
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1, **knobs)
    spec = gt.gan_train_spec(cfg, settings)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.ones(1), 1)
    start = gt.state_buffers(state)
    kern = gt.state_buffers(state.clone())
    gt.gan_train(kern, streams, spec)
    plain = gt.state_buffers(state.clone())
    right = gt.to_double(gt.state_buffers(state.clone()))
    wrong = gt.to_double(gt.state_buffers(state.clone()))
    gt.gan_train_plain(plain, streams, spec)
    gt.gan_train_plain(right, gt.to_double(streams), spec)
    gt.gan_train_plain(wrong, gt.to_double(streams), spec, faults=[fault])
    e_p = gt.step_errors(plain, right, start, spec)
    e_off = gt.step_errors(kern, wrong, start, spec)
    beyond = {k: e for k, e in e_off.items()
              if e > max(K2_ROUNDING * e_p[k], _k2_floor(case, settings, 1, k))}
    print(f"K2 {case} against the plain version with {fault}: {len(beyond)} tensors "
          f"beyond their limit, worst {max(e_off.values()):.3e}")
    assert beyond


def test_augmented_stream_is_the_recon_target(dev, train_ds, trained_f):
    """Augmentation's fault lives in the streams: the kernel on the augmented
    spectra against the plain version on the clean ones must disagree."""
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1,
                                                       **K2_PATHS["augmentation"])
    spec = gt.gan_train_spec(cfg, settings)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.ones(1), 1)
    clean = streams._replace(spectra=train_ds.spectra[idx[0, :1].to(dev)].contiguous())
    assert not torch.equal(clean.spectra, streams.spectra)
    assert float(streams.spectra.max()) <= 0.0
    rows = gt.gan_train(gt.state_buffers(state.clone()), streams, spec)
    want = gt.gan_train_plain(gt.state_buffers(state.clone()), clean, spec)
    j = gt.METRIC_KEYS.index("recon_spec_loss")
    assert abs(float(rows[0, j]) - float(want[0, j])) > 1e-2 * float(want[0, j])


def _k2_schedule(cfg, which):
    from pigan_thz_torch.train.schedules import cosine_schedule, step_schedule

    if which == "g":
        return cosine_schedule(cfg.train.lr_g, cfg.train.num_epochs, 15, 0.01)
    return step_schedule(cfg.train.lr_d, cfg.train.num_epochs, 15, 0.5, 0.25)


@pytest.mark.parametrize("case", ["knob_mix", "all_four"])
def test_gan_train_kernel_rerun_is_bit_identical(case, dev, train_ds, trained_f):
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1,
                                                       **K2_PATHS[case])
    multi = gt.make_gan_epoch_fn(cfg, settings)
    runs = []
    for _ in range(2):
        s, rows = multi(state.clone(), train_ds, torch.ones(1), indices=idx[:1], seeds=seeds)
        runs.append((torch.stack(list(rows.values())), s))
    torch.cuda.synchronize()
    (ra, a), (rb, b) = runs
    assert torch.equal(ra, rb)
    for x, y in ((a.g_params, b.g_params), (a.d_params, b.d_params), (a.g_opt.m, b.g_opt.m),
                 (a.g_opt.v, b.g_opt.v), (a.d_opt.m, b.d_opt.m), (a.d_opt.v, b.d_opt.v),
                 (a.g_ema, b.g_ema)):
        assert torch.equal(x, y)
    for m, n in zip(a.batch_norms(), b.batch_norms()):
        assert torch.equal(m.running_mean, n.running_mean)
        assert torch.equal(m.running_var, n.running_var)


@pytest.mark.parametrize("case", ["through_f", "detached", "all_four"])
def test_gan_train_kernel_matches_eager_step(case, dev, train_ds, trained_f):
    cfg, settings, state, gtx, dtx, idx, seeds = _k2_setup(train_ds, trained_f,
                                                           **K2_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    kern, eager = state.clone(), state.clone()
    kern, rows = gt.make_gan_epoch_fn(cfg, settings)(kern, train_ds, torch.ones(2),
                                                     indices=idx, seeds=seeds)
    step = make_pigan_step(gtx, dtx, settings, train_ds.param_lo, train_ds.param_hi)
    eager, want = make_multi_epoch_fn(step, 64)(eager, train_ds, torch.ones(2), indices=idx,
                                                seeds=seeds)
    torch.cuda.synchronize()
    assert (kern.step, kern.g_opt.count, kern.d_opt.count) == (
        eager.step, eager.g_opt.count, eager.d_opt.count) == (
        30, 30, 30 // settings.d_update_every)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.ones(2))
    _, _, yard = _k2_yardstick(state, streams, spec)
    keys = list(gt.METRIC_KEYS)
    _assert_k2_close(torch.stack([rows[k] for k in keys], dim=-1), kern,
                     torch.stack([want[k] for k in keys], dim=-1), eager, state, yard, spec,
                     keys)


def _bf16_rows_rel(rows, want):
    """Per row key of a first step: |kernel - plain| / |plain| over that
    key's bfloat16 tolerance (a rounding flipped where two float32 upstreams
    differ by an ulp moves F's LC and metrics terms most)."""
    out = {}
    for j, k in enumerate(gt.METRIC_KEYS):
        if k in ("d_accuracy", "violation_rate"):
            continue
        err = abs(float(rows[0, j]) - float(want[0, j])) / max(abs(float(want[0, j])), 1e-6)
        out[k] = err / K2_BF16_STEP_RTOL.get(k, K2_BF16_STEP_FLOOR)
    return out


@pytest.mark.parametrize("case", list(K2_BF16_PATHS))
def test_gan_train_kernel_bf16_matches_plain(case, dev, train_ds, trained_f):
    """bfloat16 operands: the first step's rows against the float32 plain
    version with the same rounding, its state tensor by tensor against the
    float64-accumulating one (within K2_ROUNDING of the float32 plain
    version's distance or K2_BF16_TENSOR_FLOOR), each bfloat16 fault beyond
    (in the rows, or in the state for the fault of the backward); 30 steps
    (under WGAN-GP the first K2_WGAN_WINDOW) by part, relative to what they
    changed; one launch; a rerun bit-identical."""
    cfg, settings, state, _, _, idx, seeds = _k2_setup(
        train_ds, trained_f, compute_dtype="bfloat16", **K2_BF16_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    assert spec.bf16
    one = _k2_streams(train_ds, cfg, settings, idx[:1], seeds[:15], torch.ones(1), 1)
    start1 = gt.state_buffers(state)
    kern1 = gt.state_buffers(state.clone())
    rows1 = gt.gan_train(kern1, one, spec)
    plain1 = gt.state_buffers(state.clone())
    want1 = gt.gan_train_plain(plain1, one, spec)
    right = _bf16_rows_rel(rows1, want1)
    print(f"K2 {case} first step, rows over their bf16 limits: {right}")
    assert max(right.values()) <= 1.0, right
    exact1 = gt.to_double(gt.state_buffers(state.clone()))
    gt.gan_train_plain(exact1, gt.to_double(one), spec)
    e_k = gt.step_errors(kern1, exact1, start1, spec)
    e_p = gt.step_errors(plain1, exact1, start1, spec)
    floor = K2_BF16_TENSOR_FLOOR

    def beyond(e):
        return {k: (x, e_p[k]) for k, x in e.items() if not x <= max(K2_ROUNDING * e_p[k], floor)}

    print(f"K2 {case} first step by tensor: {({k: f'{x:.2e}' for k, x in e_k.items()})}")
    assert not beyond(e_k), beyond(e_k)
    if not spec.wgan:   # (under WGAN-GP D's seeds do not read G's head)
        for fault in ("bf16_head_rounded", "bf16_hidden_fp32", "bf16_backward_fp32"):
            off = gt.gan_train_plain(gt.state_buffers(state.clone()), one, spec, faults=[fault])
            wrong = gt.to_double(gt.state_buffers(state.clone()))
            gt.gan_train_plain(wrong, gt.to_double(one), spec, faults=[fault])
            seen = beyond(gt.step_errors(kern1, wrong, start1, spec))
            assert max(_bf16_rows_rel(rows1, off).values()) > 2.0 or seen, fault
    if spec.wgan:
        streams = _k2_streams(train_ds, cfg, settings, idx[:1], seeds[:15], torch.ones(1),
                              K2_WGAN_WINDOW)
    else:
        streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.tensor([1.0, 0.5]))
    kern, again = state.clone(), state.clone()
    before = gt.LAUNCHES["gan_train"]
    rows = gt.gan_train(gt.state_buffers(kern), streams, spec)
    rows2 = gt.gan_train(gt.state_buffers(again), streams, spec)
    torch.cuda.synchronize()
    assert gt.LAUNCHES["gan_train"] == before + 2
    assert torch.equal(rows, rows2) and torch.equal(kern.g_params, again.g_params)
    want, plain, yard = _k2_yardstick(state, streams, spec)
    diffs = gt.state_diffs(gt.state_buffers(kern), gt.state_buffers(plain),
                           gt.state_buffers(state), spec)
    print(f"K2 {case} {rows.shape[0]} steps:",
          {k: f"{r:.3e} (fp32 plain vs fp64: {yard[k][1]:.3e})" for k, (_, r) in diffs.items()})
    for k, (_, r) in diffs.items():
        assert r <= K2_BF16_PART_RTOL[k.split("_")[-1]], (k, diffs)


@pytest.mark.parametrize("knobs", [dict(gan_loss="wgan_gp")])
def test_gan_train_kernel_refuses_what_it_lacks(knobs, dev):
    """The kernel takes WGAN-GP and bfloat16 operands; bfloat16 Adam moments
    are refused, as by the JAX package's kernels."""
    cfg = default_config()
    assert gt.make_gan_epoch_fn(cfg, StepSettings.from_config(cfg, **knobs)) is not None
    moments = cfg.replace(train=dataclasses.replace(cfg.train, adam_state_dtype="bfloat16"))
    with pytest.raises(ValueError, match="adam_state_dtype"):
        gt.make_gan_epoch_fn(moments, StepSettings.from_config(moments, **knobs))


@pytest.mark.parametrize("knobs", [dict(gan_loss="wgan_gp")], ids=["wgan_gp"])
def test_trainer_on_the_card_runs_the_eager_step_only_when_asked(knobs, dev, train_ds):
    """bfloat16 Adam moments are the eager step's: "auto" raises and names
    the eager engine, which then trains (WGAN-GP on top)."""
    cfg = default_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, adam_state_dtype="bfloat16"))
    settings = StepSettings.from_config(cfg, **knobs)
    trainer = Trainer(cfg, ds=train_ds, epochs_per_call=1, device=dev)
    with pytest.raises(ValueError, match="adam_state_dtype") as err:
        trainer.train_pigan(epochs=1, settings=settings)
    assert "engine='eager'" in str(err.value)
    asked = Trainer(cfg, ds=train_ds, epochs_per_call=1, device=dev, engine="eager")
    before = dict(gt.LAUNCHES)
    hist = asked.train_pigan(epochs=1, settings=settings)
    assert gt.LAUNCHES == before
    assert len(hist["pigan/g_loss"]) == 1 and hist["pigan/g_loss"][0] == hist["pigan/g_loss"][0]


def test_trainer_launches_the_gan_kernel_once_per_chunk(dev, train_ds):
    trainer = Trainer(default_config(), ds=train_ds, epochs_per_call=2, device=dev)
    trainer.pretrain_forward(epochs=2)
    trainer.init_pigan()
    before = gt.LAUNCHES["gan_train"]
    hist = trainer.train_pigan(epochs=5)
    assert gt.LAUNCHES["gan_train"] == before + 3
    loss = hist["pigan/g_loss"]
    assert len(loss) == 5 and all(x == x for x in loss)


# -- K3: the member-packed GAN kernel --------------------------------------------
K3_MIX = {**K2_MIX, "ema_decay": 0.0}


def _k3_setup(ds, f, members, epochs=1, **knobs):
    """M members from seeds 0..M-1 (``_k2_setup``), stacked, with each
    member's own shuffles stacked to (M, E, spe, B) streams."""
    from pigan_thz_torch.parallel.state_utils import tree_stack

    setups = [_k2_setup(ds, f, epochs=epochs, seed=m, **knobs) for m in range(members)]
    cfg, settings = setups[0][:2]
    ens = tree_stack([s[2] for s in setups])
    idx = torch.stack([s[5] for s in setups])
    seeds = torch.stack([s[6] for s in setups])
    streams = gt.build_streams(ds, idx, torch.linspace(1.0, 0.5, epochs), 0, 0, 0,
                               settings.d_update_every, _k2_schedule(cfg, "g"),
                               _k2_schedule(cfg, "d"), settings=settings, seeds=seeds)
    return cfg, settings, ens, streams


def _ensemble_tensors(bufs):
    return [*bufs[:6], *bufs.bn]


K3_PATHS = {"through_f": dict(detach_forward=False), "detached": dict(detach_forward=True),
            "knob_mix": K3_MIX,
            "second_passes_and_noise": dict(detach_forward=False, cycle_w=1.0, stability_w=1.0,
                                            instance_noise=0.05),
            "all_four": {**K2_PATHS["all_four"], "ema_decay": 0.0},
            "cycle_detached": dict(detach_forward=True, cycle_w=1.0),
            "wgan_gp": dict(detach_forward=False, gan_loss="wgan_gp", d_update_every=2),
            "bf16": dict(detach_forward=False, compute_dtype="bfloat16"),
            "wgan_gp_bf16_cycle_stability": dict(
                detach_forward=False, gan_loss="wgan_gp", compute_dtype="bfloat16", cycle_w=1.0,
                stability_w=1.0)}


@pytest.mark.parametrize("knobs", list(K3_PATHS.values()), ids=list(K3_PATHS))
def test_ensemble_kernel_is_bit_identical_to_the_solo_kernel(knobs, dev, train_ds, trained_f):
    """M = 2, one epoch: member m's rows and whole state after one packed
    launch equal K2's on that member alone from the same state and streams."""
    cfg, settings, ens, streams = _k3_setup(train_ds, trained_f, 2, **knobs)
    spec = gt.gan_train_spec(cfg, settings)
    solo = [st.clone() for st in ens]
    before = dict(gt.LAUNCHES)
    rows = gt.gan_ensemble_train(gt.ensemble_buffers(ens), streams, spec)
    torch.cuda.synchronize()
    assert gt.LAUNCHES["gan_ensemble_train"] == before["gan_ensemble_train"] + 1
    assert gt.LAUNCHES["gan_train"] == before["gan_train"]
    assert rows.shape == (2, 15, gt.ROW_WIDTH) and bool(torch.isfinite(rows).all())
    assert not torch.equal(rows[0], rows[1])
    for m, st in enumerate(solo):
        bufs, own = gt._member(gt.ensemble_buffers(ens), streams, m)
        want = gt.gan_train(gt.state_buffers(st), own, spec)
        torch.cuda.synchronize()
        assert torch.equal(rows[m], want), m
        for a, b in zip(_ensemble_tensors(bufs), _ensemble_tensors(gt.state_buffers(st))):
            assert torch.equal(a, b), m


@pytest.mark.parametrize("case", ["through_f", "second_passes_and_noise"])
def test_ensemble_kernel_matches_plain_and_reruns_bit_identically(case, dev, train_ds,
                                                                  trained_f):
    cfg, settings, ens, streams = _k3_setup(train_ds, trained_f, 3, epochs=2,
                                            **K3_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    start, plain, again = ens.clone(), ens.clone(), ens.clone()
    rows = gt.gan_ensemble_train(gt.ensemble_buffers(ens), streams, spec)
    rows2 = gt.gan_ensemble_train(gt.ensemble_buffers(again), streams, spec)
    before = dict(gt.LAUNCHES)
    want = gt.gan_ensemble_train_plain(gt.ensemble_buffers(plain), streams, spec)
    torch.cuda.synchronize()
    assert gt.LAUNCHES == before          # the plain version launches nothing
    assert torch.equal(rows, rows2)
    for a, b in zip(_ensemble_tensors(gt.ensemble_buffers(ens)),
                    _ensemble_tensors(gt.ensemble_buffers(again))):
        assert torch.equal(a, b)
    keys = [*gt.METRIC_KEYS, "constraint_loss"]
    for m in range(3):
        one = gt._member(gt.ensemble_buffers(start), streams, m)[1]
        _, _, yard = _k2_yardstick(start[m], one, spec)
        _assert_k2_close(rows[m], ens[m], want[m], plain[m], start[m], yard, spec, keys)


def test_ensemble_fn_on_the_card(dev, train_ds, trained_f):
    """``make_gan_ensemble_fn`` and ``train_seed_ensemble``: one launch per
    chunk whatever M is, packed equal to unpacked, counts advanced."""
    from pigan_thz_torch.parallel.ensemble_megakernel import train_seed_ensemble

    cfg = default_config()
    settings = StepSettings.from_config(cfg, detach_forward=False)
    before = dict(gt.LAUNCHES)
    packed, pm = train_seed_ensemble(cfg, train_ds, 3, settings=settings, epochs=3,
                                     epochs_per_call=2, forward_model=trained_f, packed=True)
    assert gt.LAUNCHES["gan_ensemble_train"] == before["gan_ensemble_train"] + 2
    assert gt.LAUNCHES["gan_train"] == before["gan_train"]
    solo, sm = train_seed_ensemble(cfg, train_ds, 3, settings=settings, epochs=3,
                                   epochs_per_call=2, forward_model=trained_f)
    assert gt.LAUNCHES["gan_train"] == before["gan_train"] + 6
    assert pm["g_loss"].shape == (3, 3)
    assert all((pm[k] == sm[k]).all() for k in pm)
    for a, b in zip(_ensemble_tensors(gt.ensemble_buffers(packed)),
                    _ensemble_tensors(gt.ensemble_buffers(solo))):
        assert torch.equal(a, b)
    assert [(st.step, st.g_opt.count, st.d_opt.count) for st in packed] == [(45, 45, 45)] * 3
    with pytest.raises(ValueError, match="ema_decay"):
        gt.make_gan_ensemble_fn(cfg, StepSettings.from_config(cfg, ema_decay=0.9), 2)


@pytest.mark.parametrize("case, per_step", [
    ("through_f", 69), ("detached", 58), ("cycle_detached", 58 + 17),
    ("stability", 69 + 17), ("instance_noise", 70),
    ("second_passes_mix", 69 + 19 + 16), ("wgan_gp_through_f", 69 + 14)])
def test_gan_kernel_enqueues_the_launches_a_step_it_says(case, per_step, dev, train_ds,
                                                         trained_f):
    """The C loop's own count of what it enqueued: today's settings stay 69
    launches a step (58 detached); a second pass adds 16 and the sum of the
    gradients 1, cycle through F 2 more, instance noise 1; K3 the same."""
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1,
                                                       **K2_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.ones(1))
    rows = gt.gan_train(gt.state_buffers(state), streams, spec)
    assert report_of(rows).kernels == per_step * 15
    _, _, ens, estreams = _k3_setup(train_ds, trained_f, 3, **{
        **K2_PATHS[case], "ema_decay": 0.0})
    rows = gt.gan_ensemble_train(gt.ensemble_buffers(ens), estreams, spec)
    assert report_of(rows).kernels == per_step * 15


def test_the_c_loops_time_their_enqueue_head(dev, train_ds, trained_f):
    """Each C loop's enqueue head (``train_common.cuh:EnqueueHead``): the
    launches up to the first step boundary at or past 512, or every launch
    of a shorter call, and a host time for them within the call's own."""
    cfg, state, _, _, _, streams = _k1_setup(train_ds, 0.2, epochs=1)
    spec = ft.forward_train_spec(cfg, ForwardStepSettings())
    t0 = time.perf_counter_ns()
    rows = ft.forward_train(state.params, state.opt.m, state.opt.v, streams, spec)
    took = time.perf_counter_ns() - t0
    report = report_of(rows)
    # 504 at step 14: the whole call
    assert report.head_kernels == 36 * 15 and 0 < report.head_ns < took
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1,
                                                       **K2_PATHS["through_f"])
    spec = gt.gan_train_spec(cfg, settings)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.ones(1))
    t0 = time.perf_counter_ns()
    rows = gt.gan_train(gt.state_buffers(state), streams, spec)
    took = time.perf_counter_ns() - t0
    report = report_of(rows)
    # 483 after 7 steps, 552 after 8
    assert report.head_kernels == 69 * 8 and 0 < report.head_ns < took
    _, _, ens, estreams = _k3_setup(train_ds, trained_f, 3, **{
        **K2_PATHS["through_f"], "ema_decay": 0.0})
    rows = gt.gan_ensemble_train(gt.ensemble_buffers(ens), estreams, spec)
    assert report_of(rows).head_kernels == 69 * 8


def test_gan_train_leaves_its_intermediates_in_a_given_scratch(dev, train_ds, trained_f):
    cfg, settings, state, _, _, idx, _ = _k2_setup(train_ds, trained_f, epochs=1,
                                                   detach_forward=False)
    spec = gt.gan_train_spec(cfg, settings)
    streams = gt.build_streams(train_ds, idx[:, :1], torch.ones(1), 0, 0, 0, 1,
                               _k2_schedule(cfg, "g"), _k2_schedule(cfg, "d"))
    with pytest.raises(ValueError, match="work"):
        gt.gan_train(gt.state_buffers(state.clone()), streams, spec,
                     work=torch.empty(16, device=dev))
    work = torch.zeros(gt.workspace_floats(spec, 64), device=dev)
    own, given = state.clone(), state.clone()
    rows = gt.gan_train(gt.state_buffers(own), streams, spec)
    rows2 = gt.gan_train(gt.state_buffers(given), streams, spec, work=work)
    torch.cuda.synchronize()
    assert torch.equal(rows, rows2) and torch.equal(own.g_params, given.g_params)
    views = gt.workspace_views(work, spec, 64)
    state.g.train()
    with torch.no_grad():
        want = state.g(streams.spectra[0])
    # G's output through train-mode BatchNorm, fp32 on both sides (measured 1.4e-5)
    torch.testing.assert_close(views["tn"].view(64, 4), want, rtol=0, atol=1e-4)
    assert float(views["grad_g"].abs().max()) > 0 and float(views["dfin"].abs().max()) > 0


# -- K2 / K3: the batch-row products (csrc/brow_gemm.cuh) -------------------------
def _brow_cases():
    """Every batch-row product shape and flag of a K2 step over its paths
    (through F, detached, a second pass, WGAN-GP, bfloat16): (m, n, k, bnc,
    rnd, bias), each once."""
    out = set()
    for dtype in ("float32", "bfloat16"):
        cfg = default_config()
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))
        for knobs in (dict(detach_forward=False, cycle_w=1.0, stability_w=1.0,
                           gan_loss="wgan_gp"), dict(detach_forward=True, cycle_w=1.0)):
            spec = gt.gan_train_spec(cfg, StepSettings.from_config(cfg, **knobs))
            for p in gt.brow_products(spec, 64):
                out.add((p.m, p.n, p.k, p.bnc, p.rnd, p.bias))
    return sorted(out)


BROW_CASES = _brow_cases()


def _brow_operands(m, n, k, bnc, dev, members=None, seed=0, pad=0):
    """A (m, k) rows ``k + pad`` floats apart (the step's strided inputs);
    B (k, n) as the step gives it: W.t() of a (n, k) weight (BNC false) or a
    (k, n) weight (BNC true); bias (n,); with ``members`` a leading axis on
    each."""
    gen = torch.Generator().manual_seed(seed)
    lead = () if members is None else (members,)
    a = torch.randn((*lead, m, k + pad), generator=gen)[..., :k]
    w = torch.randn((*lead, k, n) if bnc else (*lead, n, k), generator=gen)
    b = w if bnc else w.transpose(-1, -2)
    bias = torch.randn((*lead, n), generator=gen)
    return a.to(dev), b.to(dev), bias.to(dev)


def _brow_bound(a, b, bias, k, split, rnd):
    """The float32 worst-case sum bound of tests/test_torch_gan_products.py,
    doubled: the tensor cores' fp32 accumulation may truncate instead of
    round, which doubles the unit roundoff."""
    if rnd:
        a, b = a.bfloat16().float(), b.bfloat16().float()
    mag = a.double().abs() @ b.double().abs()
    if bias is not None:
        mag = mag + bias.double().abs().unsqueeze(-2)
    return 2 * (k + split + 2) * 2.0 ** -24 * mag


@pytest.mark.parametrize("members", [1, 4])
@pytest.mark.parametrize("case", BROW_CASES,
                         ids=[f"{m}x{n}x{k}-{'nn' if c else 'nt'}{'-bf16' if r else ''}"
                              f"{'-bias' if b else ''}" for m, n, k, c, r, b in BROW_CASES])
def test_brow_kernel_matches_plain(case, members, dev):
    """The kernel against ``brow_gemm_plain`` (the same slices, rank order)
    and float64, both within twice the float32 worst-case sum bound; a rerun
    bit-identical; at M = 4 member m bit for bit the launch on m alone."""
    m, n, k, bnc, rnd, with_bias = case
    a, b, bias = _brow_operands(m, n, k, bnc, dev, members if members > 1 else None,
                                pad=8 * (k % 2))
    bias = bias if with_bias else None
    plan = brow.brow_plan(m, n, k)
    assert brow.brow_plan_on_card(m, n, k) == plan
    before = LAUNCHES["brow_gemm"]
    got = brow.brow_gemm(a, b, bias, rnd=rnd)
    again = brow.brow_gemm(a, b, bias, rnd=rnd)
    torch.cuda.synchronize()
    assert LAUNCHES["brow_gemm"] == before + 2
    assert torch.equal(got, again)
    want = brow.brow_gemm_plain(a, b, bias, rnd=rnd, split=plan.split)
    exact = brow.brow_gemm_plain(a.double(), b.double(), None if bias is None else bias.double(),
                               rnd=rnd)
    bound = _brow_bound(a, b, bias, k, plan.split, rnd)
    err_p = float(((got.double() - want.double()).abs() / bound).max())
    err_x = float(((got.double() - exact).abs() / bound).max())
    print(f"brow {case} M={members} split {plan.split}: |kernel - plain| "
          f"{float((got - want).abs().max()):.3e} ({err_p:.3e} of the bound), vs float64 "
          f"{err_x:.3e} of the bound")
    assert err_x <= 1.0 and err_p <= 1.5
    if members > 1:
        for mm in range(members):
            solo = brow.brow_gemm(a[mm], b[mm], None if bias is None else bias[mm], rnd=rnd)
            assert torch.equal(got[mm], solo), mm


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("case", [(64, 512, 250, False), (128, 512, 256, True),
                                  (64, 256, 258, True), (64, 1024, 512, False)],
                         ids=["64x512x250-nt", "128x512x256-nn", "64x256x258-nn",
                              "64x1024x512-nt"])
def test_brow_kernel_every_split(case, split, dev):
    """Any cluster size the card takes gives the product within the bound,
    equal to its plain version's slices; the old SGEMM route too."""
    m, n, k, bnc = case
    a, b, bias = _brow_operands(m, n, k, bnc, dev, seed=split)
    for rnd in (False, True):
        got = brow.brow_gemm(a, b, bias, rnd=rnd, split=split)
        old = brow.brow_gemm(a, b, bias, rnd=rnd, route="sgemm")
        torch.cuda.synchronize()
        exact = brow.brow_gemm_plain(a.double(), b.double(), bias.double(), rnd=rnd)
        want = brow.brow_gemm_plain(a, b, bias, rnd=rnd, split=split)
        bound = _brow_bound(a, b, bias, k, split, rnd)
        assert float(((got.double() - exact).abs() / bound).max()) <= 1.0, rnd
        assert float(((got.double() - want.double()).abs() / bound).max()) <= 1.5, rnd
        assert float(((old.double() - exact).abs() / bound).max()) <= 1.0, rnd


@pytest.mark.parametrize("layout", ["tn", "tt"])
def test_brow_kernel_takes_every_flag(layout, dev):
    """The flags the step does not use today: A contiguous along m (AK
    false), C += (ACC), members sharing B (stride 0)."""
    m, n, k = 64, 256, 512
    bnc = layout[1] == "n"
    a, b, bias = _brow_operands(m, n, k, bnc, dev, members=3, seed=5)
    a = a.transpose(-1, -2).contiguous().transpose(-1, -2)   # (m, k) view, m-contiguous
    assert a.stride(-2) == 1
    c = torch.randn(3, m, n, device=dev)
    for rnd in (False, True):
        out = c.clone()
        brow.brow_gemm(a, b[0], bias, out=out, acc=True, rnd=rnd)
        plan = brow.brow_plan(m, n, k)
        want = brow.brow_gemm_plain(a, b[0], bias, c, rnd, plan.split)
        bound = _brow_bound(a, b[0], bias, k, plan.split, rnd) + 2 * 2.0 ** -24 * c.abs()
        assert float(((out - want).abs() / bound).max()) <= 1.5, rnd
    with pytest.raises(RuntimeError, match="brow_gemm: CUDA error"):
        brow.brow_gemm(a[0], b[0], split=16)


@pytest.mark.parametrize("case", ["through_f", "detached", "knob_mix", "second_passes_mix",
                                  "wgan_gp_mix", "all_four"])
def test_gan_step_launches_the_batch_row_kernel_as_listed(case, dev, train_ds, trained_f):
    """One epoch of K2, and of K3 at M = 3: the C loop's count of batch-row
    launches is ``brow_products`` summed over the steps (D's update gated
    per the schedule), and the step's launches stay as they were."""
    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1,
                                                       **K2_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.ones(1))
    gates = (streams.sched[:, gt.SCHED_LANES.index("d_gate")] > 0).tolist()
    want = sum(len(gt.brow_products(spec, 64, bool(u))) for u in gates)
    before = LAUNCHES["brow_gemm"]
    report = report_of(gt.gan_train(gt.state_buffers(state), streams, spec))
    assert report.brow == want
    assert LAUNCHES["brow_gemm"] == before + want
    print(f"K2 {case}: {want} batch-row launches in {len(gates)} steps, "
          f"{report.kernels} launches in all")
    ecfg, esettings, ens, estreams = _k3_setup(train_ds, trained_f, 3, **{
        **K2_PATHS[case], "ema_decay": 0.0})
    rows = gt.gan_ensemble_train(gt.ensemble_buffers(ens), estreams,
                                 gt.gan_train_spec(ecfg, esettings))
    assert report_of(rows).brow == want


# -- K1 / K2 / K3: the other products (csrc/train_common.cuh's dispatch) ----------
def _gemm_cases():
    """Every product shape and flag that a K2 step (its paths, fp32 and
    bfloat16 operands, D updated) and a K1 step (both operand types) launch
    through the dispatch: GemmProducts, each once."""
    from pigan_thz_torch.ops import products as pr

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = default_config()
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))
        for knobs in (dict(detach_forward=False, cycle_w=1.0, stability_w=1.0,
                           gan_loss="wgan_gp"), dict(detach_forward=True, cycle_w=1.0)):
            spec = gt.gan_train_spec(cfg, StepSettings.from_config(cfg, **knobs))
            for p in gt.gemm_products(spec, 64):
                out.setdefault(p[1:], p)
        for p in ft.gemm_products(ft.forward_train_spec(cfg, ForwardStepSettings()), 64):
            out.setdefault(p[1:], p._replace(name=f"K1 {p.name}"))
    return [pr.GemmProduct(*p) for _, p in sorted(out.items())]


GEMM_CASES = _gemm_cases()


def _gemm_bound(p, a, b, bias, c):
    """The float32 worst-case bound of the kernel's sums (Higham, eq. 3.5):
    (terms in the longest chain + 1) u sum |a| |b| (+ |C| + |bias|); the deep
    narrow kernel's chain is a lane's ceil(K / 32) terms, five butterfly
    adds, C and the bias; the others' K terms, C and the bias."""
    if p.rnd:
        a, b = a.bfloat16().float(), b.bfloat16().float()
    mag = a.double().abs() @ b.double().abs()
    if c is not None:
        mag = mag + c.double().abs()
    if bias is not None:
        mag = mag + (bias.double().abs().unsqueeze(-2) if bias.ndim > 1 else bias.double().abs())
    chain = (-(-p.k // 32) + 5 if p.route == "deep_narrow" else p.k) + 2 + 1
    return chain * 2.0 ** -24 * mag


@pytest.mark.parametrize("members", [1, 4])
@pytest.mark.parametrize("case", GEMM_CASES, ids=[
    f"{p.m}x{p.n}x{p.k}-{p.route}-{'n' if p.ak else 't'}{'n' if p.bnc else 't'}"
    f"{'-bf16' if p.rnd else ''}{'-acc' if p.acc else ''}{'-bias' if p.bias else ''}"
    for p in GEMM_CASES])
def test_product_kernel_matches_its_plain_twin(case, members, dev):
    """Each product a step launches through the dispatch, on the route of its
    shape (the C rule equal to its Python mirror): against its plain twin
    (the same sum order) and float64, within the float32 worst-case bound of
    its sum; a rerun bit-identical; the batch-depth kernel bit for bit the
    tiled SGEMM (the same FMA chain); at M = 4 member m bit for bit the
    launch on m alone."""
    from pigan_thz_torch.ops import products as pr

    p = case
    assert pr.product_route_on_card(p.n, p.k) == p.route
    a, b, bias, c = pr.step_operands(p, members, seed=p.m + p.n + p.k, device=dev)
    shape = (members, p.m, p.n) if members > 1 else (p.m, p.n)

    def run(route=None, a=a, b=b, bias=bias, c=c, shape=shape):
        out = c.clone() if c is not None else torch.empty(shape, device=dev)
        return pr.product_gemm(a, b, bias, out=out, acc=p.acc, rnd=p.rnd, route=route)

    key = pr.LAUNCH_KEYS[p.route]
    before = LAUNCHES[key]
    got, again = run(), run()
    torch.cuda.synchronize()
    assert LAUNCHES[key] == before + 2
    assert torch.equal(got, again)
    want = pr.product_gemm_plain(a, b, bias, c, p.rnd)
    rd = (lambda t: t.bfloat16().double()) if p.rnd else (lambda t: t.double())
    exact = pr.product_gemm_plain(rd(a), rd(b), None if bias is None else bias.double(),
                                  None if c is None else c.double())
    bound = _gemm_bound(p, a, b, bias, c)
    err_p = float(((got.double() - want.double()).abs() / bound).max())
    err_x = float(((got.double() - exact).abs() / bound).max())
    print(f"product {p.name} {p.m}x{p.n}x{p.k} {p.route} M={members}: |kernel - twin| "
          f"{float((got - want).abs().max()):.3e} ({err_p:.3e} of the bound), vs float64 "
          f"{err_x:.3e} of the bound")
    assert err_x <= 1.0 and err_p <= 0.5
    if p.route == "batch_depth":
        assert torch.equal(got, run("sgemm"))
    if members > 1:
        for mm in range(members):
            solo = run(a=a[mm], b=b[mm], bias=None if bias is None else bias[mm],
                       c=None if c is None else c[mm], shape=(p.m, p.n))
            assert torch.equal(got[mm], solo), mm


@pytest.mark.parametrize("route", ["deep_narrow", "batch_depth"])
def test_product_kernels_take_every_layout(route, dev):
    """The layouts and flags no step gives a route today: A contiguous along
    m under deep narrow, A along k and B along k under batch depth, odd
    sizes, C +=, members sharing B (stride 0); and the forced route refused
    outside its limits."""
    from pigan_thz_torch.ops import products as pr

    m, n, k = (37, 5, 300) if route == "deep_narrow" else (45, 70, 100)
    for ak, bnc in ((True, True), (True, False), (False, True), (False, False)):
        p = pr.GemmProduct("layout", m, n, k, ak, bnc, False, True, True)
        a, b, bias, c = pr.step_operands(p, 3, seed=ak + 2 * bnc, device=dev)
        for rnd in (False, True):
            out = c.clone()
            pr.product_gemm(a, b[0], bias, out=out, acc=True, rnd=rnd, route=route)
            want = pr.product_gemm_plain(a, b[0], bias, c, rnd, route)
            bound = _gemm_bound(p._replace(rnd=rnd), a, b[0].expand(3, -1, -1), bias, c)
            assert float(((out.double() - want.double()).abs() / bound).max()) <= 0.5
    with pytest.raises(ValueError, match="product_gemm"):
        pr.product_gemm(torch.ones(4, 2048, device=dev), torch.ones(2048, 4, device=dev),
                        route=route)


def test_route_rule_on_card_equals_its_mirror(dev):
    from pigan_thz_torch.ops import products as pr

    for n in (1, 4, 8, 9, 256):
        for k in (4, 8, 31, 32, 64, 127, 128, 129, 256, 512, 1024, 1025):
            assert pr.product_route_on_card(n, k) == pr.product_route(n, k), (n, k)


@pytest.mark.parametrize("case", ["through_f", "detached", "knob_mix", "second_passes_mix",
                                  "wgan_gp_mix", "all_four"])
def test_gan_step_launches_its_products_by_route_as_listed(case, dev, train_ds, trained_f):
    """One epoch of K2, and of K3 at M = 3: the C loop's launches by route
    are ``routes_of(gemm_products)`` summed over the steps (D's update gated
    per the schedule), in its report; ``launch_loop`` adds them to LAUNCHES
    and the launch span's attributes carry them."""
    from pigan_thz_torch.ops import products as pr

    cfg, settings, state, _, _, idx, seeds = _k2_setup(train_ds, trained_f, epochs=1,
                                                       **K2_PATHS[case])
    spec = gt.gan_train_spec(cfg, settings)
    streams = _k2_streams(train_ds, cfg, settings, idx, seeds, torch.ones(1))
    gates = (streams.sched[:, gt.SCHED_LANES.index("d_gate")] > 0).tolist()
    want = dict.fromkeys(pr.ROUTES, 0)
    for u in gates:
        for r, n in pr.routes_of(gt.gemm_products(spec, 64, bool(u))).items():
            want[r] += n
    before = dict(LAUNCHES)
    report = report_of(gt.gan_train(gt.state_buffers(state), streams, spec))
    assert {r: getattr(report, r) for r in pr.ROUTES} == want
    assert {r: LAUNCHES[pr.LAUNCH_KEYS[r]] - before[pr.LAUNCH_KEYS[r]]
            for r in pr.ROUTES} == want
    attrs = span_attrs(report)
    assert {r: attrs[r] for r in pr.ROUTES} == want
    assert report.kernels == attrs["kernels"]
    print(f"K2 {case}: by route {want} in {len(gates)} steps")
    ecfg, esettings, ens, estreams = _k3_setup(train_ds, trained_f, 3, **{
        **K2_PATHS[case], "ema_decay": 0.0})
    rows = gt.gan_ensemble_train(gt.ensemble_buffers(ens), estreams,
                                 gt.gan_train_spec(ecfg, esettings))
    assert {r: getattr(report_of(rows), r) for r in pr.ROUTES} == want


@pytest.mark.parametrize("dtype, per_step", [("float32", (0, 6, 1)), ("bfloat16", (1, 7, 2))])
def test_forward_kernel_launches_its_products_by_route_as_listed(dtype, per_step, dev,
                                                                 train_ds):
    from pigan_thz_torch.ops import products as pr

    cfg, state, _, _, _, streams = _k1_setup(train_ds, 0.2, epochs=1)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))
    spec = ft.forward_train_spec(cfg, ForwardStepSettings())
    want = {r: 15 * n for r, n in pr.routes_of(ft.gemm_products(spec, 64)).items()}
    assert tuple(want.values()) == tuple(15 * n for n in per_step)
    rows = ft.forward_train(state.params, state.opt.m, state.opt.v, streams, spec)
    torch.cuda.synchronize()
    report = report_of(rows)
    assert {r: getattr(report, r) for r in pr.ROUTES} == want
    attrs = span_attrs(report)
    assert {r: attrs[r] for r in pr.ROUTES} == want


def _nan_equal(a, b) -> bool:
    a, b = a.cpu(), b.cpu()
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)]))


def test_noise_ceilings_on_the_card_equal_the_cpu(dev):
    """The evaluate path's ceilings: the same CPU draws on both devices, two
    launches of K4's metrics entry on the card, the metrics equal to the
    plain versions' (NaN pattern and values), every ceiling within 1e-5."""
    from pigan_thz_torch.evaluate import ceilings as ce

    data = default_config().data
    draws = ce.ceiling_draws(data)
    before = fk.LAUNCHES["dip_qualification"]
    got, got_metrics = ce.ceilings_from_draws(*(t.to(dev) for t in draws), data.noise_level)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["dip_qualification"] == before + 2
    want, want_metrics = ce.ceilings_from_draws(*draws, data.noise_level)
    assert all(_nan_equal(g, w) for g, w in zip(got_metrics, want_metrics))
    assert set(got) == set(want)
    assert all(abs(got[k] - want[k]) <= 1e-5 for k in want), (got, want)
    before = fk.LAUNCHES["dip_qualification"]
    assert ce.noise_ceilings(data, device=dev) == got
    assert fk.LAUNCHES["dip_qualification"] == before + 2


def test_oracle_and_suites_on_the_card_equal_the_cpu(dev, models):
    """The clean oracle and the four suites on the card against the same
    modules and dataset tensors on the CPU."""
    from pigan_thz_torch.evaluate import Evaluator, oracle_validation

    cfg = default_config()
    ds = synthetic_dataset(cfg.data, device=dev)
    g, f = models
    d = build_trio(cfg, device="cpu", generator=torch.Generator().manual_seed(2))[1]
    cpu_ds = ds._replace(**{k: v.cpu() for k, v in ds._asdict().items()})
    on_card = Evaluator(*(copy.deepcopy(m).to(dev) for m in (g, d, f)))
    on_cpu = Evaluator(g, d, f)
    got = {**on_card.run_comprehensive_evaluation(ds), **oracle_validation(on_card, ds)}
    want = {**on_cpu.run_comprehensive_evaluation(cpu_ds), **oracle_validation(on_cpu, cpu_ds)}

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (k, got[k], want[k])


# -- preemption-safe training: checkpoints, resume, the shadow replay -------------


def _state_equal(a: dict, b: dict) -> list:
    """Keys of two state_dicts that differ, tensors compared on the CPU."""
    bad = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = a[k], b[k]
        if not (torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor) else x == y):
            bad.append(k)
    return bad


def _resume_stages(dev, ds, tmp=None, epochs=2):
    """Forward 2 x ``epochs``, then PI-GAN 2 x ``epochs`` through F with the
    EMA, through K1 and K2; with ``tmp`` a fresh trainer resumes each stage's
    second call from a checkpoint."""
    from pigan_thz_torch.train import checkpoint as ckpt

    cfg = default_config()
    settings = StepSettings.from_config(cfg, detach_forward=False, ema_decay=0.99)

    def trainer():
        return Trainer(cfg, ds=ds, epochs_per_call=epochs, device=dev, engine="kernel")

    t = trainer()
    t.pretrain_forward(epochs=epochs, seed=0, log_every=10**9)
    if tmp:
        mgr = ckpt.CheckpointManager(str(tmp / "fwd"), save_interval=1)
        mgr.save(epochs, t.forward_state, history=t.train_history, config=cfg)
        t = trainer()
        assert t.resume_from(mgr, "forward") == epochs
    t.pretrain_forward(epochs=epochs, seed=epochs, log_every=10**9)
    forward = {k: v.clone() if isinstance(v, torch.Tensor) else v
               for k, v in t.forward_state.state_dict().items()}
    t.init_pigan()
    t.train_pigan(epochs=epochs, settings=settings, seed=0, log_every=10**9)
    if tmp:
        mgr = ckpt.CheckpointManager(str(tmp / "gan"), save_interval=1)
        mgr.save(epochs, t.pigan_state, history=t.train_history, config=cfg)
        t = trainer()
        assert t.resume_from(mgr, "pigan") == epochs
    t.train_pigan(epochs=epochs, settings=settings, seed=epochs, log_every=10**9)
    return forward, t


def test_kill_and_resume_through_k1_and_k2_is_bit_for_bit(dev, train_ds, tmp_path):
    before = (ft.LAUNCHES["forward_train"], gt.LAUNCHES["gan_train"])
    ref_f, ref = _resume_stages(dev, train_ds)
    got_f, got = _resume_stages(dev, train_ds, tmp_path)
    assert (ft.LAUNCHES["forward_train"] - before[0], gt.LAUNCHES["gan_train"] - before[1]) \
        == (4, 4)
    assert _state_equal(got_f, ref_f) == []
    assert _state_equal(got.pigan_state.state_dict(), ref.pigan_state.state_dict()) == []
    assert got.train_history == ref.train_history
    assert got.pigan_state.g_ema is not None


def test_a_card_checkpoint_restores_on_the_cpu(dev, train_ds, tmp_path):
    from pigan_thz_torch.train import checkpoint as ckpt

    cfg = default_config()
    card = Trainer(cfg, ds=train_ds, epochs_per_call=1, device=dev)
    card.pretrain_forward(epochs=1, log_every=10**9)
    card.init_pigan()
    card.train_pigan(epochs=1, log_every=10**9,
                     settings=StepSettings.from_config(cfg, ema_decay=0.9))
    cpu_ds = type(train_ds)(*(t.cpu() for t in train_ds))
    cpu = Trainer(cfg, ds=cpu_ds, device="cpu")
    for which, state in (("forward", card.forward_state), ("pigan", card.pigan_state)):
        mgr = ckpt.CheckpointManager(str(tmp_path / which), save_interval=1)
        mgr.save(1, state, history=card.train_history, config=cfg)
        assert cpu.resume_from(mgr, which) == 1
        restored = cpu.forward_state if which == "forward" else cpu.pigan_state
        assert restored.device.type == "cpu"
        assert _state_equal(restored.state_dict(), state.state_dict()) == []


def test_shadow_replay_on_the_card(dev, train_ds, monkeypatch):
    from pigan_thz_torch.train import trainer as trainer_mod

    cfg = default_config()
    settings = StepSettings.from_config(cfg, detach_forward=False)
    t = Trainer(cfg, ds=train_ds, epochs_per_call=2, device=dev, shadow_parity="all")
    t.pretrain_forward(epochs=4, log_every=10**9)
    t.init_pigan()
    t.train_pigan(epochs=4, settings=settings, log_every=10**9)
    assert [c["what"] for c in t.shadow_checks] == ["forward"] * 2 + ["pigan"] * 2
    assert all(c["ok"] and c["worst_rel"] < 0.05 for c in t.shadow_checks), t.shadow_checks

    real = trainer_mod.make_gan_epoch_fn

    def faulty(*a, **kw):
        fn = real(*a, **kw)

        def multi_epoch(*args, **kwargs):
            state, ms = fn(*args, **kwargs)
            ms = dict(ms, g_loss=ms["g_loss"].clone())
            ms["g_loss"][0] *= 10.0
            return state, ms
        return multi_epoch

    monkeypatch.setattr(trainer_mod, "make_gan_epoch_fn", faulty)
    with pytest.raises(RuntimeError, match="disagrees"):
        t.train_pigan(epochs=2, settings=settings, log_every=10**9)
    assert not t.shadow_checks[-1]["ok"] and t.shadow_checks[-1]["worst_key"] == "g_loss"
