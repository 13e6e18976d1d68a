"""The serving kernels' tensor-core layout, on the CPU.

K5 and K6 (``csrc/fused_mlp_chain.cu``) read weights packed zero-padded to
the m16n8k8 tile and compute their products in 3xTF32.  Here: the plain
versions on the padded packing against the JAX Pallas kernels in interpret
mode (as tests/test_pallas.py runs them); the unpadded views bit for bit;
the 3xTF32 twins (``fused_*_tf32``, the kernels' arithmetic in plain
PyTorch) within the kernels' tolerances of a float64 chain, where one TF32
product alone falls outside them; K5's hi / lo W streams for its wgmma
shape read back as its descriptors read them; and the launch-shape rule at
its crossovers.  The kernels themselves are held on the card in
test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigan_thz_torch.config import ForwardModelConfig as TFwdCfg
from pigan_thz_torch.config import GeneratorConfig as TGenCfg
from pigan_thz_torch.interop import from_flax
from pigan_thz_torch.models import build_forward_model, build_generator
from pigan_thz_torch.ops import fused_kernels as fk
from pigan_thz_tpu.config import ForwardModelConfig, GeneratorConfig
from pigan_thz_tpu.models import build_forward_model as j_build_forward_model
from pigan_thz_tpu.models import build_generator as j_build_generator
from pigan_thz_tpu.ops import pallas_kernels as pk

torch.set_num_threads(1)

K5_TOL = 1e-4   # (B, 258) surrogate output; tests/test_pallas.py:43
K6_TOL = 2e-5   # (B, 4) generator output; tests/test_pallas.py:101
H100_SMS = 132


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def jax_forward():
    f = j_build_forward_model(ForwardModelConfig())
    k = jax.random.PRNGKey(3)
    return _np_tree(f.init({"params": k, "dropout": k}, jnp.zeros((2, 4)), train=False))


@pytest.fixture(scope="module")
def jax_generator():
    g = j_build_generator(GeneratorConfig())
    k = jax.random.PRNGKey(3)
    gv = dict(g.init(k, jnp.zeros((2, 250)), train=False))
    gv["batch_stats"] = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(k, a.shape) ** 2, gv["batch_stats"])
    return _np_tree(gv)


@pytest.fixture(scope="module")
def packed(jax_forward, jax_generator):
    f = build_forward_model(TFwdCfg(), device="cpu")
    f.load_state_dict(from_flax(jax_forward, "forward_model"))
    g = build_generator(TGenCfg(), device="cpu")
    g.load_state_dict(from_flax(jax_generator, "generator"))
    return {"forward": fk.pack_forward_model(f.eval()), "generator": fk.pack_generator(g.eval()),
            "modules": (f, g)}


def _small_chain():
    """7 -> 33 -> 5 with LayerNorm: no width a multiple of the tile."""
    rng = np.random.default_rng(11)
    layer = tuple(rng.normal(size=s).astype(np.float32) for s in ((7, 33), (33,), (33,), (33,)))
    head = tuple(rng.normal(size=s).astype(np.float32) for s in ((33, 5), (5,)))
    return layer, head


@pytest.mark.parametrize("batch", [1, 19, 77])
def test_padded_forward_plain_matches_jax_kernel(batch, jax_forward, packed):
    x = np.random.default_rng(batch).uniform(-1, 1, size=(batch, 4)).astype(np.float32)
    want = pk.fused_mlp_forward(jnp.asarray(x), *pk.extract_forward_mlp_weights(jax_forward),
                                tile_b=8, interpret=True)
    got = fk.fused_mlp_forward_plain(torch.from_numpy(x), packed["forward"])
    assert got.shape == (batch, 258)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K5_TOL, rtol=0)


@pytest.mark.parametrize("batch", [1, 19, 77])
def test_padded_generator_plain_matches_jax_kernel(batch, jax_generator, packed):
    x = np.random.default_rng(batch).normal(size=(batch, 250)).astype(np.float32)
    want = pk.generator_fused(jax_generator, jnp.asarray(x), tile_b=8, interpret=True)
    got = fk.fused_dense_chain_plain(torch.from_numpy(x), packed["generator"])
    assert got.shape == (batch, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K6_TOL, rtol=0)


def test_padded_small_chain_plain_matches_jax_kernel():
    layer, head = _small_chain()
    x = np.random.default_rng(5).normal(size=(19, 7)).astype(np.float32)
    want = pk.fused_mlp_forward(jnp.asarray(x), [tuple(map(jnp.asarray, layer))],
                                tuple(map(jnp.asarray, head)), tile_b=8, interpret=True)
    chain = fk.pack_chain([tuple(map(torch.from_numpy, layer))],
                          tuple(map(torch.from_numpy, head)))
    assert chain.dims == (7, 33, 5) and chain.padded_dims == (8, 40, 8)
    got = fk.fused_mlp_forward_plain(torch.from_numpy(x), chain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K5_TOL, rtol=0)


@pytest.mark.parametrize("which", ["forward", "generator", "small"])
def test_padded_packing_keeps_the_unpadded_tensors(which, packed):
    """layer(l) returns the chain's tensors bit for bit; everything the
    padding adds is zero; every tensor starts on a 64-byte boundary."""
    if which == "small":
        layer, head = _small_chain()
        entries = [layer, head]
        chain = fk.pack_chain([tuple(map(torch.from_numpy, layer))],
                              tuple(map(torch.from_numpy, head)))
    else:
        chain = packed[which]
        f, g = packed["modules"]
        src = (fk.extract_forward_mlp_weights(f) if which == "forward"
               else fk.extract_generator_weights(g))
        entries = [*src[0], src[1]]
    want_pdims = {"forward": (8, 256, 512, 1024, 512, 256, 264),
                  "generator": (256, 512, 256, 8), "small": (8, 40, 8)}[which]
    assert chain.padded_dims == want_pdims
    assert chain.weights.is_contiguous() and chain.weights.dtype == torch.float32
    covered = torch.zeros(chain.weights.numel(), dtype=torch.bool)
    for l, tensors in enumerate(entries):
        views = chain.layer(l)
        assert len(views) == len(tensors)
        for k, (got, want) in enumerate(zip(views, tensors)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want, dtype=np.float32))
            off = chain.offsets[l][k]
            assert off % fk.ALIGN == 0
            if k == 0:
                pin, pout = chain.padded_dims[l], chain.padded_dims[l + 1]
                full = chain.weights[off:off + pin * pout].view(pin, pout)
                covered[off:off + pin * pout] = True
                mask = torch.ones(pin, pout, dtype=torch.bool)
                mask[:got.shape[0], :got.shape[1]] = False
                assert not bool(full[mask].any())
            else:
                covered[off:off + got.numel()] = True
    # W in stage order, for the row-tile shape's one copy a stage
    assert (chain.tiled[-1] == -1) == (which == "generator")
    for l, off in enumerate(chain.tiled):
        if off < 0:
            continue
        assert off % fk.ALIGN == 0
        W = chain.layer(l)[0]
        rebuilt = torch.zeros(chain.padded_dims[l], chain.padded_dims[l + 1])
        for c0, cols, stride, k0, rows in fk.row_tile_stages(*chain.padded_dims[l:l + 2]):
            assert stride % 32 == 8 and rows * stride <= fk.STAGE_FLOATS and rows % 8 == 0
            stage = chain.weights[off:off + rows * stride].view(rows, stride)
            assert not bool(stage[:, cols:].any())
            rebuilt[k0:k0 + rows, c0:c0 + cols] = stage[:, :cols]
            covered[off:off + rows * stride] = True
            off += rows * stride
        assert torch.equal(rebuilt[:W.shape[0], :W.shape[1]], W)
        assert not bool(rebuilt[W.shape[0]:].any() or rebuilt[:, W.shape[1]:].any())
    # K5's hi / lo W streams for the wgmma shape (test_wgmma_streams_split_every_element_once)
    assert (chain.wgmma is not None) == (which == "forward")
    for l, off in enumerate(chain.wgmma or ()):
        covered[off:off + 2 * chain.padded_dims[l] * chain.padded_dims[l + 1]] = True
    assert not bool(chain.weights[~covered].any())


def _read_wgmma_stream(chain, l):
    """Layer l's W stream read back as the wgmma shape's shared-memory
    descriptors read it: for each cluster rank, pass and k8 step, the hi then
    the lo image of the pass's NT column groups, each two core matrices (k
    0-3, k 4-7) of 8 columns x 4 k, k fastest.  Returns (hi, lo, how often
    each padded element was read)."""
    pin, pout = chain.padded_dims[l], chain.padded_dims[l + 1]
    hi, lo = torch.zeros(pin, pout), torch.zeros(pin, pout)
    seen = torch.zeros(2, pin, pout, dtype=torch.int64)
    off = chain.wgmma[l]
    for q in range(fk.WG_CLUSTER):
        t0, t1 = fk.cta_tiles(pout // fk.PAD, q, fk.WG_CLUSTER)
        for a, nt in fk.wgmma_passes(t1 - t0):
            cols = slice(8 * (t0 + a), 8 * (t0 + a + nt))
            for j in range(pin // 8):
                for h, dst in enumerate((hi, lo)):
                    img = chain.weights[off:off + 64 * nt].view(nt, 2, 8, 4)   # (g, c, n, k)
                    dst[8 * j:8 * j + 8, cols] = img.permute(1, 3, 0, 2).reshape(8, 8 * nt)
                    seen[h, 8 * j:8 * j + 8, cols] += 1
                    off += 64 * nt
    assert off == chain.wgmma[l] + 2 * pin * pout
    return hi, lo, seen


def test_wgmma_streams_split_every_element_once(packed):
    """K5's W streams for the wgmma shape: every padded element of every
    layer once in hi and once in lo; hi is TF32 (rna) and lo the TF32 of
    what hi leaves, so hi + lo is W wherever that rest is itself TF32; the
    streams lie on 64-byte boundaries, one after another, inside the
    buffer.  A chain without LayerNorm or one the shape does not take has
    none."""
    chain = packed["forward"]
    assert fk.wgmma_global_layer(chain.dims) == 2          # 512 -> 1024 out to the scratch
    end = None
    for l in range(chain.n_layers):
        off = chain.wgmma[l]
        assert off % fk.ALIGN == 0 and (end is None or off >= end)
        pin, pout = chain.padded_dims[l], chain.padded_dims[l + 1]
        end = off + 2 * pin * pout
        hi, lo, seen = _read_wgmma_stream(chain, l)
        assert bool((seen == 1).all())
        W = torch.zeros(pin, pout)
        w = chain.layer(l)[0]
        W[:w.shape[0], :w.shape[1]] = w
        assert torch.equal(fk.tf32_round(hi), hi)
        assert torch.equal(hi, fk.tf32_round(W))
        assert torch.equal(lo, fk.tf32_round(W - hi))
        exact = fk.tf32_round(W - hi) == W - hi
        assert bool(exact.float().mean() > 0.2)          # the check sees real elements
        assert torch.equal((hi + lo)[exact], W[exact])
        assert not bool(hi[w.shape[0]:].any() or hi[:, w.shape[1]:].any())
    assert end <= chain.weights.numel()
    assert packed["generator"].wgmma is None
    small = fk.pack_chain([tuple(map(torch.from_numpy, _small_chain()[0]))],
                          tuple(map(torch.from_numpy, _small_chain()[1])))
    assert small.wgmma is None and fk.wgmma_global_layer(small.dims) is None


def _float64_chain(x, chain):
    """The chain in float64, written out independently of the port."""
    h = x.double()
    for l in range(chain.n_layers - 1):
        t = [v.double() for v in chain.layer(l)]
        h = h @ t[0] + t[1]
        if chain.layer_norm:
            mean = h.mean(-1, keepdim=True)
            var = ((h - mean) ** 2).mean(-1, keepdim=True)
            h = (h - mean) / torch.sqrt(var + 1e-6) * t[2] + t[3]
            h = torch.where(h >= 0, h, 0.2 * h)
        else:
            h = torch.relu(h)
    W, b = (v.double() for v in chain.layer(chain.n_layers - 1))
    h = h @ W + b
    return h if chain.layer_norm else torch.tanh(h)


@pytest.mark.parametrize("terms,within", [(3, True), (1, False)])
@pytest.mark.parametrize("kernel", ["fused_mlp_forward", "fused_dense_chain"])
def test_tf32_twin_against_float64(kernel, terms, within, packed):
    """3xTF32 holds the kernel's tolerance at full width; a single TF32
    product breaks it, so the check can fail."""
    rng = np.random.default_rng(7)
    if kernel == "fused_mlp_forward":
        x = torch.from_numpy(rng.uniform(-1, 1, size=(512, 4)).astype(np.float32))
        chain, tol, twin = packed["forward"], K5_TOL, fk.fused_mlp_forward_tf32
    else:
        x = torch.from_numpy(rng.normal(size=(512, 250)).astype(np.float32))
        chain, tol, twin = packed["generator"], K6_TOL, fk.fused_dense_chain_tf32
    err = float((twin(x, chain, terms=terms).double() - _float64_chain(x, chain)).abs().max())
    assert (err <= tol) == within, err
    if within:   # and as close as fp32 itself, within a factor
        plain = fk.fused_mlp_forward_plain if chain.layer_norm else fk.fused_dense_chain_plain
        fp32 = float((plain(x, chain).double() - _float64_chain(x, chain)).abs().max())
        assert err <= 4 * fp32 + 1e-7, (err, fp32)


@pytest.mark.parametrize("value,bits", [
    (1.0, 0x3F800000),
    (1.0 + 2.0 ** -11, 0x3F802000),                    # a tie: away from zero
    (-(1.0 + 2.0 ** -11), 0xBF802000),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 0x3F800000),        # below the tie: down
    (3.0e-39, None),                                    # subnormal
])
def test_tf32_round_is_round_to_nearest_away(value, bits):
    x = torch.tensor([value], dtype=torch.float32)
    u = int(x.view(torch.int32)) & 0xFFFFFFFF
    got = int(fk.tf32_round(x).view(torch.int32)) & 0xFFFFFFFF
    down = u & ~0x1FFF
    assert got == (down + 0x2000 if u & 0x1FFF >= 0x1000 else down)
    if bits is not None:
        assert got == bits


F_DIMS = (4, 256, 512, 1024, 512, 256, 258)
G_DIMS = (250, 512, 256, 4)


@pytest.mark.parametrize("batch,dims,sms,want", [
    (1, F_DIMS, H100_SMS, 8),
    (64, F_DIMS, H100_SMS, 8),
    (64, G_DIMS, H100_SMS, 8),
    (257, F_DIMS, H100_SMS, 8),           # 9 row tiles x 8 = 72 blocks
    (1024, F_DIMS, H100_SMS, 4),
    (2048, G_DIMS, H100_SMS, 2),
    (fk.crossover_batch(H100_SMS) - 1, F_DIMS, H100_SMS, 2),
    (fk.crossover_batch(H100_SMS), F_DIMS, H100_SMS, 1),
    (fk.crossover_batch(H100_SMS), G_DIMS, H100_SMS, 1),
    (8192, F_DIMS, H100_SMS, 1),
    (65536, G_DIMS, H100_SMS, 1),
    (fk.crossover_batch(114) - 1, F_DIMS, 114, 2),   # an H100 PCIe
    (fk.crossover_batch(114), F_DIMS, 114, 1),
    (19, (7, 33, 5), H100_SMS, 4),        # 40 padded columns: 5 n8 tiles
    (19, (8, 16, 4), H100_SMS, 2),
    (1, (8, 4), H100_SMS, 1),             # the head alone: one n8 tile
])
def test_launch_shape(batch, dims, sms, want):
    assert fk.launch_shape(batch, dims, sms) == want


# Fewer clusters resident than SMs / C (a cluster needs its SMs in one GPC)
RESIDENT = {2: 60, 4: 30, 8: 14}


@pytest.mark.parametrize("batch,want", [
    (1, 8), (14 * 32, 8), (14 * 32 + 1, 4), (30 * 32, 4), (30 * 32 + 1, 2),
    (60 * 32, 2), (60 * 32 + 1, 1),
])
def test_launch_shape_reads_the_resident_clusters(batch, want):
    assert fk.launch_shape(batch, F_DIMS, H100_SMS, RESIDENT) == want
    assert fk.crossover_batch(H100_SMS, RESIDENT) == 60 * 32 + 1


def test_launch_shape_edges():
    assert fk.crossover_batch(H100_SMS) == 66 * fk.ROW_TILE + 1
    assert fk.launch_shape(1, F_DIMS, H100_SMS) == fk.MAX_CLUSTER
    assert fk.launch_shape(1, F_DIMS, 1) == 1
    for b in range(1, 3000, 37):
        c = fk.launch_shape(b, F_DIMS, H100_SMS)
        assert c in fk.CLUSTER_SIZES and -(-b // fk.ROW_TILE) * c <= max(H100_SMS, 1)


@pytest.mark.parametrize("sms", [H100_SMS, 114])       # an H100 SXM, an H100 PCIe
def test_launch_shape_takes_the_wgmma_shape_from_its_crossover(sms):
    """K5 with W streams: the wgmma shape from the first batch the row-tile
    shape cannot run in one wave, at 8192 and above; the cluster shape at
    B <= 1024; a chain without streams (K6) never takes it."""
    cross = fk.wgmma_crossover(sms)
    assert cross == sms * fk.ROW_TILE + 1
    assert fk.launch_shape(cross - 1, F_DIMS, sms, wgmma=True) == 1
    for b in (cross, cross + 37, 8192, 8192 + 37, 65536):
        assert fk.launch_shape(b, F_DIMS, sms, wgmma=True) == fk.WGMMA
        assert fk.launch_shape(b, F_DIMS, sms) == 1
        assert fk.launch_shape(b, G_DIMS, sms) == 1
    for b in (1, 64, 257, 1024):
        assert fk.launch_shape(b, F_DIMS, sms, wgmma=True) in fk.CLUSTER_SIZES[1:]
    assert fk.launch_shape(8192, F_DIMS, sms, RESIDENT | {fk.WGMMA: 60}, wgmma=True) == fk.WGMMA


def test_shape_labels():
    assert [fk.shape_label(s) for s in (fk.WGMMA, 1, 2, 8)] == [
        "wgmma", "row_tile", "cluster2", "cluster8"]
    assert fk.shape_name(torch.zeros(8192, 4), None) == "plain"     # a CPU input


def test_wrappers_reject_a_bad_cluster(packed):
    with pytest.raises(ValueError):
        fk.fused_mlp_forward(torch.zeros(2, 4), packed["forward"], cluster=3)
    with pytest.raises(ValueError):
        fk.fused_dense_chain(torch.zeros(2, 250), packed["generator"], cluster=32)
    with pytest.raises(ValueError):          # past the portable cluster size
        fk.fused_mlp_forward(torch.zeros(2, 4), packed["forward"], cluster=16)
    # on the CPU a valid cluster is accepted and the plain version answers
    out = fk.fused_dense_chain(torch.zeros(2, 250), packed["generator"], cluster=8)
    assert torch.equal(out, fk.fused_dense_chain_plain(torch.zeros(2, 250), packed["generator"]))
    # the wgmma shape: K5's chain with its W streams only
    with pytest.raises(ValueError, match="wgmma"):
        fk.fused_dense_chain(torch.zeros(2, 250), packed["generator"], cluster=fk.WGMMA)
    layer, head = _small_chain()
    small = fk.pack_chain([tuple(map(torch.from_numpy, layer))], tuple(map(torch.from_numpy, head)))
    with pytest.raises(ValueError, match="wgmma"):
        fk.fused_mlp_forward(torch.zeros(2, 7), small, cluster=fk.WGMMA)
    out = fk.fused_mlp_forward(torch.zeros(2, 4), packed["forward"], cluster=fk.WGMMA)
    assert torch.equal(out, fk.fused_mlp_forward_plain(torch.zeros(2, 4), packed["forward"]))


@pytest.mark.parametrize("tiled", ["missing", "short", "long"])
@pytest.mark.parametrize("which", ["forward", "generator"])
def test_wrappers_refuse_a_chain_without_its_stage_order_copy(which, tiled, packed):
    """The row-tile shape streams W from ``tiled``: a chain without one
    offset a layer is refused before any launch, not read as offset 0."""
    chain = packed[which]
    if tiled == "missing":
        fields = {k: getattr(chain, k) for k in ("weights", "offsets", "dims", "layer_norm")}
        with pytest.raises(TypeError):
            fk.PackedChain(**fields)
        return
    bad = dataclasses.replace(
        chain, tiled=chain.tiled[:-1] if tiled == "short" else chain.tiled + (-1,))
    fn, din = ((fk.fused_mlp_forward, 4) if which == "forward"
               else (fk.fused_dense_chain, 250))
    with pytest.raises(ValueError, match="stage-order"):
        fn(torch.zeros(2, din), bad)
