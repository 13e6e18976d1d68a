"""Where the serving kernels' time goes: K5 and K6 rebuilt with one part
of ``csrc/fused_mlp_chain.cu`` changed or taken out at a time, on the card.

Each variant is the kernel source with one edit (named below), compiled
with the port's nvcc flags into its own library under
``build/kernels/ablate/`` and timed with CUDA events: a ``chain_kernel``
variant at the three shapes that matter, one row tile alone (B = 32, the
row-tile shape), B = 64 in clusters of 8 and B = 8192; a ``wg_`` variant
(and ``base``) K5's wgmma shape at B = 8192.  Variants that change the
arithmetic are checked against the plain version, the others compute wrong
numbers on purpose and are only timed.  Prints the card's name and power
limit and one JSON line.

    python examples/torch_serving_ablate.py                 # on the card
    python examples/torch_serving_ablate.py base terms1     # some variants
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch

from pigan_thz_torch.ops import _cuda_build
from pigan_thz_torch.ops import fused_kernels as fk

sys.path.insert(0, str(ROOT / "examples"))
from torch_serving_tiles import card_line, median_ms, models  # noqa: E402

SPLIT = """  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));"""
MMA = """        mma_tf32(small[m][j], alo[m], bhi[s][j][0], bhi[s][j][1]);
        mma_tf32(small[m][j], ahi[m], blo[s][j][0], blo[s][j][1]);
        mma_tf32(acc[m][j], ahi[m], bhi[s][j][0], bhi[s][j][1]);"""
PRODUCTS = """      stage_products<kTilesPerWarp>(nw, in, bw_in, st, g.stride, k0, rows, w0,"""
STREAM = """        const int rows = min(g.kt, din_p - k0);
        float* st = ring.stage"""
LN = "      layer_norm_leaky(next, bw_next"
TILED = "csize == 1 && d.tiled_off[l] >= 0"
WG_LN = "      wg_layer_norm(L.next,"
WG_COPY = """        mbar_arrive_expect_tx(ring.full + slot, 4 * floats);
        bulk_copy(ring.stage + slot * kWgStageFloats, src, 4 * floats, ring.full + slot);"""
WG_PEER = "  return ld_cluster4(cluster_addr(p, q));"
WG_WAIT = "      if (sub == 0) mbar_wait(ring.full + slot, (it / kWgStages) & 1);\n"
WG_RELEASE = "if (prev_slot >= 0) release(ring.empty + prev_slot);\n"
WG_PRODUCE = "    if (threadIdx.x == kWgThreads) wg_produce(d, w, rank, ring);\n"

# name -> (what it measures, [(text, replacement)], checked against plain)
VARIANTS = {
    "base": ("the kernel as it is", [], True),
    "terms1": ("one TF32 product (hi*hi) instead of three",
               [(MMA, "        mma_tf32(acc[m][j], ahi[m], bhi[s][j][0], bhi[s][j][1]);")],
               False),
    "trunc": ("hi by truncation, lo unrounded: 3 integer / float ops a split instead of 5",
              [(SPLIT, "  hi = __float_as_uint(x) & 0xffffe000u;\n"
                       "  lo = __float_as_uint(x - __uint_as_float(hi));")], True),
    "no_products": ("the consumers only wait for and release the stages",
                    [(PRODUCTS, "      stage_products<0>(nw, in, bw_in, st, g.stride, k0, rows, "
                                "w0,")], False),
    "one_row": ("the producer streams one W row a stage: the products alone",
                [(STREAM, "        const int rows = 1;\n"
                          "        float* st = ring.stage")], False),
    "row_copies": ("one bulk copy a W row, as the cluster shape streams, in the row-tile "
                   "shape too", [(TILED, "csize == 1 && d.tiled_off[l] < -1")],
                   True),
    "no_layernorm": ("K5's LayerNorms skipped", [(LN, "      if (batch < 0) "
                                                       "layer_norm_leaky(next, bw_next")], False),
    "wg_no_layernorm": ("the wgmma shape without its LayerNorms and their cluster meetings",
                        [(WG_LN, "      if (batch < 0) wg_layer_norm(L.next,")], False),
    "wg_no_stream": ("the wgmma shape's producer arrives on each stage without copying it",
                     [(WG_COPY, "        mbar_arrive(ring.full + slot);")], False),
    "wg_products_only": ("the wgmma shape's products, epilogues and A loads alone: no W "
                         "stream, no stage barriers, no peer reads, no LayerNorm",
                         [(WG_PEER, "  return *reinterpret_cast<const float4*>(p);"),
                          (WG_LN, "      if (batch < 0) wg_layer_norm(L.next,"),
                          (WG_WAIT, ""), ("      " + WG_RELEASE, ""), ("  " + WG_RELEASE, ""),
                          (WG_PRODUCE, "")], False),
}
SHAPES = ((32, 1), (64, 8), (8192, 1))
WG_BATCH = 8192


def build(name: str, edits) -> ctypes.CDLL:
    src = (_cuda_build.CSRC / "fused_mlp_chain.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    out = _cuda_build.BUILD_ROOT / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    cmd = [_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for entry in ("pigan_fused_mlp_forward", "pigan_fused_dense_chain",
                  "pigan_fused_mlp_forward_wgmma"):
        fn = getattr(lib, entry)
        fn.argtypes = _cuda_build.ENTRY_POINTS[entry]
        fn.restype = ctypes.c_int
    return lib


def time_wgmma(name, lib, packed, checked, failures, stream) -> dict:
    """K5 in the wgmma shape at WG_BATCH rows from a variant's library."""
    offsets, _, dims, wg, gl, sw = fk._c_layout(packed.offsets, packed.tiled, packed.dims,
                                                packed.wgmma)
    dev = packed.device
    x = torch.rand((WG_BATCH, 4), device=dev) * 2 - 1
    out = torch.empty((WG_BATCH, packed.dims[-1]), device=dev)
    scratch = torch.empty(fk._round_up(WG_BATCH, fk.WG_ROWS) * sw, device=dev)

    def call():
        rc = lib.pigan_fused_mlp_forward_wgmma(
            x.data_ptr(), out.data_ptr(), packed.weights.data_ptr(), scratch.data_ptr(),
            offsets, wg, dims, packed.n_layers, gl, WG_BATCH, 0.2, 1e-6, stream)
        if rc != 0:
            raise RuntimeError(f"{name} wgmma: CUDA error {rc}")

    call()
    torch.cuda.synchronize()
    res = {"ms": median_ms(call, 30)}
    if checked:
        res["max_abs_err"] = float((out - fk.fused_mlp_forward_plain(x, packed)).abs().max())
        if not res["max_abs_err"] <= 1e-4:
            failures.append(f"{name} wgmma: {res['max_abs_err']}")
    return res


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    if not torch.cuda.is_available():
        print("torch_serving_ablate: FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    G, F = models(dev)
    chains = {"fused_mlp_forward": (fk.pack_forward_model(F, dev), 4),
              "fused_dense_chain": (fk.pack_generator(G, dev), 250)}
    stream = torch.cuda.current_stream().cuda_stream
    result, failures = {}, []
    for name in names:
        what, edits, checked = VARIANTS[name]
        lib = build(name, edits)
        row = {"measures": what}
        if name == "base" or name.startswith("wg_"):
            row[f"fused_mlp_forward B={WG_BATCH} wgmma"] = time_wgmma(
                name, lib, chains["fused_mlp_forward"][0], checked, failures, stream)
        for kernel, (packed, din) in chains.items():
            if name.startswith("wg_"):
                break
            offsets = (ctypes.c_longlong * (4 * packed.n_layers))(
                *(o for offs in packed.offsets for o in offs))
            tiled = (ctypes.c_longlong * packed.n_layers)(*packed.tiled)
            dims = (ctypes.c_int * len(packed.dims))(*packed.dims)
            scalars = (0.2, 1e-6) if packed.layer_norm else ()
            for b, c in SHAPES:
                x = torch.randn((b, din), device=dev)
                out = torch.empty((b, packed.dims[-1]), device=dev)

                def call():
                    rc = getattr(lib, f"pigan_{kernel}")(
                        x.data_ptr(), out.data_ptr(), packed.weights.data_ptr(), offsets,
                        tiled, dims, packed.n_layers, b, c, *scalars, stream)
                    if rc != 0:
                        raise RuntimeError(f"{name} {kernel}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                key = f"{kernel} B={b} cluster={c}"
                row[key] = {"ms": median_ms(call, 30)}
                if checked:
                    plain = (fk.fused_mlp_forward_plain if packed.layer_norm
                             else fk.fused_dense_chain_plain)
                    err = float((out - plain(x, packed)).abs().max())
                    row[key]["max_abs_err"] = err
                    if not err <= (1e-4 if packed.layer_norm else 2e-5):
                        failures.append(f"{name} {key}: {err}")
        result[name] = row
        print(name, json.dumps(row), flush=True)
    print(f"card: {card}")
    print(json.dumps({"variants": result, "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
