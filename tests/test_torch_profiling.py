"""The port's spans and counters (``utils/profiling.py``) on the CPU.

Off (no profiler, no ``recording()``) a Trainer chunk and a design request
record nothing; under ``torch.profiler`` the spans appear both among the
profiler's events and in ``snapshot()``, nested as the program opens them,
with one id a chunk or a request; a span that a traced segment's start or
stop cuts is dropped; ``host_syncs`` counts the chunk's transfer and each
read of its finite check; a request's stage spans say whether the stage
replayed a CUDA graph, beside the capture and replay counters.  The
benchmark's six readers of these spans return None on an empty snapshot,
on a run without a trace and on a program without ``snapshot``, and their
arithmetic on a synthetic one."""

import importlib.util
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pigan_thz_torch import serve
from pigan_thz_torch.cli import main as cli_main
from pigan_thz_torch.config import GeneratorConfig, apply_overrides, default_config
from pigan_thz_torch.data import synthetic_dataset
from pigan_thz_torch.models import build_generator
from pigan_thz_torch.serve import Designer, make_inverse_design_fn
from pigan_thz_torch.train.trainer import Trainer
from pigan_thz_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["data.num_samples=64", "data.spectrum_dim=20", "train.batch_size=32"]
CHUNK_SPANS = ("draws", "streams", "launch", "transfer", "check")


@pytest.fixture(autouse=True)
def fresh_store():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def small():
    cfg = apply_overrides(default_config(), SMALL)
    return cfg, synthetic_dataset(cfg.data, device="cpu")


def _trainer(small):
    cfg, ds = small
    return Trainer(cfg, ds=ds, epochs_per_call=1, engine="kernel", device="cpu")


def _designer_fn(small):
    cfg, ds = small
    t = Trainer(cfg, ds=ds, engine="eager", device="cpu")
    return make_inverse_design_fn(t.generator.eval(), t.forward_model.eval(), ds), ds


def _traced(work):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    return {e.name for e in prof.events()}, profiling.snapshot()


def _by_name(snap):
    out = {}
    for r in snap["recent"]:
        out.setdefault(r["name"], []).append(r)
    return out


def _gan_reads(state) -> int:
    """The device reads of ``PiGanState.is_finite``: one a tensor."""
    tensors = 6 + sum(t.is_floating_point() for m in (state.g, state.d) for t in m.buffers())
    return tensors + (state.g_ema is not None)


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------


def test_off_a_chunk_and_a_request_record_nothing(small):
    t = _trainer(small)
    t.pretrain_forward(epochs=1)
    t.train_pigan(epochs=1)
    fn, ds = _designer_fn(small)
    fn(ds.spectra[:8])
    snap = profiling.snapshot()
    assert snap == {"spans": {}, "recent": [], "counters": {}}


def test_off_a_span_site_is_one_shared_object():
    assert not profiling.on()
    a, b = profiling.span("x", k=1), profiling.span("y")
    assert a is b and not a.on
    with a as s:
        s.set(kernels=3)
    profiling.count("c")
    assert profiling.snapshot()["counters"] == {}


# ---------------------------------------------------------------------------
# under the profiler
# ---------------------------------------------------------------------------


def test_chunk_spans_nest_and_share_an_id(small):
    t = _trainer(small)
    names, snap = _traced(lambda: t.pretrain_forward(epochs=1))
    spans = snap["spans"]
    for part in ("chunk", "record", "replay", *CHUNK_SPANS):
        assert f"pigan.train.{part}" in names            # on the profiler's timeline
        assert spans[f"pigan.train.{part}"]["count"] == 1
    rec = _by_name(snap)
    (chunk,) = rec["pigan.train.chunk"]
    assert chunk["parent"] is None
    assert chunk["attrs"] == {"what": "forward", "epochs": 1, "at": 0}
    for part in ("replay", *CHUNK_SPANS):
        (r,) = rec[f"pigan.train.{part}"]
        assert r["parent"] == "pigan.train.chunk" and r["id"] == chunk["id"]
        assert chunk["start_ns"] <= r["start_ns"] <= r["end_ns"] <= chunk["end_ns"]
    (record,) = rec["pigan.train.record"]
    assert record["parent"] is None and record["id"] == chunk["id"]
    assert record["start_ns"] >= chunk["end_ns"]
    # the chunk's self time is what its children leave
    children = sum(spans[f"pigan.train.{p}"]["total_s"] for p in ("replay", *CHUNK_SPANS))
    c = spans["pigan.train.chunk"]
    assert c["self_s"] == pytest.approx(c["total_s"] - children, abs=1e-6)
    assert spans["pigan.train.launch"]["attrs"] == {                  # the plain version
        "kernels": 0, "head_kernels": 0, "head_ns": 0,
        "deep_narrow": 0, "batch_depth": 0, "sgemm": 0}


def test_two_chunks_take_two_ids(small):
    t = _trainer(small)
    t.pretrain_forward(epochs=0)
    _, snap = _traced(lambda: t.pretrain_forward(epochs=2))
    ids = [r["id"] for r in _by_name(snap)["pigan.train.chunk"]]
    assert len(ids) == 2 and ids[0] != ids[1]
    records = [r["id"] for r in _by_name(snap)["pigan.train.record"]]
    assert records == ids


def test_request_spans_share_an_id(small):
    fn, ds = _designer_fn(small)
    fn(ds.spectra[:8])                                  # a warm request, off
    names, snap = _traced(lambda: [fn(ds.spectra[:8]) for _ in range(2)])
    rec = _by_name(snap)
    assert set(snap["spans"]) == {"pigan.serve.gen_stage", "pigan.serve.fwd_stage"}
    for name in snap["spans"]:
        assert name in names and snap["spans"][name]["count"] == 2
    gens, fwds = rec["pigan.serve.gen_stage"], rec["pigan.serve.fwd_stage"]
    assert {r["parent"] for r in gens + fwds} == {None}
    assert [g["id"] for g in gens] == [f["id"] for f in fwds]    # one id a request
    assert gens[0]["id"] != gens[1]["id"]
    for gen, fwd in zip(gens, fwds):
        assert gen["end_ns"] <= fwd["start_ns"]


def test_request_spans_say_whether_a_stage_replayed(small, monkeypatch):
    """A module stage's graph (capture stubbed: the eager forward, counted)
    marks its span ``replayed`` and counts its captures and replays, the
    span's ``shape`` "module" (a CPU designer's residual G never takes the
    residual chain kernel); a fused stage's span reads 0; the span table
    lists both counters."""
    cfg, ds = small
    made = []

    class Graph:
        def __init__(self, forward, x):
            self.forward = forward
            made.append(self)

        def __call__(self, x):
            return self.forward(x)

    monkeypatch.setattr(serve, "_capturable", lambda x: True)
    monkeypatch.setattr(serve, "_Graph", Graph)
    g = build_generator(GeneratorConfig(name="residual"), ds.spectrum_dim, device="cpu")
    t = Trainer(cfg, ds=ds, engine="eager", device="cpu")
    fn = make_inverse_design_fn(g.eval(), t.forward_model.eval(), ds)
    _, snap = _traced(lambda: [fn(ds.spectra[:8]) for _ in range(3)])
    rec = _by_name(snap)
    assert [r["attrs"] for r in rec["pigan.serve.gen_stage"]] == [
        {"replayed": 0, "shape": "module"}, {"replayed": 1, "shape": "module"},
        {"replayed": 1, "shape": "module"}]
    assert [r["attrs"] for r in rec["pigan.serve.fwd_stage"]] == [
        {"replayed": 0, "shape": "plain"}] * 3
    assert snap["spans"]["pigan.serve.gen_stage"]["attrs"] == {"replayed": 2}
    assert len(made) == 1
    assert snap["counters"] == {profiling.GRAPH_CAPTURES: 1, profiling.GRAPH_REPLAYS: 2}
    assert "counters: serve_graph_captures 1, serve_graph_replays 2" in profiling.span_table(snap)


def test_wgmma_launches_count_and_the_fwd_span_names_its_shape(small, monkeypatch):
    """K5's wgmma shape (the launch stubbed: the card's limits and the C
    call) adds to its per-shape launch count, recording or not, and to no
    counter; a request's F stage span names the launch shape its kernel
    takes for the request."""
    from pigan_thz_torch.config import ForwardModelConfig
    from pigan_thz_torch.models import build_forward_model
    from pigan_thz_torch.ops import fused_kernels as fk

    calls = []

    def fake_launch(name, device, *args, count_as=None):
        calls.append(name)
        fk.LAUNCHES[count_as or name] += 1

    monkeypatch.setattr(fk, "launch", fake_launch)
    monkeypatch.setattr(fk, "chain_limits", lambda p: (132, {2: 66, 4: 30, 8: 15, fk.WGMMA: 66}))
    packed = fk.pack_forward_model(build_forward_model(ForwardModelConfig(), device="cpu").eval())
    before = dict(fk.LAUNCHES)
    with profiling.recording():
        for b in (8192, 64):
            fk._launch("fused_mlp_forward", torch.zeros(b, 4), packed, None, 0.2, 1e-6)
        snap = profiling.snapshot()
    fk._launch("fused_mlp_forward", torch.zeros(8192, 4), packed, None, 0.2, 1e-6)   # off
    assert calls == ["fused_mlp_forward_wgmma", "fused_mlp_forward", "fused_mlp_forward_wgmma"]
    assert {k: fk.LAUNCHES[k] - before[k] for k in ("fused_mlp_forward",
                                                    "fused_mlp_forward.wgmma")} == {
        "fused_mlp_forward": 3, "fused_mlp_forward.wgmma": 2}
    assert snap["counters"] == {}
    assert profiling.snapshot()["counters"] == snap["counters"]

    fn, ds = _designer_fn(small)
    monkeypatch.setattr(serve, "shape_name",
                        lambda x, p: fk.shape_label(fk.launch_shape(x.shape[0], p.dims, 1,
                                                                    wgmma=True)))
    _, snap = _traced(lambda: [fn(ds.spectra[:b]) for b in (8, 64)])    # crossover 33
    assert [r["attrs"]["shape"] for r in _by_name(snap)["pigan.serve.fwd_stage"]] == [
        "row_tile", "wgmma"]


def test_the_serving_callable_keeps_its_designer_in_the_closure(small):
    fn, _ = _designer_fn(small)
    cells = [c.cell_contents for c in fn.__wrapped__.__closure__]
    assert any(isinstance(m, Designer) for m in cells)


def test_seed_ensemble_chunks(small):
    from pigan_thz_torch.parallel.ensemble_megakernel import train_seed_ensemble

    cfg, ds = small
    t = _trainer(small)
    t.pretrain_forward(epochs=0)

    out = {}

    def work():
        out["states"], _ = train_seed_ensemble(
            cfg, ds, 2, epochs=2, epochs_per_call=1, devices=["cpu"],
            forward_model=t.forward_model, packed=True)

    _, snap = _traced(work)
    spans, rec = snap["spans"], _by_name(snap)
    for part in ("chunk", *CHUNK_SPANS):
        assert spans[f"pigan.train.{part}"]["count"] == 2
    assert spans["pigan.train.launch"]["attrs"] == {
        "members": 4, "kernels": 0, "head_kernels": 0, "head_ns": 0,
        "deep_narrow": 0, "batch_depth": 0, "sgemm": 0}
    for part in CHUNK_SPANS:
        assert {r["parent"] for r in rec[f"pigan.train.{part}"]} == {"pigan.train.chunk"}
    # a transfer a member, then a read a tensor of the stacked state
    reads = 6 + len(out["states"].bn)
    assert snap["counters"] == {profiling.HOST_SYNCS: 2 * (2 + reads)}


# ---------------------------------------------------------------------------
# host_syncs
# ---------------------------------------------------------------------------


def test_host_syncs_a_forward_chunk(small):
    t = _trainer(small)
    t.pretrain_forward(epochs=0)
    _, snap = _traced(lambda: t.pretrain_forward(epochs=3))
    assert snap["spans"]["pigan.train.chunk"]["count"] == 3
    assert snap["counters"] == {profiling.HOST_SYNCS: 2 * 3}


def test_host_syncs_a_gan_chunk(small):
    t = _trainer(small)
    state = t.init_pigan()
    _, snap = _traced(lambda: t.train_pigan(epochs=2))
    assert snap["spans"]["pigan.train.chunk"]["count"] == 2
    assert snap["counters"] == {profiling.HOST_SYNCS: 2 * (1 + _gan_reads(state))}
    assert _gan_reads(state) >= 10


# ---------------------------------------------------------------------------
# cut spans, recording()
# ---------------------------------------------------------------------------


def test_a_span_cut_by_the_profilers_start_is_dropped():
    prof = profile(activities=[ProfilerActivity.CPU])
    with profiling.span("outer"):
        prof.start()
        with profiling.span("inner"):
            pass
    prof.stop()
    snap = profiling.snapshot()
    assert set(snap["spans"]) == {"inner"}
    assert snap["recent"][0]["parent"] is None


def test_a_span_cut_by_the_profilers_stop_is_dropped():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
        prof.stop()
    snap = profiling.snapshot()
    assert set(snap["spans"]) == {"inner"}
    assert snap["recent"][0]["parent"] == "outer"


def test_recording_without_the_profiler(monkeypatch):
    clock = iter([0, 10, 30, 100, 110, 120, 200, 1000])
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(clock))
    with profiling.recording():
        assert profiling.on()
        with profiling.span("a", epochs=2):          # 0 .. 100
            with profiling.span("b") as b:           # 10 .. 30
                b.set(kernels=5)
            profiling.count("c", 3)
        with profiling.span("a", epochs=1):          # 110 .. 120
            pass
        with profiling.span("d", follows=True):      # 200 .. 1000
            pass
    assert not profiling.on()
    with profiling.span("e"):
        pass
    snap = profiling.snapshot()
    ns = {name: (a["count"], round(a["total_s"] * 1e9), round(a["self_s"] * 1e9), a["attrs"])
          for name, a in snap["spans"].items()}
    assert ns == {"a": (2, 110, 90, {"epochs": 3}), "b": (1, 20, 20, {"kernels": 5}),
                  "d": (1, 800, 800, {})}
    assert snap["counters"] == {"c": 3}
    rec = _by_name(snap)
    assert rec["b"][0]["id"] == rec["a"][0]["id"] != rec["a"][1]["id"] == rec["d"][0]["id"]


def test_recent_spans_are_capped(monkeypatch):
    monkeypatch.setattr(profiling._STORE, "recent",
                        profiling._STORE.recent.__class__(maxlen=3))
    with profiling.recording():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    snap = profiling.snapshot()
    assert [r["name"] for r in snap["recent"]] == ["s2", "s3", "s4"]
    assert len(snap["spans"]) == 5


# ---------------------------------------------------------------------------
# profile prints the table
# ---------------------------------------------------------------------------


def test_profile_prints_the_span_table(tmp_path, capsys):
    args = [a for s in SMALL for a in ("--set", s)]
    rc = cli_main(["profile", "--device", "cpu", "--engine", "kernel", *args,
                   "--epochs", "1", "--repeats", "2", "--trace-dir", str(tmp_path)])
    assert rc == 0
    text = capsys.readouterr().out
    json.loads(text[: text.rindex("}") + 1])            # the report comes first
    table = text[text.rindex("}") + 1:]
    for name in ("pigan.train.draws", "pigan.train.streams", "pigan.train.launch"):
        line = next(x for x in table.splitlines() if x.startswith(name))
        assert int(line.split()[1]) == 2                # the traced repeats only
    assert "counters: none" in table


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

READERS = ("prologue_ms.train", "enqueue_us_per_kernel.train", "epilogue_ms.train",
           "syncs_per_chunk.train", "enqueue_ms.gen_stage", "enqueue_ms.fwd_stage")


def _reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("_reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _agg(count, total_s, self_s=None, **attrs):
    return {"count": count, "total_s": total_s,
            "self_s": total_s if self_s is None else self_s, "attrs": attrs}


SYNTHETIC = {
    "spans": {
        "pigan.train.chunk": _agg(4, 0.2, 0.01, epochs=100),
        "pigan.train.draws": _agg(4, 0.004),
        "pigan.train.streams": _agg(4, 0.008),
        "pigan.train.launch": _agg(4, 0.16, kernels=40000, head_kernels=2048,
                                   head_ns=8_601_600),
        "pigan.train.transfer": _agg(4, 0.02),
        "pigan.train.check": _agg(4, 0.002),
        "pigan.train.record": _agg(2, 0.003, 0.002),
        "pigan.serve.gen_stage": _agg(300, 0.06),
        "pigan.serve.fwd_stage": _agg(300, 0.027),
    },
    "recent": [],
    "counters": {profiling.HOST_SYNCS: 26},
}
EXPECTED = {
    "prologue_ms.train": (0.004 + 0.008) / 4 * 1e3,
    "enqueue_us_per_kernel.train": 8_601_600 / 2048 * 1e-3,
    "epilogue_ms.train": (0.002 / 4 + 0.002 / 2) * 1e3,
    "syncs_per_chunk.train": 6.5,
    "enqueue_ms.gen_stage": 0.06 / 300 * 1e3,
    "enqueue_ms.fwd_stage": 0.027 / 300 * 1e3,
}
RUN = {"trace": {"window_s": 1.0, "busy_s": 0.8}, "record": {}, "cfg": {}, "traffic": {}}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_an_empty_snapshot_and_without_a_trace(name):
    read = _reader(name)
    assert read(RUN) is None
    with profiling.recording():
        with profiling.span("pigan.other"):
            pass
    assert read(RUN) is None
    assert read(dict(RUN, trace=None)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_snapshot(name, monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: SYNTHETIC)
    assert _reader(name)(RUN) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_program_without_spans(name, monkeypatch):
    """A version of the program without ``snapshot``: nothing to read."""
    monkeypatch.delattr(profiling, "snapshot")
    assert _reader(name)(RUN) is None
