"""Batch inverse design, one client in a closed loop.

Set-up builds the trio from the configuration, copies the benchmark's
weights into G and F (BatchNorm with a trained model's running statistics),
and makes the program's serving callable
(``serve.make_inverse_design_fn`` at its default).  A pool of request
spectra lives on the device; request i is the ``batch`` rows of the pool at
an offset drawn from the seed.  The client calls the designer, then
synchronises, then sends the next request.  Each request's latency is the
device clock's span from an event recorded before the call to one recorded
after it; the window's rate is every spectrum over the window's host time.

The check judges the answers of a sample of the requests, drawn from the
seed, and of the last one: the parameters against the reference's G on the
request's spectra, the spectrum and the metrics against the reference's F
at the parameters the program returned.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .. import inputs, program
from ..reference import compare
from ..reference import models as M
from ..tracing import Segment


class Clock:
    """Request latency: CUDA events on the card, the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop_ms(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


def designer_of(fn):
    """The designer module inside the program's serving callable, or None."""
    inner = getattr(fn, "__wrapped__", fn)
    for cell in inner.__closure__ or ():
        m = cell.cell_contents
        if isinstance(m, torch.nn.Module) and hasattr(m, "generator") and hasattr(m, "surrogate"):
            return m
    return None


class _Ranges:
    """``bench.gen_stage`` / ``bench.fwd_stage`` ranges around the designer's
    two stages while a traced segment runs."""

    def __init__(self, designer):
        self.stages = []
        if designer is None:
            return
        for attr, name in (("generator", "bench.gen_stage"), ("surrogate", "bench.fwd_stage")):
            stage = getattr(designer, attr)
            self.stages.append(stage)
            stage.forward = self._wrap(stage.forward, name)

    @staticmethod
    def _wrap(forward, name):
        def ranged(x):
            with torch.profiler.record_function(name):
                return forward(x)
        return ranged

    def remove(self):
        for stage in self.stages:
            del stage.forward


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.batch = traffic["batch"]

    # ------------------------------------------------------------------
    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        pc = program.port_config(cfg)
        ds = program.dataset(pc, inputs.training_set(cfg, self.seed, dev), dev)
        from pigan_thz_torch.models.registry import build_trio
        from pigan_thz_torch.serve import make_inverse_design_fn

        g, _, f = build_trio(pc, device=dev)
        self.g_ops, self.f_ops = M.generator_layers(cfg), M.forward_layers(cfg)
        self.w_g = inputs.make_weights(M.param_layout(self.g_ops) + M.buffer_layout(self.g_ops),
                                       self.seed, dev, "G", trained_stats=True)
        self.w_f = inputs.make_weights(M.param_layout(self.f_ops), self.seed, dev, "F")
        program.load_(g, self.w_g, self.g_ops)
        program.load_(f, self.w_f, self.f_ops)
        self.fn = make_inverse_design_fn(g.eval(), f.eval(), ds)
        del g, f
        self.pool = inputs.request_pool(cfg, self.traffic["pool_rows"], self.seed, dev)
        self.rng = inputs.host_rng(self.seed, "offsets")
        self.sample = set(int(i) for i in inputs.host_rng(self.seed, "sample").choice(
            self.traffic["sample_range"], self.traffic["sample_requests"], replace=False))
        for _ in range(self.traffic["warmup_requests"]):
            self.fn(self.pool[:self.batch])
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _offset(self) -> int:
        return int(self.rng.integers(0, self.traffic["pool_rows"] - self.batch + 1))

    # ------------------------------------------------------------------
    def window(self, seconds: float, trace: bool) -> dict:
        fn, pool, b = self.fn, self.pool, self.batch
        clock = Clock(self.device)
        first, count = self.traffic["trace_from"], self.traffic["trace_requests"]
        seg = ranges = None
        lat, enqueue, kept, traced_enqueue = [], 0.0, {}, 0.0
        n, last = 0, None
        t_start = time.perf_counter()
        while True:
            if trace and n == first:
                enqueue_before = enqueue
                seg = Segment("design")
                seg.start()
                ranges = _Ranges(designer_of(fn))
            o = self._offset()
            x = pool[o:o + b]
            clock.start()
            t0 = time.perf_counter()
            with (torch.profiler.record_function("bench.request") if ranges
                  else contextlib.nullcontext()):
                out = fn(x)
            enqueue += time.perf_counter() - t0
            lat.append(clock.stop_ms())
            if n in self.sample:
                kept[n] = (o, out)
            last = (n, o, out)
            n += 1
            if seg is not None and ranges is not None and n == first + count:
                ranges.remove()
                ranges = None
                seg.stop()
                traced_enqueue = enqueue - enqueue_before
            if time.perf_counter() - t_start >= seconds and (not trace or n >= first + count):
                break
        window_s = time.perf_counter() - t_start
        kept[last[0]] = last[1:]
        self.kept = kept
        traced = count if seg is not None else 0
        # the window without the traced segment, whose tracer slows the host
        return {"window_s": window_s, "requests": n, "rows": n * b, "latencies_ms": lat,
                "segments": [seg.summary] if seg else [],
                "free_s": window_s - (seg.outer_s if seg else 0.0),
                "free_requests": n - traced, "free_enqueue_s": enqueue - traced_enqueue}

    def release(self) -> None:
        del self.fn

    # ------------------------------------------------------------------
    def answers_of_reference(self, x: torch.Tensor, precision: str):
        """(params, spectrum, metrics) of the reference put in the program's
        place, computed in ``precision``."""
        cfg = self.cfg
        with torch.no_grad():
            pn = M.run(self.g_ops, self.w_g, x, precision=precision)
            out = M.run(self.f_ops, self.w_f, pn, precision=precision)
        s = cfg["spectrum_dim"]
        return M.denormalize_params(pn, cfg), out[:, :s], out[:, s:]

    def judge(self, x: torch.Tensor, answers) -> dict:
        """The gaps of one request's answers from the reference."""
        cfg, s = self.cfg, self.cfg["spectrum_dim"]
        params, spec, met = answers
        with torch.no_grad():
            p_ref = M.denormalize_params(M.run(self.g_ops, self.w_g, x), cfg)
            f_ref = M.run(self.f_ops, self.w_f, M.normalize_params(params, cfg))
        return {"params_gap": compare.answer_gap(params, p_ref),
                "spectrum_gap": compare.answer_gap(spec, f_ref[:, :s]),
                "metrics_gap": compare.answer_gap(met, f_ref[:, s:])}

    def check(self, answers_fn=None) -> dict:
        """The widest gaps over the sampled requests.  ``answers_fn(x)``
        stands in for the program's answers (the control, a planted fault)."""
        worst: dict = {}
        for _, (o, out) in sorted(self.kept.items()):
            x = self.pool[o:o + self.batch]
            got = answers_fn(x) if answers_fn is not None else out
            for k, v in self.judge(x, got).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return {f"design.{k}": v for k, v in worst.items()}

