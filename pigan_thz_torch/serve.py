"""Model serving: the in-process inverse-design cycle and exported artifacts.

The port of ``pigan_thz_tpu/serve.py``.  ``make_inverse_design_fn`` is the
cycle spectra (B, S) -> generator -> normalised params (B, 4) -> frozen
forward surrogate -> (spectrum (B, S), metrics (B, 8)), the params
denormalised to physical units, on one of four paths:

- fp32, the default: each baseline model through its fused kernel of
  ``ops/fused_kernels.py`` (on the card one launch of K6 for the
  ``MLPGenerator``, one of K5 for the ``ForwardMLP``; on the CPU their
  plain PyTorch versions), and a model that no TPU kernel covers (the
  enhanced variants) through its module, as the JAX package's XLA path
  serves it: the choice is made stage by stage, by the model's type (on
  the card a module stage replays a CUDA graph of its forward from its
  second call with a request shape on: ``ModuleStage``);
- fp32 with ``use_pallas=False``: the modules' eval-mode forward in plain
  PyTorch, the JAX package's XLA path and the portable artifacts' body;
- ``compute_dtype=torch.bfloat16`` (or "bfloat16"): the models' bf16 twins
  (``models/blocks.py:bf16_twin``, flax's ``dtype=bfloat16``
  semantics), plain PyTorch as the JAX path is plain XLA, fp32 outputs;
- ``compute_dtype="int8"`` (or ``torch.int8``): the post-training-quantized
  cycle of ``ops/quantized.py``.

``make_ensemble_inverse_design_fn`` is the ensemble-mean cycle: the mean of
N seed-ensemble members' normalised predictions, then F on the mean, plain
PyTorch (the JAX package runs one vmap over the members, outside any Pallas
kernel), in fp32 or bf16.

The ``export_*`` functions write ``torch.export`` programs with the weights
baked in and a fixed batch, as ``.pt2`` files (the JAX package writes
StableHLO ``.stablehlo`` files): the generator, the forward surrogate, the
designer and the ensemble designer.  With ``use_pallas`` the surrogate and
the designer call the fused kernels as the custom ops
``pigan_thz::fused_dense_chain`` (K6) and ``pigan_thz::fused_mlp_forward``
(K5): such a program runs only where ``pigan_thz_torch`` is imported, and
there on the card through the kernels (the JAX package's ``use_pallas``
artifacts are TPU-only for the same reason).  The other artifacts are
portable.  ``load_exported`` runs an artifact on the device the caller
asks for, wherever it was written.

Every path reads its weights (and folds the generator's BatchNorm) once, at
construction, onto the device of ``ds``; later changes to the modules are
not seen.  The int8 path and the kernels (``use_pallas=True``, the
``use_pallas`` artifacts) take the baseline MLP models only and raise
``ValueError`` for another.
"""

from __future__ import annotations

import copy
import os
from collections import OrderedDict
from typing import Callable, Sequence

import torch
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode

from .data.dataset import ThzDataset, denormalize_params
from .models.blocks import bf16_twin
from .models.forward_model import ForwardMLP
from .models.generator import MLPGenerator
from .ops.fused_kernels import (
    RESIDUAL_CROSSOVER,
    WGMMA,
    PackedChain,
    PackedResidual,
    fused_dense_chain,
    fused_mlp_forward,
    fused_residual_chain,
    pack_forward_model,
    pack_generator,
    pack_residual,
    packed_op_args,
    residual_chain_covers,
    shape_name,
)
from .ops.quantized import (
    int8_forward_apply,
    int8_generator_apply,
    quantize_forward,
    quantize_generator,
)
from .utils import profiling

InverseDesignFn = Callable[
    [torch.Tensor], tuple[torch.Tensor, torch.Tensor, torch.Tensor]
]


def serving_dtype(compute_dtype) -> str:
    """The serving dtype a ``compute_dtype`` names: "float32" (None),
    "bfloat16" or "int8"."""
    if compute_dtype is None or compute_dtype in ("float32", torch.float32):
        return "float32"
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return "bfloat16"
    if compute_dtype in ("int8", torch.int8):
        return "int8"
    raise ValueError(f"compute_dtype {compute_dtype!r}: use None | bfloat16 | int8")


# ---------------------------------------------------------------------------
# Stages: one model's serving form as a module (its tensors are buffers or
# parameters, so torch.export bakes them in and .to() moves them).  Every
# stage returns float32.
# ---------------------------------------------------------------------------


# A module stage's graphs.  The callers that replay them: the benchmark's
# design cells (one request shape a stage), chip_smoke.py's serving phase
# (four batches, REQUEST_BATCHES) and examples/torch_serving_bench.py (nine,
# one after another).  Four graphs hold every shape of the first two at
# once; the keys remembered bound the bookkeeping, and traffic that cycles
# through up to sixteen shapes pays each capture once (ModuleStage).
GRAPHS_PER_STAGE = 4   # graphs a module stage keeps, least recently used out
SHAPES_SEEN = 16       # keys a module stage remembers: called once, or captured
GRAPH_WARMUP = 3       # eager calls on the capture stream before a capture
                       # (torch.cuda.make_graphed_callables's count)


def _capturable(x: torch.Tensor) -> bool:
    """Whether a module stage may capture or replay a CUDA graph for ``x``
    (and a residual stage launch its kernel): a real tensor on the card, in
    an inference-mode call (the serving callables') that nothing traces or
    intercepts (``torch.export``, ``torch.compile``, fake tensors, a dispatch
    mode such as ``ops/costs.py``'s ``FlopCounterMode``) or captures already."""
    return (x.is_cuda and not torch.compiler.is_compiling() and type(x) is torch.Tensor
            and torch.is_inference_mode_enabled() and _get_current_dispatch_mode() is None
            and not torch.cuda.is_current_stream_capturing())


class _Graph:
    """A stage's eval-mode forward captured for one input (shape, dtype,
    device): a static input that each call fills with one device-to-device
    copy, the graph, and its static outputs in the graph's own memory pool,
    freed with the graph.  A call returns copies of the outputs."""

    def __init__(self, forward: Callable, x: torch.Tensor):
        with torch.cuda.device(x.device):
            self.input = x.clone()
            self.graph = torch.cuda.CUDAGraph()
            capture = torch.cuda.graph(self.graph)
            # the warm-up on the capture stream itself: PyTorch's one capture
            # stream a process, so cuBLAS makes its workspace for it once,
            # outside any graph's pool, and not once a stage
            stream = capture.capture_stream
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for _ in range(GRAPH_WARMUP):
                    forward(self.input)
            with capture:
                self.outputs = forward(self.input)
            torch.cuda.current_stream().wait_stream(stream)

    def __call__(self, x: torch.Tensor):
        self.input.copy_(x)
        self.graph.replay()
        if isinstance(self.outputs, tuple):
            return tuple(t.clone() for t in self.outputs)
        return self.outputs.clone()


class ModuleStage(nn.Module):
    """A model's eval-mode forward (fp32 or its bf16 twin), outputs in fp32.

    On the card, in an inference-mode call (the serving callables'), the
    forward runs as a CUDA graph, so a request costs the host a copy in,
    one graph launch and a copy out whatever the module's kernel count: the
    first call with an input's (shape, dtype, device) runs eagerly, the
    second captures a graph for it, and every later call replays that.  A
    stage keeps ``GRAPHS_PER_STAGE`` graphs, least recently used out, and
    never captures again a key whose graph it evicted while it remembers
    the key (``SHAPES_SEEN`` keys, least recently seen out): traffic that
    cycles through more shapes than it keeps graphs for replays some and
    runs the rest eagerly, and pays each capture at most once.
    ``replayed`` says whether the last call replayed.  Each call returns
    fresh tensors; a module in train mode, a CPU call and a call that
    ``_capturable`` refuses run eagerly.  A graph's input and outputs are buffers of the
    stage, not of the call: a stage serves one caller at a time, on one
    stream."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module.eval()
        self.replayed = False
        self._graphs: OrderedDict = OrderedDict()     # key -> _Graph, most recent last
        self._seen: OrderedDict = OrderedDict()       # key -> captured once, most recent last

    def _eager(self, x: torch.Tensor):
        out = self.module(x)
        if isinstance(out, tuple):
            return tuple(t.to(torch.float32) for t in out[:2])
        return out.to(torch.float32)

    def _graph(self, x: torch.Tensor) -> _Graph | None:
        """The graph to replay for ``x``, captured now if this is the second
        call with its key; None to run eagerly."""
        key = (x.shape, x.dtype, x.device)
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            return graph
        captured = self._seen.pop(key, None)          # None: a first call
        self._seen[key] = captured is not None
        if len(self._seen) > SHAPES_SEEN:
            self._seen.popitem(last=False)
        if captured is not False:                     # a first call, or evicted
            return None
        graph = self._graphs[key] = _Graph(self._eager, x)
        profiling.count(profiling.GRAPH_CAPTURES)
        if len(self._graphs) > GRAPHS_PER_STAGE:
            self._graphs.popitem(last=False)
        return graph

    def forward(self, x: torch.Tensor):
        graph = None
        if not self.module.training and _capturable(x):
            graph = self._graph(x)
        self.replayed = graph is not None
        if graph is None:
            return self._eager(x)
        profiling.count(profiling.GRAPH_REPLAYS)
        return graph(x)


class ResidualStage(ModuleStage):
    """The residual generator's stage on the card: its chain packed once, at
    construction (BatchNorm folded: ``fused_kernels.pack_residual``), and a
    call of ``crossover`` rows or more served by one launch of the residual
    chain kernel (``fused_residual_chain``), where the model is in eval mode,
    the input float32, 2-D, contiguous and on the chain's card, and the call
    one that ``_capturable`` admits (nothing traces or intercepts it).  Any
    other call runs the module stage's path, its CUDA graphs included.
    ``launched`` says whether the last call launched the kernel."""

    crossover = RESIDUAL_CROSSOVER

    def __init__(self, module: nn.Module, packed: PackedResidual):
        super().__init__(module)
        self._packed = packed
        self.launched = False

    def takes_kernel(self, x: torch.Tensor) -> bool:
        # _capturable first: under torch.export x's rows may be symbolic
        return (not self.module.training and _capturable(x) and x.dtype == torch.float32
                and x.dim() == 2 and x.is_contiguous() and x.device == self._packed.device
                and x.shape[0] >= self.crossover)

    def forward(self, x: torch.Tensor):
        self.launched = self.takes_kernel(x)
        if not self.launched:
            return super().forward(x)
        self.replayed = False
        return fused_residual_chain(x, self._packed)


class FusedStage(nn.Module):
    """A packed chain through its fused kernel: K6 for the generator, K5 for
    the surrogate (split at ``spectrum_dim``).  With ``via_ops`` it calls the
    kernels' custom ops on its buffer, which torch.export can trace;
    without, the wrappers on the packed chain, which stays on the device it
    was packed on."""

    def __init__(self, packed: PackedChain, spectrum_dim: int | None = None,
                 via_ops: bool = False):
        super().__init__()
        self.register_buffer("weights", packed.weights)
        self._packed = packed
        self._layout = packed_op_args(packed)
        self.spectrum_dim = spectrum_dim
        self.via_ops = via_ops

    def shape(self, x: torch.Tensor) -> str:
        """The launch shape of the kernel for ``x`` (``fused_kernels.shape_name``)."""
        return shape_name(x, self._packed)

    def forward(self, x: torch.Tensor):
        if self.via_ops:
            ops = torch.ops.pigan_thz
            if self._packed.layer_norm:
                out = ops.fused_mlp_forward(x, self.weights, *self._layout, 0.2, 1e-6)
            else:
                out = ops.fused_dense_chain(x, self.weights, *self._layout)
        elif self._packed.layer_norm:
            out = fused_mlp_forward(x, self._packed)
        else:
            out = fused_dense_chain(x, self._packed)
        if self.spectrum_dim is None:
            return out
        return out[:, :self.spectrum_dim], out[:, self.spectrum_dim:]


class Int8Stage(nn.Module):
    """An int8 chain of ``ops/quantized.py``: the generator's
    (``spectrum_dim`` None) or the surrogate's."""

    def __init__(self, q_chain, spectrum_dim: int | None = None):
        super().__init__()
        layers, head = q_chain
        self._arity = [len(t) for t in layers]
        for i, tensors in enumerate([*layers, head]):
            for j, t in enumerate(tensors):
                self.register_buffer(f"q{i}_{j}", t.detach().clone())
        self.spectrum_dim = spectrum_dim

    def _chain(self):
        tensors = [tuple(getattr(self, f"q{i}_{j}") for j in range(n))
                   for i, n in enumerate([*self._arity, 3])]
        return tensors[:-1], tensors[-1]

    def forward(self, x: torch.Tensor):
        if self.spectrum_dim is None:
            return int8_generator_apply(self._chain(), x)
        return int8_forward_apply(self._chain(), x, self.spectrum_dim)


class MeanStage(nn.Module):
    """The members' eval-mode predictions, averaged in fp32."""

    def __init__(self, members: Sequence[nn.Module]):
        super().__init__()
        self.members = nn.ModuleList(m.eval() for m in members)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([m(x).to(torch.float32) for m in self.members]).mean(dim=0)


def _replayed(stage: nn.Module) -> int:
    """1 where ``stage``'s last call replayed a CUDA graph, else 0."""
    return int(isinstance(stage, ModuleStage) and stage.replayed)


def _shape(stage: nn.Module, x: torch.Tensor) -> str:
    """The launch shape a fused stage's kernel takes for ``x``, "wgmma" where
    a residual stage's last call launched the residual chain kernel, and
    "module" for any other stage or call."""
    if isinstance(stage, FusedStage):
        return stage.shape(x)
    if isinstance(stage, ResidualStage) and stage.launched:
        return WGMMA
    return "module"


class Designer(nn.Module):
    """The cycle: generator stage -> surrogate stage, params denormalised."""

    def __init__(self, generator: nn.Module, surrogate: nn.Module, ds: ThzDataset):
        super().__init__()
        self.generator, self.surrogate = generator, surrogate
        self.register_buffer("lo", ds.param_lo.clone())
        self.register_buffer("hi", ds.param_hi.clone())

    def forward(self, spectra: torch.Tensor):
        # the stages' forward, not __call__: the hook machinery costs the
        # host a few µs a module, which shows in a request's latency at B = 1;
        # a span's ``replayed`` is 1 where its stage replayed a CUDA graph;
        # its ``shape`` names the launch shape of its stage's kernel
        with profiling.span("pigan.serve.gen_stage") as s:
            pn = self.generator.forward(spectra)
            if s.on:
                s.set(replayed=_replayed(self.generator), shape=_shape(self.generator, spectra))
        with profiling.span("pigan.serve.fwd_stage", follows=True) as s:
            spec, met = self.surrogate.forward(pn)
            if s.on:
                s.set(replayed=_replayed(self.surrogate), shape=_shape(self.surrogate, pn))
        return denormalize_params(pn, self.lo, self.hi), spec, met


class GeneratorArtifact(nn.Module):
    """spectra -> physical params through a generator stage."""

    def __init__(self, generator: nn.Module, ds: ThzDataset):
        super().__init__()
        self.generator = generator
        self.register_buffer("lo", ds.param_lo.clone())
        self.register_buffer("hi", ds.param_hi.clone())

    def forward(self, spectra: torch.Tensor) -> torch.Tensor:
        return denormalize_params(self.generator(spectra), self.lo, self.hi)


def _copy(module: nn.Module, device, kind: str) -> nn.Module:
    """An eval-mode copy of ``module`` on ``device`` computing in ``kind``,
    its tensors its own (a member bound to a stacked buffer is copied out)."""
    twin = bf16_twin(module) if kind == "bfloat16" else copy.deepcopy(module)
    with torch.no_grad():
        for t in [*twin.parameters(), *twin.buffers()]:
            t.data = t.data.to(device, copy=True)
    return twin.eval().requires_grad_(False)


def _stage(model, device, kind: str, fused: bool, spectrum_dim: int | None = None,
           via_ops: bool = False, residual: bool = False) -> nn.Module:
    """One model's serving stage: the generator's (``spectrum_dim`` None) or
    the surrogate's, through its kernel, its int8 chain or its module
    (with ``residual`` its module and the residual chain kernel)."""
    generator = spectrum_dim is None
    if fused:
        pack = pack_generator if generator else pack_forward_model
        return FusedStage(pack(model, device), spectrum_dim, via_ops)
    if kind == "int8":
        quantize = quantize_generator if generator else quantize_forward
        return Int8Stage(quantize(model), spectrum_dim).to(device)
    if residual:
        return ResidualStage(_copy(model, device, kind), pack_residual(model, device))
    return ModuleStage(_copy(model, device, kind))


def _check_pallas(use_pallas, kind: str) -> bool:
    """Whether the path is the fused kernels' (None: fp32's default)."""
    if use_pallas and kind != "float32":
        raise ValueError("use_pallas and compute_dtype are mutually exclusive "
                         "(the fused kernels run fp32)")
    return kind == "float32" if use_pallas is None else bool(use_pallas)


def kernel_covers(model: nn.Module) -> bool:
    """Whether a TPU kernel (K6 / K5) serves this model: the baseline
    ``MLPGenerator`` and ``ForwardMLP``, by type."""
    return isinstance(model, (MLPGenerator, ForwardMLP))


def serves_residual(model: nn.Module, device, kind: str, use_pallas) -> bool:
    """Whether the designer gives ``model`` a ``ResidualStage``: the default
    fp32 path (``use_pallas`` None) on the card, for a model the residual
    chain kernel covers (``fused_kernels.residual_chain_covers``)."""
    return (use_pallas is None and kind == "float32" and torch.device(device).type == "cuda"
            and residual_chain_covers(model))


def _designer(generator, forward_model, ds, use_pallas, compute_dtype,
              via_ops: bool = False) -> Designer:
    kind = serving_dtype(compute_dtype)
    fused = _check_pallas(use_pallas, kind)
    device = ds.param_lo.device

    def stage_fused(model):
        # None: the kernel where one covers the model; True raises in the
        # packing for a model it does not cover
        return fused and (use_pallas is not None or kernel_covers(model))

    return Designer(
        _stage(generator, device, kind, stage_fused(generator), via_ops=via_ops,
               residual=serves_residual(generator, device, kind, use_pallas)),
        _stage(forward_model, device, kind, stage_fused(forward_model), ds.spectrum_dim,
               via_ops), ds)


def _serving_fn(module: nn.Module) -> InverseDesignFn:
    @torch.inference_mode()
    def fn(spectra: torch.Tensor):
        return module.forward(spectra)

    return fn


def make_inverse_design_fn(
    generator: nn.Module,
    forward_model: nn.Module,
    ds: ThzDataset,
    use_pallas: bool | None = None,
    compute_dtype=None,
) -> InverseDesignFn:
    """Serving callable: spectra (B, S) float32, contiguous, on the device of
    ``ds`` -> (params_phys (B, 4), recon_spectrum (B, S), metrics (B, 8)),
    all float32.

    ``use_pallas`` None (the default) serves fp32 through the fused kernel
    of each stage whose model is the baseline (``kernel_covers``: K6 for
    the ``MLPGenerator``, K5 for the ``ForwardMLP``) and through the module
    for a stage that no kernel covers (an enhanced variant; on the card the
    ``ResidualGenerator`` with BatchNorm through the residual chain kernel
    from its crossover up: ``ResidualStage``), and the other
    dtypes on their own paths; True asks for the kernels (``ValueError``
    for an enhanced model, as the packing refuses its layout, and with a
    ``compute_dtype``, as the kernels run fp32); False serves fp32 through
    the modules' eval-mode forward."""
    return _serving_fn(_designer(generator, forward_model, ds, use_pallas, compute_dtype))


def _ensemble_designer(generators, forward_model, ds, compute_dtype) -> Designer:
    kind = serving_dtype(compute_dtype)
    if kind == "int8":
        raise ValueError("int8 covers the single-model designer only")
    generators = list(generators)
    if not generators:
        raise ValueError("make_ensemble_inverse_design_fn: no member generators")
    device = ds.param_lo.device
    # one eval-mode skeleton and every member's tensors: a member bound to a
    # stacked buffer is read through its state_dict, not deep-copied
    skeleton = _copy(generators[0], device, kind)
    members = []
    for g in generators:
        member = copy.deepcopy(skeleton)
        member.load_state_dict({k: v.detach() for k, v in g.state_dict().items()})
        members.append(member)
    return Designer(MeanStage(members), ModuleStage(_copy(forward_model, device, kind)), ds)


def make_ensemble_inverse_design_fn(
    generators: Sequence[nn.Module],
    forward_model: nn.Module,
    ds: ThzDataset,
    compute_dtype=None,
) -> InverseDesignFn:
    """Ensemble-mean serving: spectra (B, S) float32 on the device of ``ds``
    -> (params_phys (B, 4), recon_spectrum (B, S), metrics (B, 8)).

    ``generators`` are the members' G modules (``[st.g for st in states]`` of
    an ``EnsembleState``; ``parallel/ensemble.py:evaluate_ensemble_mean`` is
    the scoring twin of this path).  Each member predicts in eval mode, its
    BatchNorm on its own running stats; the normalised predictions are
    averaged in fp32, denormalised, and ``forward_model`` reconstructs the
    spectrum and metrics of the mean.  ``compute_dtype`` bfloat16 runs the
    members and F as their bf16 twins.  Plain PyTorch on either device, as
    the JAX package's is plain XLA."""
    return _serving_fn(_ensemble_designer(generators, forward_model, ds, compute_dtype))


# ---------------------------------------------------------------------------
# Exported artifacts
# ---------------------------------------------------------------------------


def _save(module: nn.Module, example: torch.Tensor, path: str) -> str:
    program = torch.export.export(module.eval(), (example,))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return path


def _spectra_example(ds: ThzDataset, batch_size: int) -> torch.Tensor:
    return torch.zeros((batch_size, ds.spectrum_dim), device=ds.param_lo.device)


def export_generator(
    generator: nn.Module, ds: ThzDataset, path: str, batch_size: int = 64,
    compute_dtype=None,
) -> str:
    """spectrum (B, S) -> physical params (B, 4), the generator's eval-mode
    forward in fp32 or (``compute_dtype`` bfloat16) its bf16 twin; a
    ``torch.export`` program (``.pt2``) for ``batch_size`` rows."""
    kind = serving_dtype(compute_dtype)
    if kind == "int8":
        raise ValueError("int8 covers the designer and the surrogate, not the generator")
    stage = _stage(generator, ds.param_lo.device, kind, fused=False)
    return _save(GeneratorArtifact(stage, ds), _spectra_example(ds, batch_size), path)


def export_forward_surrogate(
    forward_model: nn.Module, ds: ThzDataset, path: str, batch_size: int = 64,
    use_pallas: bool = False, compute_dtype=None,
) -> str:
    """normalised params (B, 4) -> (spectrum (B, S), metrics (B, 8)).

    ``use_pallas`` bakes the fused forward kernel (K5, as its custom op) in;
    ``compute_dtype`` "int8" the post-training-quantized chain; bfloat16 the
    bf16 twin; both together raise ValueError."""
    kind = serving_dtype(compute_dtype)
    fused = _check_pallas(use_pallas, kind)
    stage = _stage(forward_model, ds.param_lo.device, kind, fused, ds.spectrum_dim,
                   via_ops=True)
    example = torch.zeros((batch_size, ds.params_norm.shape[1]), device=ds.param_lo.device)
    return _save(stage, example, path)


def export_inverse_design(
    generator: nn.Module, forward_model: nn.Module, ds: ThzDataset, path: str,
    batch_size: int = 64, use_pallas: bool = False, compute_dtype=None,
) -> str:
    """The full cycle of ``make_inverse_design_fn`` (spectrum -> physical
    params, surrogate spectrum, metrics) as a ``torch.export`` program.
    ``use_pallas`` bakes K6 and K5 in as custom ops (one launch of each a
    call on the card); the default is the portable modules' path."""
    module = _designer(generator, forward_model, ds, use_pallas, compute_dtype, via_ops=True)
    return _save(module, _spectra_example(ds, batch_size), path)


def export_ensemble_inverse_design(
    generators: Sequence[nn.Module], forward_model: nn.Module, ds: ThzDataset, path: str,
    batch_size: int = 64, compute_dtype=None,
) -> str:
    """The ensemble-mean cycle of ``make_ensemble_inverse_design_fn`` as a
    portable ``torch.export`` program, every member's weights baked in."""
    module = _ensemble_designer(generators, forward_model, ds, compute_dtype)
    return _save(module, _spectra_example(ds, batch_size), path)


def load_exported(path: str, device: torch.device | str = "cuda"):
    """A callable that runs the ``torch.export`` program at ``path`` on
    ``device`` (its weights moved there, wherever it was written).  Inputs
    of another shape than the program's raise ValueError."""
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(torch.export.load(path), torch.device(device))
    names = set(program.graph_signature.user_inputs)
    shapes = [tuple(n.meta["val"].shape) for n in program.graph.nodes
              if n.op == "placeholder" and n.name in names]
    module = program.module()

    def call(*args):
        got = [tuple(a.shape) for a in args]
        if got != shapes:
            raise ValueError(f"{path}: exported for inputs of shape {shapes}, got {got}")
        with torch.inference_mode():
            return module(*args)

    return call
