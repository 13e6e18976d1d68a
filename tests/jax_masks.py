"""The JAX package's dropout masks, made with numpy and handed to both sides.

flax draws its masks from threefry and the port from its hash, so a
train-mode comparison carries the masks across.  ``MaskPlan.apply()``
replaces, while active, every mask the JAX models draw:

- ``flax.linen.Dropout.__call__``, through ``flax.linen.intercept_methods``;
- attention-weight dropout, which flax draws inside
  ``flax.linen.attention.dot_product_attention_weights`` (no Dropout
  module): that function is wrapped to run without dropout and then take
  the plan's mask, of flax's ``broadcast_dropout`` shape (1, 1, Q, K).

Each top-level model call (a root module of ``plan``) opens a mask *set*
named by the plan (a list of names that cycle per model, in trace order: a
JAX step reusing one dropout key for two calls names one set twice; or a
function of the call's arguments), and its dropout layers, in
the order they run, take the set's masks by index, drawn once from numpy.
``MaskPlan.provider(sets)`` hands the same masks to the port's
``models.blocks.dropout_masks`` / the steps' ``draws["dropout"]``.

Shared by tests/test_torch_enhanced_models.py and
tests/test_torch_enhanced_train.py.
"""

import contextlib

import flax.linen as nn
import flax.linen.attention as fattn
import jax.numpy as jnp
import numpy as np
import torch


class MaskPlan:
    def __init__(self, seed: int, plan: dict):
        self.rng = np.random.default_rng(seed)
        self.plan = plan
        self.sets: dict = {}          # (set, layer) -> (bool mask, rate)
        self.counts: dict = {}
        self.current = None
        self.layer = 0

    def _mask(self, shape, rate) -> np.ndarray:
        key = (self.current, self.layer)
        self.layer += 1
        if key not in self.sets:
            self.sets[key] = (self.rng.random(tuple(shape)) < 1.0 - rate, rate)
        mask, r = self.sets[key]
        assert mask.shape == tuple(shape) and r == rate, (key, mask.shape, shape, r, rate)
        return mask

    def _interceptor(self, next_fun, args, kwargs, context):
        m = context.module
        if context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        if m.path == ():
            names = self.plan.get(type(m).__name__)
            if callable(names):
                self.current, self.layer = names(args), 0
            elif names is not None:
                c = self.counts.get(type(m).__name__, 0)
                self.counts[type(m).__name__] = c + 1
                self.current, self.layer = names[c % len(names)], 0
            return next_fun(*args, **kwargs)
        if isinstance(m, nn.Dropout):
            det = kwargs.get("deterministic")
            det = m.deterministic if det is None else det
            if det or m.rate == 0.0:
                return next_fun(*args, **kwargs)
            x = args[0]
            mask = self._mask(x.shape, m.rate)
            return jnp.where(mask, x / (1.0 - m.rate), jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    @contextlib.contextmanager
    def apply(self):
        original = fattn.dot_product_attention_weights

        def weights(query, key, bias=None, mask=None, broadcast_dropout=True,
                    dropout_rng=None, dropout_rate=0.0, deterministic=False, *args, **kw):
            w = original(query, key, bias, mask, broadcast_dropout, None, 0.0, True,
                         *args, **kw)
            if deterministic or dropout_rate == 0.0:
                return w
            assert broadcast_dropout
            shape = (1,) * (key.ndim - 2) + w.shape[-2:]
            keep = 1.0 - dropout_rate
            mask = self._mask(shape, dropout_rate)
            return w * (jnp.asarray(mask, w.dtype) / jnp.asarray(keep, w.dtype))

        fattn.dot_product_attention_weights = weights
        try:
            with nn.intercept_methods(self._interceptor):
                yield self
        finally:
            fattn.dot_product_attention_weights = original

    def scale(self, name, layer, shape, rate, device="cpu") -> torch.Tensor:
        mask, r = self.sets[(name, layer)]
        assert tuple(mask.shape) == tuple(shape) and r == rate, (
            name, layer, mask.shape, shape, r, rate)
        return torch.where(torch.from_numpy(mask), 1.0 / (1.0 - rate), 0.0).to(
            torch.float32).to(device)

    def masks(self, name):
        """A ``dropout_masks`` provider: the set ``name``."""
        return lambda layer, shape, rate, device: self.scale(name, layer, shape, rate, device)

    def provider(self, sets):
        """A steps' ``draws["dropout"]`` provider: ``sets[stream]`` names the
        set of each call of the step, or is a function of the mask's shape."""
        def fn(stream, layer, shape, rate, device):
            name = sets[stream]
            name = name(shape) if callable(name) else name
            return self.scale(name, layer, shape, rate, device)
        return fn
