"""Plain-JAX layers for the flagship model.

A model is a frozen dataclass whose `__call__(scope, ...)` builds the
forward pass. `init` runs that pass once under `jit` with a `Scope`
that creates every parameter it is asked for (XLA drops the unused
forward outputs); `apply` runs it with a `Scope` that only reads.
Parameters form a nested dict `{"params": {module: {layer: {"kernel",
"bias"}}}}`, the layout flax uses, so snapshots, the `.npy` importer
and the sharding rules key on the same paths. Initialisers match
flax's defaults (lecun-normal kernels, zero biases), so a fresh model
has the same statistics.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()


class Scope:
    """One level of the parameter tree. With `rng` set, missing
    parameters are created; without it, they are only read."""

    def __init__(self, params: dict, rng: Optional[jax.Array] = None):
        self.params = params
        self.rng = rng

    def _key(self, name: str) -> jax.Array:
        return jax.random.fold_in(self.rng, zlib.crc32(name.encode()))

    def child(self, name: str) -> "Scope":
        if self.rng is None:
            return Scope(self.params[name])
        return Scope(self.params.setdefault(name, {}), self._key(name))

    def param(self, name: str, init_fn, shape: Sequence[int]) -> jax.Array:
        if self.rng is not None and name not in self.params:
            self.params[name] = init_fn(self._key(name), tuple(shape), jnp.float32)
        return self.params[name]


class Module:
    """init/apply entry points shared by the plain-JAX models."""

    def __call__(self, scope: Scope, *args, **kwargs):
        raise NotImplementedError

    def init(self, rng: jax.Array, *args, **kwargs) -> dict:
        # python scalars (train, keep_prob, …) stay static; arrays trace
        static = {k: v for k, v in kwargs.items() if isinstance(v, (bool, int, float, str))}
        traced = {k: v for k, v in kwargs.items() if k not in static}

        def build(rng, args, traced):
            scope = Scope({}, rng)
            self(scope, *args, **traced, **static)
            return {"params": scope.params}

        return jax.jit(build)(rng, args, traced)

    def apply(self, params: dict, *args, **kwargs):
        return self(Scope(params["params"]), *args, **kwargs)


def conv(scope: Scope, x, features: int, kernel: int, dtype) -> jax.Array:
    """Stride-1 SAME convolution, NHWC × HWIO, computed in `dtype`."""
    w = scope.param("kernel", _lecun_normal, (kernel, kernel, x.shape[-1], features))
    b = scope.param("bias", jax.nn.initializers.zeros, (features,))
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), w.astype(dtype), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y + b.astype(dtype)


def dense(scope: Scope, x, features: int, dtype) -> jax.Array:
    w = scope.param("kernel", _lecun_normal, (x.shape[-1], features))
    b = scope.param("bias", jax.nn.initializers.zeros, (features,))
    return jnp.dot(x.astype(dtype), w.astype(dtype)) + b.astype(dtype)


def max_pool_2x2(x) -> jax.Array:
    """2×2 stride-2 max pool, SAME padding."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "SAME"
    )


def dropout(x, keep_prob: float, rng: Optional[jax.Array]) -> jax.Array:
    """Inverted dropout (the mask flax's `nn.Dropout` draws for the
    same rng)."""
    if keep_prob >= 1.0:
        return x
    if rng is None:
        raise ValueError("dropout with keep_prob < 1 needs a dropout_rng")
    mask = jax.random.bernoulli(rng, p=keep_prob, shape=x.shape)
    return jax.lax.select(mask, x / keep_prob, jnp.zeros_like(x))

