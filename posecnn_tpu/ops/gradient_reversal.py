"""Gradient reversal (domain adaptation, Ganin & Lempitsky).

JAX equivalent of the `Gradientreversal` CUDA op
(ref: lib/gradient_reversal_layer/gradient_reversal_op.cc: identity
forward, −λ·grad backward): a two-line custom_vjp — exactly the kind
of op where a hand-written CUDA kernel dissolves into the autodiff
system on the JAX side.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from functools import partial


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def gradient_reversal(x: jnp.ndarray, lambda_: float = 1.0) -> jnp.ndarray:
    return x


def _fwd(x, lambda_):
    return x, None


def _bwd(lambda_, _, g):
    return (-lambda_ * g,)


gradient_reversal.defvjp(_fwd, _bwd)
