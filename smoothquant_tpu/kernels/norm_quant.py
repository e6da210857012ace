"""Normalization + quantization (LayerNormQ equivalents, plain XLA).

The reference's real-INT8 path uses torch_int's LayerNormQ: LayerNorm whose
output is emitted directly as int8 with a static calibrated scale
(opt.py:16,220,239-252).  Here the norm, scale division, rounding and
saturation are one chain of elementwise ops and row reductions that XLA
fuses into a single pass over x; the RMSNorm variant serves the Llama
family (which the reference never had — its Llama path was simulation-only).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("eps", "rms"))
def norm_quant(
    x: jax.Array,        # (N, C)
    gamma: jax.Array,    # (C,)
    beta: jax.Array,     # (C,) — zeros for RMSNorm
    scale: jax.Array,    # scalar f32 static output scale
    *,
    eps: float = 1e-5,
    rms: bool = False,
) -> jax.Array:
    xf = x.astype(jnp.float32)
    if rms:
        y = xf * jax.lax.rsqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + eps)
    else:
        mean = jnp.mean(xf, axis=-1, keepdims=True)
        var = jnp.var(xf, axis=-1, keepdims=True)
        y = (xf - mean) * jax.lax.rsqrt(var + eps)
    y = y * gamma.astype(jnp.float32) + beta.astype(jnp.float32)
    inv = 1.0 / jnp.asarray(scale, jnp.float32)
    return jnp.clip(jnp.round(y * inv), -127, 127).astype(jnp.int8)


def layer_norm_q(x, gamma, beta, scale, eps=1e-5):
    """torch_int LayerNormQ equivalent (opt.py:239-252)."""
    return norm_quant(x, gamma, beta, scale, eps=eps, rms=False)


def rms_norm_q(x, gamma, scale, eps=1e-6):
    """RMSNorm → int8 with static scale (Llama-family real path)."""
    return norm_quant(x, gamma, jnp.zeros_like(gamma), scale, eps=eps,
                      rms=True)
