"""Layer-stacked floating-point matmul — the unquantized decode twin of
int4_group_matmul_stacked (plain XLA).

A bf16 model decoded under lax.scan keeps its whole (L, K, O) weight stack
loop-invariant; layer `layer_idx` is read with a dynamic index that feeds
the dot, the same no-slice-as-scan-xs structure the packed path uses, so
the bf16 baseline in bench.py and bf16 serving get the same compile-once
scan decode as packed models (models.llama.pack_fp_decode).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def fp_matmul_stacked(
    layer_idx: jax.Array,   # () or (1,) int32 — which layer's weights to read
    x: jax.Array,           # (N, K) bf16/f32 activations
    w_t: jax.Array,         # (L, K, O) — ALL layers, transposed weights
    *,
    out_dtype=None,
) -> jax.Array:
    assert w_t.shape[1] == x.shape[1], (w_t.shape, x.shape)
    i = jnp.asarray(layer_idx, jnp.int32).reshape(())
    w = jax.lax.dynamic_index_in_dim(w_t, i, keepdims=False)
    y = jnp.dot(x, w.astype(x.dtype), preferred_element_type=jnp.float32)
    return y.astype(out_dtype or x.dtype)
