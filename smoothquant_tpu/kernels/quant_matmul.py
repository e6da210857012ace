"""Dual-path quantized matmul, dequantize route (plain XLA).

    y = x_sal @ w_sal + x_ns @ (w_q * scales)

The weight lives in device memory as int4-range values in an int8 container
with per-(row, group) scales, and the salient columns as a small dense
block.  The dequantized weight is formed in the compute dtype and contracted
with f32 accumulation.  This is the `compute="dequant"` route of
real_quant_linear, for recipes whose activations the integer route cannot
take (act_bits > 8, or activation groups that do not match weight groups).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("group_size", "out_dtype"))
def dual_path_matmul(
    x_ns: jax.Array,       # (N, K_ns) bf16/f32, already act-quantized (Q-DQ)
    x_sal: jax.Array,      # (N, K_s)  bf16/f32, full-precision salient slice
    w_qt: jax.Array,       # (K_ns, O) int8 (int4-range values), transposed
    w_scales_t: jax.Array,  # (K_ns // group_size, O) f32
    w_sal_t: jax.Array,    # (K_s, O)  bf16/f32, transposed
    *,
    group_size: int,
    out_dtype=jnp.float32,
) -> jax.Array:
    k_ns, o = w_qt.shape
    k_s = x_sal.shape[1]
    assert w_sal_t.shape == (k_s, o)
    assert k_ns % group_size == 0
    g = w_scales_t.shape[0]
    assert g in (1, k_ns // group_size)
    cdt = x_ns.dtype
    w = (w_qt.astype(jnp.float32).reshape(g, -1, o)
         * w_scales_t.astype(jnp.float32)[:, None, :]).reshape(k_ns, o)
    y = jnp.dot(x_ns, w.astype(cdt), preferred_element_type=jnp.float32)
    if k_s:
        y = y + jnp.dot(x_sal, w_sal_t.astype(x_sal.dtype),
                        preferred_element_type=jnp.float32)
    return y.astype(out_dtype)
