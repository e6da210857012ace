"""Integer-compute group matmul for int8-container weights (plain XLA).

    out[n, o] = Σ_g s_x[n, g] · s_w[g, o] · Σ_{c∈g} x_int[n, c] · w_int[c, o]
                + x_sal @ w_sal

Per group, the s8×s8 product accumulates in int32 (one batched
`dot_general` over the groups) and the two scales are applied to the
(G, N, O) partials — exactly the Q-DQ float semantics of the simulation
(per-token or per-group activation scales × per-(row, group) weight
scales), up to f32 rounding order.  Off the serving hot path: the decode
path stores weights nibble-packed (kernels/int4_group_matmul.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("group_size", "out_dtype"))
def int_group_matmul(
    x_q: jax.Array,        # (N, K) int8 — integer-quantized activations
    x_scales: jax.Array,   # (N, G) f32 — per-(token, group) act scales
    w_qt: jax.Array,       # (K, O) int8
    w_scales_t: jax.Array,  # (G, O) f32
    x_sal: jax.Array,      # (N, K_s) bf16/f32 salient slice (fp path)
    w_sal_t: jax.Array,    # (K_s, O) bf16/f32
    *,
    group_size: int,
    out_dtype=jnp.float32,
) -> jax.Array:
    n, kk = x_q.shape
    o = w_qt.shape[1]
    g = kk // group_size
    assert kk % group_size == 0
    assert x_scales.shape == (n, g)
    assert w_scales_t.shape == (g, o)
    acc = jax.lax.dot_general(
        x_q.reshape(n, g, group_size), w_qt.reshape(g, group_size, o),
        dimension_numbers=(((2,), (1,)), ((1,), (0,))),
        preferred_element_type=jnp.int32)                      # (G, N, O)
    y = jnp.sum(acc.astype(jnp.float32)
                * x_scales.T.astype(jnp.float32)[:, :, None]
                * w_scales_t.astype(jnp.float32)[:, None, :], axis=0)
    if x_sal.shape[1]:
        y = y + jax.lax.dot_general(
            x_sal, w_sal_t.astype(x_sal.dtype),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
    return y.astype(out_dtype)
