"""Int8 matmul with a per-token × per-column scale epilogue + salient path.

    out[n, o] = s_x[n] · s_w[o] · Σ_k x8[n, k] · w8[k, o]
                + Σ_s x_sal[n, s] · w_sal[s, o]

The promoted-int8 prefill recipe (kernels/pack.py:promote_int8) and the
int8 lm_head.  The route is XLA's s8×s8→s32 `dot_general`, which the GPU
backend lowers to an int8 tensor-core GEMM, followed by the f32 scale
epilogue and the salient dot — the design of the reference's W8A8 CUTLASS
GEMMs (torch_int W8A8BFP32OFP32Linear) with dynamic per-token activation
scales instead of static calibration scales.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def int8_prefill_matmul(
    x_q: jax.Array,        # (N, K) int8 quantized acts — or RAW bf16/f32
    #                        acts when ns_mask is given (quantized here)
    sx: jax.Array,         # (N, 1) f32 per-token activation scales
    w_qt: jax.Array,       # (K, O) int8 — per-column quantized weight
    sw_t: jax.Array,       # (1, O) f32 per-output-column weight scales
    x_sal: jax.Array,      # (N, K_s) bf16/f32 salient activation slice
    w_sal_t: jax.Array,    # (K_s, O) bf16/f32 salient weight columns
    ns_mask: jax.Array = None,  # (1, K) 0/1 non-salient mask — presence
    #                        means x_q holds raw activations: round(x·m/sx)
    *,
    out_dtype=jnp.bfloat16,
) -> jax.Array:
    n, kk = x_q.shape
    o = w_qt.shape[1]
    assert sx.shape == (n, 1) and sw_t.shape == (1, o)
    if ns_mask is not None:
        x_q = jnp.round(x_q.astype(jnp.float32)
                        * ns_mask.astype(jnp.float32) / sx).astype(jnp.int8)
    acc = jax.lax.dot_general(
        x_q, w_qt, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * sx * sw_t.astype(jnp.float32)
    if x_sal.shape[1]:
        y = y + jax.lax.dot_general(
            x_sal, w_sal_t.astype(x_sal.dtype),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
    return y.astype(out_dtype)
