"""Static-scale INT8 GEMMs — torch_int equivalents (plain XLA).

The reference's only real-kernel path is Int8 OPT built on six external
CUDA/CUTLASS kernels (smoothquant/opt.py:15-18; SURVEY.md §2.7).  Here each
is XLA's s8×s8→s32 `dot_general` (an int8 tensor-core GEMM on the GPU) with
the requantization (static scales, computed by calibration) as an
elementwise epilogue that XLA fuses onto the product:

  int8_linear(out=int8)            ≡ W8A8B8O8Linear
  int8_linear(out=f32)             ≡ W8A8BFP32OFP32Linear
  int8_linear(out=int8, relu=True) ≡ W8A8B8O8LinearReLU
  int8_bmm(out=f32)                ≡ BMM_S8T_S8N_F32T  (QK^T logits)
  int8_bmm(out=int8)               ≡ BMM_S8T_S8N_S8T   (PV)

Quantization convention (matching the torch_int usage in opt.py:52-85):
y_int32 = x_s8 @ w_s8^T; out = y_int32 * alpha (+ bias); int8 outputs are
rounded and saturated to [-127, 127].
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp


def _requant(acc_f32, out_dtype):
    if out_dtype == jnp.int8:
        return jnp.clip(jnp.round(acc_f32), -127, 127).astype(jnp.int8)
    return acc_f32.astype(out_dtype)


@functools.partial(jax.jit, static_argnames=("relu", "out_dtype"))
def int8_linear(
    x: jax.Array,             # (N, K) int8
    w: jax.Array,             # (O, K) int8
    alpha: jax.Array,         # scalar f32: s_x * s_w [/ s_y for int8 out]
    bias: Optional[jax.Array] = None,  # (O,) f32, pre-scaled for the output domain
    *,
    relu: bool = False,
    out_dtype=jnp.float32,
) -> jax.Array:
    assert w.shape[1] == x.shape[1]
    acc = jax.lax.dot_general(
        x, w, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(alpha, jnp.float32)
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    if relu:
        y = jnp.maximum(y, 0.0)
    return _requant(y, out_dtype)


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def int8_bmm(
    a: jax.Array,      # (B, M, K) int8
    b: jax.Array,      # (B, N, K) int8  (contracted on K: a @ b^T)
    alpha: jax.Array,  # scalar f32
    *,
    out_dtype=jnp.float32,
) -> jax.Array:
    acc = jax.lax.dot_general(
        a, b, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32)
    return _requant(acc.astype(jnp.float32) * jnp.asarray(alpha, jnp.float32),
                    out_dtype)


def quantize_to_int8(x: jax.Array, scale: jax.Array) -> jax.Array:
    """round(x / scale) saturated to [-127, 127] (static calibrated scale)."""
    return jnp.clip(
        jnp.round(x.astype(jnp.float32) / scale), -127, 127
    ).astype(jnp.int8)
