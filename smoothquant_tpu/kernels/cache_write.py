"""Decode KV-cache write into a layer-stacked int8 cache (plain XLA).

Writes ONE decode position's K/V into layer `layer` of a STACKED int8
cache: rotary on k, per-(slot, head) int8 quantize, and one
dynamic_update_slice per batch row and field on the carried cache.  XLA
fuses the rotary and quantize into one elementwise pass and updates the
carried buffers in place.

The int8 quantization matches QuantKVCache._quantize exactly:
scale = max(absmax, 1e-8)/127, round-to-nearest-even.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _rot_half(x):
    d = x.shape[-1]
    return jnp.concatenate([-x[..., d // 2:], x[..., : d // 2]], axis=-1)


def _quantize(x):
    absmax = jnp.max(jnp.abs(x), axis=-1)
    scale = jnp.maximum(absmax, 1e-8) / 127.0
    return jnp.round(x / scale[..., None]).astype(jnp.int8), scale


@functools.partial(jax.jit, static_argnames=("rotary",))
def write_quant_cache_stacked(
    layer_idx: jax.Array,   # scalar int32
    pos: jax.Array,         # () aligned decode position, or (B,) per-slot
    #                         positions (continuous batching)
    k_new: jax.Array,       # (B, H_kv, D) — PRE-rotary keys
    v_new: jax.Array,       # (B, H_kv, D)
    cos: jax.Array,         # (B, 1, D) rotary tables for this position
    sin: jax.Array,
    k_q: jax.Array,         # (L, B, H_kv, S, D) int8
    v_q: jax.Array,
    k_scale: jax.Array,     # (L, B, H_kv, S) f32
    v_scale: jax.Array,
    *,
    rotary: bool = True,
):
    """Returns updated (k_q, v_q, k_scale, v_scale).  rotary=False for
    non-rotary archs (OPT/Bloom) — cos/sin are ignored."""
    kf = k_new.astype(jnp.float32)
    if rotary:
        kf = (kf * cos.astype(jnp.float32)
              + _rot_half(kf) * sin.astype(jnp.float32))
    kq, ks = _quantize(kf)                                  # (B, H, D), (B, H)
    vq, vs = _quantize(v_new.astype(jnp.float32))
    return (put_rows(k_q, kq, layer_idx, pos, 3),
            put_rows(v_q, vq, layer_idx, pos, 3),
            put_rows(k_scale, ks, layer_idx, pos, 3),
            put_rows(v_scale, vs, layer_idx, pos, 3))


def put_rows(buf, rows, layer_idx, pos, s_axis: int):
    """Write rows[b] into buf[layer_idx, b, ..., pos_b, ...] in place.

    buf: (L, B, ...) with the position axis at s_axis; rows: buf's shape
    without the L and position axes; pos: () aligned or (B,) per-slot.
    dynamic_update_slice updates the carried buffer in place — one for an
    aligned position, one per batch row (B is static) otherwise — where a
    scatter over (L, B, S) with H between them makes XLA transpose the
    whole cache twice per layer.  dynamic_update_slice clamps a position
    past the cache end to the last row: a finished slot in a continuous
    batch keeps decoding, and its write lands on that (masked) row."""
    li = jnp.asarray(layer_idx, jnp.int32).reshape(())
    zero = jnp.zeros((), jnp.int32)
    pos = jnp.asarray(pos, jnp.int32)

    def put(buf, upd, b0, p):
        start = [li, b0] + [zero] * (buf.ndim - 2)
        start[s_axis] = p
        return jax.lax.dynamic_update_slice(buf, upd.astype(buf.dtype), start)

    if pos.ndim == 0:
        return put(buf, jnp.expand_dims(rows, (0, s_axis)), zero, pos)
    for bi in range(buf.shape[1]):
        buf = put(buf, jnp.expand_dims(rows[bi], (0, 1, s_axis)),
                  jnp.int32(bi), pos[bi])
    return buf
