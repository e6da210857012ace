"""Decode attention — one query token per sequence over the KV cache.

Two routes, one contract (q (B, H, D); K/V (B, H_kv, S, D) in the cache's
head-major layout, int8 with per-(head, position) scales or floating point;
an additive (B, S) f32 bias of 0 / NEG_INF that carries cache fill,
continuous-batching key holes and sliding windows; optional per-head ALiBi
slopes; GQA by H = rep·H_kv):

  * `_plain` — einsum over the cache as XLA compiles it.  For an int8 cache
    the scales are applied to the score and probability columns, so the
    int8 bytes are the only cache operand.
  * a Pallas flash-decoding kernel through Triton (`backend="triton"`) that
    reads the int8 K/V and their scales in place.  Each block owns one
    (sequence, KV head) and one split of the cache positions, keeps the
    rep query heads of that KV head as the rows of one `dot` (padded to 16,
    the smallest block `dot` takes), and streams S-tiles with a running
    max and denominator.  A second pass merges the splits.  Modelled on JAX's
    `pallas/ops/gpu/decode_attention.py`; written here for the int8 cache,
    the additive bias and ALiBi.

The layer-stacked form takes the whole (L, …) cache and a layer index, which
the kernel offsets by itself — the cache is never sliced per layer.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG_INF = -1e30
_M_FLOOR = NEG_INF / 2   # running-max floor: fully masked tiles give p = 0
# Cache positions per tile (at most; a power of two), how many blocks to
# keep in flight (split-S adds blocks until there are this many), and
# Triton's warps and pipeline stages.
CONFIG = dict(bs=128, target_blocks=264, num_warps=4, num_stages=2)


def supported(s: int, n_heads: int, n_kv: int, head_dim: int) -> bool:
    """The kernel's shape rule: a power-of-two head_dim (a Triton block)
    and whole GQA groups.  Any cache length works (tiles are masked)."""
    del s
    return (n_heads % n_kv == 0 and 16 <= head_dim <= 256
            and head_dim & (head_dim - 1) == 0)


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _plain(q, k, v, bias, k_scale, v_scale, alibi_slopes, sm_scale):
    b, h, d = q.shape
    n_kv, s = k.shape[1], k.shape[2]
    rep = h // n_kv
    cdt = q.dtype
    qg = q.reshape(b, n_kv, rep, d)
    scores = jnp.einsum("bgrd,bgsd->bgrs", qg, k.astype(cdt),
                        preferred_element_type=jnp.float32) * sm_scale
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :]
    if alibi_slopes is not None:
        pos = jnp.arange(s, dtype=jnp.float32)
        scores = scores + (alibi_slopes.astype(jnp.float32)
                           .reshape(1, n_kv, rep, 1) * pos)
    scores = scores + bias[:, None, None, :]
    m = jnp.maximum(jnp.max(scores, axis=-1, keepdims=True), _M_FLOOR)
    p = jnp.exp(scores - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    out = jnp.einsum("bgrs,bgsd->bgrd", p.astype(cdt), v.astype(cdt),
                     preferred_element_type=jnp.float32)
    out = out / jnp.where(l > 0.0, l, 1.0)
    return out.reshape(b, h, d).astype(q.dtype)


def _kernel(idx_ref, q_ref, k_ref, v_ref, bias_ref, *rest, quant: bool,
            alibi: bool, sm_scale: float, rep: int, rp: int, bs: int,
            tps: int, s_len: int):
    rest = list(rest)
    ks_ref, vs_ref = (rest.pop(0), rest.pop(0)) if quant else (None, None)
    sl_ref = rest.pop(0) if alibi else None
    o_ref, m_ref, l_ref = rest
    bi, hi, sp = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    layer = idx_ref[0]
    rmask = jnp.arange(rp) < rep
    q = plgpu.load(q_ref.at[bi, pl.ds(hi * rep, rp), :],
                   mask=rmask[:, None], other=0)                 # (rp, D)
    cdt = q.dtype
    slope = (plgpu.load(sl_ref.at[pl.ds(hi * rep, rp)], mask=rmask,
                        other=0) if alibi else None)

    def body(t, carry):
        acc, m_prev, l_prev = carry
        start = (sp * tps + t) * bs
        pos = start + jnp.arange(bs)
        pmask = pos < s_len
        sl = pl.ds(start, bs)
        k = plgpu.load(k_ref.at[layer, bi, hi, sl, :],
                       mask=pmask[:, None], other=0)
        sc = jnp.dot(q, k.astype(cdt).T,
                     preferred_element_type=jnp.float32) * sm_scale
        if quant:
            sc = sc * plgpu.load(ks_ref.at[layer, bi, hi, sl], mask=pmask,
                                 other=0)[None, :]
        if alibi:
            sc = sc + slope[:, None] * pos.astype(jnp.float32)[None, :]
        sc = sc + plgpu.load(bias_ref.at[bi, sl], mask=pmask,
                             other=NEG_INF)[None, :]
        m_new = jnp.maximum(m_prev, jnp.max(sc, axis=1))
        alpha = jnp.exp(m_prev - m_new)
        p = jnp.exp(sc - m_new[:, None])
        l_new = l_prev * alpha + jnp.sum(p, axis=1)
        if quant:
            p = p * plgpu.load(vs_ref.at[layer, bi, hi, sl], mask=pmask,
                               other=0)[None, :]
        v = plgpu.load(v_ref.at[layer, bi, hi, sl, :],
                       mask=pmask[:, None], other=0)
        acc = acc * alpha[:, None] + jnp.dot(
            p.astype(cdt), v.astype(cdt), preferred_element_type=jnp.float32)
        return acc, m_new, l_new

    d = q.shape[1]
    acc, m, l = jax.lax.fori_loop(
        0, tps, body,
        (jnp.zeros((rp, d), jnp.float32),
         jnp.full((rp,), _M_FLOOR, jnp.float32),
         jnp.zeros((rp,), jnp.float32)))
    o_ref[bi, hi, sp] = acc
    m_ref[bi, hi, sp] = m
    l_ref[bi, hi, sp] = l


def _kernel_call(layer_idx, q, k, v, bias, k_scale, v_scale, alibi_slopes,
                 sm_scale, interpret):
    b, h, d = q.shape
    _, _, n_kv, s, _ = k.shape
    rep = h // n_kv
    rp = max(16, _pow2(rep))
    bs = min(CONFIG["bs"], max(16, _pow2(s)))
    n_tiles = pl.cdiv(s, bs)
    want = max(1, min(n_tiles, pl.cdiv(CONFIG["target_blocks"], b * n_kv)))
    tps = pl.cdiv(n_tiles, want)
    n_split = pl.cdiv(n_tiles, tps)
    quant = k_scale is not None
    alibi = alibi_slopes is not None
    operands = [jnp.asarray(layer_idx, jnp.int32).reshape(1), q, k, v,
                bias.astype(jnp.float32)]
    if quant:
        operands += [k_scale.astype(jnp.float32), v_scale.astype(jnp.float32)]
    if alibi:
        operands.append(alibi_slopes.astype(jnp.float32))
    acc, m, l = pl.pallas_call(
        functools.partial(_kernel, quant=quant, alibi=alibi,
                          sm_scale=sm_scale, rep=rep, rp=rp, bs=bs, tps=tps,
                          s_len=s),
        grid=(b, n_kv, n_split),
        out_shape=[
            jax.ShapeDtypeStruct((b, n_kv, n_split, rp, d), jnp.float32),
            jax.ShapeDtypeStruct((b, n_kv, n_split, rp), jnp.float32),
            jax.ShapeDtypeStruct((b, n_kv, n_split, rp), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(
            num_warps=CONFIG["num_warps"], num_stages=CONFIG["num_stages"]),
        backend="triton",
        interpret=interpret,
        name="decode_attention",
    )(*operands)
    # merge the splits (flash-decoding's second pass)
    m_all = jnp.max(m, axis=2, keepdims=True)
    w = jnp.exp(m - m_all)
    l_all = jnp.sum(l * w, axis=2)
    out = jnp.sum(acc * w[..., None], axis=2)
    out = out / jnp.where(l_all > 0.0, l_all, 1.0)[..., None]
    return out[:, :, :rep].reshape(b, h, d).astype(q.dtype)


@functools.partial(jax.jit,
                   static_argnames=("sm_scale", "kernel", "interpret"))
def decode_attention_stacked(
    layer_idx: jax.Array,              # () or (1,) int32
    q: jax.Array,                      # (B, H, D) — this layer's queries
    k: jax.Array,                      # (L, B, H_kv, S, D) — ALL layers
    v: jax.Array,
    bias: jax.Array,                   # (B, S) f32 — this layer's mask bias
    k_scale: Optional[jax.Array] = None,   # (L, B, H_kv, S) when k is int8
    v_scale: Optional[jax.Array] = None,
    alibi_slopes: Optional[jax.Array] = None,  # (H,) f32 — per-head ALiBi;
    #                                    score += slope_h * key_pos (Bloom)
    *,
    sm_scale: Optional[float] = None,
    kernel: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """Layer `layer_idx` of a stacked cache; returns (B, H, D) in q.dtype.
    kernel=True runs the Triton kernel (interpret=True: in the Pallas
    interpreter), kernel=False the plain XLA route."""
    b, h, d = q.shape
    n_kv = k.shape[2]
    assert h % n_kv == 0 and k.shape == v.shape and k.shape[1] == b
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if kernel:
        return _kernel_call(layer_idx, q, k, v, bias, k_scale, v_scale,
                            alibi_slopes, sm_scale, interpret)
    i = jnp.asarray(layer_idx, jnp.int32).reshape(())
    pick = lambda a: (None if a is None else
                      jax.lax.dynamic_index_in_dim(a, i, keepdims=False))
    return _plain(q, pick(k), pick(v), bias, pick(k_scale), pick(v_scale),
                  alibi_slopes, sm_scale)


def decode_attention(
    q: jax.Array,                      # (B, H, D)
    k: jax.Array,                      # (B, H_kv, S, D) bf16/f32 or int8
    v: jax.Array,                      # (B, H_kv, S, D)
    bias: jax.Array,                   # (B, S) f32 additive mask (0 / -inf)
    k_scale: Optional[jax.Array] = None,   # (B, H_kv, S) f32 when k is int8
    v_scale: Optional[jax.Array] = None,
    alibi_slopes: Optional[jax.Array] = None,  # (H,) f32 (Bloom)
    *,
    sm_scale: Optional[float] = None,
    kernel: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """One layer's cache: the stacked attention over a one-layer stack."""
    return decode_attention_stacked(
        jnp.zeros((1,), jnp.int32), q, k[None], v[None], bias,
        None if k_scale is None else k_scale[None],
        None if v_scale is None else v_scale[None],
        alibi_slopes, sm_scale=sm_scale, kernel=kernel, interpret=interpret)
