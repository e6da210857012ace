"""True-int4 (nibble-packed) group matmul — 4 bits/weight in device memory.

    out[n, o] = Σ_g s_x[n, g] · s_w[g, o] · Σ_{c∈g} x_int[n, c] · w_int[c, o]
                + Σ_s x_sal[n, s] · w_sal[s, o]

The weight rides device memory packed two-per-byte in the split-half layout
of utils/native.pack_nibbles_split: packed byte row r of (K/2, O) holds
channel r in the low nibble and channel r + K/2 in the high nibble, both
BIASED by +8, so one loaded byte tile yields the two K-ranges [0, K/2) and
[K/2, K).  Constraint: (K/2) % group_size == 0 so groups never straddle the
halves.

Two routes, one contract:

  * `_plain` — unpack nibbles, then kernels/int_group_matmul.py: one
    batched s8×s8→s32 `dot_general` over the groups, the scale epilogue
    and the salient bf16 dot, all as XLA compiles them.  Runs on the CPU,
    and is the reference the kernel is tested against.
  * a Pallas kernel through Triton (`backend="triton"`).  Decode is bound
    by memory bandwidth, and XLA will not fuse a nibble unpack plus per-group
    int8 dots into one GEMM, so the kernel reads each nibble byte once and
    never writes a dequantized copy.  Each block owns (BN tokens, BO output
    columns, a K-range of byte groups); per 64-wide group it runs one int8
    `dot` per nibble half with an int32 result, removes the +8 bias on the
    accumulator (−8·Σx per group) and scales by s_x·s_w into an f32 sum.
    Blocks run in parallel with nothing carried between them, so narrow
    outputs split K over several blocks (split-K) and a second pass sums the
    partials; the bf16 salient dot is one more block per output tile.

For lax.scan decode the stacked (L, …) weights ride loop-invariant and the
layer index is a kernel operand: the kernel offsets into the stack itself,
so no per-layer slice of the weights is ever copied.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from smoothquant_tpu.kernels.int_group_matmul import int_group_matmul
from smoothquant_tpu.kernels.pack import unpack_nibbles_to_int8

# Block shape and launch parameters: output columns per block (a power of
# two, as Triton blocks must be), how many blocks to keep in flight (split-K
# adds blocks until there are this many), and Triton's warps and pipeline
# stages.
CONFIG = dict(bo=128, target_blocks=264, num_warps=4, num_stages=3)
# salient columns per dot in the salient block (k_s is a multiple of 128)
_SAL_CHUNK = 128


def kernel_supported(group_size: int) -> bool:
    """The kernel's shape rule: one int8 `dot` per group needs a power-of-two
    group of at least 32 (the smallest K an int8 tensor-core dot takes)."""
    return 32 <= group_size <= 256 and group_size & (group_size - 1) == 0


def _plain(x_q, x_scales, w_packed, w_scales_t, x_sal, w_sal_t, group_size):
    """The XLA route: exact per-group int32 products, f32 epilogue."""
    return int_group_matmul(x_q, x_scales, unpack_nibbles_to_int8(w_packed),
                            w_scales_t, x_sal, w_sal_t,
                            group_size=group_size)


def _kernel(idx_ref, xq_ref, xs_ref, wp_ref, ws_ref, *rest, n: int,
            bn: int, bo: int, gs: int, g_half: int, gps: int, n_split: int,
            k_s: int, o: int, sal_block: bool):
    if k_s:
        xsal_ref, wsal_ref, out_ref = rest
    else:
        (out_ref,) = rest
    i, j, s = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    layer = idx_ref[0]
    rows = pl.ds(i * bn, bn)
    cols = pl.ds(j * bo, bo)
    cmask = (j * bo + jnp.arange(bo)) < o
    # rows past N are masked, not padded: no XLA pad ops around the call
    rmask = (i * bn + jnp.arange(bn)) < n
    half = g_half * gs

    def load_x(ref, c0, width):
        return plgpu.load(ref.at[rows, pl.ds(c0, width)],
                          mask=rmask[:, None], other=0)

    def int_part():
        def body(t, acc):
            g = s * gps + t
            live = g < g_half
            gi = jnp.minimum(g, g_half - 1)   # in-bounds address; masked out
            wp = plgpu.load(wp_ref.at[layer, pl.ds(gi * gs, gs), cols],
                            mask=cmask[None, :], other=0)
            w_lo = (wp & 0xF).astype(jnp.int8)
            w_hi = (jnp.right_shift(wp, 4) & 0xF).astype(jnp.int8)
            x_lo = load_x(xq_ref, gi * gs, gs)
            x_hi = load_x(xq_ref, half + gi * gs, gs)
            p_lo = jnp.dot(x_lo, w_lo, preferred_element_type=jnp.int32)
            p_hi = jnp.dot(x_hi, w_hi, preferred_element_type=jnp.int32)
            p_lo = p_lo - 8 * jnp.sum(x_lo.astype(jnp.int32), axis=1)[:, None]
            p_hi = p_hi - 8 * jnp.sum(x_hi.astype(jnp.int32), axis=1)[:, None]
            sx_lo = plgpu.load(xs_ref.at[rows, gi], mask=rmask, other=0
                               ) * live.astype(jnp.float32)
            sx_hi = plgpu.load(xs_ref.at[rows, g_half + gi], mask=rmask,
                               other=0) * live.astype(jnp.float32)
            sw_lo = plgpu.load(ws_ref.at[layer, gi, cols], mask=cmask,
                               other=0).astype(jnp.float32)
            sw_hi = plgpu.load(ws_ref.at[layer, g_half + gi, cols],
                               mask=cmask, other=0).astype(jnp.float32)
            return (acc
                    + p_lo.astype(jnp.float32) * sx_lo[:, None] * sw_lo[None]
                    + p_hi.astype(jnp.float32) * sx_hi[:, None] * sw_hi[None])

        return jax.lax.fori_loop(0, gps, body,
                                 jnp.zeros((bn, bo), jnp.float32))

    def sal_part(acc):
        def body(c, acc):
            xs = load_x(xsal_ref, c * _SAL_CHUNK, _SAL_CHUNK)
            ws = plgpu.load(
                wsal_ref.at[layer, pl.ds(c * _SAL_CHUNK, _SAL_CHUNK), cols],
                mask=cmask[None, :], other=0)
            return acc + jnp.dot(xs, ws.astype(xs.dtype),
                                 preferred_element_type=jnp.float32)

        return jax.lax.fori_loop(0, k_s // _SAL_CHUNK, body, acc)

    if not k_s:
        acc = int_part()
    elif not sal_block:
        acc = sal_part(int_part())
    else:  # the last split index is the salient block
        acc = jax.lax.cond(
            s < n_split, int_part,
            lambda: sal_part(jnp.zeros((bn, bo), jnp.float32)))
    plgpu.store(out_ref.at[s, rows, cols], acc,
                mask=rmask[:, None] & cmask[None, :])


def _kernel_call(layer_idx, x_q, x_scales, w_packed, w_scales_t, x_sal,
                 w_sal_t, group_size, interpret):
    n, kk = x_q.shape
    l_num, half, o = w_packed.shape
    k_s = x_sal.shape[1]
    g_half = half // group_size
    bn = 16 if n <= 16 else 64       # 16 rows: the smallest block `dot` takes
    bo = CONFIG["bo"]
    nb, ob = pl.cdiv(n, bn), pl.cdiv(o, bo)
    want = max(1, min(g_half, pl.cdiv(CONFIG["target_blocks"], nb * ob)))
    gps = pl.cdiv(g_half, want)
    n_split = pl.cdiv(g_half, gps)
    sal_block = bool(k_s) and n_split > 1
    operands = [jnp.asarray(layer_idx, jnp.int32).reshape(1), x_q,
                x_scales.astype(jnp.float32), w_packed, w_scales_t]
    if k_s:
        assert k_s % _SAL_CHUNK == 0, k_s
        operands += [x_sal, w_sal_t]
    n_out = n_split + int(sal_block)
    out = pl.pallas_call(
        functools.partial(_kernel, n=n, bn=bn, bo=bo, gs=group_size,
                          g_half=g_half, gps=gps, n_split=n_split, k_s=k_s,
                          o=o, sal_block=sal_block),
        grid=(nb, ob, n_out),
        out_shape=jax.ShapeDtypeStruct((n_out, n, o), jnp.float32),
        compiler_params=plgpu.CompilerParams(
            num_warps=CONFIG["num_warps"], num_stages=CONFIG["num_stages"]),
        backend="triton",
        interpret=interpret,
        name="w4a4_group_matmul",
    )(*operands)
    return out[0] if n_out == 1 else jnp.sum(out, axis=0)


@functools.partial(
    jax.jit, static_argnames=("group_size", "out_dtype", "kernel",
                              "interpret"))
def int4_group_matmul_stacked(
    layer_idx: jax.Array,  # () or (1,) int32 — which layer's weights to read
    x_q: jax.Array,        # (N, K) int8 — this layer's quantized activations
    x_scales: jax.Array,   # (N, G) f32
    w_packed: jax.Array,   # (L, K/2, O) int8 — ALL layers, nibble-packed
    w_scales_t: jax.Array,  # (L, G, O) f32 or bf16
    x_sal: jax.Array,      # (N, K_s) fp
    w_sal_t: jax.Array,    # (L, K_s, O) fp
    *,
    group_size: int,
    out_dtype=jnp.float32,
    kernel: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """Layer-stacked int4 group matmul for the lax.scan decode.

    kernel=True runs the Triton kernel (compiled for the GPU, or in the
    Pallas interpreter when interpret=True); kernel=False runs the plain
    XLA route on layer `layer_idx` of the stack."""
    n, kk = x_q.shape
    l_num, half, o = w_packed.shape
    g_total = kk // group_size
    assert kk == 2 * half and half % group_size == 0, (
        "nibble packing needs (K/2) % group_size == 0")
    assert x_scales.shape == (n, g_total)
    assert w_scales_t.shape == (l_num, g_total, o)
    if kernel:
        y = _kernel_call(layer_idx, x_q, x_scales, w_packed, w_scales_t,
                         x_sal, w_sal_t, group_size, interpret)
    else:
        i = jnp.asarray(layer_idx, jnp.int32).reshape(())
        pick = lambda a: jax.lax.dynamic_index_in_dim(a, i, keepdims=False)
        y = _plain(x_q, x_scales, pick(w_packed), pick(w_scales_t), x_sal,
                   pick(w_sal_t), group_size)
    return y.astype(out_dtype)


def int4_group_matmul(
    x_q: jax.Array,        # (N, K) int8 — integer-quantized activations
    x_scales: jax.Array,   # (N, G) f32
    w_packed: jax.Array,   # (K/2, O) int8 — split-half nibble-packed weights
    w_scales_t: jax.Array,  # (G, O) f32
    x_sal: jax.Array,      # (N, K_s) fp salient slice
    w_sal_t: jax.Array,    # (K_s, O) fp
    *,
    group_size: int,
    out_dtype=jnp.float32,
    kernel: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """One layer's weights: the stacked matmul over a one-layer stack."""
    return int4_group_matmul_stacked(
        jnp.zeros((1,), jnp.int32), x_q, x_scales, w_packed[None],
        w_scales_t[None], x_sal, w_sal_t[None], group_size=group_size,
        out_dtype=out_dtype, kernel=kernel, interpret=interpret)
