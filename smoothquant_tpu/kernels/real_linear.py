"""Real-quantized linear forward: static permute → act quant → matmul.

This is the execution path the reference could only simulate: weights live
as int4-range values + group scales in device memory; activations are
quantized on the fly (an XLA-fused elementwise pass) and the salient
channels ride a dense bf16 side path.  Nibble-packed weights go through
kernels/int4_group_matmul.py (the Triton kernel on the GPU), int8-container
packs through the plain XLA integer or dequantize routes, and the
promoted-int8 identity layout through one XLA int8 GEMM with a scale
epilogue (kernels/int8_prefill.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from smoothquant_tpu.kernels.int4_group_matmul import (
    int4_group_matmul_stacked,
    kernel_supported,
)
from smoothquant_tpu.kernels.int8_prefill import int8_prefill_matmul
from smoothquant_tpu.kernels.int_group_matmul import int_group_matmul
from smoothquant_tpu.kernels.pack import (
    PackedLinear,
    quantize_activations_packed,
    quantize_activations_packed_int,
)
from smoothquant_tpu.kernels.quant_matmul import dual_path_matmul
from smoothquant_tpu.kernels.route import use_kernel
from smoothquant_tpu.quant.config import QuantConfig
from smoothquant_tpu.quant.core import compute_scale


def _identity_int8_forward(packed: PackedLinear, x2d: jax.Array,
                           out_dtype) -> jax.Array:
    """Forward for promote_int8's identity layout: a masked per-token int8
    quantize (one fused pass over x), then ONE full-depth int8 GEMM with
    the per-token x per-column scale epilogue and the salient fp side path.
    No activation gather beyond the small salient column take."""
    meta = packed.meta
    c = meta.in_features
    xf = x2d.astype(jnp.float32)
    k_s = packed.w_sal_t.shape[0]
    if meta.num_salient:
        sal_idx = packed.perm[c - meta.num_salient:]
        ns = (packed.ns_mask if packed.ns_mask is not None
              else jnp.ones((c,), jnp.float32).at[sal_idx].set(0.0))
        x_main = xf * ns[None, :]
        x_sal = jnp.zeros((x2d.shape[0], k_s), packed.w_sal_t.dtype)
        x_sal = x_sal.at[:, : meta.num_salient].set(
            jnp.take(x2d, sal_idx, axis=-1).astype(x_sal.dtype))
        w_sal_t = packed.w_sal_t
    else:
        x_main = xf
        x_sal = jnp.zeros((x2d.shape[0], 0), packed.w_sal_t.dtype)
        w_sal_t = packed.w_sal_t[:0]
    sx = compute_scale(jnp.max(jnp.abs(x_main), axis=-1, keepdims=True), 8)
    x_q = jnp.round(x_main / sx).astype(jnp.int8)
    return int8_prefill_matmul(
        x_q, sx, packed.w_qt, packed.w_scales_t.astype(jnp.float32)
        .reshape(1, -1), x_sal, w_sal_t, out_dtype=out_dtype)


def _int_path_supported(meta) -> bool:
    if meta.act_bits > 8:
        return False  # activation values must fit the int8 container
    if meta.act_quant in ("per_token", "per_tensor"):
        return True
    return meta.act_group_size == meta.group_size


def _nibble_quantize(packed: PackedLinear, x2d: jax.Array, perm, ns_mask):
    """(x_q, x_scales, x_sal) for a nibble pack (one layer's perm/mask).

    Permuted layout: gather into packed order (unless the input arrives
    pre-permuted), then the recipe's integer quantize.  Identity layout:
    activations group-quantize in ORIGINAL channel order with the scattered
    salient channels masked to zero (their int-weight rows are zero too);
    the salient slice rides a small k_s-wide gather."""
    meta = packed.meta
    if meta.layout != "identity":
        x_perm = x2d if meta.pre_permuted else jnp.take(x2d, perm, axis=-1)
        return quantize_activations_packed_int(x_perm, meta)
    n, c = x2d.shape
    xf = x2d.astype(jnp.float32) * ns_mask.astype(jnp.float32)[None, :]
    if meta.k_ns != c:
        xf = jnp.pad(xf, ((0, 0), (0, meta.k_ns - c)))
    xg = xf.reshape(n, meta.k_ns // meta.group_size, meta.group_size)
    scales = compute_scale(jnp.max(jnp.abs(xg), axis=-1, keepdims=True),
                           meta.act_bits)
    x_q = jnp.round(xg / scales).astype(jnp.int8).reshape(n, meta.k_ns)
    x_sal = jnp.zeros((n, meta.k_s), x2d.dtype)
    if meta.num_salient:
        sal_idx = perm[c - meta.num_salient:]
        x_sal = x_sal.at[:, : meta.num_salient].set(
            jnp.take(x2d, sal_idx, axis=-1))
    return x_q, scales[..., 0].astype(jnp.float32), x_sal


def real_quant_linear(
    packed: PackedLinear,
    x: jax.Array,
    cfg: Optional[QuantConfig] = None,  # compat; recipe lives in packed.meta
    *,
    compute: str = "auto",  # "auto" | "dequant" | "int"
    interpret: bool = False,
    plain: bool = False,
    out_dtype=None,
    layer_idx: Optional[jax.Array] = None,
) -> jax.Array:
    """y = act_qdq(x) @ W_qdq^T + bias with true int-weight storage.

    x: (..., in_features).  Matches the simulated quant_linear numerics in
    the packed (static-permutation) domain.  The quantization recipe is
    self-contained in packed.meta (recorded at pack time), so models can mix
    per-layer recipes (e.g. int8 lm_head over an int4 body).  compute picks
    the route for int8-container packs: "int" = per-group int8 products with
    output-side scaling, "dequant" = dequantized weight + float GEMM,
    "auto" = int where the recipe allows it.  Nibble packs always take the
    int4 matmul: its Triton kernel where kernels.route.use_kernel says so
    (interpret=True runs it in the Pallas interpreter; plain=True forces
    the XLA route), else the plain XLA route.

    layer_idx: when `packed` is a LAYER-STACKED pytree (stack_layers output:
    every array carries a leading L axis), selects the layer — the kernel
    reads only that layer's weights, so the full weight stack rides lax.scan
    without per-iteration slice copies.
    """
    del cfg
    meta = packed.meta
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    out_dtype = out_dtype or x.dtype
    bias = packed.bias

    if layer_idx is not None or meta.nibble:
        if not (meta.nibble and _int_path_supported(meta)):
            raise NotImplementedError(
                "layer-stacked packs need a nibble-packed int recipe")
        stacked = layer_idx is not None
        at = ((lambda a: None if a is None else a[layer_idx]) if stacked
              else (lambda a: a))
        x_q, x_scales, x_sal = _nibble_quantize(
            packed, x2d, at(packed.perm), at(packed.ns_mask))
        w = ((packed.w_qt, packed.w_scales_t, packed.w_sal_t) if stacked else
             (packed.w_qt[None], packed.w_scales_t[None],
              packed.w_sal_t[None]))
        y = int4_group_matmul_stacked(
            layer_idx if stacked else jnp.zeros((), jnp.int32),
            x_q, x_scales, w[0], w[1], x_sal.astype(x.dtype),
            w[2].astype(x.dtype), group_size=meta.group_size,
            out_dtype=out_dtype,
            kernel=(kernel_supported(meta.group_size)
                    and use_kernel(interpret, plain)),
            interpret=interpret)
        bias = at(bias)
    elif meta.layout == "identity":
        # promote_int8 prefill layout / int8 per-channel lm_head
        y = _identity_int8_forward(packed, x2d, out_dtype)
    else:
        x_perm = (x2d if meta.pre_permuted
                  else jnp.take(x2d, packed.perm, axis=-1))
        if compute == "auto":
            # one route for every token count, so a token-chunked call
            # (ForwardContext.tp_overlap_chunks) gives the same bits
            compute = "int" if _int_path_supported(meta) else "dequant"
        if compute == "int" and not _int_path_supported(meta):
            raise ValueError("int compute path unsupported for this recipe")
        if compute == "int":
            x_q, x_scales, x_sal = quantize_activations_packed_int(x_perm,
                                                                   meta)
            y = int_group_matmul(
                x_q, x_scales, packed.w_qt, packed.w_scales_t,
                x_sal.astype(x.dtype), packed.w_sal_t.astype(x.dtype),
                group_size=meta.group_size, out_dtype=out_dtype)
        else:
            x_ns_q, x_sal = quantize_activations_packed(x_perm, meta)
            y = dual_path_matmul(
                x_ns_q.astype(x.dtype), x_sal.astype(x.dtype),
                packed.w_qt, packed.w_scales_t,
                packed.w_sal_t.astype(x.dtype),
                group_size=meta.group_size, out_dtype=out_dtype)
    # packs built with align_o padding return extra zero columns — slice them
    # off before the bias.  Under shard_map the arrays are O-SHARDS (width <=
    # meta.out_features, which records global dims), so only wider-than-meta
    # outputs are sliced.
    if y.shape[-1] > meta.out_features:
        y = y[..., : meta.out_features]
    if bias is not None:
        y = y + bias.astype(y.dtype)
    return y.reshape(*shape[:-1], y.shape[-1])
