"""Shared model building blocks.

The reference borrows its transformer implementation from HF transformers and
only swaps Linear/norm modules in place (SURVEY.md §1).  Here the models are
our own: pure functions over params pytrees.  This module holds the pieces
every architecture shares — norms, rotary embeddings, attention math, the
quantization-aware linear call, and the KV cache structure.

Params conventions:
  linear: {"weight": (out, in), "bias": (out,) | None, [salient keys]}
  norm:   {"weight": (C,), ["bias": (C,)]}
  layer stacks are dicts keyed by str(layer_index) so pytree paths are
  uniform string tuples.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from smoothquant_tpu.quant.calibrate import TapCollector
from smoothquant_tpu.quant.config import QuantConfig
from smoothquant_tpu.quant.linear import linear as plain_linear
from smoothquant_tpu.quant.linear import quant_linear

NEG_INF = -1e9


@dataclasses.dataclass
class ForwardContext:
    """Per-call context threaded through a model forward pass.

    quant: when set, weight-quantized linears apply on-the-fly activation
      quantization (the simulated path).  Params must have been produced by
      quantize_model_params (dict linears) or pack_model (PackedLinear —
      the real-quantized path; `compute` selects int/dequant/auto routes).
    taps: when set, every quantizable linear reports input (and output)
      statistics for calibration (replaces the reference's torch hooks).
    """

    quant: Optional[QuantConfig] = None
    taps: Optional[TapCollector] = None
    compute: str = "auto"  # int8-container pack route: auto | int | dequant
    interpret: bool = False  # run the Pallas kernels in the interpreter
    #                          (CPU tests); off the GPU they run only so
    tp_axis: Optional[str] = None  # inside shard_map: packed-linear outputs
    #                                are computed on local O-shards and
    #                                combined over this mesh axis per
    #                                meta.tp_reduce (gather / psum / none)
    moe_dispatch: str = "dense"  # MoE execution: "dense" computes every
    #                              expert weighted by routing probs (XLA-
    #                              trivial, reference-equivalent numerics);
    #                              "sparse" gathers routed tokens into
    #                              capacity-bounded per-expert buffers —
    #                              top-k/E of the dense FLOPs
    moe_capacity_factor: float = 2.0  # sparse buffer slack: capacity =
    #                                   ceil(topk * n / E * factor)
    ep_axis: Optional[str] = None  # inside shard_map: experts are sharded
    #                                over this mesh axis; each device runs
    #                                its local experts and the combined MoE
    #                                output is psum'd
    tp_overlap_chunks: int = 0  # Megatron row-parallel (tp_reduce="psum")
    #                             linears: split the token axis into this
    #                             many independent chunks, each with its own
    #                             psum — XLA's latency-hiding scheduler
    #                             overlaps chunk c's all-reduce with chunk
    #                             c+1's matmul (the north-star "collectives
    #                             overlapped with dequant+matmul";
    #                             bitwise-identical results).  0 = one
    #                             synchronous psum.  Effective for prefill
    #                             token counts (>= 8 rows per chunk).
    cp_axis: Optional[str] = None  # inside shard_map: the SEQUENCE axis is
    #                                sharded over this mesh axis and
    #                                no-cache (prefill) attention runs as
    #                                ring attention (parallel/cp.py) — K/V
    #                                chunks stream around the ring via
    #                                ppermute with a streaming softmax
    plain: bool = False  # for the benchmark's A/B (bench.py) and the smoke
    #                      check's kernel-vs-XLA comparison only: every
    #                      operation takes its plain XLA route — the Pallas
    #                      kernels (kernels/route.py) AND cuDNN prefill
    #                      attention give way to jnp; both choices ride this
    #                      one flag


def call_linear(
    params,
    x: jax.Array,
    name: str,
    ctx: Optional[ForwardContext],
    quantize_output: bool = False,
    layer_idx: Optional[jax.Array] = None,
) -> jax.Array:
    """A quantizable linear call site.

    name is the HF-style module path (e.g. "model.layers.0.self_attn.q_proj")
    used for calibration stats and act-scales keys, so artifacts produced by
    the reference pipeline remain loadable.  layer_idx selects the layer of
    a LAYER-STACKED PackedLinear (leaves carrying a leading L axis) inside
    the prefetch-scan decode path.
    """
    from smoothquant_tpu.kernels.pack import PackedLinear

    if ctx is not None and ctx.taps is not None:
        ctx.taps.tap_input(name, x)
    if isinstance(params, dict) and "weight_t" in params:
        # transposed-fp decode layout (llama.pack_fp_decode): under scan
        # (layer_idx set) the dot reads layer i of the loop-invariant stack
        from smoothquant_tpu.kernels.fp_matmul import fp_matmul_stacked

        x2d = x.reshape(-1, x.shape[-1])
        if layer_idx is not None:
            y = fp_matmul_stacked(layer_idx, x2d, params["weight_t"])
            bias = params.get("bias")
            if bias is not None:
                y = y + bias[layer_idx].astype(y.dtype)
        else:
            y = jnp.dot(x2d, params["weight_t"],
                        preferred_element_type=jnp.float32).astype(x.dtype)
            if params.get("bias") is not None:
                y = y + params["bias"].astype(y.dtype)
        y = y.reshape(*x.shape[:-1], y.shape[-1]).astype(x.dtype)
        if ctx is not None and ctx.taps is not None:
            ctx.taps.tap_output(name, y)
        return y
    if isinstance(params, PackedLinear):
        from smoothquant_tpu.kernels.real_linear import real_quant_linear
        from smoothquant_tpu.quant import core

        kw = dict(compute=ctx.compute if ctx is not None else "auto",
                  interpret=bool(ctx is not None and ctx.interpret),
                  plain=bool(ctx is not None and ctx.plain),
                  layer_idx=layer_idx)
        if (ctx is not None and ctx.tp_axis is not None
                and params.meta.tp_reduce == "psum"):
            # Megatron row-parallel: local K-shard partial product, then
            # all-reduce; bias is stored pre-divided by tp so the psum
            # reconstitutes it exactly once.  tp_overlap_chunks > 1 splits
            # the token axis into independent (matmul, psum) chunks so the
            # collective of one chunk overlaps the next chunk's compute.
            ch = ctx.tp_overlap_chunks
            if (ch > 1 and x.ndim == 3 and x.shape[1] >= ch * 8
                    and x.shape[1] % ch == 0):
                step = x.shape[1] // ch
                parts = []
                prev = None
                for c in range(ch):
                    yc = real_quant_linear(
                        params, x[:, c * step:(c + 1) * step], **kw)
                    if prev is not None:
                        # chain ONLY the collectives: the barrier puts a
                        # dependency path between successive psums (so
                        # XLA's all-reduce combiner cannot re-merge the
                        # chunks) while chunk c+1's matmul stays
                        # independent of chunk c's in-flight all-reduce —
                        # the structure the latency-hiding scheduler
                        # overlaps on a real device mesh
                        yc, prev = jax.lax.optimization_barrier((yc, prev))
                    yc = jax.lax.psum(yc, ctx.tp_axis)
                    prev = yc
                    parts.append(yc)
                y = jnp.concatenate(parts, axis=1)
            else:
                y = real_quant_linear(params, x, **kw)
                y = jax.lax.psum(y, ctx.tp_axis)
        else:
            y = real_quant_linear(params, x, **kw)
            if (ctx is not None and ctx.tp_axis is not None
                    and params.meta.tp_reduce == "gather"):
                # v1 column-parallel: each device computed its O-shard
                y = jax.lax.all_gather(y, ctx.tp_axis, axis=-1, tiled=True)
            # tp_reduce == "none": output stays sharded (Megatron col layers)
        if (quantize_output and ctx is not None and ctx.quant is not None
                and ctx.quant.quantize_bmm_input):
            aq = core.get_act_quantizer(ctx.quant.act_quant,
                                        ctx.quant.effective_act_bits,
                                        ctx.quant.group_size,
                                        ctx.quant.sort_strategy)
            y = aq(y)
    elif ctx is not None and ctx.quant is not None:
        y = quant_linear(
            params,
            x,
            ctx.quant,
            quantize_output=quantize_output and ctx.quant.quantize_bmm_input,
        )
    else:
        y = plain_linear(params, x)
    if ctx is not None and ctx.taps is not None:
        ctx.taps.tap_output(name, y)
    return y


def maybe_quantize_output(y: jax.Array, ctx: Optional[ForwardContext]) -> jax.Array:
    """Apply the recipe's activation quantizer to a projection OUTPUT when
    quantize_bmm_input is on — used by fused q/k/v projections, which must
    quantize each split separately to match the reference's per-projection
    output quantization (fake_quant.py:258-263)."""
    if ctx is None or ctx.quant is None or not ctx.quant.quantize_bmm_input:
        return y
    from smoothquant_tpu.quant import core

    aq = core.get_act_quantizer(ctx.quant.act_quant,
                                ctx.quant.effective_act_bits,
                                ctx.quant.group_size,
                                ctx.quant.sort_strategy)
    return aq(y)


def layer_norm(params: dict, x: jax.Array, eps: float = 1e-5) -> jax.Array:
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    y = y * params["weight"].astype(jnp.float32)
    if params.get("bias") is not None:
        y = y + params["bias"].astype(jnp.float32)
    return y.astype(x.dtype)


def rms_norm(params: dict, x: jax.Array, eps: float = 1e-6) -> jax.Array:
    xf = x.astype(jnp.float32)
    y = xf * jax.lax.rsqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + eps)
    return (y * params["weight"].astype(jnp.float32)).astype(x.dtype)


def rotary_cos_sin(
    positions: jax.Array, head_dim: int, theta: float = 10000.0
) -> tuple[jax.Array, jax.Array]:
    """HF-Llama-style rotary tables: (..., seq, head_dim) with duplicated halves."""
    inv_freq = 1.0 / (
        theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim)
    )
    freqs = positions.astype(jnp.float32)[..., None] * inv_freq[None, :]
    emb = jnp.concatenate([freqs, freqs], axis=-1)
    return jnp.cos(emb), jnp.sin(emb)


def apply_rotary(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x: (B, S, n_heads, head_dim); cos/sin: (B or 1, S, head_dim)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = jnp.concatenate([-x2, x1], axis=-1)
    cos = cos[:, :, None, :].astype(x.dtype)
    sin = sin[:, :, None, :].astype(x.dtype)
    return x * cos + rotated * sin


class KVCache(NamedTuple):
    """Static-shape decode cache: k/v (B, n_kv_heads, max_len, head_dim).

    The (B, H, S, D) layout keeps S×D contiguous per head — the tiling the
    fused decode-attention kernel streams — and is what XLA prefers for the
    score einsum anyway.  update() accepts the model's natural projection
    layout (B, Sq, H, D) and transposes the (tiny) new slice internally.

    pos is either a scalar (all rows aligned — the simple generate path) or
    per-slot (B,) for continuous batching, where each slot's sequence has its
    own length.
    """

    k: jax.Array
    v: jax.Array
    pos: jax.Array  # () or (B,) int32: valid positions already written

    @classmethod
    def create(cls, batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               dtype, per_slot: bool = False):
        shape = (batch, n_kv_heads, max_len, head_dim)
        pos = jnp.zeros((batch,) if per_slot else (), jnp.int32)
        return cls(k=jnp.zeros(shape, dtype), v=jnp.zeros(shape, dtype), pos=pos)

    def update(self, k_new: jax.Array, v_new: jax.Array) -> "KVCache":
        """Append k/v (B, Sq, H, D) for the current step(s) at self.pos."""
        k_new = k_new.transpose(0, 2, 1, 3).astype(self.k.dtype)
        v_new = v_new.transpose(0, 2, 1, 3).astype(self.v.dtype)
        if self.pos.ndim == 0:
            k = jax.lax.dynamic_update_slice(self.k, k_new, (0, 0, self.pos, 0))
            v = jax.lax.dynamic_update_slice(self.v, v_new, (0, 0, self.pos, 0))
        else:
            upd = jax.vmap(
                lambda buf, new, p: jax.lax.dynamic_update_slice(buf, new, (0, p, 0))
            )
            k = upd(self.k, k_new, self.pos)
            v = upd(self.v, v_new, self.pos)
        return KVCache(k=k, v=v, pos=self.pos + k_new.shape[2])

    def read(self) -> tuple[jax.Array, jax.Array]:
        """(B, H, S, D) key/value views for attention."""
        return self.k, self.v


class QuantKVCache(NamedTuple):
    """INT8 KV cache: values stored int8 with per-(slot, head, position)
    symmetric absmax scales — half the HBM footprint and read bandwidth of a
    bf16 cache.  Same (B, H, S, D) layout as KVCache; the fused decode kernel
    applies the scales to score/prob columns so the int8 bytes are the only
    cache traffic.  (North-star capability; the reference keeps stock HF fp
    caches, SURVEY.md §5 long-context row.)
    """

    k_q: jax.Array       # (B, H, max_len, D) int8
    v_q: jax.Array       # (B, H, max_len, D) int8
    k_scale: jax.Array   # (B, H, max_len) f32
    v_scale: jax.Array   # (B, H, max_len) f32
    pos: jax.Array       # () or (B,) int32

    @classmethod
    def create(cls, batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               dtype=None, per_slot: bool = False):
        del dtype  # storage is int8; read() dequantizes to bf16
        shape = (batch, n_kv_heads, max_len, head_dim)
        pos = jnp.zeros((batch,) if per_slot else (), jnp.int32)
        return cls(
            k_q=jnp.zeros(shape, jnp.int8), v_q=jnp.zeros(shape, jnp.int8),
            k_scale=jnp.zeros(shape[:3], jnp.float32),
            v_scale=jnp.zeros(shape[:3], jnp.float32),
            pos=pos,
        )

    @staticmethod
    def _quantize(x: jax.Array) -> tuple[jax.Array, jax.Array]:
        absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)
        scale = jnp.maximum(absmax, 1e-8) / 127.0
        q = jnp.round(x.astype(jnp.float32) / scale[..., None]).astype(jnp.int8)
        return q, scale

    def update(self, k_new: jax.Array, v_new: jax.Array) -> "QuantKVCache":
        """Append k/v (B, Sq, H, D) at self.pos."""
        kq, ks = self._quantize(k_new.transpose(0, 2, 1, 3))  # (B,H,Sq,D)
        vq, vs = self._quantize(v_new.transpose(0, 2, 1, 3))
        if self.pos.ndim == 0:
            at4 = lambda buf, new: jax.lax.dynamic_update_slice(
                buf, new, (0, 0, self.pos, 0))
            at3 = lambda buf, new: jax.lax.dynamic_update_slice(
                buf, new, (0, 0, self.pos))
            out = QuantKVCache(at4(self.k_q, kq), at4(self.v_q, vq),
                               at3(self.k_scale, ks), at3(self.v_scale, vs),
                               self.pos + kq.shape[2])
        else:
            u4 = jax.vmap(lambda buf, new, p: jax.lax.dynamic_update_slice(
                buf, new, (0, p, 0)))
            u3 = jax.vmap(lambda buf, new, p: jax.lax.dynamic_update_slice(
                buf, new, (0, p)))
            out = QuantKVCache(u4(self.k_q, kq, self.pos), u4(self.v_q, vq, self.pos),
                               u3(self.k_scale, ks, self.pos),
                               u3(self.v_scale, vs, self.pos),
                               self.pos + kq.shape[2])
        return out

    def read(self) -> tuple[jax.Array, jax.Array]:
        """(B, H, S, D) dequantized views (einsum fallback path)."""
        k = self.k_q.astype(jnp.float32) * self.k_scale[..., None]
        v = self.v_q.astype(jnp.float32) * self.v_scale[..., None]
        return k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)


def attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    causal_offset: jax.Array | int = 0,
    scale: Optional[float] = None,
    valid_len: Optional[jax.Array] = None,
    attn_mask: Optional[jax.Array] = None,
    sliding_window: Optional[int] = None,
    ctx: Optional["ForwardContext"] = None,
) -> jax.Array:
    """Scaled dot-product attention with causal masking and GQA.

    q: (B, Sq, n_heads, d); k/v: (B, n_kv_heads, Sk, d) — the KV cache's
    native head-major layout (fresh projections transpose their small
    (B, S, H, D) tensors on the way in).  kv heads are repeated to match q
    heads.  Query position i attends to key positions j <= i + causal_offset;
    positions >= valid_len (if given) are masked (used with a pre-allocated
    KV cache).  causal_offset and valid_len may be scalars or per-batch (B,)
    arrays (continuous batching).  attn_mask: optional (B, Sk) of {0,1}
    marking valid key positions (padding mask).  Softmax in float32
    (matching the reference INT8 path, opt.py:168-189).
    """
    if ctx is not None and ctx.cp_axis is not None:
        # context-parallel prefill: sequence-sharded q/k/v, KV chunks
        # stream around the ring (parallel/cp.py).  Local causal masking
        # only — callers express continuous-batching offsets via attn_mask.
        from smoothquant_tpu.parallel.cp import ring_attention

        assert valid_len is None, "cp prefill uses attn_mask, not valid_len"
        assert sliding_window is None, (
            "ring attention does not implement sliding windows")
        assert isinstance(causal_offset, int) and causal_offset == 0, (
            "cp prefill masks causally from the ring's global offsets; a "
            "nonzero causal_offset would be silently dropped here")
        return ring_attention(q, k, v, ctx.cp_axis, scale=scale,
                              attn_mask=attn_mask)

    b, sq, nh, d = q.shape
    n_kv = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    # plain causal bf16 PREFILL on the GPU rides cuDNN's fused attention
    # (named, so a shape cuDNN refuses fails instead of silently falling
    # back): the einsum below materializes (B, H, S, S) f32 scores.
    # Masked / cached / windowed variants keep the einsum (exact-mask
    # reference semantics).
    if (attn_mask is None and valid_len is None and sliding_window is None
            and isinstance(causal_offset, int) and causal_offset == 0
            and sq == k.shape[2] and q.dtype == jnp.bfloat16
            and d % 8 == 0 and d <= 128 and nh % n_kv == 0
            and not (ctx is not None and ctx.plain)
            and jax.default_backend() == "gpu"):
        out = jax.nn.dot_product_attention(
            q, k.transpose(0, 2, 1, 3).astype(q.dtype),
            v.transpose(0, 2, 1, 3).astype(q.dtype), scale=float(scale),
            is_causal=True, implementation="cudnn")
        return out.astype(q.dtype)

    if n_kv != nh:
        rep = nh // n_kv
        k = jnp.repeat(k, rep, axis=1)
        v = jnp.repeat(v, rep, axis=1)

    # (B, nh, Sq, Sk)
    scores = jnp.einsum("bqhd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
    scores = scores * scale

    sk = k.shape[2]
    qi = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sq, sk), 2)
    kj = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sq, sk), 3)

    def per_batch(x):
        x = jnp.asarray(x)
        return x.reshape(-1, 1, 1, 1) if x.ndim == 1 else x

    mask = kj <= qi + per_batch(causal_offset)
    if sliding_window is not None:
        # Mistral sliding-window (HF modeling_mistral sliding-window mask):
        # query at absolute position p attends to keys in (p - W, p]
        mask = jnp.logical_and(
            mask, kj > qi + per_batch(causal_offset) - sliding_window)
    if valid_len is not None:
        mask = jnp.logical_and(mask, kj < per_batch(valid_len))
    if attn_mask is not None:
        mask = jnp.logical_and(mask, attn_mask[:, None, None, :].astype(bool))
    scores = jnp.where(mask, scores, NEG_INF)

    probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
    return jnp.einsum("bhqk,bhkd->bqhd", probs, v).astype(q.dtype)


def to_head_major(x: jax.Array) -> jax.Array:
    """(B, S, H, D) → (B, H, S, D) for the no-cache attention path."""
    return x.transpose(0, 2, 1, 3)


def cached_attention(
    q: jax.Array,
    cache,
    *,
    causal_offset: jax.Array | int,
    ctx: Optional[ForwardContext] = None,
    scale: Optional[float] = None,
    attn_mask: Optional[jax.Array] = None,
    sliding_window: Optional[int] = None,
) -> jax.Array:
    """Attention over an (already-updated) KVCache/QuantKVCache.

    Single-query steps go through kernels/decode_attention.py (its Triton
    kernel where kernels.route.use_kernel says so and the shape fits, else
    its plain route), with cache fill validity, the continuous-batching key
    mask and the sliding window folded into one additive bias.  Multi-token
    steps take the einsum over the dequantized cache.
    """
    from smoothquant_tpu.kernels import decode_attention as da

    b, sq, nh, d = q.shape
    quant = isinstance(cache, QuantKVCache)
    kbuf = cache.k_q if quant else cache.k
    n_kv, s = kbuf.shape[1], kbuf.shape[2]
    if sq == 1:
        valid = jnp.broadcast_to(jnp.asarray(cache.pos, jnp.int32), (b,))
        bias = decode_bias(valid - 1, b, s, attn_mask, sliding_window,
                           qpos=causal_offset)
        out = da.decode_attention(
            q[:, 0], kbuf, cache.v_q if quant else cache.v, bias,
            cache.k_scale if quant else None,
            cache.v_scale if quant else None, sm_scale=scale,
            **attention_route(ctx, s, nh, n_kv, d))
        return out[:, None]

    return attention(q, *cache.read(), causal_offset=causal_offset,
                     valid_len=cache.pos, scale=scale, attn_mask=attn_mask,
                     sliding_window=sliding_window)


def attention_route(ctx, s: int, nh: int, n_kv: int, d: int) -> dict:
    """kernel/interpret flags for kernels.decode_attention at this shape."""
    from smoothquant_tpu.kernels import decode_attention as da
    from smoothquant_tpu.kernels.route import use_kernel

    interpret = bool(ctx is not None and ctx.interpret)
    kernel = (da.supported(s, nh, n_kv, d)
              and use_kernel(interpret, bool(ctx is not None and ctx.plain)))
    return {"kernel": kernel, "interpret": interpret}


def unembed(x: jax.Array, embedding: jax.Array) -> jax.Array:
    """Tied-embedding logits: (B,S,H) @ (V,H)^T in float32."""
    return jnp.einsum(
        "bsh,vh->bsv", x, embedding.astype(x.dtype),
        preferred_element_type=jnp.float32,
    )


# ---------------------------------------------------------------------------
# Shared prefetch-scan decode machinery (per-arch _prefetch_scan_decode
# bodies in models/llama.py, opt.py, falcon.py, bloom.py, mixtral.py)
# ---------------------------------------------------------------------------


def prefetch_tree_capable(stacked, ctx, caches, s: int) -> bool:
    """Gate for the no-copy scan decode: single token, a stacked cache, no
    taps/TP/EP, and every projection a nibble PackedLinear or a
    transposed-fp ("weight_t") dict.  The weights and the cache ride the
    scan loop-invariant and each layer's kernels read layer i in place."""
    from smoothquant_tpu.kernels.pack import PackedLinear

    # NB: KVCache/QuantKVCache are NamedTuples — a plain tuple check would
    # reject every cache; a stacked cache is recognized by its pos field
    if s != 1 or caches is None or not hasattr(caches, "pos"):
        return False
    if ctx is not None and (ctx.taps is not None or ctx.tp_axis is not None
                            or ctx.ep_axis is not None):
        return False
    if stacked is None or not isinstance(stacked, dict):
        return False
    if caches.pos.ndim not in (1, 2):
        # (L,) aligned or (L, B) per-slot stacked positions; per-slot rides
        # the same scan — validity rides the per-row (B, S) decode bias
        return False
    sa = stacked.get("self_attn", stacked.get("self_attention", {}))
    qp = sa.get("qkv_proj", sa.get("query_key_value", sa.get("q_proj")))
    if isinstance(qp, dict) and "weight_t" in qp:
        return True
    if isinstance(qp, PackedLinear) and qp.meta.nibble:
        if ctx is None or ctx.compute not in ("auto", "int"):
            return False
        return all(leaf.meta.nibble for leaf in jax.tree.leaves(
            stacked, is_leaf=lambda n: isinstance(n, PackedLinear))
            if isinstance(leaf, PackedLinear))
    return False


def stacked_cache_append(cache, i, k_new, v_new, cos=None, sin=None,
                         rotate_k: bool = False):
    """Write one decode position's K/V into layer i of a STACKED cache at
    its current fill position.  k_new/v_new: (B, 1, H_kv, D) model layout,
    k PRE-rotary when rotate_k (cos/sin: this position's rotary tables).
    pos may be (L,) aligned or (L, B) per-slot (continuous batching) —
    per-slot rows each land at their own position.  Returns (cache, pos_i)."""
    from smoothquant_tpu.kernels.cache_write import (put_rows,
                                                     write_quant_cache_stacked)

    pos_i = cache.pos[i]
    b, _, h, d = k_new.shape
    if isinstance(cache, QuantKVCache):
        if cos is None:  # non-rotary arch: dummy (ignored) tables
            cos = sin = jnp.zeros((b, 1, d), jnp.float32)
        kq, vq, ks, vs = write_quant_cache_stacked(
            i, pos_i, k_new.reshape(b, h, d), v_new.reshape(b, h, d),
            cos, sin, cache.k_q, cache.v_q, cache.k_scale, cache.v_scale,
            rotary=rotate_k)
        return cache._replace(k_q=kq, v_q=vq, k_scale=ks, v_scale=vs), pos_i
    if rotate_k:
        k_new = apply_rotary(k_new, cos, sin)
    k = put_rows(cache.k, k_new[:, 0], i, pos_i, 3)
    v = put_rows(cache.v, v_new[:, 0], i, pos_i, 3)
    return cache._replace(k=k, v=v), pos_i


def decode_bias(pos_i, b: int, s_max: int, attn_mask,
                sliding_window: Optional[int] = None,
                qpos=None) -> jax.Array:
    """(B, S_max) additive f32 bias for single-token decode: 0 on valid key
    positions (<= pos_i, minus attn_mask holes, minus keys that fell out
    of a sliding window), NEG_INF elsewhere.  pos_i: () aligned or (B,)
    per-slot positions of the decoded token; qpos (default pos_i): its
    absolute position for the window."""
    from smoothquant_tpu.kernels import decode_attention as da

    pos_i = jnp.broadcast_to(jnp.asarray(pos_i, jnp.int32).reshape(-1),
                             (b,))[:, None]
    col = jax.lax.broadcasted_iota(jnp.int32, (b, s_max), 1)
    ok = col <= pos_i
    if sliding_window is not None:
        qp = pos_i if qpos is None else jnp.broadcast_to(
            jnp.asarray(qpos, jnp.int32).reshape(-1), (b,))[:, None]
        # the query decodes at absolute position qp: keys (qp - W, qp]
        ok = jnp.logical_and(ok, col > qp - sliding_window)
    if attn_mask is not None:
        ok = jnp.logical_and(ok, attn_mask.astype(bool))
    return jnp.where(ok, 0.0, da.NEG_INF).astype(jnp.float32)


def stacked_flash_attention(cache, i, q_bhd, bias, ctx, sm_scale=None,
                            alibi_slopes=None):
    """Layer-i decode attention over a stacked (quant or fp) cache.
    q_bhd: (B, H, D); returns (B, H, D).  sm_scale=1.0 for archs that
    pre-scale q (OPT folds 1/sqrt(d) into the projection, reference
    opt.py:63-66).  alibi_slopes: (H,) per-head ALiBi slopes (Bloom)."""
    from smoothquant_tpu.kernels import decode_attention as da

    quant = isinstance(cache, QuantKVCache)
    k = cache.k_q if quant else cache.k
    v = cache.v_q if quant else cache.v
    b, h, d = q_bhd.shape
    return da.decode_attention_stacked(
        i, q_bhd, k, v, bias, cache.k_scale if quant else None,
        cache.v_scale if quant else None, alibi_slopes, sm_scale=sm_scale,
        **attention_route(ctx, k.shape[3], h, k.shape[2], d))
