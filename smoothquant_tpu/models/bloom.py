"""Bloom decoder — functional JAX.

The reference supports Bloom for smoothing only (smooth.py:91-100:
input_layernorm → query_key_value, post_attention_layernorm →
mlp.dense_h_to_4h); quantize_model raises for it.  We provide the full
forward (ALiBi attention, fused per-head QKV, embedding LayerNorm) plus the
smoothing map, and additionally allow quantization of the same four
projections (a strict superset of the reference's capability).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from smoothquant_tpu.models.common import (
    ForwardContext,
    KVCache,
    NEG_INF,
    call_linear,
    layer_norm,
    to_head_major,
    unembed,
)
from smoothquant_tpu.quant.config import QuantConfig
from smoothquant_tpu.quant.linear import quantize_linear_params


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    layer_norm_epsilon: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "BloomConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, dtype="float32")


def alibi_slopes(n_heads: int) -> np.ndarray:
    """HF Bloom ALiBi slopes (power-of-2 construction)."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** (i + 1) for i in range(closest)]
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        extra = [extra_base ** (2 * i + 1) for i in range(n_heads - closest)]
        slopes.extend(extra)
    return np.asarray(slopes, np.float32)


def init_params(key: jax.Array, cfg: BloomConfig) -> dict:
    dtype = jnp.dtype(cfg.dtype)
    h = cfg.hidden_size
    keys = iter(jax.random.split(key, 2 + cfg.num_hidden_layers * 4))

    def lin(k, out_f, in_f):
        return {"weight": jax.random.normal(k, (out_f, in_f), dtype) * (in_f ** -0.5),
                "bias": jnp.zeros((out_f,), dtype)}

    def ln(c):
        return {"weight": jnp.ones((c,), dtype), "bias": jnp.zeros((c,), dtype)}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        layers[str(i)] = {
            "input_layernorm": ln(h),
            "post_attention_layernorm": ln(h),
            "self_attention": {
                "query_key_value": lin(next(keys), 3 * h, h),
                "dense": lin(next(keys), h, h),
            },
            "mlp": {
                "dense_h_to_4h": lin(next(keys), 4 * h, h),
                "dense_4h_to_h": lin(next(keys), h, 4 * h),
            },
        }
    return {
        "word_embeddings": {"weight": jax.random.normal(next(keys), (cfg.vocab_size, h), dtype) * 0.02},
        "word_embeddings_layernorm": ln(h),
        "layers": layers,
        "ln_f": ln(h),
    }


def _alibi_attention(q, k, v, slopes, causal_offset, valid_len, attn_mask):
    """Attention with ALiBi bias: score += slope_h * (j - i_abs).

    k/v arrive head-major (B, H, Sk, D) — the KV cache's native layout."""
    b, sq, nh, d = q.shape
    sk = k.shape[2]
    scores = jnp.einsum("bqhd,bhkd->bhqk", q, k,
                        preferred_element_type=jnp.float32) * (d ** -0.5)
    qi = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sq, sk), 2)
    kj = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sq, sk), 3)

    def per_batch(x):
        x = jnp.asarray(x)
        return x.reshape(-1, 1, 1, 1) if x.ndim == 1 else x

    offset = per_batch(causal_offset)
    # HF computes alibi as slope * key_position relative to the key block
    # start; with full causal masks this equals slope * (j - query_abs_pos)
    # up to a per-row constant that softmax cancels — use slope * j.
    bias = slopes.reshape(1, nh, 1, 1) * kj.astype(jnp.float32)
    scores = scores + bias
    mask = kj <= qi + offset
    if valid_len is not None:
        mask = jnp.logical_and(mask, kj < per_batch(valid_len))
    if attn_mask is not None:
        mask = jnp.logical_and(mask, attn_mask[:, None, None, :].astype(bool))
    scores = jnp.where(mask, scores, NEG_INF)
    probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
    return jnp.einsum("bhqk,bhkd->bqhd", probs, v).astype(q.dtype)


def _cached_alibi_attention(q, cache, slopes, offset, ctx, attn_mask):
    """ALiBi decode over a cache — the Bloom twin of common.cached_attention
    (which handles the non-ALiBi archs): single-token steps go through
    kernels/decode_attention.py, which adds slope_h * key_pos to the
    scores; multi-token steps take the einsum."""
    from smoothquant_tpu.kernels import decode_attention as da
    from smoothquant_tpu.models.common import (QuantKVCache, attention_route,
                                               decode_bias)

    b, sq, nh, d = q.shape
    quant = isinstance(cache, QuantKVCache)
    kbuf = cache.k_q if quant else cache.k
    s = kbuf.shape[2]
    if sq == 1:
        valid = jnp.broadcast_to(jnp.asarray(cache.pos, jnp.int32), (b,))
        bias = decode_bias(valid - 1, b, s, attn_mask)
        out = da.decode_attention(
            q[:, 0], kbuf, cache.v_q if quant else cache.v, bias,
            cache.k_scale if quant else None,
            cache.v_scale if quant else None, slopes,
            **attention_route(ctx, s, nh, nh, d))
        return out[:, None]
    ck, cv = cache.read()
    return _alibi_attention(q, ck, cv, slopes, offset, cache.pos, attn_mask)


def _decoder_layer(lp, x, cfg, name, slopes, ctx, cache, attn_mask):
    b, s, _ = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim

    residual = x
    hidden = layer_norm(lp["input_layernorm"], x, cfg.layer_norm_epsilon)
    sa = lp["self_attention"]
    fused = call_linear(sa["query_key_value"], hidden,
                        f"{name}.self_attention.query_key_value", ctx, True)
    qkv = fused.reshape(b, s, nh, 3, d)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    if cache is not None:
        offset = cache.pos
        cache = cache.update(k, v)
        a = _cached_alibi_attention(q, cache, slopes, offset, ctx, attn_mask)
    else:
        a = _alibi_attention(q, to_head_major(k), to_head_major(v),
                             slopes, 0, None, attn_mask)
    a = a.reshape(b, s, nh * d)
    x = residual + call_linear(sa["dense"], a,
                               f"{name}.self_attention.dense", ctx)

    residual = x
    hidden = layer_norm(lp["post_attention_layernorm"], x, cfg.layer_norm_epsilon)
    h1 = call_linear(lp["mlp"]["dense_h_to_4h"], hidden,
                     f"{name}.mlp.dense_h_to_4h", ctx)
    # HF Bloom uses exact gelu
    x = residual + call_linear(lp["mlp"]["dense_4h_to_h"],
                               jax.nn.gelu(h1, approximate=False),
                               f"{name}.mlp.dense_4h_to_h", ctx)
    return x, cache


def stack_layers(params: dict, cfg: BloomConfig) -> dict:
    """Pre-stack per-layer pytrees along a leading L axis for the lax.scan
    forward — one compiled layer body instead of num_hidden_layers (cf.
    llama.stack_layers; Bloom-176B has 70 layers)."""
    layer_list = [params["layers"][str(i)]
                  for i in range(cfg.num_hidden_layers)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *layer_list)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {"stacked": stacked}
    return out


def stacked_caches(cfg: BloomConfig, batch: int, max_len: int, dtype,
                   pos: int = 0, quant_kv: bool = False):
    """A scan-ready KV cache: every field carries a leading layers axis.
    quant_kv=True builds the INT8 cache consumed in place by the fused
    flash-decode kernel (half the per-step cache read)."""
    from smoothquant_tpu.models.common import QuantKVCache

    shape = (cfg.num_hidden_layers, batch, cfg.num_attention_heads, max_len,
             cfg.head_dim)
    poss = jnp.full((cfg.num_hidden_layers,), pos, jnp.int32)
    if quant_kv:
        return QuantKVCache(
            k_q=jnp.zeros(shape, jnp.int8), v_q=jnp.zeros(shape, jnp.int8),
            k_scale=jnp.zeros(shape[:4], jnp.float32),
            v_scale=jnp.zeros(shape[:4], jnp.float32),
            pos=poss,
        )
    return KVCache(k=jnp.zeros(shape, dtype), v=jnp.zeros(shape, dtype),
                   pos=poss)


def _prefetch_scan_decode(params, x, cfg, ctx, caches, slopes, attn_mask):
    """Single-token decode over stacked PACKED layers without scan-slice
    copies — the Bloom twin of opt._prefetch_scan_decode: the kernels read
    only layer i's weight/KV tiles; the decode attention applies the per-head ALiBi term in-kernel (score +=
    slope_h * key_pos, matching _alibi_attention)."""
    from smoothquant_tpu.models.common import (
        QuantKVCache,
        decode_bias,
        stacked_cache_append,
        stacked_flash_attention,
    )

    stacked = params["layers"]["stacked"]
    b, s, h = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    s_max = (caches.k_q if isinstance(caches, QuantKVCache)
             else caches.k).shape[3]

    def norm_at(node, i):
        return {"weight": node["weight"][i], "bias": node["bias"][i]}

    def body(carry, i):
        x, cache = carry
        sa = stacked["self_attention"]
        nm = "transformer.h.scan"
        residual = x
        hidden = layer_norm(norm_at(stacked["input_layernorm"], i), x,
                            cfg.layer_norm_epsilon)
        fused = call_linear(sa["query_key_value"], hidden,
                            f"{nm}.self_attention.query_key_value", ctx,
                            True, layer_idx=i)
        qkv = fused.reshape(b, s, nh, 3, d)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]

        cache, pos_i = stacked_cache_append(cache, i, k, v)
        bias = decode_bias(pos_i, b, s_max, attn_mask)
        a = stacked_flash_attention(cache, i, q[:, 0], bias, ctx,
                                    alibi_slopes=slopes)
        a = a[:, None].reshape(b, s, nh * d)
        x = residual + call_linear(sa["dense"], a,
                                   f"{nm}.self_attention.dense", ctx,
                                   layer_idx=i)

        residual = x
        hidden = layer_norm(norm_at(stacked["post_attention_layernorm"], i),
                            x, cfg.layer_norm_epsilon)
        h1 = call_linear(stacked["mlp"]["dense_h_to_4h"], hidden,
                         f"{nm}.mlp.dense_h_to_4h", ctx, layer_idx=i)
        h2 = call_linear(stacked["mlp"]["dense_4h_to_h"],
                         jax.nn.gelu(h1, approximate=False),
                         f"{nm}.mlp.dense_4h_to_h", ctx, layer_idx=i)
        cache = cache._replace(pos=cache.pos.at[i].add(s))
        return (residual + h2, cache), None

    (x, caches), _ = jax.lax.scan(
        body, (x, caches), jnp.arange(cfg.num_hidden_layers))
    return x, caches


def _prefetch_capable(params, cfg, ctx, caches, s: int) -> bool:
    from smoothquant_tpu.models.common import prefetch_tree_capable

    return prefetch_tree_capable(params["layers"].get("stacked"), ctx,
                                 caches, s)


def forward(
    params: dict,
    input_ids: jax.Array,
    cfg: BloomConfig,
    ctx: Optional[ForwardContext] = None,
    caches: Optional[list[KVCache]] = None,
    positions: Optional[jax.Array] = None,
    attn_mask: Optional[jax.Array] = None,
) -> tuple[jax.Array, Optional[list[KVCache]]]:
    b, s = input_ids.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    stacked_mode = "stacked" in params["layers"]
    x = jnp.take(params["word_embeddings"]["weight"], input_ids, axis=0)
    x = layer_norm(params["word_embeddings_layernorm"], x, cfg.layer_norm_epsilon)
    slopes = jnp.asarray(alibi_slopes(nh))

    if stacked_mode and _prefetch_capable(params, cfg, ctx, caches, s):
        x, new_caches = _prefetch_scan_decode(params, x, cfg, ctx, caches,
                                              slopes, attn_mask)
    elif stacked_mode:
        assert ctx is None or ctx.taps is None, "taps unsupported with scan"

        def body(carry, layer_in):
            lp, cache = layer_in
            y, cache = _decoder_layer(lp, carry, cfg, "transformer.h.scan",
                                      slopes, ctx, cache, attn_mask)
            return y, cache

        x, new_caches = jax.lax.scan(body, x,
                                     (params["layers"]["stacked"], caches))
    else:
        new_caches = [] if caches is not None else None
        for i in range(cfg.num_hidden_layers):
            cache = caches[i] if caches is not None else None
            x, cache = _decoder_layer(
                params["layers"][str(i)], x, cfg, f"transformer.h.{i}",
                slopes, ctx, cache, attn_mask)
            if new_caches is not None:
                new_caches.append(cache)

    x = layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon)
    return unembed(x, params["word_embeddings"]["weight"]), new_caches


def quantize_params(params: dict, cfg: BloomConfig, qcfg: QuantConfig,
                    input_feat: Optional[dict] = None) -> dict:
    """Extension beyond the reference (its quantize_model rejects Bloom)."""
    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        prefix = f"transformer.h.{i}"

        def imp(name):
            return None if input_feat is None else np.asarray(input_feat[name])

        sa = dict(lp["self_attention"])
        sa["query_key_value"] = quantize_linear_params(
            sa["query_key_value"], qcfg,
            imp(f"{prefix}.self_attention.query_key_value"))
        sa["dense"] = quantize_linear_params(
            sa["dense"], qcfg, imp(f"{prefix}.self_attention.dense"))
        mlp = dict(lp["mlp"])
        for p in ("dense_h_to_4h", "dense_4h_to_h"):
            mlp[p] = quantize_linear_params(mlp[p], qcfg, imp(f"{prefix}.mlp.{p}"))
        lp["self_attention"], lp["mlp"] = sa, mlp
        new_layers[str(i)] = lp
    out = dict(params)
    out["layers"] = new_layers
    return out


def smoothing_map(cfg: BloomConfig):
    """smooth_lm Bloom branch (smooth.py:91-100)."""
    pairs = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pairs.append((
            li + ("input_layernorm",),
            [li + ("self_attention", "query_key_value")],
            f"transformer.h.{i}.self_attention.query_key_value",
        ))
        pairs.append((
            li + ("post_attention_layernorm",),
            [li + ("mlp", "dense_h_to_4h")],
            f"transformer.h.{i}.mlp.dense_h_to_4h",
        ))
    return pairs


def config_from_hf(hf_cfg) -> BloomConfig:
    return BloomConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_hidden_layers=hf_cfg.n_layer,
        num_attention_heads=hf_cfg.n_head,
        layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
    )


def params_from_hf_state_dict(state: dict, cfg: BloomConfig, dtype=None) -> dict:
    dtype = jnp.dtype(dtype or cfg.dtype)

    def arr(name):
        return jnp.asarray(np.asarray(state[name]), dtype)

    def lin(name):
        return {"weight": arr(name + ".weight"), "bias": arr(name + ".bias")}

    def ln(name):
        return {"weight": arr(name + ".weight"), "bias": arr(name + ".bias")}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.h.{i}"
        layers[str(i)] = {
            "input_layernorm": ln(f"{p}.input_layernorm"),
            "post_attention_layernorm": ln(f"{p}.post_attention_layernorm"),
            "self_attention": {
                "query_key_value": lin(f"{p}.self_attention.query_key_value"),
                "dense": lin(f"{p}.self_attention.dense"),
            },
            "mlp": {
                "dense_h_to_4h": lin(f"{p}.mlp.dense_h_to_4h"),
                "dense_4h_to_h": lin(f"{p}.mlp.dense_4h_to_h"),
            },
        }
    return {
        "word_embeddings": {"weight": arr("transformer.word_embeddings.weight")},
        "word_embeddings_layernorm": ln("transformer.word_embeddings_layernorm"),
        "layers": layers,
        "ln_f": ln("transformer.ln_f"),
    }


def quantizable_linears(cfg: BloomConfig):
    """(params_path, feat/scales key, quantize_output) — generic packing."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pre = f"transformer.h.{i}"
        out.append((li + ("self_attention", "query_key_value"),
                    f"{pre}.self_attention.query_key_value", True))
        out.append((li + ("self_attention", "dense"),
                    f"{pre}.self_attention.dense", False))
        out.append((li + ("mlp", "dense_h_to_4h"), f"{pre}.mlp.dense_h_to_4h", False))
        out.append((li + ("mlp", "dense_4h_to_h"), f"{pre}.mlp.dense_4h_to_h", False))
    return out
