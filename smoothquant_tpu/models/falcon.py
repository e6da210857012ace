"""Falcon decoder — functional JAX.

Covers the three HF Falcon layouts the reference handles in smoothing
(smooth.py:101-125) and quantization (fake_quant.py:671-731):
  * 7B style: multi-query (1 kv head), parallel attention+MLP off ONE
    input_layernorm;
  * 40B style (new_decoder_architecture): GQA, parallel attn+MLP with
    separate ln_attn / ln_mlp;
  * RW style: sequential blocks with input/post_attention layernorms.

The fused query_key_value projection's head layout matches HF: for the new
architecture, heads are grouped [q*heads_per_group, k, v] per kv group; for
multi_query, [all q heads, k, v]; otherwise per-head [q, k, v] interleave.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from smoothquant_tpu.models.common import (
    ForwardContext,
    KVCache,
    apply_rotary,
    attention,
    cached_attention,
    call_linear,
    layer_norm,
    rotary_cos_sin,
    to_head_major,
    unembed,
)
from smoothquant_tpu.quant.config import QuantConfig
from smoothquant_tpu.quant.linear import quantize_linear_params


@dataclasses.dataclass(frozen=True)
class FalconConfig:
    vocab_size: int = 65024
    hidden_size: int = 4544
    num_hidden_layers: int = 32
    num_attention_heads: int = 71
    num_kv_heads: int = 1
    multi_query: bool = True
    parallel_attn: bool = True
    new_decoder_architecture: bool = False
    bias: bool = False
    layer_norm_epsilon: float = 1e-5
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def effective_kv_heads(self) -> int:
        if self.new_decoder_architecture:
            return self.num_kv_heads
        return 1 if self.multi_query else self.num_attention_heads

    @classmethod
    def tiny(cls, vocab_size: int = 256, **kw) -> "FalconConfig":
        base = dict(vocab_size=vocab_size, hidden_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_kv_heads=2, dtype="float32")
        base.update(kw)
        return cls(**base)


def _qkv_dim(cfg: FalconConfig) -> int:
    return cfg.hidden_size + 2 * cfg.effective_kv_heads * cfg.head_dim


def init_params(key: jax.Array, cfg: FalconConfig) -> dict:
    dtype = jnp.dtype(cfg.dtype)
    h = cfg.hidden_size
    keys = iter(jax.random.split(key, 2 + cfg.num_hidden_layers * 4))

    def lin(k, out_f, in_f):
        p = {"weight": jax.random.normal(k, (out_f, in_f), dtype) * (in_f ** -0.5)}
        p["bias"] = jnp.zeros((out_f,), dtype) if cfg.bias else None
        return p

    def ln(c):
        return {"weight": jnp.ones((c,), dtype), "bias": jnp.zeros((c,), dtype)}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = {
            "self_attention": {
                "query_key_value": lin(next(keys), _qkv_dim(cfg), h),
                "dense": lin(next(keys), h, h),
            },
            "mlp": {
                "dense_h_to_4h": lin(next(keys), 4 * h, h),
                "dense_4h_to_h": lin(next(keys), h, 4 * h),
            },
        }
        if cfg.new_decoder_architecture:
            lp["ln_attn"] = ln(h)
            lp["ln_mlp"] = ln(h)
        else:
            lp["input_layernorm"] = ln(h)
            if not cfg.parallel_attn:
                lp["post_attention_layernorm"] = ln(h)
        layers[str(i)] = lp
    return {
        "word_embeddings": {"weight": jax.random.normal(next(keys), (cfg.vocab_size, h), dtype) * 0.02},
        "layers": layers,
        "ln_f": ln(h),
    }


def _split_qkv(fused: jax.Array, cfg: FalconConfig):
    """Split the fused QKV projection into q/k/v with HF's head layout."""
    b, s, _ = fused.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    n_kv = cfg.effective_kv_heads
    if cfg.new_decoder_architecture:
        # (B, S, n_kv, heads_per_group + 2, d): per group [q..., k, v]
        per = nh // n_kv
        qkv = fused.reshape(b, s, n_kv, per + 2, d)
        q = qkv[:, :, :, :per].reshape(b, s, nh, d)
        k = qkv[:, :, :, per]
        v = qkv[:, :, :, per + 1]
    elif cfg.multi_query:
        q = fused[..., : nh * d].reshape(b, s, nh, d)
        k = fused[..., nh * d : (nh + 1) * d].reshape(b, s, 1, d)
        v = fused[..., (nh + 1) * d :].reshape(b, s, 1, d)
    else:
        qkv = fused.reshape(b, s, nh, 3, d)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    return q, k, v


def _decoder_layer(lp, x, cfg, name, cos, sin, ctx, cache, attn_mask):
    b, s, _ = x.shape
    eps = cfg.layer_norm_epsilon
    residual = x

    if cfg.new_decoder_architecture:
        attn_in = layer_norm(lp["ln_attn"], x, eps)
        mlp_in = layer_norm(lp["ln_mlp"], x, eps)
    else:
        attn_in = layer_norm(lp["input_layernorm"], x, eps)
        mlp_in = attn_in  # parallel_attn shares the single LN

    sa = lp["self_attention"]
    fused = call_linear(sa["query_key_value"], attn_in,
                        f"{name}.self_attention.query_key_value", ctx, True)
    q, k, v = _split_qkv(fused, cfg)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    if cache is not None:
        offset = cache.pos
        cache = cache.update(k, v)
        a = cached_attention(q, cache, causal_offset=offset, ctx=ctx,
                             attn_mask=attn_mask)
    else:
        a = attention(q, to_head_major(k), to_head_major(v),
                      attn_mask=attn_mask, ctx=ctx)
    a = a.reshape(b, s, cfg.num_attention_heads * cfg.head_dim)
    attn_out = call_linear(sa["dense"], a, f"{name}.self_attention.dense", ctx)

    if cfg.parallel_attn or cfg.new_decoder_architecture:
        h1 = call_linear(lp["mlp"]["dense_h_to_4h"], mlp_in,
                         f"{name}.mlp.dense_h_to_4h", ctx)
        mlp_out = call_linear(lp["mlp"]["dense_4h_to_h"], jax.nn.gelu(h1),
                              f"{name}.mlp.dense_4h_to_h", ctx)
        x = residual + attn_out + mlp_out
    else:
        x = residual + attn_out
        residual = x
        mlp_in = layer_norm(lp["post_attention_layernorm"], x, eps)
        h1 = call_linear(lp["mlp"]["dense_h_to_4h"], mlp_in,
                         f"{name}.mlp.dense_h_to_4h", ctx)
        x = residual + call_linear(lp["mlp"]["dense_4h_to_h"], jax.nn.gelu(h1),
                                   f"{name}.mlp.dense_4h_to_h", ctx)
    return x, cache


def stack_layers(params: dict, cfg: FalconConfig) -> dict:
    """Pre-stack per-layer pytrees along a leading L axis for the lax.scan
    forward — one compiled layer body instead of num_hidden_layers (same
    mechanism as llama.stack_layers; matters most for the 32-60-layer
    Falcon sizes)."""
    layer_list = [params["layers"][str(i)]
                  for i in range(cfg.num_hidden_layers)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *layer_list)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {"stacked": stacked}
    return out


def stacked_caches(cfg: FalconConfig, batch: int, max_len: int, dtype,
                   pos: int = 0, quant_kv: bool = False):
    """A scan-ready KV cache: every field carries a leading layers axis.
    quant_kv=True builds the INT8 cache consumed in place by the fused
    flash-decode kernel (half the per-step cache read)."""
    from smoothquant_tpu.models.common import QuantKVCache

    shape = (cfg.num_hidden_layers, batch, cfg.effective_kv_heads, max_len,
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


def _prefetch_scan_decode(params, x, cfg, ctx, caches, cos, sin, attn_mask):
    """Single-token decode over stacked PACKED layers without scan-slice
    copies — the Falcon twin of opt._prefetch_scan_decode (covers the
    new-decoder, parallel-attn, and classic block layouts; MQA/GQA KV
    heads ride the flash kernel's rep axis)."""
    from smoothquant_tpu.models.common import (
        QuantKVCache,
        decode_bias,
        stacked_cache_append,
        stacked_flash_attention,
    )

    stacked = params["layers"]["stacked"]
    b, s, h = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.layer_norm_epsilon
    s_max = (caches.k_q if isinstance(caches, QuantKVCache)
             else caches.k).shape[3]

    def norm_at(node, i):
        return {"weight": node["weight"][i], "bias": node["bias"][i]}

    def body(carry, i):
        x, cache = carry
        sa = stacked["self_attention"]
        nm = "transformer.h.scan"
        residual = x
        if cfg.new_decoder_architecture:
            attn_in = layer_norm(norm_at(stacked["ln_attn"], i), x, eps)
            mlp_in = layer_norm(norm_at(stacked["ln_mlp"], i), x, eps)
        else:
            attn_in = layer_norm(norm_at(stacked["input_layernorm"], i), x,
                                 eps)
            mlp_in = attn_in  # parallel_attn shares the single LN

        fused = call_linear(sa["query_key_value"], attn_in,
                            f"{nm}.self_attention.query_key_value", ctx,
                            True, layer_idx=i)
        q, k, v = _split_qkv(fused, cfg)
        q = apply_rotary(q, cos, sin)    # k-rotary fuses into the writer

        cache, pos_i = stacked_cache_append(cache, i, k, v, cos, sin,
                                            rotate_k=True)
        bias = decode_bias(pos_i, b, s_max, attn_mask)
        a = stacked_flash_attention(cache, i, q[:, 0], bias, ctx)
        a = a[:, None].reshape(b, s, nh * d)
        attn_out = call_linear(sa["dense"], a,
                               f"{nm}.self_attention.dense", ctx,
                               layer_idx=i)

        if cfg.parallel_attn or cfg.new_decoder_architecture:
            h1 = call_linear(stacked["mlp"]["dense_h_to_4h"], mlp_in,
                             f"{nm}.mlp.dense_h_to_4h", ctx, layer_idx=i)
            mlp_out = call_linear(stacked["mlp"]["dense_4h_to_h"],
                                  jax.nn.gelu(h1),
                                  f"{nm}.mlp.dense_4h_to_h", ctx,
                                  layer_idx=i)
            x = residual + attn_out + mlp_out
        else:
            x = residual + attn_out
            residual = x
            mlp_in2 = layer_norm(
                norm_at(stacked["post_attention_layernorm"], i), x, eps)
            h1 = call_linear(stacked["mlp"]["dense_h_to_4h"], mlp_in2,
                             f"{nm}.mlp.dense_h_to_4h", ctx, layer_idx=i)
            x = residual + call_linear(stacked["mlp"]["dense_4h_to_h"],
                                       jax.nn.gelu(h1),
                                       f"{nm}.mlp.dense_4h_to_h", ctx,
                                       layer_idx=i)
        cache = cache._replace(pos=cache.pos.at[i].add(s))
        return (x, cache), None

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
    cfg: FalconConfig,
    ctx: Optional[ForwardContext] = None,
    caches: Optional[list[KVCache]] = None,
    positions: Optional[jax.Array] = None,
    attn_mask: Optional[jax.Array] = None,
) -> tuple[jax.Array, Optional[list[KVCache]]]:
    b, s = input_ids.shape
    stacked_mode = "stacked" in params["layers"]
    x = jnp.take(params["word_embeddings"]["weight"], input_ids, axis=0)
    if positions is None:
        if caches is None:
            start = jnp.asarray(0)
        elif stacked_mode:
            start = caches.pos[0]
        else:
            start = jnp.asarray(caches[0].pos)
        if start.ndim == 1:
            start = start[:, None]
        positions = start + jax.lax.broadcasted_iota(jnp.int32, (b, s), 1)
    cos, sin = rotary_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    if stacked_mode and _prefetch_capable(params, cfg, ctx, caches, s):
        x, new_caches = _prefetch_scan_decode(params, x, cfg, ctx, caches,
                                              cos, sin, attn_mask)
    elif stacked_mode:
        assert ctx is None or ctx.taps is None, "taps unsupported with scan"

        def body(carry, layer_in):
            lp, cache = layer_in
            y, cache = _decoder_layer(lp, carry, cfg, "transformer.h.scan",
                                      cos, sin, ctx, cache, attn_mask)
            return y, cache

        x, new_caches = jax.lax.scan(body, x,
                                     (params["layers"]["stacked"], caches))
    else:
        new_caches = [] if caches is not None else None
        for i in range(cfg.num_hidden_layers):
            cache = caches[i] if caches is not None else None
            x, cache = _decoder_layer(
                params["layers"][str(i)], x, cfg, f"transformer.h.{i}",
                cos, sin, ctx, cache, attn_mask)
            if new_caches is not None:
                new_caches.append(cache)

    x = layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon)
    return unembed(x, params["word_embeddings"]["weight"]), new_caches


def quantize_params(params: dict, cfg: FalconConfig, qcfg: QuantConfig,
                    input_feat: Optional[dict] = None) -> dict:
    """quantize_falcon equivalent (fake_quant.py:671-731): query_key_value
    (with output quant), dense, dense_h_to_4h, dense_4h_to_h."""
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


def smoothing_map(cfg: FalconConfig):
    """smooth_lm Falcon branch (smooth.py:101-125), incl. the parallel-attn
    single-LN case where one LN feeds both QKV and the MLP up-projection."""
    pairs = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        qkv = li + ("self_attention", "query_key_value")
        fc1 = li + ("mlp", "dense_h_to_4h")
        qkv_key = f"transformer.h.{i}.self_attention.query_key_value"
        fc1_key = f"transformer.h.{i}.mlp.dense_h_to_4h"
        if not cfg.new_decoder_architecture and cfg.parallel_attn:
            pairs.append((li + ("input_layernorm",), [qkv, fc1], qkv_key))
        elif cfg.new_decoder_architecture:
            pairs.append((li + ("ln_attn",), [qkv], qkv_key))
            pairs.append((li + ("ln_mlp",), [fc1], fc1_key))
        else:
            pairs.append((li + ("input_layernorm",), [qkv], qkv_key))
            pairs.append((li + ("post_attention_layernorm",), [fc1], fc1_key))
    return pairs


def config_from_hf(hf_cfg) -> FalconConfig:
    return FalconConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        num_kv_heads=getattr(hf_cfg, "num_kv_heads", 1) or 1,
        multi_query=getattr(hf_cfg, "multi_query", True),
        parallel_attn=getattr(hf_cfg, "parallel_attn", True),
        new_decoder_architecture=getattr(hf_cfg, "new_decoder_architecture", False),
        bias=getattr(hf_cfg, "bias", False),
        layer_norm_epsilon=hf_cfg.layer_norm_epsilon,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
    )


def params_from_hf_state_dict(state: dict, cfg: FalconConfig, dtype=None) -> dict:
    dtype = jnp.dtype(dtype or cfg.dtype)

    def arr(name):
        return jnp.asarray(np.asarray(state[name]), dtype)

    def lin(name):
        p = {"weight": arr(name + ".weight")}
        p["bias"] = arr(name + ".bias") if cfg.bias and name + ".bias" in state else None
        return p

    def ln(name):
        return {"weight": arr(name + ".weight"), "bias": arr(name + ".bias")}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.h.{i}"
        lp = {
            "self_attention": {
                "query_key_value": lin(f"{p}.self_attention.query_key_value"),
                "dense": lin(f"{p}.self_attention.dense"),
            },
            "mlp": {
                "dense_h_to_4h": lin(f"{p}.mlp.dense_h_to_4h"),
                "dense_4h_to_h": lin(f"{p}.mlp.dense_4h_to_h"),
            },
        }
        if cfg.new_decoder_architecture:
            lp["ln_attn"] = ln(f"{p}.ln_attn")
            lp["ln_mlp"] = ln(f"{p}.ln_mlp")
        else:
            lp["input_layernorm"] = ln(f"{p}.input_layernorm")
            if not cfg.parallel_attn:
                lp["post_attention_layernorm"] = ln(f"{p}.post_attention_layernorm")
        layers[str(i)] = lp
    return {
        "word_embeddings": {"weight": arr("transformer.word_embeddings.weight")},
        "layers": layers,
        "ln_f": ln("transformer.ln_f"),
    }


def quantizable_linears(cfg: FalconConfig):
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
