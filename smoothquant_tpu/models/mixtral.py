"""Mixtral (sparse MoE) decoder — functional JAX.

Llama-style attention (GQA, RoPE) + top-2 expert routing.  Quantization
surgery mirrors quantize_mixtral (fake_quant.py:564-668): per expert w1/w2/w3,
attention projections, and the MoE router gate.  Smoothing mirrors
smooth_lm's Mixtral branch (smooth.py:142-160): post_attention_layernorm →
[gate] + every expert's w1 and w3.

Routing is computed exactly as HF (softmax over router logits, top-2,
renormalized); expert execution is dense-weighted (every expert computed,
weighted by routing probs) — numerically identical to sparse dispatch and
XLA-friendly; capacity-based sparse dispatch is a serving optimization to
layer on later (expert parallelism over the mesh).
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
    rms_norm,
    rotary_cos_sin,
    to_head_major,
    unembed,
)
from smoothquant_tpu.quant.config import QuantConfig
from smoothquant_tpu.quant.linear import quantize_linear_params


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e6
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "MixtralConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=96,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, num_local_experts=4,
                   max_position_embeddings=128, dtype="float32")


ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj")
EXPERT_PROJS = ("w1", "w2", "w3")


def init_params(key: jax.Array, cfg: MixtralConfig) -> dict:
    dtype = jnp.dtype(cfg.dtype)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    kv_dim = cfg.num_key_value_heads * cfg.head_dim
    n_keys = 4 + cfg.num_hidden_layers * (5 + 3 * cfg.num_local_experts)
    keys = iter(jax.random.split(key, n_keys))

    def lin(k, out_f, in_f):
        return {"weight": jax.random.normal(k, (out_f, in_f), dtype) * (in_f ** -0.5),
                "bias": None}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        experts = {
            str(e): {
                "w1": lin(next(keys), inter, h),
                "w2": lin(next(keys), h, inter),
                "w3": lin(next(keys), inter, h),
            }
            for e in range(cfg.num_local_experts)
        }
        layers[str(i)] = {
            "input_layernorm": {"weight": jnp.ones((h,), dtype)},
            "post_attention_layernorm": {"weight": jnp.ones((h,), dtype)},
            "self_attn": {
                "q_proj": lin(next(keys), h, h),
                "k_proj": lin(next(keys), kv_dim, h),
                "v_proj": lin(next(keys), kv_dim, h),
                "o_proj": lin(next(keys), h, h),
            },
            "block_sparse_moe": {
                "gate": lin(next(keys), cfg.num_local_experts, h),
                "experts": experts,
            },
        }
    return {
        "embed_tokens": {"weight": jax.random.normal(next(keys), (cfg.vocab_size, h), dtype) * 0.02},
        "layers": layers,
        "norm": {"weight": jnp.ones((h,), dtype)},
        "lm_head": lin(next(keys), cfg.vocab_size, h),
    }


def stack_experts(params: dict, cfg: MixtralConfig) -> dict:
    """Stack each layer's per-expert trees along a leading E axis (one copy,
    outside jit).  Required for expert parallelism: the stacked leaves shard
    cleanly with P("ep", ...) and each device slices its local experts."""
    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        moe = dict(lp["block_sparse_moe"])
        ex = [moe["experts"][str(e)] for e in range(cfg.num_local_experts)]
        moe["experts"] = {"stacked": jax.tree.map(lambda *xs: jnp.stack(xs), *ex)}
        lp["block_sparse_moe"] = moe
        new_layers[str(i)] = lp
    out = dict(params)
    out["layers"] = new_layers
    return out


def _experts_view(bp: dict):
    """Per-expert param list from either dict-of-experts or stacked form."""
    ex = bp["experts"]
    if "stacked" in ex:
        stacked = ex["stacked"]
        e_local = jax.tree.leaves(stacked)[0].shape[0]
        return [jax.tree.map(lambda a, e=e: a[e], stacked)
                for e in range(e_local)], e_local
    n = len(ex)
    return [ex[str(e)] for e in range(n)], n


def moe_capacity(n_tokens: int, cfg: MixtralConfig,
                 capacity_factor: float) -> int:
    """Static per-expert buffer size for sparse dispatch.

    capacity = ceil(topk * n / E * factor), clamped to [1, n].  Per-expert
    FLOPs drop from n (dense, every expert computes every token) to
    capacity ≈ topk/E * n * factor — the top-2/8 saving the reference's
    dense simulation leaves on the table (fake_quant.py:564-668 only
    surgically replaces the expert Linears; HF routes sparsely on GPU).
    """
    e = cfg.num_local_experts
    k = cfg.num_experts_per_tok
    cap = -(-int(k * n_tokens * capacity_factor) // e)
    return max(1, min(n_tokens, cap))


def _route(bp, x, cfg, layer_name, ctx, layer_idx=None):
    """Router: softmax over gate logits, top-k, renormalized (HF-exact)."""
    router_logits = call_linear(bp["gate"], x, f"{layer_name}.gate", ctx,
                                layer_idx=layer_idx)
    probs = jax.nn.softmax(router_logits.astype(jnp.float32), axis=-1)
    top_p, top_idx = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)  # renormalize (HF)
    return top_p, top_idx


def _expert_mlp(ep, x2d, pre, ctx, layer_idx=None):
    g = call_linear(ep["w1"], x2d, f"{pre}.w1", ctx, layer_idx=layer_idx)
    u = call_linear(ep["w3"], x2d, f"{pre}.w3", ctx, layer_idx=layer_idx)
    return call_linear(ep["w2"], jax.nn.silu(g) * u, f"{pre}.w2", ctx,
                       layer_idx=layer_idx)


def _moe_block_dense(bp, x, cfg, layer_name, ctx, layer_idx=None,
                     experts_flat=None):
    top_p, top_idx = _route(bp, x, cfg, layer_name, ctx, layer_idx=layer_idx)
    one_hot = jax.nn.one_hot(top_idx, cfg.num_local_experts, dtype=top_p.dtype)
    weights = jnp.sum(one_hot * top_p[..., None], axis=-2)  # (B, S, E)

    if experts_flat is not None:
        e_local = cfg.num_local_experts
    else:
        experts, e_local = _experts_view(bp)
    out = jnp.zeros_like(x, dtype=jnp.float32)
    for e in range(e_local):
        if experts_flat is not None:
            y = _expert_mlp(experts_flat, x, f"{layer_name}.experts.{e}",
                            ctx, layer_idx=layer_idx * e_local + e)
        else:
            y = _expert_mlp(experts[e], x, f"{layer_name}.experts.{e}", ctx)
        out = out + y.astype(jnp.float32) * weights[..., e : e + 1].astype(jnp.float32)
    return out.astype(x.dtype)


def _moe_block_sparse(bp, x, cfg, layer_name, ctx, layer_idx=None,
                      experts_flat=None):
    """Capacity-bounded token-gather dispatch: each expert computes only its
    routed tokens.  Numerically identical to the dense path whenever no
    token exceeds capacity (overflow assignments are dropped, as in
    standard MoE serving).  Under expert parallelism (ctx.ep_axis) each
    device holds E/ep experts; contributions are psum-combined.

    layer_idx / experts_flat: prefetch-scan decode — experts_flat carries
    (L*E, ...)-leading expert leaves (the (L, E) axes flattened) and expert
    e of layer layer_idx is read at index layer_idx*E + e, so the full MoE weight stack rides the scan without
    per-iteration slice copies.
    """
    b, s, h = x.shape
    n = b * s
    topk = cfg.num_experts_per_tok
    e_total = cfg.num_local_experts
    xf = x.reshape(n, h)

    top_p, top_idx = _route(bp, x, cfg, layer_name, ctx, layer_idx=layer_idx)
    cf = ctx.moe_capacity_factor if ctx is not None else 2.0
    capacity = moe_capacity(n, cfg, cf)

    nk = n * topk
    flat_e = top_idx.reshape(nk)                         # expert per assignment
    flat_t = jnp.repeat(jnp.arange(n, dtype=jnp.int32), topk)
    flat_w = top_p.reshape(nk).astype(jnp.float32)

    # stable sort by expert → position within each expert's buffer
    order = jnp.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = jnp.zeros((e_total,), jnp.int32).at[flat_e].add(1)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(nk, dtype=jnp.int32) - starts[se]
    keep = pos < capacity

    if experts_flat is not None:
        e_local, offset = e_total, 0
    else:
        experts, e_local = _experts_view(bp)
        if ctx is not None and ctx.ep_axis is not None:
            offset = jax.lax.axis_index(ctx.ep_axis) * e_local
        else:
            offset = 0
            assert e_local == e_total
    le = se - offset
    mine = keep & (le >= 0) & (le < e_local)

    # scatter routed tokens into (E_local, capacity, H); overflow and other
    # devices' assignments land in a trash row
    dest = jnp.where(mine, le * capacity + pos, e_local * capacity)
    disp = jnp.zeros((e_local * capacity + 1, h), x.dtype).at[dest].set(xf[st])
    disp = disp[:-1].reshape(e_local, capacity, h)

    ys = []
    for e in range(e_local):
        if experts_flat is not None:
            ys.append(_expert_mlp(experts_flat, disp[e],
                                  f"{layer_name}.experts.{e}", ctx,
                                  layer_idx=layer_idx * e_total + e))
            continue
        # offset is a traced axis_index under EP — use a local tap name then
        name_e = e if isinstance(offset, int) else f"local{e}"
        ys.append(_expert_mlp(experts[e], disp[e],
                              f"{layer_name}.experts.{name_e}", ctx))
    ysf = jnp.concatenate([y[None] for y in ys], axis=0).reshape(
        e_local * capacity, h)
    ysf = jnp.concatenate([ysf, jnp.zeros((1, h), ysf.dtype)], axis=0)

    y_a = ysf[dest].astype(jnp.float32) * sw[:, None]
    y_a = jnp.where(mine[:, None], y_a, 0.0)
    out = jnp.zeros((n, h), jnp.float32).at[st].add(y_a)
    if ctx is not None and ctx.ep_axis is not None:
        out = jax.lax.psum(out, ctx.ep_axis)
    return out.reshape(b, s, h).astype(x.dtype)


def _moe_block(bp: dict, x: jax.Array, cfg: MixtralConfig, layer_name: str,
               ctx: Optional[ForwardContext], layer_idx=None,
               experts_flat=None) -> jax.Array:
    sparse = (ctx is not None
              and (ctx.moe_dispatch == "sparse" or ctx.ep_axis is not None))
    if sparse:
        return _moe_block_sparse(bp, x, cfg, layer_name, ctx,
                                 layer_idx=layer_idx,
                                 experts_flat=experts_flat)
    return _moe_block_dense(bp, x, cfg, layer_name, ctx,
                            layer_idx=layer_idx, experts_flat=experts_flat)


def _decoder_layer(lp, x, cfg, name, cos, sin, ctx, cache, attn_mask):
    b, s, _ = x.shape
    nh, n_kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    residual = x
    hidden = rms_norm(lp["input_layernorm"], x, cfg.rms_norm_eps)
    sa = lp["self_attn"]
    q = call_linear(sa["q_proj"], hidden, f"{name}.self_attn.q_proj", ctx, True)
    k = call_linear(sa["k_proj"], hidden, f"{name}.self_attn.k_proj", ctx, True)
    v = call_linear(sa["v_proj"], hidden, f"{name}.self_attn.v_proj", ctx, True)
    q = apply_rotary(q.reshape(b, s, nh, d), cos, sin)
    k = apply_rotary(k.reshape(b, s, n_kv, d), cos, sin)
    v = v.reshape(b, s, n_kv, d)
    if cache is not None:
        offset = cache.pos
        cache = cache.update(k, v)
        a = cached_attention(q, cache, causal_offset=offset, ctx=ctx,
                             attn_mask=attn_mask)
    else:
        a = attention(q, to_head_major(k), to_head_major(v),
                      attn_mask=attn_mask, ctx=ctx)
    x = residual + call_linear(sa["o_proj"], a.reshape(b, s, nh * d),
                               f"{name}.self_attn.o_proj", ctx)

    residual = x
    hidden = rms_norm(lp["post_attention_layernorm"], x, cfg.rms_norm_eps)
    x = residual + _moe_block(lp["block_sparse_moe"], hidden, cfg,
                              f"{name}.block_sparse_moe", ctx)
    return x, cache


def stack_layers(params: dict, cfg: MixtralConfig) -> dict:
    """Pre-stack per-layer pytrees (experts stacked first so the tree is
    uniform) along a leading L axis for the lax.scan forward — one compiled
    layer body instead of num_hidden_layers.  The MoE block (dense or
    sparse capacity-bounded dispatch) is static-shaped, so it scans."""
    if "stacked" not in params["layers"]["0"]["block_sparse_moe"]["experts"]:
        params = stack_experts(params, cfg)
    layer_list = [params["layers"][str(i)]
                  for i in range(cfg.num_hidden_layers)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *layer_list)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {"stacked": stacked}
    return out


def stacked_caches(cfg: MixtralConfig, batch: int, max_len: int, dtype,
                   pos: int = 0, quant_kv: bool = False):
    """A scan-ready KV cache: every field carries a leading layers axis.
    quant_kv=True builds the INT8 cache consumed in place by the fused
    flash-decode kernel."""
    from smoothquant_tpu.models.common import QuantKVCache

    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len,
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
    copies — the Mixtral twin of llama._prefetch_scan_decode.  The MoE
    expert weights ride as (L*E, ...)-flattened loop-invariant stacks and
    the matmuls read (layer, expert) = layer*E + e in place, so
    neither the attention nor the expert weights are ever slice-copied
    inside the scan."""
    from smoothquant_tpu.models.common import (
        QuantKVCache,
        decode_bias,
        stacked_cache_append,
        stacked_flash_attention,
    )

    stacked = params["layers"]["stacked"]
    moe = stacked["block_sparse_moe"]
    e_total = cfg.num_local_experts
    # flatten the (L, E, ...) expert leaves to (L*E, ...): a free reshape of
    # loop-invariant arrays, hoisted out of the scan by XLA
    experts_flat = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]),
                                moe["experts"]["stacked"])
    b, s, h = x.shape
    nh, n_kv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    s_max = (caches.k_q if isinstance(caches, QuantKVCache)
             else caches.k).shape[3]

    def norm_at(node, i):
        return {"weight": node["weight"][i]}

    def body(carry, i):
        x, cache = carry
        sa = stacked["self_attn"]
        nm = "model.layers.scan"
        residual = x
        hidden = rms_norm(norm_at(stacked["input_layernorm"], i), x,
                          cfg.rms_norm_eps)
        q = call_linear(sa["q_proj"], hidden, f"{nm}.q", ctx, True,
                        layer_idx=i)
        k = call_linear(sa["k_proj"], hidden, f"{nm}.k", ctx, True,
                        layer_idx=i)
        v = call_linear(sa["v_proj"], hidden, f"{nm}.v", ctx, True,
                        layer_idx=i)
        q = apply_rotary(q.reshape(b, s, nh, d), cos, sin)
        k = k.reshape(b, s, n_kv, d)      # k-rotary fuses into the writer
        v = v.reshape(b, s, n_kv, d)

        cache, pos_i = stacked_cache_append(cache, i, k, v, cos, sin,
                                            rotate_k=True)
        bias = decode_bias(pos_i, b, s_max, attn_mask)
        a = stacked_flash_attention(cache, i, q[:, 0], bias, ctx)
        a = a[:, None].reshape(b, s, nh * d)
        x = residual + call_linear(sa["o_proj"], a, f"{nm}.o", ctx,
                                   layer_idx=i)

        residual = x
        hidden = rms_norm(norm_at(stacked["post_attention_layernorm"], i),
                          x, cfg.rms_norm_eps)
        x = residual + _moe_block(moe, hidden, cfg, f"{nm}.block_sparse_moe",
                                  ctx, layer_idx=i,
                                  experts_flat=experts_flat)
        cache = cache._replace(pos=cache.pos.at[i].add(s))
        return (x, cache), None

    (x, caches), _ = jax.lax.scan(
        body, (x, caches), jnp.arange(cfg.num_hidden_layers))
    return x, caches


def _prefetch_capable(params, cfg, ctx, caches, s: int) -> bool:
    from smoothquant_tpu.models.common import prefetch_tree_capable

    stacked = params["layers"].get("stacked")
    if not prefetch_tree_capable(stacked, ctx, caches, s):
        return False
    return "stacked" in stacked.get("block_sparse_moe", {}).get(
        "experts", {})


def forward(
    params: dict,
    input_ids: jax.Array,
    cfg: MixtralConfig,
    ctx: Optional[ForwardContext] = None,
    caches: Optional[list[KVCache]] = None,
    positions: Optional[jax.Array] = None,
    attn_mask: Optional[jax.Array] = None,
) -> tuple[jax.Array, Optional[list[KVCache]]]:
    b, s = input_ids.shape
    stacked_mode = "stacked" in params["layers"]
    x = jnp.take(params["embed_tokens"]["weight"], input_ids, axis=0)
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
            y, cache = _decoder_layer(lp, carry, cfg, "model.layers.scan",
                                      cos, sin, ctx, cache, attn_mask)
            return y, cache

        x, new_caches = jax.lax.scan(body, x,
                                     (params["layers"]["stacked"], caches))
    else:
        new_caches = [] if caches is not None else None
        for i in range(cfg.num_hidden_layers):
            cache = caches[i] if caches is not None else None
            x, cache = _decoder_layer(
                params["layers"][str(i)], x, cfg, f"model.layers.{i}",
                cos, sin, ctx, cache, attn_mask)
            if new_caches is not None:
                new_caches.append(cache)

    x = rms_norm(params["norm"], x, cfg.rms_norm_eps)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        logits = unembed(x, params["embed_tokens"]["weight"])
    else:
        logits = jnp.einsum("bsh,vh->bsv", x,
                            params["lm_head"]["weight"].astype(x.dtype),
                            preferred_element_type=jnp.float32)
    return logits, new_caches


def quantize_params(params: dict, cfg: MixtralConfig, qcfg: QuantConfig,
                    input_feat: Optional[dict] = None) -> dict:
    """quantize_mixtral equivalent (fake_quant.py:564-668)."""
    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        prefix = f"model.layers.{i}"

        def imp(name):
            return None if input_feat is None else np.asarray(input_feat[name])

        sa = dict(lp["self_attn"])
        for p in ATTN_PROJS:
            sa[p] = quantize_linear_params(sa[p], qcfg, imp(f"{prefix}.self_attn.{p}"))
        moe = dict(lp["block_sparse_moe"])
        moe["gate"] = quantize_linear_params(
            moe["gate"], qcfg, imp(f"{prefix}.block_sparse_moe.gate"))
        experts = {}
        for e in range(cfg.num_local_experts):
            ep = dict(moe["experts"][str(e)])
            for p in EXPERT_PROJS:
                ep[p] = quantize_linear_params(
                    ep[p], qcfg,
                    imp(f"{prefix}.block_sparse_moe.experts.{e}.{p}"))
            experts[str(e)] = ep
        moe["experts"] = experts
        lp["self_attn"], lp["block_sparse_moe"] = sa, moe
        new_layers[str(i)] = lp
    out = dict(params)
    out["layers"] = new_layers
    return out


def smoothing_map(cfg: MixtralConfig):
    """smooth_lm Mixtral branch (smooth.py:142-160)."""
    pairs = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pairs.append((
            li + ("input_layernorm",),
            [li + ("self_attn", p) for p in ("q_proj", "k_proj", "v_proj")],
            f"model.layers.{i}.self_attn.q_proj",
        ))
        fcs = [li + ("block_sparse_moe", "gate")]
        for e in range(cfg.num_local_experts):
            fcs.append(li + ("block_sparse_moe", "experts", str(e), "w1"))
            fcs.append(li + ("block_sparse_moe", "experts", str(e), "w3"))
        pairs.append((
            li + ("post_attention_layernorm",),
            fcs,
            f"model.layers.{i}.block_sparse_moe.gate",
        ))
    return pairs


def config_from_hf(hf_cfg) -> MixtralConfig:
    return MixtralConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        num_key_value_heads=hf_cfg.num_key_value_heads,
        num_local_experts=hf_cfg.num_local_experts,
        num_experts_per_tok=hf_cfg.num_experts_per_tok,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rms_norm_eps=hf_cfg.rms_norm_eps,
        rope_theta=getattr(hf_cfg, "rope_theta", 1e6),
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
    )


def params_from_hf_state_dict(state: dict, cfg: MixtralConfig, dtype=None) -> dict:
    dtype = jnp.dtype(dtype or cfg.dtype)

    def arr(name):
        return jnp.asarray(np.asarray(state[name]), dtype)

    def lin(name):
        return {"weight": arr(name + ".weight"), "bias": None}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        layers[str(i)] = {
            "input_layernorm": {"weight": arr(f"{p}.input_layernorm.weight")},
            "post_attention_layernorm": {"weight": arr(f"{p}.post_attention_layernorm.weight")},
            "self_attn": {k: lin(f"{p}.self_attn.{k}") for k in ATTN_PROJS},
            "block_sparse_moe": {
                "gate": lin(f"{p}.block_sparse_moe.gate"),
                "experts": {
                    str(e): {k: lin(f"{p}.block_sparse_moe.experts.{e}.{k}")
                             for k in EXPERT_PROJS}
                    for e in range(cfg.num_local_experts)
                },
            },
        }
    params = {
        "embed_tokens": {"weight": arr("model.embed_tokens.weight")},
        "layers": layers,
        "norm": {"weight": arr("model.norm.weight")},
    }
    if "lm_head.weight" in state:
        params["lm_head"] = {"weight": arr("lm_head.weight"), "bias": None}
    return params


def quantizable_linears(cfg: MixtralConfig):
    """(params_path, feat/scales key, quantize_output) — generic packing."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pre = f"model.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj"):
            out.append((li + ("self_attn", p), f"{pre}.self_attn.{p}", True))
        out.append((li + ("self_attn", "o_proj"), f"{pre}.self_attn.o_proj", False))
        out.append((li + ("block_sparse_moe", "gate"),
                    f"{pre}.block_sparse_moe.gate", False))
        for e in range(cfg.num_local_experts):
            for p in EXPERT_PROJS:
                out.append((li + ("block_sparse_moe", "experts", str(e), p),
                            f"{pre}.block_sparse_moe.experts.{e}.{p}", False))
    return out
