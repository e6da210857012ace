"""OPT decoder — functional JAX implementation.

Architecture facts mirrored from HF transformers' modeling_opt (which the
reference uses unmodified, swapping only linears — SURVEY.md §1): learned
positional embeddings with offset 2, pre-LayerNorm blocks
(do_layer_norm_before), q scaled by 1/sqrt(head_dim) at projection time,
ReLU MLP, decoder-level final LayerNorm, tied LM head, and optional
project_in/project_out when word_embed_proj_dim != hidden_size.

Quantization surgery follows quantize_opt (fake_quant.py:377-461); smoothing
pairing follows smooth_lm's OPT branch (smooth.py:77-90).
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
    attention,
    cached_attention,
    call_linear,
    layer_norm,
    maybe_quantize_output,
    to_head_major,
    unembed,
)
from smoothquant_tpu.quant.config import QuantConfig
from smoothquant_tpu.quant.linear import quantize_linear_params

POS_OFFSET = 2  # OPTLearnedPositionalEmbedding offset


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    word_embed_proj_dim: Optional[int] = None  # != hidden_size only for 350m
    do_layer_norm_before: bool = True
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def embed_dim(self) -> int:
        return self.word_embed_proj_dim or self.hidden_size

    @classmethod
    def opt_125m(cls) -> "OPTConfig":
        return cls()

    @classmethod
    def opt_1_3b(cls) -> "OPTConfig":
        return cls(hidden_size=2048, ffn_dim=8192, num_hidden_layers=24,
                   num_attention_heads=32)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "OPTConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, ffn_dim=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   max_position_embeddings=128, dtype="float32")


ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "out_proj")


def init_params(key: jax.Array, cfg: OPTConfig) -> dict:
    dtype = jnp.dtype(cfg.dtype)
    h, ffn = cfg.hidden_size, cfg.ffn_dim
    keys = iter(jax.random.split(key, 4 + cfg.num_hidden_layers * 6))

    def lin(k, out_f, in_f, bias=True):
        p = {"weight": jax.random.normal(k, (out_f, in_f), dtype) * (in_f ** -0.5)}
        p["bias"] = jnp.zeros((out_f,), dtype) if bias else None
        return p

    def ln(c):
        return {"weight": jnp.ones((c,), dtype), "bias": jnp.zeros((c,), dtype)}

    layers = {}
    for i in range(cfg.num_hidden_layers):
        layers[str(i)] = {
            "self_attn_layer_norm": ln(h),
            "self_attn": {p: lin(next(keys), h, h) for p in ATTN_PROJS},
            "final_layer_norm": ln(h),
            "fc1": lin(next(keys), ffn, h),
            "fc2": lin(next(keys), h, ffn),
        }
    params = {
        "embed_tokens": {"weight": jax.random.normal(next(keys), (cfg.vocab_size, cfg.embed_dim), dtype) * 0.02},
        "embed_positions": {"weight": jax.random.normal(next(keys), (cfg.max_position_embeddings + POS_OFFSET, h), dtype) * 0.02},
        "final_layer_norm": ln(h),
        "layers": layers,
    }
    if cfg.embed_dim != cfg.hidden_size:
        params["project_in"] = lin(next(keys), h, cfg.embed_dim, bias=False)
        params["project_out"] = lin(next(keys), cfg.embed_dim, h, bias=False)
    return params


def _decoder_layer(lp, x, cfg, layer_name, ctx, cache, attn_mask):
    b, s, h = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim

    residual = x
    hidden = layer_norm(lp["self_attn_layer_norm"], x, cfg.layer_norm_eps) if cfg.do_layer_norm_before else x
    sa = lp["self_attn"]
    # q/k/v outputs optionally quantized (quantize_bmm_input default True for
    # OPT, fake_quant.py:381,417-450); HF folds 1/sqrt(d) into q at
    # projection time — we pass scale=1.0 to attention and scale q here so
    # static INT8 q_output scales fold the same way (opt.py:63-66).
    if "qkv_proj" in sa:  # fused projection (fuse_projections)
        qkv = call_linear(sa["qkv_proj"], hidden,
                          f"{layer_name}.self_attn.qkv_proj", ctx)
        q, k, v = (qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:])
        q, k, v = (maybe_quantize_output(t, ctx) for t in (q, k, v))
    else:
        q = call_linear(sa["q_proj"], hidden, f"{layer_name}.self_attn.q_proj", ctx, True)
        k = call_linear(sa["k_proj"], hidden, f"{layer_name}.self_attn.k_proj", ctx, True)
        v = call_linear(sa["v_proj"], hidden, f"{layer_name}.self_attn.v_proj", ctx, True)
    q = q * (d ** -0.5)
    q = q.reshape(b, s, nh, d)
    k = k.reshape(b, s, nh, d)
    v = v.reshape(b, s, nh, d)

    if cache is not None:
        offset = cache.pos
        cache = cache.update(k, v)
        attn_out = cached_attention(q, cache, causal_offset=offset, ctx=ctx,
                                    scale=1.0, attn_mask=attn_mask)
    else:
        attn_out = attention(q, to_head_major(k), to_head_major(v),
                             scale=1.0, attn_mask=attn_mask, ctx=ctx)
    attn_out = attn_out.reshape(b, s, h)
    x = residual + call_linear(sa["out_proj"], attn_out, f"{layer_name}.self_attn.out_proj", ctx)
    if not cfg.do_layer_norm_before:
        x = layer_norm(lp["self_attn_layer_norm"], x, cfg.layer_norm_eps)

    residual = x
    hidden = layer_norm(lp["final_layer_norm"], x, cfg.layer_norm_eps) if cfg.do_layer_norm_before else x
    hidden = call_linear(lp["fc1"], hidden, f"{layer_name}.fc1", ctx)
    hidden = jax.nn.relu(hidden)
    hidden = call_linear(lp["fc2"], hidden, f"{layer_name}.fc2", ctx)
    x = residual + hidden
    if not cfg.do_layer_norm_before:
        x = layer_norm(lp["final_layer_norm"], x, cfg.layer_norm_eps)
    return x, cache


def stack_layers(params: dict, cfg: OPTConfig) -> dict:
    """Pre-stack the per-layer pytrees along a leading L axis for the
    lax.scan forward — one compiled layer body instead of num_hidden_layers
    (same mechanism as llama.stack_layers; the compile-time win matters most
    for the 24-48-layer OPT sizes)."""
    layer_list = [params["layers"][str(i)] for i in range(cfg.num_hidden_layers)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *layer_list)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {"stacked": stacked}
    return out


def stacked_caches(cfg: OPTConfig, batch: int, max_len: int, dtype,
                   pos: int = 0, quant_kv: bool = False):
    """A scan-ready KV cache: every field carries a leading layers axis.

    quant_kv=True builds the INT8 cache (half the HBM read per step; the
    fused decode-attention kernel consumes the int8 bytes directly)."""
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


def fuse_projections(params: dict, cfg: OPTConfig) -> dict:
    """Concatenate q/k/v → qkv_proj (fp tree; biases concatenated too).
    Same input activation → shared calibration stats → fused packing is
    row-concatenation of the individual packs (cf. llama.fuse_projections).
    The reference's OPT surgery replaces the three separately
    (fake_quant.py:417-450); fusing is a decode-kernel-count optimization
    with identical numerics."""
    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        sa = dict(lp["self_attn"])
        if "q_proj" in sa:
            parts = [sa.pop(p) for p in ("q_proj", "k_proj", "v_proj")]
            ws = jnp.concatenate([p["weight"] for p in parts], axis=0)
            if any(p.get("bias") is not None for p in parts):
                bias = jnp.concatenate([
                    p["bias"] if p.get("bias") is not None
                    else jnp.zeros((p["weight"].shape[0],), ws.dtype)
                    for p in parts])
            else:
                bias = None
            sa["qkv_proj"] = {"weight": ws, "bias": bias}
        lp["self_attn"] = sa
        new_layers[str(i)] = lp
    out = dict(params)
    out["layers"] = new_layers
    return out


def perm_fold_pairs(cfg: OPTConfig, fused: bool):
    """fc2's input is relu(fc1 out) — elementwise — so fc2's packed channel
    perm folds into fc1's output rows (kernels.pack.fold_input_perm)."""
    del fused  # fc1/fc2 never fuse; the pair is the same either way
    return [(("layers", str(i), "fc2"), [(("layers", str(i), "fc1"), 1)])
            for i in range(cfg.num_hidden_layers)]


def _prefetch_scan_decode(params, x, cfg, ctx, caches, attn_mask):
    """Single-token decode over stacked PACKED (or transposed-fp) layers
    without scan-slice copies — the OPT twin of llama._prefetch_scan_decode:
    the kernels read only layer i's weight/KV tiles while the
    stacks ride loop-invariant (see that function's docstring)."""
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
        sa = stacked["self_attn"]
        residual = x
        hidden = layer_norm(norm_at(stacked["self_attn_layer_norm"], i), x,
                            cfg.layer_norm_eps)
        nm = "model.decoder.layers.scan"
        if "qkv_proj" in sa:
            qkv = call_linear(sa["qkv_proj"], hidden, f"{nm}.qkv", ctx,
                              layer_idx=i)
            q, k, v = (qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:])
            q, k, v = (maybe_quantize_output(t, ctx) for t in (q, k, v))
        else:
            q = call_linear(sa["q_proj"], hidden, f"{nm}.q", ctx, True,
                            layer_idx=i)
            k = call_linear(sa["k_proj"], hidden, f"{nm}.k", ctx, True,
                            layer_idx=i)
            v = call_linear(sa["v_proj"], hidden, f"{nm}.v", ctx, True,
                            layer_idx=i)
        # HF folds 1/sqrt(d) into q at projection time; scale after the
        # (optional) output quantization, same order as _decoder_layer
        q = (q * (d ** -0.5)).reshape(b, s, nh, d)
        k = k.reshape(b, s, nh, d)
        v = v.reshape(b, s, nh, d)

        cache, pos_i = stacked_cache_append(cache, i, k, v)
        bias = decode_bias(pos_i, b, s_max, attn_mask)
        a = stacked_flash_attention(cache, i, q[:, 0], bias, ctx,
                                    sm_scale=1.0)
        a = a[:, None].reshape(b, s, nh * d)
        x = residual + call_linear(sa["out_proj"], a, f"{nm}.out", ctx,
                                   layer_idx=i)

        residual = x
        hidden = layer_norm(norm_at(stacked["final_layer_norm"], i), x,
                            cfg.layer_norm_eps)
        hidden = call_linear(stacked["fc1"], hidden, f"{nm}.fc1", ctx,
                             layer_idx=i)
        hidden = jax.nn.relu(hidden)
        hidden = call_linear(stacked["fc2"], hidden, f"{nm}.fc2", ctx,
                             layer_idx=i)
        cache = cache._replace(pos=cache.pos.at[i].add(s))
        return (residual + hidden, cache), None

    (x, caches), _ = jax.lax.scan(
        body, (x, caches), jnp.arange(cfg.num_hidden_layers))
    return x, caches


def _prefetch_capable(params, cfg, ctx, caches, s: int) -> bool:
    from smoothquant_tpu.models.common import prefetch_tree_capable

    if not cfg.do_layer_norm_before:
        return False  # post-LN (opt-350m) keeps the plain scan path
    return prefetch_tree_capable(params["layers"].get("stacked"), ctx,
                                 caches, s)


def forward(
    params: dict,
    input_ids: jax.Array,
    cfg: OPTConfig,
    ctx: Optional[ForwardContext] = None,
    caches: Optional[list[KVCache]] = None,
    positions: Optional[jax.Array] = None,
    attn_mask: Optional[jax.Array] = None,
) -> tuple[jax.Array, Optional[list[KVCache]]]:
    """Returns (logits float32 (B,S,V), updated caches or None)."""
    b, s = input_ids.shape
    stacked_mode = "stacked" in params["layers"]
    x = jnp.take(params["embed_tokens"]["weight"], input_ids, axis=0)
    if "project_in" in params:
        x = x @ params["project_in"]["weight"].T.astype(x.dtype)
    if positions is None:
        if caches is None:
            start = 0
        elif stacked_mode:
            start = caches.pos[0]
        else:
            start = caches[0].pos
        start = jnp.asarray(start)
        if start.ndim == 1:  # per-slot cache positions (continuous batching)
            start = start[:, None]
        positions = start + jax.lax.broadcasted_iota(jnp.int32, (b, s), 1)
    pos_emb = jnp.take(params["embed_positions"]["weight"], positions + POS_OFFSET, axis=0)
    x = x + pos_emb.astype(x.dtype)

    if stacked_mode and _prefetch_capable(params, cfg, ctx, caches, s):
        x, new_caches = _prefetch_scan_decode(params, x, cfg, ctx, caches,
                                              attn_mask)
    elif stacked_mode:
        assert ctx is None or ctx.taps is None, "taps unsupported with scan"

        def body(carry, layer_in):
            lp, cache = layer_in
            y, cache = _decoder_layer(lp, carry, cfg,
                                      "model.decoder.layers.scan",
                                      ctx, cache, attn_mask)
            return y, cache

        x, new_caches = jax.lax.scan(body, x,
                                     (params["layers"]["stacked"], caches))
    else:
        new_caches = [] if caches is not None else None
        for i in range(cfg.num_hidden_layers):
            layer_cache = caches[i] if caches is not None else None
            x, layer_cache = _decoder_layer(
                params["layers"][str(i)], x, cfg, f"model.decoder.layers.{i}",
                ctx, layer_cache, attn_mask,
            )
            if new_caches is not None:
                new_caches.append(layer_cache)

    # decoder-level final LN exists only with do_layer_norm_before (HF OPT)
    if "final_layer_norm" in params:
        x = layer_norm(params["final_layer_norm"], x, cfg.layer_norm_eps)
    if "project_out" in params:
        x = x @ params["project_out"]["weight"].T.astype(x.dtype)
    logits = unembed(x, params["embed_tokens"]["weight"])
    return logits, new_caches


def quantize_params(
    params: dict,
    cfg: OPTConfig,
    qcfg: QuantConfig,
    input_feat: Optional[dict] = None,
) -> dict:
    """quantize_opt equivalent (fake_quant.py:377-461): per layer, quantize
    fc1/fc2 and q/k/v (with output quant when quantize_bmm_input)/out_proj."""
    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        prefix = f"model.decoder.layers.{i}"

        def imp(name):
            if input_feat is None:
                return None
            return np.asarray(input_feat[name])

        sa = dict(lp["self_attn"])
        for p in ATTN_PROJS:
            sa[p] = quantize_linear_params(sa[p], qcfg, imp(f"{prefix}.self_attn.{p}"))
        lp["self_attn"] = sa
        lp["fc1"] = quantize_linear_params(lp["fc1"], qcfg, imp(f"{prefix}.fc1"))
        lp["fc2"] = quantize_linear_params(lp["fc2"], qcfg, imp(f"{prefix}.fc2"))
        new_layers[str(i)] = lp
    out = dict(params)
    out["layers"] = new_layers
    return out


def smoothing_map(cfg: OPTConfig):
    """smooth_lm OPT branch (smooth.py:77-90): self_attn_layer_norm → q/k/v;
    per-layer final_layer_norm → fc1."""
    pairs = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pairs.append((
            li + ("self_attn_layer_norm",),
            [li + ("self_attn", p) for p in ("q_proj", "k_proj", "v_proj")],
            f"model.decoder.layers.{i}.self_attn.q_proj",
        ))
        pairs.append((
            li + ("final_layer_norm",),
            [li + ("fc1",)],
            f"model.decoder.layers.{i}.fc1",
        ))
    return pairs


def config_from_hf(hf_cfg) -> OPTConfig:
    return OPTConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        ffn_dim=hf_cfg.ffn_dim,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        word_embed_proj_dim=(
            hf_cfg.word_embed_proj_dim
            if hf_cfg.word_embed_proj_dim != hf_cfg.hidden_size else None
        ),
        do_layer_norm_before=hf_cfg.do_layer_norm_before,
    )


def params_from_hf_state_dict(state: dict, cfg: OPTConfig, dtype=None) -> dict:
    dtype = jnp.dtype(dtype or cfg.dtype)

    def arr(name):
        return jnp.asarray(np.asarray(state[name]), dtype)

    def lin(name, bias=True):
        p = {"weight": arr(name + ".weight")}
        p["bias"] = arr(name + ".bias") if bias and name + ".bias" in state else None
        return p

    def ln(name):
        return {"weight": arr(name + ".weight"), "bias": arr(name + ".bias")}

    d = "model.decoder"
    layers = {}
    for i in range(cfg.num_hidden_layers):
        p = f"{d}.layers.{i}"
        layers[str(i)] = {
            "self_attn_layer_norm": ln(f"{p}.self_attn_layer_norm"),
            "self_attn": {k: lin(f"{p}.self_attn.{k}") for k in ATTN_PROJS},
            "final_layer_norm": ln(f"{p}.final_layer_norm"),
            "fc1": lin(f"{p}.fc1"),
            "fc2": lin(f"{p}.fc2"),
        }
    params = {
        "embed_tokens": {"weight": arr(f"{d}.embed_tokens.weight")},
        "embed_positions": {"weight": arr(f"{d}.embed_positions.weight")},
        "layers": layers,
    }
    if f"{d}.final_layer_norm.weight" in state:
        params["final_layer_norm"] = ln(f"{d}.final_layer_norm")
    if f"{d}.project_in.weight" in state:
        params["project_in"] = lin(f"{d}.project_in", bias=False)
        params["project_out"] = lin(f"{d}.project_out", bias=False)
    return params


def quantizable_linears(cfg: OPTConfig):
    """(params_path, feat/scales key, quantize_output) — generic packing."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pre = f"model.decoder.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj"):
            out.append((li + ("self_attn", p), f"{pre}.self_attn.{p}", True))
        out.append((li + ("self_attn", "out_proj"), f"{pre}.self_attn.out_proj", False))
        out.append((li + ("fc1",), f"{pre}.fc1", False))
        out.append((li + ("fc2",), f"{pre}.fc2", False))
    return out


def quantizable_linears_fused(cfg: OPTConfig):
    """quantizable_linears for a fuse_projections() tree; the fused qkv
    shares q_proj's calibration key (same input tensor)."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pre = f"model.decoder.layers.{i}"
        out.append((li + ("self_attn", "qkv_proj"),
                    f"{pre}.self_attn.q_proj", True))
        out.append((li + ("self_attn", "out_proj"),
                    f"{pre}.self_attn.out_proj", False))
        out.append((li + ("fc1",), f"{pre}.fc1", False))
        out.append((li + ("fc2",), f"{pre}.fc2", False))
    return out
