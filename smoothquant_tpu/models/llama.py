"""Llama-family decoder (covers Llama 2/3 and Mistral) — functional JAX.

The reference relies on HF transformers for the model itself and only swaps
linears/norms (SURVEY.md §1); quantization surgery and smoothing pairing for
this family live in fake_quant.py:464-561 and smooth.py:126-141.  Here the
model is ours: params pytree + pure forward, with quantization and
calibration reached through ForwardContext.

Mistral is this architecture with sliding-window attention: when
config.sliding_window is set, every attention path (prefill mask, cached
decode bias, prefetch-scan decode) masks keys older than the window,
matching HF modeling_mistral (the reference quantizes Mistral via
fake_quant.py:464-561 and inherits HF's windowed attention; its own 2048
eval windows never bind the default 4096 window).
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
    maybe_quantize_output,
    rms_norm,
    rotary_cos_sin,
    to_head_major,
    unembed,
)
from smoothquant_tpu.quant.config import QuantConfig
from smoothquant_tpu.quant.linear import quantize_linear_params


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    sliding_window: Optional[int] = None  # Mistral: 4096
    dtype: str = "bfloat16"
    # set when heads are tensor-sharded: a shard's cfg carries LOCAL head
    # counts while hidden_size stays global, so head_dim can't be derived
    head_dim_value: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_value is not None:
            return self.head_dim_value
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def llama2_13b(cls) -> "LlamaConfig":
        return cls(hidden_size=5120, intermediate_size=13824,
                   num_hidden_layers=40, num_attention_heads=40,
                   num_key_value_heads=40)

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        return cls(hidden_size=4096, intermediate_size=14336,
                   num_hidden_layers=32, num_attention_heads=32,
                   num_key_value_heads=8, rope_theta=1e6,
                   sliding_window=4096, vocab_size=32000)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "LlamaConfig":
        """Small config for tests."""
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128,
                   dtype="float32")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj")
MLP_PROJS = ("gate_proj", "up_proj", "down_proj")


def _init_lin(k, out_f, in_f, bias, dtype):
    p = {"weight": (jax.random.normal(k, (out_f, in_f), dtype) * (in_f ** -0.5))}
    p["bias"] = jnp.zeros((out_f,), dtype) if bias else None
    return p


def init_layer_params(key: jax.Array, cfg: LlamaConfig) -> dict:
    """One decoder layer's params — lets callers build deep models layer by
    layer (pack-and-free) without materializing the full fp tree at once."""
    return _init_layer(iter(jax.random.split(key, 7)), cfg)


def _init_layer(keys, cfg: LlamaConfig) -> dict:
    dtype = jnp.dtype(cfg.dtype)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    kv_dim = cfg.num_key_value_heads * cfg.head_dim
    return {
        "input_layernorm": {"weight": jnp.ones((h,), dtype)},
        "post_attention_layernorm": {"weight": jnp.ones((h,), dtype)},
        "self_attn": {
            "q_proj": _init_lin(next(keys), h, h, cfg.attention_bias, dtype),
            "k_proj": _init_lin(next(keys), kv_dim, h, cfg.attention_bias, dtype),
            "v_proj": _init_lin(next(keys), kv_dim, h, cfg.attention_bias, dtype),
            "o_proj": _init_lin(next(keys), h, h, False, dtype),
        },
        "mlp": {
            "gate_proj": _init_lin(next(keys), inter, h, cfg.mlp_bias, dtype),
            "up_proj": _init_lin(next(keys), inter, h, cfg.mlp_bias, dtype),
            "down_proj": _init_lin(next(keys), h, inter, cfg.mlp_bias, dtype),
        },
    }


def init_params(key: jax.Array, cfg: LlamaConfig) -> dict:
    dtype = jnp.dtype(cfg.dtype)
    h = cfg.hidden_size
    # one flat split consumed 7-at-a-time keeps weights bit-identical to the
    # original monolithic initializer
    keys = iter(jax.random.split(key, 4 + cfg.num_hidden_layers * 7))

    def lin(k, out_f, in_f, bias):
        return _init_lin(k, out_f, in_f, bias, dtype)

    layers = {}
    for i in range(cfg.num_hidden_layers):
        layers[str(i)] = _init_layer(keys, cfg)
    params = {
        "embed_tokens": {"weight": jax.random.normal(next(keys), (cfg.vocab_size, h), dtype) * 0.02},
        "layers": layers,
        "norm": {"weight": jnp.ones((h,), dtype)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = lin(next(keys), cfg.vocab_size, h, False)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _decoder_layer(
    lp: dict,
    x: jax.Array,
    cfg: LlamaConfig,
    layer_name: str,
    cos: jax.Array,
    sin: jax.Array,
    ctx: Optional[ForwardContext],
    cache: Optional[KVCache],
    attn_mask: Optional[jax.Array],
) -> tuple[jax.Array, Optional[KVCache]]:
    b, s, h = x.shape
    nh, n_kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    residual = x
    hidden = rms_norm(lp["input_layernorm"], x, cfg.rms_norm_eps)
    sa = lp["self_attn"]
    # q/k/v outputs optionally quantized to simulate quantized BMM inputs
    # (quantize_bmm_input; fake_quant.py:517-550).
    if "qkv_proj" in sa:  # fused projection (fuse_projections)
        qkv = call_linear(sa["qkv_proj"], hidden,
                          f"{layer_name}.self_attn.qkv_proj", ctx)
        q_dim, kv_dim = nh * d, n_kv * d
        q = qkv[..., :q_dim]
        k = qkv[..., q_dim:q_dim + kv_dim]
        v = qkv[..., q_dim + kv_dim:]
        q, k, v = (maybe_quantize_output(t, ctx) for t in (q, k, v))
    else:
        q = call_linear(sa["q_proj"], hidden, f"{layer_name}.self_attn.q_proj", ctx, True)
        k = call_linear(sa["k_proj"], hidden, f"{layer_name}.self_attn.k_proj", ctx, True)
        v = call_linear(sa["v_proj"], hidden, f"{layer_name}.self_attn.v_proj", ctx, True)
    q = q.reshape(b, s, nh, d)
    k = k.reshape(b, s, n_kv, d)
    v = v.reshape(b, s, n_kv, d)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)

    if cache is not None:
        offset = cache.pos
        cache = cache.update(k, v)
        attn_out = cached_attention(q, cache, causal_offset=offset, ctx=ctx,
                                    attn_mask=attn_mask,
                                    sliding_window=cfg.sliding_window)
    else:
        attn_out = attention(q, to_head_major(k), to_head_major(v),
                             attn_mask=attn_mask, ctx=ctx,
                             sliding_window=cfg.sliding_window)
    attn_out = attn_out.reshape(b, s, nh * d)
    x = residual + call_linear(sa["o_proj"], attn_out, f"{layer_name}.self_attn.o_proj", ctx)

    residual = x
    hidden = rms_norm(lp["post_attention_layernorm"], x, cfg.rms_norm_eps)
    mlp = lp["mlp"]
    if "gate_up_proj" in mlp:  # fused projection (fuse_projections)
        gu = call_linear(mlp["gate_up_proj"], hidden,
                         f"{layer_name}.mlp.gate_up_proj", ctx)
        inter = gu.shape[-1] // 2
        gate, up = gu[..., :inter], gu[..., inter:]
    else:
        gate = call_linear(mlp["gate_proj"], hidden, f"{layer_name}.mlp.gate_proj", ctx)
        up = call_linear(mlp["up_proj"], hidden, f"{layer_name}.mlp.up_proj", ctx)
    down = call_linear(
        mlp["down_proj"], jax.nn.silu(gate) * up, f"{layer_name}.mlp.down_proj", ctx
    )
    return residual + down, cache


def stack_layers(params: dict, cfg: LlamaConfig) -> dict:
    """Pre-stack the per-layer pytrees along a leading L axis (ONE copy, done
    outside jit) so forward's lax.scan consumes them directly.

    Passing a dict of 32 separate layer trees to a jitted scan forward would
    re-stack (copy) every weight on every call; pre-stacked params make the
    stack a one-time load-time cost.  Works for fp, simulated-quant, and
    PackedLinear layer trees (registered dataclass pytrees stack leaf-wise).
    With stacked params, `caches` must be a single stacked KVCache pytree
    (leading L on every field, pos shape (L,) or (L, B)) instead of a list.
    """
    layer_list = [params["layers"][str(i)] for i in range(cfg.num_hidden_layers)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *layer_list)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = {"stacked": stacked}
    return out


def stacked_caches(cfg: LlamaConfig, batch: int, max_len: int, dtype,
                   pos: int = 0, quant_kv: bool = False,
                   per_slot: bool = False):
    """A scan-ready KV cache: every field carries a leading layers axis.

    quant_kv=True builds the INT8 cache (half the bytes read per step; the
    decode-attention kernel consumes the int8 bytes directly).
    per_slot=True gives pos shape (L, B) — each batch slot tracks its own
    fill position (continuous batching over the prefetch-scan path)."""
    from smoothquant_tpu.models.common import QuantKVCache

    n_layers = cfg.num_hidden_layers
    pos_shape = (n_layers, batch) if per_slot else (n_layers,)
    poss = jnp.full(pos_shape, pos, jnp.int32)
    shape = (n_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
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
    """Single-token decode over stacked PACKED (or transposed-fp) layers
    without scan-slice copies: weights and the KV cache stay loop-invariant
    / carried whole, and each layer's matmuls and attention read layer i of
    the stacks in place (kernels/int4_group_matmul.py,
    kernels/decode_attention.py).  A naive stacked scan would slice every
    weight byte into each layer's operands.
    """
    from smoothquant_tpu.models.common import (
        QuantKVCache,
        decode_bias,
        stacked_cache_append,
        stacked_flash_attention,
    )

    stacked = params["layers"]["stacked"]
    b, s, h = x.shape
    nh, n_kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    s_max = (caches.k_q if isinstance(caches, QuantKVCache)
             else caches.k).shape[3]

    def norm_at(node, i):
        return {"weight": node["weight"][i]}

    def body(carry, i):
        x, cache = carry
        sa, mlp = stacked["self_attn"], stacked["mlp"]
        residual = x
        nm = "model.layers.scan"
        hidden = rms_norm(norm_at(stacked["input_layernorm"], i), x,
                          cfg.rms_norm_eps)
        if "qkv_proj" in sa:  # fused: one matmul + one quantize chain
            qkv = call_linear(sa["qkv_proj"], hidden, f"{nm}.qkv", ctx,
                              layer_idx=i)
            q_dim, kv_dim = nh * d, n_kv * d
            q = qkv[..., :q_dim]
            k = qkv[..., q_dim:q_dim + kv_dim]
            v = qkv[..., q_dim + kv_dim:]
            q, k, v = (maybe_quantize_output(t, ctx) for t in (q, k, v))
        else:
            q = call_linear(sa["q_proj"], hidden, f"{nm}.q", ctx, True,
                            layer_idx=i)
            k = call_linear(sa["k_proj"], hidden, f"{nm}.k", ctx, True,
                            layer_idx=i)
            v = call_linear(sa["v_proj"], hidden, f"{nm}.v", ctx, True,
                            layer_idx=i)
        q = apply_rotary(q.reshape(b, s, nh, d), cos, sin)
        # k-rotary fuses into the cache write
        cache, pos_i = stacked_cache_append(
            cache, i, k.reshape(b, s, n_kv, d), v.reshape(b, s, n_kv, d),
            cos, sin, rotate_k=True)
        bias = decode_bias(pos_i, b, s_max, attn_mask, cfg.sliding_window)
        a = stacked_flash_attention(cache, i, q[:, 0], bias, ctx)
        a = a[:, None].reshape(b, s, nh * d)
        x = residual + call_linear(sa["o_proj"], a, f"{nm}.o", ctx,
                                   layer_idx=i)

        residual = x
        hidden = rms_norm(norm_at(stacked["post_attention_layernorm"], i), x,
                          cfg.rms_norm_eps)
        if "gate_up_proj" in mlp:
            gu = call_linear(mlp["gate_up_proj"], hidden, f"{nm}.gu", ctx,
                             layer_idx=i)
            inter = gu.shape[-1] // 2
            gate, up = gu[..., :inter], gu[..., inter:]
        else:
            gate = call_linear(mlp["gate_proj"], hidden, f"{nm}.g", ctx,
                               layer_idx=i)
            up = call_linear(mlp["up_proj"], hidden, f"{nm}.u", ctx,
                             layer_idx=i)
        down = call_linear(mlp["down_proj"], jax.nn.silu(gate) * up,
                           f"{nm}.d", ctx, layer_idx=i)
        cache = cache._replace(pos=cache.pos.at[i].add(s))
        return (residual + down, cache), None

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
    cfg: LlamaConfig,
    ctx: Optional[ForwardContext] = None,
    caches=None,
    positions: Optional[jax.Array] = None,
    attn_mask: Optional[jax.Array] = None,
    scan_layers: bool = False,
) -> tuple[jax.Array, Optional[list[KVCache]]]:
    """Returns (logits float32 (B,S,V), updated caches or None).

    scan_layers=True runs the (homogeneous) layer stack under lax.scan so
    the decoder layer compiles ONCE instead of num_hidden_layers times —
    large compile-time win for deep models.  Calibration taps are per-layer
    named and therefore unsupported under scan.  Params produced by
    stack_layers() always take the scan path and expect a stacked KVCache.
    """
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
        if start.ndim == 1:  # per-slot cache positions (continuous batching)
            start = start[:, None]
        positions = start + jax.lax.broadcasted_iota(jnp.int32, (b, s), 1)
    cos, sin = rotary_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    if stacked_mode and _prefetch_capable(params, cfg, ctx, caches, s):
        x, new_caches = _prefetch_scan_decode(params, x, cfg, ctx, caches,
                                              cos, sin, attn_mask)
    elif scan_layers or stacked_mode:
        assert ctx is None or ctx.taps is None, "taps unsupported with scan"
        if stacked_mode:
            stacked = params["layers"]["stacked"]
            scan_caches = caches  # already stacked (leading L axis)
        else:
            layer_list = [params["layers"][str(i)]
                          for i in range(cfg.num_hidden_layers)]
            stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *layer_list)
            scan_caches = (None if caches is None
                           else jax.tree.map(lambda *xs: jnp.stack(xs), *caches))

        def body(carry, layer_in):
            lp, cache = layer_in
            y, cache = _decoder_layer(lp, carry, cfg, "model.layers.scan",
                                      cos, sin, ctx, cache, attn_mask)
            return y, cache

        x, out_caches = jax.lax.scan(body, x, (stacked, scan_caches))
        if caches is None:
            new_caches = None
        elif stacked_mode:
            new_caches = out_caches  # keep the stacked form
        else:
            new_caches = [jax.tree.map(lambda a: a[i], out_caches)
                          for i in range(cfg.num_hidden_layers)]
    else:
        new_caches = [] if caches is not None else None
        for i in range(cfg.num_hidden_layers):
            layer_cache = caches[i] if caches is not None else None
            x, layer_cache = _decoder_layer(
                params["layers"][str(i)], x, cfg, f"model.layers.{i}",
                cos, sin, ctx, layer_cache, attn_mask,
            )
            if new_caches is not None:
                new_caches.append(layer_cache)

    x = rms_norm(params["norm"], x, cfg.rms_norm_eps)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        logits = unembed(x, params["embed_tokens"]["weight"])
    elif not isinstance(params["lm_head"], dict):
        # PackedLinear lm_head (real-kernel path; recipe travels in its meta)
        logits = call_linear(params["lm_head"], x, "lm_head", ctx
                             ).astype(jnp.float32)
    else:
        logits = jnp.einsum(
            "bsh,vh->bsv", x, params["lm_head"]["weight"].astype(x.dtype),
            preferred_element_type=jnp.float32,
        )
    return logits, new_caches


def fuse_projections(params: dict, cfg: LlamaConfig) -> dict:
    """Concatenate q/k/v → qkv_proj and gate/up → gate_up_proj (fp tree).

    The fused projections share one input activation, so their calibration
    stats — and therefore the packed channel permutation and salient set —
    are identical; fused packing is then row-concatenation of the individual
    packs (bit-identical outputs, tested).  At decode this halves the
    per-layer kernel launches and activation permute/quantize chains.
    """
    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        def cat(parts):
            ws = jnp.concatenate([p["weight"] for p in parts], axis=0)
            if any(p.get("bias") is not None for p in parts):
                bias = jnp.concatenate([
                    p["bias"] if p.get("bias") is not None
                    else jnp.zeros((p["weight"].shape[0],), ws.dtype)
                    for p in parts])
            else:
                bias = None
            return {"weight": ws, "bias": bias}

        sa = dict(lp["self_attn"])
        if "q_proj" in sa:
            sa["qkv_proj"] = cat([sa.pop(p)
                                  for p in ("q_proj", "k_proj", "v_proj")])
        lp["self_attn"] = sa
        mlp = dict(lp["mlp"])
        if "gate_proj" in mlp:
            mlp["gate_up_proj"] = cat([mlp.pop(p)
                                       for p in ("gate_proj", "up_proj")])
        lp["mlp"] = mlp
        new_layers[str(i)] = lp
    out = dict(params)
    out["layers"] = new_layers
    return out


def residual_consumers(cfg: LlamaConfig, fused: bool):
    """(param_path, feat/scales key) of every linear whose input IS the
    (normed) residual stream — the consumers of the shared residual basis.
    The norm between stream and linear is elementwise, so one channel
    permutation serves them all."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pre = f"model.layers.{i}"
        if fused:
            out.append((li + ("self_attn", "qkv_proj"),
                        f"{pre}.self_attn.q_proj"))
            out.append((li + ("mlp", "gate_up_proj"), f"{pre}.mlp.gate_proj"))
        else:
            for p in ("q_proj", "k_proj", "v_proj"):
                out.append((li + ("self_attn", p), f"{pre}.self_attn.{p}"))
            for p in ("gate_proj", "up_proj"):
                out.append((li + ("mlp", p), f"{pre}.mlp.{p}"))
    return out


def apply_shared_residual_basis(params: dict, cfg: LlamaConfig,
                                perm) -> dict:
    """Move the whole residual stream into the shared permuted basis π.

    After this load-time transform the hidden state flows permuted end to
    end: embedding columns, every norm weight, and the residual producers'
    (o_proj/down_proj) output columns are relaid by π, so the qkv/gate_up
    packs (marked pre_permuted, packed with the SHARED sort key) need no
    runtime activation gather — the widest per-layer gathers in the scan
    decode become load-time relayouts.  RMSNorm and residual adds are
    permutation-equivariant, and the tied/untied unembedding consumes the
    permuted basis via its own permuted columns, so logits are exactly
    those of the unpermuted model (given the same shared stats)."""
    from smoothquant_tpu.kernels.pack import PackedLinear, permute_output_columns

    take = jnp.asarray(np.asarray(perm, np.int32))
    out = dict(params)
    out["embed_tokens"] = {
        "weight": jnp.take(params["embed_tokens"]["weight"], take, axis=1)}
    out["norm"] = {"weight": jnp.take(params["norm"]["weight"], take)}
    if "lm_head" in params and isinstance(params["lm_head"], dict):
        lm = params["lm_head"]
        out["lm_head"] = {
            "weight": jnp.take(lm["weight"], take, axis=1),
            "bias": lm.get("bias"),
        }
    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        for nrm in ("input_layernorm", "post_attention_layernorm"):
            lp[nrm] = {"weight": jnp.take(lp[nrm]["weight"], take)}
        sa, mlp = dict(lp["self_attn"]), dict(lp["mlp"])
        sa["o_proj"] = permute_output_columns(sa["o_proj"], perm)
        dp_key = "down_proj"
        mlp[dp_key] = permute_output_columns(mlp[dp_key], perm)
        lp["self_attn"], lp["mlp"] = sa, mlp
        new_layers[str(i)] = lp
    out["layers"] = new_layers
    return out


def pack_fp_decode(params: dict, cfg: LlamaConfig) -> dict:
    """Prepare an UNQUANTIZED tree for the no-copy scan decode: fuse q/k/v
    and gate/up, then store every projection transposed ((K, O), the GEMM
    B-operand layout) under "weight_t" so call_linear routes it to
    kernels.fp_matmul.fp_matmul_stacked.  stack_layers() the result and
    decode takes the same compile-once, no-slice-copy scan decode as packed
    models — the bf16 baseline bench.py measures against, and the fast path
    for serving unquantized models."""
    params = fuse_projections(params, cfg)

    def tr(lin):
        return {"weight_t": lin["weight"].T, "bias": lin.get("bias")}

    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        sa, mlp = dict(lp["self_attn"]), dict(lp["mlp"])
        sa["qkv_proj"] = tr(sa["qkv_proj"])
        sa["o_proj"] = tr(sa["o_proj"])
        mlp["gate_up_proj"] = tr(mlp["gate_up_proj"])
        mlp["down_proj"] = tr(mlp["down_proj"])
        lp["self_attn"], lp["mlp"] = sa, mlp
        new_layers[str(i)] = lp
    out = dict(params)
    out["layers"] = new_layers
    return out


# ---------------------------------------------------------------------------
# Quantization surgery + smoothing map
# ---------------------------------------------------------------------------


def quantize_params(
    params: dict,
    cfg: LlamaConfig,
    qcfg: QuantConfig,
    input_feat: Optional[dict] = None,
) -> dict:
    """Offline weight quantization of every attention/MLP projection.

    The equivalent of quantize_llama_like (fake_quant.py:464-561): all
    seven projections per layer are weight-quantized; salient importance for
    each comes from input_feat (summed mean-abs calibration vectors) keyed by
    HF-style names.
    """
    new_layers = {}
    for i in range(cfg.num_hidden_layers):
        lp = dict(params["layers"][str(i)])
        prefix = f"model.layers.{i}"

        def imp(proj_name):
            if input_feat is None:
                return None
            return np.asarray(input_feat[proj_name])

        sa = dict(lp["self_attn"])
        for p in ATTN_PROJS:
            sa[p] = quantize_linear_params(sa[p], qcfg, imp(f"{prefix}.self_attn.{p}"))
        mlp = dict(lp["mlp"])
        for p in MLP_PROJS:
            mlp[p] = quantize_linear_params(mlp[p], qcfg, imp(f"{prefix}.mlp.{p}"))
        lp["self_attn"], lp["mlp"] = sa, mlp
        new_layers[str(i)] = lp
    out = dict(params)
    out["layers"] = new_layers
    return out


def smoothing_map(cfg: LlamaConfig):
    """Norm→linears pairing for smooth_model (smooth.py:126-141).

    input_layernorm → q/k/v (scales key: q_proj input);
    post_attention_layernorm → gate/up (scales key: gate_proj input).
    down_proj and o_proj inputs follow nonlinearities, not norms — unsmoothed.
    """
    pairs = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pairs.append((
            li + ("input_layernorm",),
            [li + ("self_attn", p) for p in ("q_proj", "k_proj", "v_proj")],
            f"model.layers.{i}.self_attn.q_proj",
        ))
        pairs.append((
            li + ("post_attention_layernorm",),
            [li + ("mlp", p) for p in ("gate_proj", "up_proj")],
            f"model.layers.{i}.mlp.gate_proj",
        ))
    return pairs


# ---------------------------------------------------------------------------
# HF checkpoint import
# ---------------------------------------------------------------------------

def config_from_hf(hf_cfg) -> LlamaConfig:
    """Build LlamaConfig from a transformers Llama/MistralConfig object."""
    return LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        num_key_value_heads=getattr(hf_cfg, "num_key_value_heads", hf_cfg.num_attention_heads),
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rms_norm_eps=hf_cfg.rms_norm_eps,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        attention_bias=getattr(hf_cfg, "attention_bias", False),
        mlp_bias=getattr(hf_cfg, "mlp_bias", False),
        sliding_window=getattr(hf_cfg, "sliding_window", None),
    )


def params_from_hf_state_dict(state: dict, cfg: LlamaConfig, dtype=None) -> dict:
    """Map an HF Llama/Mistral state dict (numpy arrays) to our pytree."""
    dtype = jnp.dtype(dtype or cfg.dtype)

    def arr(name):
        return jnp.asarray(np.asarray(state[name]), dtype)

    def lin(name, bias):
        p = {"weight": arr(name + ".weight")}
        p["bias"] = arr(name + ".bias") if bias and name + ".bias" in state else None
        return p

    layers = {}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        layers[str(i)] = {
            "input_layernorm": {"weight": arr(f"{p}.input_layernorm.weight")},
            "post_attention_layernorm": {"weight": arr(f"{p}.post_attention_layernorm.weight")},
            "self_attn": {
                k: lin(f"{p}.self_attn.{k}", cfg.attention_bias) for k in ATTN_PROJS
            },
            "mlp": {k: lin(f"{p}.mlp.{k}", cfg.mlp_bias) for k in MLP_PROJS},
        }
    params = {
        "embed_tokens": {"weight": arr("model.embed_tokens.weight")},
        "layers": layers,
        "norm": {"weight": arr("model.norm.weight")},
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in state:
        params["lm_head"] = {"weight": arr("lm_head.weight"), "bias": None}
    return params


def perm_fold_pairs(cfg: LlamaConfig, fused: bool):
    """(consumer_path, [(producer_path, n_splits), ...]) for
    kernels.pack.fold_input_perm: down_proj's input is an ELEMENTWISE
    function of gate/up outputs (silu(gate)*up), so its packed channel
    permutation folds into their output rows at pack time — no runtime
    activation gather for down_proj."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i), "mlp")
        if fused:
            out.append((li + ("down_proj",), [(li + ("gate_up_proj",), 2)]))
        else:
            out.append((li + ("down_proj",),
                        [(li + ("gate_proj",), 1), (li + ("up_proj",), 1)]))
    return out


def quantizable_linears(cfg: LlamaConfig):
    """(params_path, feat/scales key, quantize_output) for every quantizable
    projection — drives generic packing (registry.pack_model)."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pre = f"model.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj"):
            out.append((li + ("self_attn", p), f"{pre}.self_attn.{p}", True))
        out.append((li + ("self_attn", "o_proj"), f"{pre}.self_attn.o_proj", False))
        for p in MLP_PROJS:
            out.append((li + ("mlp", p), f"{pre}.mlp.{p}", False))
    return out


def quantizable_linears_fused(cfg: LlamaConfig):
    """quantizable_linears for a fuse_projections() tree.  The fused
    projections read the SAME input as their parts, so the calibration key
    of the first part (q_proj / gate_proj) supplies importance and act
    scales for the whole fusion."""
    out = []
    for i in range(cfg.num_hidden_layers):
        li = ("layers", str(i))
        pre = f"model.layers.{i}"
        out.append((li + ("self_attn", "qkv_proj"),
                    f"{pre}.self_attn.q_proj", True))
        out.append((li + ("self_attn", "o_proj"),
                    f"{pre}.self_attn.o_proj", False))
        out.append((li + ("mlp", "gate_up_proj"),
                    f"{pre}.mlp.gate_proj", False))
        out.append((li + ("mlp", "down_proj"), f"{pre}.mlp.down_proj", False))
    return out
