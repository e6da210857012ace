"""Real-INT8 OPT decoder — TPU equivalent of the reference's Int8OPT stack.

Mirrors smoothquant/opt.py:23-481: every decoder-layer projection runs as a
true int8 GEMM with static calibrated scales, layer norms emit int8 directly
(fused norm+quant kernel), attention scores/probs ride int8 BMMs with the
softmax in fp32 and probs requantized at 1/127 (opt.py:168-190).  Residual
adds stay in floating point (opt.py:298).  Embeddings / final LN reuse the
FP params pytree of models/opt.py.

Scale plumbing (from get_static_decoder_layer_scales →
Int8OPTDecoderLayer.from_float, opt.py:225-316):
  attn_input_scale  — LN(q/k/v input) int8 scale
  q_output_scale    — q_proj output int8 scale (× softmax 1/sqrt(d) folded
                      into the weight, opt.py:63-66)
  k/v_output_scale  — k/v_proj output int8 scales
  out_input_scale   — out_proj input (= PV output) int8 scale
  fc1_input_scale   — LN(fc input) int8 scale
  fc2_input_scale   — fc2 input (= ReLU(fc1) output) int8 scale
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from smoothquant_tpu.kernels.int8 import int8_bmm, int8_linear
from smoothquant_tpu.kernels.norm_quant import layer_norm_q
from smoothquant_tpu.models.opt import OPTConfig, POS_OFFSET
from smoothquant_tpu.models.common import layer_norm, unembed


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Int8Linear:
    """Static-scale int8 linear: weights pre-quantized at export time."""

    w_q: jax.Array      # (O, K) int8
    bias: jax.Array     # (O,) f32 in the OUTPUT domain (pre-scaled)
    alpha: jax.Array    # scalar f32: s_in * s_w [/ s_out for int8 outputs]

    @classmethod
    def from_float(cls, weight, bias, input_scale: float,
                   output_scale: Optional[float] = None):
        """Quantize an FP linear for int8 execution.

        weight (O, K), bias (O,).  input_scale: static int8 scale of the
        incoming activation.  output_scale: if given, outputs are int8 in
        that scale; else outputs are f32.
        """
        w = np.asarray(weight, np.float32)
        # per-tensor weight scale, matching torch_int's scalar GEMM alpha
        # (opt.py:47-50)
        s_w_t = np.maximum(np.abs(w).max(), 1e-8) / 127.0
        w_q = np.clip(np.round(w / s_w_t), -127, 127).astype(np.int8)
        alpha = float(input_scale) * s_w_t
        b = np.zeros(w.shape[0], np.float32) if bias is None else np.asarray(bias, np.float32)
        if output_scale is not None:
            alpha = alpha / float(output_scale)
            b = b / float(output_scale)
        return cls(w_q=jnp.asarray(w_q), bias=jnp.asarray(b),
                   alpha=jnp.asarray(alpha, jnp.float32))

    def __call__(self, x_q: jax.Array, *, relu=False,
                 out_dtype=jnp.float32) -> jax.Array:
        shape = x_q.shape
        y = int8_linear(x_q.reshape(-1, shape[-1]), self.w_q, self.alpha,
                        self.bias, relu=relu, out_dtype=out_dtype)
        return y.reshape(*shape[:-1], y.shape[-1])


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Int8OPTLayerParams:
    ln_attn_gamma: jax.Array
    ln_attn_beta: jax.Array
    ln_fc_gamma: jax.Array
    ln_fc_beta: jax.Array
    q_proj: Int8Linear
    k_proj: Int8Linear
    v_proj: Int8Linear
    out_proj: Int8Linear
    fc1: Int8Linear
    fc2: Int8Linear
    scales: dict  # the seven static scales (f32 scalars)


def layer_from_float(lp: dict, layer_scales: dict) -> Int8OPTLayerParams:
    """Int8OPTDecoderLayer.from_float equivalent (opt.py:225-257).

    lp: FP layer params from models/opt.py; layer_scales: one entry of
    get_static_decoder_layer_scales_opt output.
    """
    s = {k: float(v) for k, v in layer_scales.items()}
    sa = lp["self_attn"]

    def wb(p):
        return np.asarray(p["weight"], np.float32), (
            None if p.get("bias") is None else np.asarray(p["bias"], np.float32))

    qw, qb = wb(sa["q_proj"])
    return Int8OPTLayerParams(
        ln_attn_gamma=jnp.asarray(lp["self_attn_layer_norm"]["weight"]),
        ln_attn_beta=jnp.asarray(lp["self_attn_layer_norm"]["bias"]),
        ln_fc_gamma=jnp.asarray(lp["final_layer_norm"]["weight"]),
        ln_fc_beta=jnp.asarray(lp["final_layer_norm"]["bias"]),
        q_proj=Int8Linear.from_float(qw, qb, s["attn_input_scale"], s["q_output_scale"]),
        k_proj=Int8Linear.from_float(*wb(sa["k_proj"]), s["attn_input_scale"], s["k_output_scale"]),
        v_proj=Int8Linear.from_float(*wb(sa["v_proj"]), s["attn_input_scale"], s["v_output_scale"]),
        out_proj=Int8Linear.from_float(*wb(sa["out_proj"]), s["out_input_scale"]),
        fc1=Int8Linear.from_float(*wb(lp["fc1"]), s["fc1_input_scale"], s["fc2_input_scale"]),
        fc2=Int8Linear.from_float(*wb(lp["fc2"]), s["fc2_input_scale"]),
        scales=dict(s),
    )


def from_float(params: dict, cfg: OPTConfig, decoder_layer_scales: list[dict],
               fold_q_scaling: bool = True) -> dict:
    """Int8OPTForCausalLM.from_float equivalent (opt.py:429-481).

    Keeps FP embeddings / decoder-level final LN; converts each decoder
    layer to static-scale int8.  fold_q_scaling folds 1/sqrt(head_dim) into
    the q projection before quantization (opt.py:63-66).
    """
    d = cfg.head_dim
    int8_layers = []
    for i in range(cfg.num_hidden_layers):
        lp = params["layers"][str(i)]
        if fold_q_scaling:
            lp = dict(lp)
            sa = dict(lp["self_attn"])
            qp = dict(sa["q_proj"])
            qp["weight"] = np.asarray(qp["weight"], np.float32) * (d ** -0.5)
            if qp.get("bias") is not None:
                qp["bias"] = np.asarray(qp["bias"], np.float32) * (d ** -0.5)
            sa["q_proj"] = qp
            lp["self_attn"] = sa
            ls = dict(decoder_layer_scales[i])
            ls["q_output_scale"] = ls["q_output_scale"] * (d ** -0.5)
        else:
            ls = decoder_layer_scales[i]
        int8_layers.append(layer_from_float(lp, ls))
    out = {
        "embed_tokens": params["embed_tokens"],
        "embed_positions": params["embed_positions"],
        "int8_layers": int8_layers,
    }
    if "final_layer_norm" in params:
        out["final_layer_norm"] = params["final_layer_norm"]
    for k in ("project_in", "project_out"):
        if k in params:
            out[k] = params[k]
    return out


def _per_batch(x):
    x = jnp.asarray(x)
    return x.reshape(-1, 1, 1, 1) if x.ndim == 1 else x


def _int8_attention(q8, k8, v8, scales: dict, cfg: OPTConfig,
                    causal_offset=0, valid_len=None, attn_mask=None):
    """int8 QK^T → fp32 softmax → ×127 int8 probs → int8 PV (opt.py:94-209).

    q8: (B, Sq, H) int8.  k8/v8: (B, nh, Sk, d) int8 head-major — either the
    current step's keys/values or a full static KV cache (the cache stores the
    raw static-scale int8 projections, exactly what the reference's
    past_key_value carries on the int8 path, opt.py:122-133 — so cached decode
    is bit-identical to teacher-forced).  Masking follows
    models.common.attention: query i sees keys j <= i + causal_offset,
    j < valid_len, attn_mask.
    """
    b, sq, h = q8.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    sk = k8.shape[2]

    q3 = q8.reshape(b, sq, nh, d).transpose(0, 2, 1, 3).reshape(b * nh, sq, d)
    k3 = k8.reshape(b * nh, sk, d)
    v3 = v8.reshape(b * nh, sk, d)

    alpha_qk = scales["q_output_scale"] * scales["k_output_scale"]
    logits = int8_bmm(q3, k3, alpha_qk, out_dtype=jnp.float32)
    logits = logits.reshape(b, nh, sq, sk)

    qi = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sq, sk), 2)
    kj = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sq, sk), 3)
    mask = kj <= qi + _per_batch(causal_offset)
    if valid_len is not None:
        mask = jnp.logical_and(mask, kj < _per_batch(valid_len))
    if attn_mask is not None:
        mask = jnp.logical_and(mask, attn_mask[:, None, None, :].astype(bool))
    logits = jnp.where(mask, logits, -1e9)
    probs = jax.nn.softmax(logits, axis=-1).reshape(b * nh, sq, sk)
    probs8 = jnp.clip(jnp.round(probs * 127.0), -127, 127).astype(jnp.int8)

    alpha_pv = (1.0 / 127.0) * scales["v_output_scale"] / scales["out_input_scale"]
    # PV contracts over keys: probs (B*nh, Sq, Sk) @ v (B*nh, Sk, d) — use
    # v^T layout for the (.., N, K) convention of int8_bmm
    ctx8 = int8_bmm(probs8, v3.transpose(0, 2, 1), alpha_pv,
                    out_dtype=jnp.int8)
    return ctx8.reshape(b, nh, sq, d).transpose(0, 2, 1, 3).reshape(b, sq, h)


def forward(params: dict, input_ids: jax.Array, cfg: OPTConfig,
            ctx=None, caches=None, positions=None, attn_mask=None):
    """Int8 decoder forward (opt.py:259-426) with KV-cached decode.

    Same contract as the other model modules — (logits, caches) — so
    serve.Generator / ContinuousBatcher drive it directly (the reference
    gets generation for free from HF `generate`, opt.py:429-481; here the
    serving layer is ours).  caches: list of common.KVCache holding INT8
    k/v at the layer's static k/v output scales.
    """
    del ctx  # the int8 path has no recipe or route choice to thread
    b, s = input_ids.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    x = jnp.take(params["embed_tokens"]["weight"], input_ids, axis=0).astype(jnp.float32)
    if "project_in" in params:
        x = x @ params["project_in"]["weight"].T.astype(x.dtype)
    if positions is None:
        if caches is not None:
            start = jnp.asarray(caches[0].pos)
            start = start[:, None] if start.ndim == 1 else start
        else:
            start = 0
        positions = start + jax.lax.broadcasted_iota(jnp.int32, (b, s), 1)
    x = x + jnp.take(params["embed_positions"]["weight"], positions + POS_OFFSET, axis=0).astype(x.dtype)

    new_caches = [] if caches is not None else None
    for li, lp in enumerate(params["int8_layers"]):
        sc = lp.scales
        residual = x
        x2d = x.reshape(-1, x.shape[-1])
        h8 = layer_norm_q(x2d, lp.ln_attn_gamma, lp.ln_attn_beta,
                          sc["attn_input_scale"], eps=cfg.layer_norm_eps).reshape(x.shape)
        q8 = lp.q_proj(h8, out_dtype=jnp.int8)
        k8 = lp.k_proj(h8, out_dtype=jnp.int8)
        v8 = lp.v_proj(h8, out_dtype=jnp.int8)
        k4 = k8.reshape(b, s, nh, d)
        v4 = v8.reshape(b, s, nh, d)
        if caches is not None:
            cache = caches[li]
            offset = cache.pos
            cache = cache.update(k4, v4)
            ck, cv = cache.read()
            ctx8 = _int8_attention(q8, ck, cv, sc, cfg,
                                   causal_offset=offset, valid_len=cache.pos,
                                   attn_mask=attn_mask)
            new_caches.append(cache)
        else:
            ctx8 = _int8_attention(q8, k4.transpose(0, 2, 1, 3),
                                   v4.transpose(0, 2, 1, 3), sc, cfg,
                                   attn_mask=attn_mask)
        attn_out = lp.out_proj(ctx8, out_dtype=jnp.float32)
        x = residual + attn_out  # fp residual add (opt.py:298)

        residual = x
        x2d = x.reshape(-1, x.shape[-1])
        h8 = layer_norm_q(x2d, lp.ln_fc_gamma, lp.ln_fc_beta,
                          sc["fc1_input_scale"], eps=cfg.layer_norm_eps).reshape(x.shape)
        h8 = lp.fc1(h8, relu=True, out_dtype=jnp.int8)
        ffn = lp.fc2(h8, out_dtype=jnp.float32)
        x = residual + ffn

    if "final_layer_norm" in params:
        x = layer_norm(params["final_layer_norm"], x, cfg.layer_norm_eps)
    if "project_out" in params:
        x = x @ params["project_out"]["weight"].T.astype(x.dtype)
    return unembed(x, params["embed_tokens"]["weight"]), new_caches
