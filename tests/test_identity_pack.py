"""IDENTITY nibble layout (pack_linear(identity=True)): original-channel-
order int weights + masked activation quantize + small salient side gather
— no full-width input permute at runtime."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smoothquant_tpu.kernels.pack import pack_linear, unpack_nibbles_to_int8
from smoothquant_tpu.kernels.real_linear import real_quant_linear
from smoothquant_tpu.quant import w4a4_group
from smoothquant_tpu.quant.core import compute_scale

L, C, O, GS = 3, 256, 256, 16


def _build(salient_prop=0.05, seed=0):
    qcfg = w4a4_group(group_size=GS, salient_prop=salient_prop)
    rng = np.random.default_rng(seed)
    packs = []
    for i in range(L):
        lin = {"weight": jnp.asarray(
            rng.normal(size=(O, C)).astype(np.float32)), "bias": None}
        imp = rng.uniform(0.1, 1.0, size=(C,))
        packs.append(pack_linear(lin, qcfg, importance=imp,
                                 compute_dtype=jnp.float32, nibble=True,
                                 identity=True, align_k_groups=8,
                                 align_o=256))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *packs)
    return qcfg, packs, stacked


def _oracle(packed, x):
    """Pure-jnp simulation of the identity layout's math."""
    m = packed.meta
    w_int = unpack_nibbles_to_int8(packed.w_qt).astype(jnp.float32)
    ws = packed.w_scales_t.astype(jnp.float32)
    w_deq = (w_int.reshape(m.k_ns // m.group_size, m.group_size, -1)
             * ws[:, None, :]).reshape(m.k_ns, -1)
    xf = x.astype(jnp.float32) * packed.ns_mask[None, :]
    xf = jnp.pad(xf, ((0, 0), (0, m.k_ns - x.shape[1])))
    xg = xf.reshape(x.shape[0], -1, m.group_size)
    sc = compute_scale(jnp.max(jnp.abs(xg), axis=-1, keepdims=True),
                       m.act_bits)
    x_dq = (jnp.round(xg / sc) * sc).reshape(x.shape[0], m.k_ns)
    y = x_dq @ w_deq
    if m.num_salient:
        sal_idx = packed.perm[C - m.num_salient:]
        y = y + (jnp.take(x, sal_idx, axis=-1).astype(jnp.float32)
                 @ packed.w_sal_t[: m.num_salient].astype(jnp.float32))
    return y[:, :O]


@pytest.mark.parametrize("salient_prop", [0.0, 0.05])
def test_identity_layout_parity(salient_prop):
    qcfg, packs, stacked = _build(salient_prop)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(4, C)).astype(np.float32))
    for i in (0, 2):
        ref = _oracle(packs[i], x)
        # stacked (prefetch-scan) path
        got = real_quant_linear(stacked, x, compute="int", interpret=True,
                                layer_idx=jnp.asarray(i))
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)
        # per-layer path
        got2 = real_quant_linear(packs[i], x, compute="int", interpret=True)
        np.testing.assert_allclose(np.asarray(got2), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)


def test_identity_no_gather_marker():
    qcfg, packs, _ = _build()
    m = packs[0].meta
    assert m.layout == "identity" and m.pre_permuted and m.nibble
    assert packs[0].ns_mask.shape == (C,)
    # salient channels are zeroed out of BOTH the int weights and the mask
    sal = np.asarray(packs[0].perm[C - m.num_salient:])
    w_int = np.asarray(unpack_nibbles_to_int8(packs[0].w_qt))
    assert (w_int[sal] == 0).all()
    assert (np.asarray(packs[0].ns_mask)[sal] == 0).all()


def test_model_decode_with_identity_o_proj():
    """o_proj packed in the identity layout: the per-layer and prefetch-scan
    decodes (both identity) must match, and the forward stays finite."""
    from smoothquant_tpu.models import ForwardContext, llama as jllama
    from smoothquant_tpu.models.common import QuantKVCache
    from smoothquant_tpu.models.registry import pack_model
    from smoothquant_tpu.quant import w4a4_group as _w4

    cfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(), hidden_size=256, intermediate_size=256,
        num_attention_heads=2, num_key_value_heads=2, num_hidden_layers=2)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    qcfg = _w4(group_size=16, salient_prop=0.05)
    rng = np.random.default_rng(1)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        cfg.intermediate_size if "down_proj" in key else cfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(cfg)}
    packed = pack_model("llama", params, cfg, qcfg, input_feat=feat,
                        compute_dtype=jnp.float32, nibble=True,
                        align_k_groups=8, align_o=256,
                        identity_keys=("o_proj",))
    o_meta = packed["layers"]["0"]["self_attn"]["o_proj"].meta
    assert o_meta.layout == "identity"

    ctx = ForwardContext(quant=qcfg, compute="int", interpret=True)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(2, 5)))
    caches = [QuantKVCache.create(2, 128, cfg.num_key_value_heads,
                                  cfg.head_dim, jnp.float32)
              for _ in range(cfg.num_hidden_layers)]
    _, caches = jllama.forward(packed, prompt, cfg, ctx=ctx, caches=caches)
    stacked = jllama.stack_layers(packed, cfg)
    scache = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
    tok = jnp.asarray([[7], [9]])
    ref, _ = jllama.forward(packed, tok, cfg, ctx=ctx, caches=caches)
    got, _ = jllama.forward(stacked, tok, cfg, ctx=ctx, caches=scache)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
