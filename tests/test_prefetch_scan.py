"""Prefetch-scan decode (stacked weights read at the layer index inside
the scan) must match the per-layer loop bit-for-bit-ish."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smoothquant_tpu.models import ForwardContext, llama as jllama
from smoothquant_tpu.models.common import KVCache, QuantKVCache
from smoothquant_tpu.models.registry import pack_model
from smoothquant_tpu.quant import w4a4_group


@pytest.fixture(scope="module")
def packed_model():
    cfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(), hidden_size=256, intermediate_size=256,
        num_attention_heads=2, num_key_value_heads=2, num_hidden_layers=3)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    qcfg = w4a4_group(group_size=16, salient_prop=0.05)
    rng = np.random.default_rng(1)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        cfg.intermediate_size if "down_proj" in key else cfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(cfg)}
    packed = pack_model("llama", params, cfg, qcfg, input_feat=feat,
                        compute_dtype=jnp.float32, nibble=True)
    return cfg, qcfg, packed


@pytest.mark.parametrize("quant_kv", [False, True])
def test_prefetch_decode_matches_per_layer(packed_model, quant_kv):
    """Both decodes start from the SAME prefilled cache state (stacked from
    the per-layer one): int8 quantization boundaries would otherwise amplify
    benign 1-ulp fusion-order differences accumulated during prefill into
    spurious mismatches on a chaotic random-weight model."""
    cfg, qcfg, packed = packed_model
    ctx = ForwardContext(quant=qcfg, compute="int", interpret=True)
    rng = np.random.default_rng(2)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(2, 5)))

    cache_cls = QuantKVCache if quant_kv else KVCache
    caches = [cache_cls.create(2, 128, cfg.num_key_value_heads, cfg.head_dim,
                               jnp.float32)
              for _ in range(cfg.num_hidden_layers)]
    _, caches = jllama.forward(packed, prompt, cfg, ctx=ctx, caches=caches)

    stacked = jllama.stack_layers(packed, cfg)
    scache = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)

    tok = jnp.asarray([[7], [9]])
    ref, ref_caches = jllama.forward(packed, tok, cfg, ctx=ctx, caches=caches)
    got, got_caches = jllama.forward(stacked, tok, cfg, ctx=ctx, caches=scache)

    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
    for i, rc in enumerate(ref_caches):
        if quant_kv:
            np.testing.assert_array_equal(np.asarray(got_caches.k_q[i]),
                                          np.asarray(rc.k_q))
        else:
            np.testing.assert_allclose(np.asarray(got_caches.k[i]),
                                       np.asarray(rc.k), atol=1e-5)
        assert int(got_caches.pos[i]) == int(rc.pos)


def test_prefetch_gate_declines_gracefully(packed_model):
    """Multi-token inputs take the regular stacked-scan path (still
    correct, just the copying one)."""
    cfg, qcfg, packed = packed_model
    ctx = ForwardContext(quant=qcfg, compute="int", interpret=True)
    stacked = jllama.stack_layers(packed, cfg)
    scache = jllama.stacked_caches(cfg, 1, 128, jnp.float32)
    ids = jnp.asarray([[1, 2, 3]])
    logits, _ = jllama.forward(stacked, ids, cfg, ctx=ctx, caches=scache)
    assert np.isfinite(np.asarray(logits)).all()
