"""Mixtral prefetch-scan decode: attention via layer-indexed kernels and
MoE experts streamed through flattened (L*E, ...) stacks — must match the
per-layer packed path for both dense and sparse dispatch."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smoothquant_tpu.models import ForwardContext
from smoothquant_tpu.models import mixtral as jmix
from smoothquant_tpu.models.common import KVCache, QuantKVCache
from smoothquant_tpu.models.registry import pack_model
from smoothquant_tpu.quant import w4a4_group

CACHE_LEN = 128


@pytest.fixture(scope="module")
def packed_mixtral():
    cfg = dataclasses.replace(
        jmix.MixtralConfig.tiny(), hidden_size=256, intermediate_size=256,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_hidden_layers=2)
    params = jmix.init_params(jax.random.PRNGKey(0), cfg)
    qcfg = w4a4_group(group_size=16, salient_prop=0.05)
    rng = np.random.default_rng(1)

    def in_dim(key):
        if key.endswith(".w2"):
            return cfg.intermediate_size
        if "o_proj" in key:
            return cfg.num_attention_heads * cfg.head_dim
        return cfg.hidden_size

    feat = {key: rng.uniform(0.1, 1.0, size=(in_dim(key),))
            for _, key, _ in jmix.quantizable_linears(cfg)}
    packed = pack_model("mixtral", params, cfg, qcfg, input_feat=feat,
                        compute_dtype=jnp.float32, nibble=True,
                        align_k_groups=8, align_o=256)
    return cfg, qcfg, packed


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
@pytest.mark.parametrize("quant_kv", [False, True])
def test_mixtral_prefetch_matches_per_layer(packed_mixtral, dispatch,
                                            quant_kv):
    cfg, qcfg, packed = packed_mixtral
    ctx = ForwardContext(quant=qcfg, compute="int", interpret=True,
                         moe_dispatch=dispatch)
    rng = np.random.default_rng(2)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(2, 5)))

    cache_cls = QuantKVCache if quant_kv else KVCache
    caches = [cache_cls.create(2, CACHE_LEN, cfg.num_key_value_heads,
                               cfg.head_dim, jnp.float32)
              for _ in range(cfg.num_hidden_layers)]
    _, caches = jmix.forward(packed, prompt, cfg, ctx=ctx, caches=caches)

    stacked = jmix.stack_layers(packed, cfg)
    scache = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)

    tok = jnp.asarray([[7], [9]])
    ref, ref_caches = jmix.forward(packed, tok, cfg, ctx=ctx, caches=caches)
    got, got_caches = jmix.forward(stacked, tok, cfg, ctx=ctx, caches=scache)

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


def test_mixtral_prefetch_gate_multi_token(packed_mixtral):
    """Multi-token inputs fall back to the copying stacked scan."""
    cfg, qcfg, packed = packed_mixtral
    ctx = ForwardContext(quant=qcfg, compute="int", interpret=True)
    stacked = jmix.stack_layers(packed, cfg)
    scache = jmix.stacked_caches(cfg, 1, CACHE_LEN, jnp.float32)
    logits, _ = jmix.forward(stacked, jnp.asarray([[1, 2, 3]]), cfg,
                             ctx=ctx, caches=scache)
    assert np.isfinite(np.asarray(logits)).all()
