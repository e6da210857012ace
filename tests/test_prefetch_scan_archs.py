"""Falcon / Bloom prefetch-scan decode (layer-indexed kernels, no
scan-slice copies) must match the per-layer packed path — the twins of
tests/test_prefetch_scan.py for the non-llama/OPT architectures.  Bloom
additionally exercises the decode attention's ALiBi term."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smoothquant_tpu.models import ForwardContext
from smoothquant_tpu.models import bloom as jbloom
from smoothquant_tpu.models import falcon as jfalcon
from smoothquant_tpu.models.common import KVCache, QuantKVCache
from smoothquant_tpu.models.registry import pack_model
from smoothquant_tpu.quant import w4a4_group

CACHE_LEN = 128


def _build(mod, cfg, arch):
    params = mod.init_params(jax.random.PRNGKey(0), cfg)
    qcfg = w4a4_group(group_size=16, salient_prop=0.05)
    rng = np.random.default_rng(1)
    h = cfg.hidden_size

    def in_dim(key):
        if "dense_4h_to_h" in key:
            return 4 * h
        if "dense" in key and "4h" not in key:
            return cfg.num_attention_heads * cfg.head_dim
        return h

    feat = {key: rng.uniform(0.1, 1.0, size=(in_dim(key),))
            for _, key, _ in mod.quantizable_linears(cfg)}
    packed = pack_model(arch, params, cfg, qcfg, input_feat=feat,
                        compute_dtype=jnp.float32, nibble=True,
                        align_k_groups=8, align_o=256)
    return qcfg, packed


def _run_pair(mod, cfg, arch, quant_kv, n_prefill=5):
    qcfg, packed = _build(mod, cfg, arch)
    ctx = ForwardContext(quant=qcfg, compute="int", interpret=True)
    rng = np.random.default_rng(2)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(2, n_prefill)))

    n_kv = (cfg.effective_kv_heads if hasattr(cfg, "effective_kv_heads")
            else cfg.num_attention_heads)
    cache_cls = QuantKVCache if quant_kv else KVCache
    caches = [cache_cls.create(2, CACHE_LEN, n_kv, cfg.head_dim,
                               jnp.float32)
              for _ in range(cfg.num_hidden_layers)]
    _, caches = mod.forward(packed, prompt, cfg, ctx=ctx, caches=caches)

    stacked = mod.stack_layers(packed, cfg)
    scache = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)

    tok = jnp.asarray([[7], [9]])
    ref, ref_caches = mod.forward(packed, tok, cfg, ctx=ctx, caches=caches)
    got, got_caches = mod.forward(stacked, tok, cfg, ctx=ctx, caches=scache)
    return ref, ref_caches, got, got_caches


FALCON_VARIANTS = {
    "mqa_parallel": dict(),  # tiny default: multi_query + parallel_attn
    "new_decoder": dict(new_decoder_architecture=True, multi_query=False),
    "classic": dict(parallel_attn=False, multi_query=False, num_kv_heads=4),
}


@pytest.mark.parametrize("variant", sorted(FALCON_VARIANTS))
@pytest.mark.parametrize("quant_kv", [False, True])
def test_falcon_prefetch_matches_per_layer(variant, quant_kv):
    cfg = jfalcon.FalconConfig.tiny(hidden_size=256, num_attention_heads=4,
                                    num_hidden_layers=2,
                                    **FALCON_VARIANTS[variant])
    ref, ref_caches, got, got_caches = _run_pair(jfalcon, cfg, "falcon",
                                                 quant_kv)
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


@pytest.mark.parametrize("quant_kv", [False, True])
def test_bloom_prefetch_matches_per_layer(quant_kv):
    cfg = dataclasses.replace(jbloom.BloomConfig.tiny(), hidden_size=256,
                              num_attention_heads=4)
    ref, ref_caches, got, got_caches = _run_pair(jbloom, cfg, "bloom",
                                                 quant_kv)
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


def test_bloom_prefetch_gate_respects_unsupported_shapes():
    """head_dim 16 (< 64) cannot ride the flash kernel — the stacked scan
    fallback must still produce finite logits."""
    cfg = jbloom.BloomConfig.tiny()  # hidden 64 / 4 heads -> d=16
    qcfg, packed = _build(jbloom, cfg, "bloom")
    ctx = ForwardContext(quant=qcfg, compute="int", interpret=True)
    stacked = jbloom.stack_layers(packed, cfg)
    scache = jbloom.stacked_caches(cfg, 1, CACHE_LEN, jnp.float32)
    logits, _ = jbloom.forward(stacked, jnp.asarray([[3]]), cfg, ctx=ctx,
                               caches=scache)
    assert np.isfinite(np.asarray(logits)).all()
