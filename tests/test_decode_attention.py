"""Decode-attention kernel (Triton, interpret mode) vs the einsum reference
path.

The kernel must be numerically interchangeable with models.common.attention
over a dequantized cache read."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smoothquant_tpu.kernels.decode_attention import NEG_INF, decode_attention, supported
from smoothquant_tpu.models.common import (
    ForwardContext,
    KVCache,
    QuantKVCache,
    attention,
    cached_attention,
)


def _bias(valid, s, attn_mask=None):
    col = np.arange(s)[None, :]
    ok = col < np.asarray(valid)[:, None]
    if attn_mask is not None:
        ok = ok & np.asarray(attn_mask, bool)
    return jnp.asarray(np.where(ok, 0.0, NEG_INF), jnp.float32)


@pytest.mark.parametrize("nh,n_kv", [(4, 4), (8, 2)])
def test_kernel_matches_einsum_fp(nh, n_kv):
    b, s, d = 2, 128, 128
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(b, 1, nh, d)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(b, n_kv, s, d)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(b, n_kv, s, d)), jnp.float32)
    valid = np.array([s, s // 3], np.int32)

    ref = attention(q, k, v, causal_offset=jnp.asarray(valid - 1),
                    valid_len=jnp.asarray(valid))
    got = decode_attention(q[:, 0], k, v, _bias(valid, s), kernel=True,
                           interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref[:, 0]),
                               rtol=2e-5, atol=2e-5)


def test_kernel_matches_einsum_with_mask_holes():
    b, nh, s, d = 2, 4, 128, 128
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.normal(size=(b, 1, nh, d)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(b, nh, s, d)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(b, nh, s, d)), jnp.float32)
    valid = np.array([60, 90], np.int32)
    mask = rng.random((b, s)) > 0.3  # continuous-batching key holes

    ref = attention(q, k, v, causal_offset=jnp.asarray(valid - 1),
                    valid_len=jnp.asarray(valid),
                    attn_mask=jnp.asarray(mask))
    got = decode_attention(q[:, 0], k, v, _bias(valid, s, mask),
                           kernel=True, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref[:, 0]),
                               rtol=2e-5, atol=2e-5)


def test_kernel_int8_matches_dequant_einsum():
    b, nh, s, d = 2, 4, 256, 128
    rng = np.random.default_rng(2)
    cache = QuantKVCache.create(b, s, nh, d)
    kf = rng.normal(size=(b, s - 16, nh, d)).astype(np.float32)
    vf = rng.normal(size=(b, s - 16, nh, d)).astype(np.float32)
    cache = cache.update(jnp.asarray(kf), jnp.asarray(vf))
    q = jnp.asarray(rng.normal(size=(b, 1, nh, d)), jnp.float32)
    valid = np.full(b, s - 16, np.int32)

    ref = attention(q, *cache.read(), causal_offset=cache.pos - 1,
                    valid_len=cache.pos)
    got = decode_attention(q[:, 0], cache.k_q, cache.v_q, _bias(valid, s),
                           cache.k_scale, cache.v_scale, kernel=True,
                           interpret=True)
    # int8 path dequantizes to bf16 inside the kernel; the einsum reads a
    # bf16 dequantized cache — both quantization-limited, compare loosely
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref[:, 0], np.float32),
                               rtol=0.05, atol=0.05)


def test_cached_attention_dispatch_parity():
    """cached_attention(kernel) == cached_attention(einsum) on a fp cache."""
    b, nh, s, d = 2, 4, 128, 128
    rng = np.random.default_rng(3)
    cache = KVCache.create(b, s, nh, d, jnp.float32)
    kf = jnp.asarray(rng.normal(size=(b, 40, nh, d)), jnp.float32)
    vf = jnp.asarray(rng.normal(size=(b, 40, nh, d)), jnp.float32)
    offset = cache.pos
    cache = cache.update(kf, vf)
    q = jnp.asarray(rng.normal(size=(b, 1, nh, d)), jnp.float32)

    out_e = cached_attention(q, cache, causal_offset=offset + 39,
                             ctx=ForwardContext(plain=True))
    out_k = cached_attention(q, cache, causal_offset=offset + 39,
                             ctx=ForwardContext(interpret=True))
    np.testing.assert_allclose(np.asarray(out_k), np.asarray(out_e),
                               rtol=2e-5, atol=2e-5)


def test_supported_gate():
    assert supported(512, 32, 32, 128)
    assert supported(1024, 32, 8, 128)
    assert supported(96, 32, 32, 128)        # any S: tiles are masked
    assert supported(512, 32, 32, 64)        # head_dim 64 (OPT family)
    assert not supported(512, 32, 32, 80)    # head_dim not a power of two
    assert not supported(512, 32, 32, 8)     # below the smallest dot block
    assert not supported(512, 30, 4, 128)    # ragged GQA


def test_model_decode_kernel_vs_einsum_logits():
    """End-to-end: tiny llama (head_dim 128) decode step, both attn paths."""
    import dataclasses

    from smoothquant_tpu.models import llama

    cfg = dataclasses.replace(
        llama.LlamaConfig.tiny(), hidden_size=256, intermediate_size=256,
        num_attention_heads=2, num_key_value_heads=2, num_hidden_layers=2)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(4)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(1, 7)))

    outs = {}
    for mode in ("einsum", "kernel"):
        ctx = ForwardContext(plain=(mode == "einsum"),
                             interpret=(mode == "kernel"))
        caches = [KVCache.create(1, 128, cfg.num_key_value_heads,
                                 cfg.head_dim, jnp.float32)
                  for _ in range(cfg.num_hidden_layers)]
        _, caches = llama.forward(params, prompt, cfg, ctx=ctx, caches=caches)
        tok = jnp.asarray([[3]])
        logits, _ = llama.forward(params, tok, cfg, ctx=ctx, caches=caches)
        outs[mode] = np.asarray(logits[:, -1])
    np.testing.assert_allclose(outs["kernel"], outs["einsum"],
                               rtol=2e-4, atol=2e-4)
