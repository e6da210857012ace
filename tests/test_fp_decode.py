"""Transposed-fp (bf16-class) prefetch-scan decode: parity vs the plain
per-layer forward.  This path is the baseline bench.py measures the
quantized decode against, and the fast serving path for unquantized models
(kernels/fp_matmul.py, models/llama.pack_fp_decode)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smoothquant_tpu.kernels.fp_matmul import fp_matmul_stacked
from smoothquant_tpu.models import ForwardContext, llama as jllama
from smoothquant_tpu.models.common import KVCache


def test_fp_matmul_stacked_matches_dot():
    rng = np.random.default_rng(0)
    l_num, n, k, o = 3, 5, 256, 384
    x = jnp.asarray(rng.normal(size=(n, k)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(l_num, k, o)), jnp.float32)
    for i in range(l_num):
        got = fp_matmul_stacked(jnp.asarray([i], jnp.int32), x, w)
        ref = x @ w[i]
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(), hidden_size=256, intermediate_size=256,
        num_attention_heads=2, num_key_value_heads=2, num_hidden_layers=2)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params


def test_fp_prefetch_decode_parity(setup):
    cfg, params = setup
    ctx = ForwardContext(interpret=True)
    rng = np.random.default_rng(1)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(2, 4)))

    caches = [KVCache.create(2, 128, cfg.num_key_value_heads, cfg.head_dim,
                             jnp.float32) for _ in range(cfg.num_hidden_layers)]
    _, caches = jllama.forward(params, prompt, cfg, caches=caches)

    fp = jllama.pack_fp_decode(params, cfg)
    stacked = jllama.stack_layers(fp, cfg)
    scache = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
    assert jllama._prefetch_capable(stacked, cfg, ctx, scache, 1)

    tok = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(2, 1)))
    ref, ref_caches = jllama.forward(params, tok, cfg, caches=caches)
    got, new_scache = jllama.forward(stacked, tok, cfg, ctx=ctx, caches=scache)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
    # cache advanced identically
    np.testing.assert_array_equal(np.asarray(new_scache.pos),
                                  np.asarray([c.pos for c in ref_caches]))
    ref_k = np.stack([np.asarray(c.k) for c in ref_caches])
    np.testing.assert_allclose(np.asarray(new_scache.k), ref_k,
                               rtol=2e-4, atol=2e-4)


def test_fp_flat_call_linear_matches_plain(setup):
    cfg, params = setup
    fp = jllama.pack_fp_decode(params, cfg)
    rng = np.random.default_rng(2)
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(1, 6)))
    # non-scan path (no caches): weight_t linears take the plain-dot branch
    ref, _ = jllama.forward(params, ids, cfg)
    got, _ = jllama.forward(fp, ids, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
