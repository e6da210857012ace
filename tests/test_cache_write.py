"""Stacked int8 KV-cache write (kernels/cache_write.py) against the model's
own rotary and QuantKVCache quantizer, and the fp stacked append."""

import numpy as np
import pytest
import jax.numpy as jnp

from smoothquant_tpu.kernels.cache_write import write_quant_cache_stacked
from smoothquant_tpu.models.common import (KVCache, QuantKVCache,
                                           apply_rotary, rotary_cos_sin,
                                           stacked_cache_append)

L, B, H, S, D = 3, 2, 4, 32, 16


@pytest.mark.parametrize("rotary", [True, False])
@pytest.mark.parametrize("per_slot", [False, True])
def test_write_matches_rotary_and_quantize(rotary, per_slot):
    rng = np.random.default_rng(int(rotary) * 2 + int(per_slot))
    k = jnp.asarray(rng.normal(size=(B, 1, H, D)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(B, 1, H, D)), jnp.float32)
    pos = jnp.asarray([3, 17] if per_slot else 9, jnp.int32)
    cos, sin = rotary_cos_sin(jnp.broadcast_to(pos, (B,))[:, None], D)
    kq = jnp.zeros((L, B, H, S, D), jnp.int8)
    ks = jnp.zeros((L, B, H, S), jnp.float32)
    kq2, vq2, ks2, vs2 = write_quant_cache_stacked(
        jnp.int32(1), pos, k[:, 0], v[:, 0], cos, sin, kq, kq, ks, ks,
        rotary=rotary)
    k_rot = apply_rotary(k, cos, sin) if rotary else k
    ref_q, ref_s = QuantKVCache._quantize(k_rot[:, 0])       # (B, H, D)
    rows = np.broadcast_to(np.asarray(pos), (B,))
    for b in range(B):
        np.testing.assert_array_equal(np.asarray(kq2[1, b, :, rows[b]]),
                                      np.asarray(ref_q[b]))
        np.testing.assert_allclose(np.asarray(ks2[1, b, :, rows[b]]),
                                   np.asarray(ref_s[b]), rtol=1e-6)
    # nothing else moved
    mask = np.zeros((L, B, H, S), bool)
    for b in range(B):
        mask[1, b, :, rows[b]] = True
    assert (np.asarray(ks2)[~mask] == 0).all()
    assert (np.asarray(vs2)[mask] > 0).all()


def test_write_clamps_past_the_cache_end():
    """A finished slot keeps decoding; its write lands on the last row."""
    k = jnp.ones((B, H, D), jnp.float32)
    kq = jnp.zeros((L, B, H, S, D), jnp.int8)
    ks = jnp.zeros((L, B, H, S), jnp.float32)
    cs = jnp.zeros((B, 1, D), jnp.float32)
    kq2, _, ks2, _ = write_quant_cache_stacked(
        jnp.int32(0), jnp.asarray([S + 5, 2], jnp.int32), k, k, cs, cs,
        kq, kq, ks, ks, rotary=False)
    assert float(ks2[0, 0, 0, S - 1]) > 0 and float(ks2[0, 1, 0, 2]) > 0


def test_fp_stacked_append_matches_update():
    rng = np.random.default_rng(5)
    k = jnp.asarray(rng.normal(size=(B, 1, H, D)), jnp.float32)
    pos = jnp.asarray([4, 11], jnp.int32)
    stacked = KVCache(k=jnp.zeros((L, B, H, S, D)), v=jnp.zeros((L, B, H, S, D)),
                      pos=jnp.broadcast_to(pos, (L, B)))
    out, pos_i = stacked_cache_append(stacked, 2, k, k)
    single = KVCache(k=jnp.zeros((B, H, S, D)), v=jnp.zeros((B, H, S, D)),
                     pos=pos).update(k, k)
    np.testing.assert_array_equal(np.asarray(out.k[2]), np.asarray(single.k))
    np.testing.assert_array_equal(np.asarray(pos_i), np.asarray(pos))
