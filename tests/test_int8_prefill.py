"""int8 prefill matmul (kernels/int8_prefill.py) vs an exact numpy oracle:
int8 dot → int32 acc → per-token x per-column scale epilogue → + salient
fp dot."""

import numpy as np
import pytest
import jax.numpy as jnp

from smoothquant_tpu.kernels.int8_prefill import int8_prefill_matmul


def _oracle(x_q, sx, w_qt, sw_t, x_sal, w_sal_t):
    acc = np.asarray(x_q, np.int64) @ np.asarray(w_qt, np.int64)
    y = acc.astype(np.float32) * np.asarray(sx) * np.asarray(sw_t)
    if x_sal.shape[1]:
        y = y + (np.asarray(x_sal, np.float32)
                 @ np.asarray(w_sal_t, np.float32))
    return y


@pytest.mark.parametrize("n,k,o,k_s", [
    (32, 160, 48, 0),          # padded everything, no salient
    (100, 512, 300, 128),      # salient path + N/O padding
    (256, 1024, 512, 0),       # tile-exact
])
def test_kernel_matches_oracle(n, k, o, k_s):
    rng = np.random.default_rng(0)
    x_q = jnp.asarray(rng.integers(-127, 128, size=(n, k)), jnp.int8)
    sx = jnp.asarray(rng.uniform(0.001, 0.02, size=(n, 1)), jnp.float32)
    w_qt = jnp.asarray(rng.integers(-127, 128, size=(k, o)), jnp.int8)
    sw_t = jnp.asarray(rng.uniform(0.001, 0.02, size=(1, o)), jnp.float32)
    x_sal = jnp.asarray(rng.normal(size=(n, k_s)), jnp.float32)
    w_sal_t = jnp.asarray(rng.normal(size=(k_s, o)), jnp.float32)

    got = int8_prefill_matmul(x_q, sx, w_qt, sw_t, x_sal, w_sal_t,
                              out_dtype=jnp.float32)
    ref = _oracle(x_q, sx, w_qt, sw_t, x_sal, w_sal_t)
    assert got.shape == (n, o)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k,o,k_s", [
    (100, 512, 300, 128),
    (64, 1024, 256, 0),
])
def test_raw_x_mode_matches_prequantized(n, k, o, k_s):
    """ns_mask mode (raw activations, masked quantize inside) must produce
    the same bytes as quantizing first: identical f32 op chain."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=(n, k)), jnp.float32)
    mask = (rng.random(k) > 0.1).astype(np.float32)
    x_main = x * jnp.asarray(mask)[None, :]
    sx = jnp.maximum(jnp.max(jnp.abs(x_main), axis=-1, keepdims=True),
                     1e-5) / 127.0
    x_q = jnp.round(x_main / sx).astype(jnp.int8)
    w_qt = jnp.asarray(rng.integers(-127, 128, size=(k, o)), jnp.int8)
    sw_t = jnp.asarray(rng.uniform(0.001, 0.02, size=(1, o)), jnp.float32)
    x_sal = jnp.asarray(rng.normal(size=(n, k_s)), jnp.float32)
    w_sal_t = jnp.asarray(rng.normal(size=(k_s, o)), jnp.float32)

    kw = dict(out_dtype=jnp.float32)
    ref = int8_prefill_matmul(x_q, sx, w_qt, sw_t, x_sal, w_sal_t, **kw)
    got = int8_prefill_matmul(x, sx, w_qt, sw_t, x_sal, w_sal_t,
                              jnp.asarray(mask).reshape(1, -1), **kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_multi_k_step_accumulation():
    """A deep K must accumulate exactly in int32."""
    rng = np.random.default_rng(1)
    n, k, o = 16, 4096, 256
    x_q = jnp.asarray(rng.integers(-127, 128, size=(n, k)), jnp.int8)
    sx = jnp.full((n, 1), 0.01, jnp.float32)
    w_qt = jnp.asarray(rng.integers(-127, 128, size=(k, o)), jnp.int8)
    sw_t = jnp.full((1, o), 0.005, jnp.float32)
    x_sal = jnp.zeros((n, 0), jnp.float32)
    w_sal_t = jnp.zeros((0, o), jnp.float32)

    got = int8_prefill_matmul(x_q, sx, w_qt, sw_t, x_sal, w_sal_t,
                              out_dtype=jnp.float32)
    ref = _oracle(x_q, sx, w_qt, sw_t, x_sal, w_sal_t)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-5)
