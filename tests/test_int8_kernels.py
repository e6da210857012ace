"""INT8 GEMM + norm-quant tests (torch_int equivalents)."""

import numpy as np
import pytest
import jax.numpy as jnp

from smoothquant_tpu.kernels.int8 import int8_bmm, int8_linear, quantize_to_int8
from smoothquant_tpu.kernels.norm_quant import layer_norm_q, rms_norm_q


@pytest.fixture
def rng():
    return np.random.default_rng(0)


class TestInt8Linear:
    def test_f32_out_matches_int32_accum(self, rng):
        # W8A8BFP32OFP32Linear semantics
        n, o, k = 16, 64, 128
        x = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
        w = rng.integers(-127, 128, size=(o, k)).astype(np.int8)
        b = rng.normal(size=(o,)).astype(np.float32)
        alpha = 0.0123
        got = int8_linear(jnp.asarray(x), jnp.asarray(w), alpha,
                          jnp.asarray(b), out_dtype=jnp.float32)
        ref = x.astype(np.int32) @ w.astype(np.int32).T * alpha + b
        np.testing.assert_allclose(np.asarray(got), ref, atol=1e-3, rtol=1e-5)

    def test_int8_out_saturates(self, rng):
        # W8A8B8O8Linear semantics: round + clip to ±127
        n, o, k = 8, 32, 64
        x = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
        w = rng.integers(-127, 128, size=(o, k)).astype(np.int8)
        alpha = 0.01
        got = int8_linear(jnp.asarray(x), jnp.asarray(w), alpha,
                          out_dtype=jnp.int8)
        ref = np.clip(np.round(x.astype(np.int32) @ w.astype(np.int32).T * alpha),
                      -127, 127).astype(np.int8)
        np.testing.assert_array_equal(np.asarray(got), ref)

    def test_fused_relu(self, rng):
        # W8A8B8O8LinearReLU: relu applied before requantization
        n, o, k = 8, 32, 64
        x = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
        w = rng.integers(-127, 128, size=(o, k)).astype(np.int8)
        b = rng.normal(size=(o,)).astype(np.float32) * 10
        alpha = 0.01
        got = int8_linear(jnp.asarray(x), jnp.asarray(w), alpha, jnp.asarray(b),
                          relu=True, out_dtype=jnp.int8)
        pre = x.astype(np.int32) @ w.astype(np.int32).T * alpha + b
        ref = np.clip(np.round(np.maximum(pre, 0)), -127, 127).astype(np.int8)
        np.testing.assert_array_equal(np.asarray(got), ref)
        assert np.asarray(got).min() >= 0

    def test_unaligned_shapes(self, rng):
        n, o, k = 10, 50, 70
        x = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
        w = rng.integers(-127, 128, size=(o, k)).astype(np.int8)
        got = int8_linear(jnp.asarray(x), jnp.asarray(w), 1.0,
                          out_dtype=jnp.float32)
        ref = x.astype(np.int32) @ w.astype(np.int32).T
        np.testing.assert_allclose(np.asarray(got), ref.astype(np.float32))

    def test_multi_k_tile_accumulation(self, rng):
        n, o, k = 8, 128, 2048  # 4 K-steps at tile_k=512
        x = rng.integers(-5, 6, size=(n, k)).astype(np.int8)
        w = rng.integers(-5, 6, size=(o, k)).astype(np.int8)
        got = int8_linear(jnp.asarray(x), jnp.asarray(w), 1.0,
                          out_dtype=jnp.float32)
        ref = x.astype(np.int32) @ w.astype(np.int32).T
        np.testing.assert_allclose(np.asarray(got), ref.astype(np.float32))


class TestInt8BMM:
    def test_qk_bmm_f32(self, rng):
        # BMM_S8T_S8N_F32T: per-batch a @ b^T * alpha → f32
        b, m, n, k = 4, 16, 24, 64
        a = rng.integers(-127, 128, size=(b, m, k)).astype(np.int8)
        bb = rng.integers(-127, 128, size=(b, n, k)).astype(np.int8)
        alpha = 0.005
        got = int8_bmm(jnp.asarray(a), jnp.asarray(bb), alpha,
                       out_dtype=jnp.float32)
        ref = np.einsum("bmk,bnk->bmn", a.astype(np.int32), bb.astype(np.int32)) * alpha
        np.testing.assert_allclose(np.asarray(got), ref, atol=1e-3, rtol=1e-5)

    def test_pv_bmm_int8(self, rng):
        # BMM_S8T_S8N_S8T: int8 output with requant
        b, m, n, k = 2, 8, 16, 32
        a = rng.integers(-127, 128, size=(b, m, k)).astype(np.int8)
        bb = rng.integers(-127, 128, size=(b, n, k)).astype(np.int8)
        alpha = 0.002
        got = int8_bmm(jnp.asarray(a), jnp.asarray(bb), alpha,
                       out_dtype=jnp.int8)
        ref = np.clip(np.round(
            np.einsum("bmk,bnk->bmn", a.astype(np.int32), bb.astype(np.int32)) * alpha
        ), -127, 127).astype(np.int8)
        np.testing.assert_array_equal(np.asarray(got), ref)


class TestNormQuant:
    def test_layer_norm_q(self, rng):
        n, c = 24, 128
        x = rng.normal(size=(n, c)).astype(np.float32) * 3
        g = rng.normal(size=(c,)).astype(np.float32)
        b = rng.normal(size=(c,)).astype(np.float32)
        scale = 0.05
        got = layer_norm_q(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                           scale)
        mean = x.mean(-1, keepdims=True)
        var = x.var(-1, keepdims=True)
        y = (x - mean) / np.sqrt(var + 1e-5) * g + b
        ref = np.clip(np.round(y / scale), -127, 127).astype(np.int8)
        np.testing.assert_allclose(np.asarray(got), ref, atol=1)
        assert (np.asarray(got) != ref).mean() < 0.01  # rounding-boundary slack

    def test_rms_norm_q(self, rng):
        n, c = 16, 256
        x = rng.normal(size=(n, c)).astype(np.float32)
        g = rng.normal(size=(c,)).astype(np.float32)
        scale = 0.02
        got = rms_norm_q(jnp.asarray(x), jnp.asarray(g), scale)
        y = x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6) * g
        ref = np.clip(np.round(y / scale), -127, 127).astype(np.int8)
        np.testing.assert_allclose(np.asarray(got), ref, atol=1)
        assert (np.asarray(got) != ref).mean() < 0.01

    def test_quantize_to_int8_saturation(self):
        x = jnp.asarray([[-1000.0, -0.06, 0.0, 0.04, 1000.0]])
        got = np.asarray(quantize_to_int8(x, 0.05))
        np.testing.assert_array_equal(got[0], [-127, -1, 0, 1, 127])
