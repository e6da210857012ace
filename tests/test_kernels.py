"""Packed-linear equivalence tests (kernels in interpret mode on CPU).

Each kernel must reproduce the quant/core simulation semantics in the packed
(static-permutation) domain — the numerical contract of SURVEY.md §7 step 5.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smoothquant_tpu.kernels import dual_path_matmul, pack_linear, real_quant_linear
from smoothquant_tpu.kernels.pack import quantize_activations_packed
from smoothquant_tpu.quant import QuantConfig, core, w4a4_group


@pytest.fixture
def rng():
    return np.random.default_rng(0)


class TestDualPathMatmul:
    @pytest.mark.parametrize("n,o,k_ns,k_s,g", [
        (16, 128, 256, 128, 64),
        (8, 256, 512, 128, 128),
        (33, 130, 256, 128, 64),   # unaligned N and O (padding path)
    ])
    def test_matches_dense_reference(self, rng, n, o, k_ns, k_s, g):
        x_ns = rng.normal(size=(n, k_ns)).astype(np.float32)
        x_sal = rng.normal(size=(n, k_s)).astype(np.float32)
        w_q = rng.integers(-7, 8, size=(o, k_ns)).astype(np.int8)
        scales = rng.uniform(0.01, 0.1, size=(o, k_ns // g)).astype(np.float32)
        w_sal = rng.normal(size=(o, k_s)).astype(np.float32)

        got = dual_path_matmul(
            jnp.asarray(x_ns), jnp.asarray(x_sal), jnp.asarray(w_q.T),
            jnp.asarray(scales.T), jnp.asarray(w_sal.T),
            group_size=g,
        )
        w_deq = (w_q.astype(np.float32).reshape(o, -1, g)
                 * scales[..., None]).reshape(o, k_ns)
        ref = x_ns @ w_deq.T + x_sal @ w_sal.T
        np.testing.assert_allclose(np.asarray(got), ref, atol=1e-3, rtol=1e-4)

    def test_multiple_k_tiles_accumulate(self, rng):
        n, o, k_ns, g = 8, 128, 2048, 128  # forces 4 K-steps at tile_k=512
        x_ns = rng.normal(size=(n, k_ns)).astype(np.float32)
        x_sal = np.zeros((n, 128), np.float32)
        w_q = rng.integers(-7, 8, size=(o, k_ns)).astype(np.int8)
        scales = rng.uniform(0.01, 0.1, size=(o, k_ns // g)).astype(np.float32)
        w_sal = np.zeros((o, 128), np.float32)
        got = dual_path_matmul(
            jnp.asarray(x_ns), jnp.asarray(x_sal), jnp.asarray(w_q.T),
            jnp.asarray(scales.T), jnp.asarray(w_sal.T),
            group_size=g,
        )
        w_deq = (w_q.astype(np.float32).reshape(o, -1, g)
                 * scales[..., None]).reshape(o, k_ns)
        np.testing.assert_allclose(np.asarray(got), x_ns @ w_deq.T, atol=2e-3, rtol=1e-4)


class TestPackedLinear:
    def _oracle(self, w, x, packed, cfg):
        """Static-perm-domain simulation: permute, pad, Q-DQ both sides, matmul."""
        meta = packed.meta
        perm = np.asarray(packed.perm)
        x_perm = x[:, perm]
        x_ns_q, x_sal = quantize_activations_packed(
            jnp.asarray(x_perm), meta, cfg
        )
        w_deq = (np.asarray(packed.w_qt, np.float32).T.reshape(meta.out_features, -1, meta.group_size)
                 * np.asarray(packed.w_scales_t).T[..., None]).reshape(meta.out_features, meta.k_ns)
        y = np.asarray(x_ns_q) @ w_deq.T + np.asarray(x_sal) @ np.asarray(packed.w_sal_t, np.float32)
        if packed.bias is not None:
            y = y + np.asarray(packed.bias)
        return y

    @pytest.mark.parametrize("cfg", [
        w4a4_group(group_size=64),
        w4a4_group(group_size=64, salient_prop=0.1),
        QuantConfig(weight_quant="per_channel", act_quant="per_token", quant_bits=8),
        QuantConfig(weight_quant="per_tensor", act_quant="per_tensor", quant_bits=8),
    ])
    def test_real_linear_matches_oracle(self, rng, cfg):
        o, c, n = 128, 320, 16
        w = rng.normal(size=(o, c)).astype(np.float32)
        b = rng.normal(size=(o,)).astype(np.float32)
        x = rng.normal(size=(n, c)).astype(np.float32)
        imp = rng.uniform(0.1, 1.0, size=(c,)) if cfg.salient_prop else None
        packed = pack_linear({"weight": w, "bias": b}, cfg, importance=imp,
                             compute_dtype=jnp.float32)
        got = real_quant_linear(packed, jnp.asarray(x), cfg, interpret=True)
        ref = self._oracle(w, x, packed, cfg)
        np.testing.assert_allclose(np.asarray(got), ref, atol=2e-3, rtol=1e-3)

    def test_packed_weight_qdq_matches_sim(self, rng):
        # weight Q-DQ in the packed domain == core group quantizer output
        o, c, g = 64, 256, 64
        w = rng.normal(size=(o, c)).astype(np.float32)
        cfg = w4a4_group(group_size=g)
        packed = pack_linear({"weight": w, "bias": None}, cfg, compute_dtype=jnp.float32)
        perm = np.asarray(packed.perm)
        w_deq = (np.asarray(packed.w_qt, np.float32).T.reshape(o, -1, g)
                 * np.asarray(packed.w_scales_t).T[..., None]).reshape(o, -1)[:, :c]
        ref = np.asarray(core.quantize_weight_per_group_absmax(
            jnp.asarray(w[:, perm]), 4, g))
        np.testing.assert_allclose(w_deq, ref, atol=1e-6)

    def test_static_sort_groups_similar_channels(self, rng):
        # packing sorts non-salient channels by act absmax: with outliers the
        # packed-domain quant error must beat unsorted grouping
        o, c, g = 64, 256, 32
        w = rng.normal(size=(o, c)).astype(np.float32)
        act_absmax = rng.uniform(0.5, 1.0, size=(c,))
        out_cols = np.arange(0, c, 8)
        w[:, out_cols] *= 50
        act_absmax[out_cols] *= 50
        cfg = w4a4_group(group_size=g)
        packed = pack_linear({"weight": w, "bias": None}, cfg,
                             act_absmax=act_absmax, compute_dtype=jnp.float32)
        perm = np.asarray(packed.perm)
        w_deq = (np.asarray(packed.w_qt, np.float32).T.reshape(o, -1, g)
                 * np.asarray(packed.w_scales_t).T[..., None]).reshape(o, -1)[:, :c]
        err_sorted = np.abs(w_deq - w[:, perm]).mean()
        unsorted = np.asarray(core.quantize_weight_per_group_absmax(jnp.asarray(w), 4, g))
        err_unsorted = np.abs(unsorted - w).mean()
        assert err_sorted < err_unsorted

    def test_salient_columns_exact_fp(self, rng):
        o, c = 32, 128
        cfg = w4a4_group(group_size=32, salient_prop=0.1)
        w = rng.normal(size=(o, c)).astype(np.float32)
        imp = rng.uniform(0.1, 1.0, size=(c,))
        packed = pack_linear({"weight": w, "bias": None}, cfg, importance=imp,
                             compute_dtype=jnp.float32)
        meta = packed.meta
        assert meta.num_salient == 12  # int(0.1*128)=12
        perm = np.asarray(packed.perm)
        sal_cols = perm[c - meta.num_salient:]
        np.testing.assert_array_equal(
            np.asarray(packed.w_sal_t).T[:, : meta.num_salient], w[:, sal_cols]
        )

    def test_3d_input_and_bias(self, rng):
        o, c = 128, 256
        cfg = w4a4_group(group_size=64)
        w = rng.normal(size=(o, c)).astype(np.float32)
        b = rng.normal(size=(o,)).astype(np.float32)
        packed = pack_linear({"weight": w, "bias": b}, cfg, compute_dtype=jnp.float32)
        x = rng.normal(size=(2, 5, c)).astype(np.float32)
        y = real_quant_linear(packed, jnp.asarray(x), cfg, interpret=True)
        assert y.shape == (2, 5, o)
