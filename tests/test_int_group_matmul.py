"""Int-compute group matmul tests."""

import numpy as np
import pytest
import jax.numpy as jnp

from smoothquant_tpu.kernels import pack_linear, real_quant_linear
from smoothquant_tpu.kernels.int_group_matmul import int_group_matmul
from smoothquant_tpu.quant import QuantConfig, w4a4_group


@pytest.fixture
def rng():
    return np.random.default_rng(0)


class TestIntGroupMatmul:
    @pytest.mark.parametrize("n,o,k,gs", [
        (8, 256, 512, 64),
        (16, 128, 256, 128),
        (40, 130, 320, 64),   # padding everywhere (g_total=5 pads to 8)
    ])
    def test_matches_float_factorization(self, rng, n, o, k, gs):
        g = k // gs
        x_q = rng.integers(-7, 8, size=(n, k)).astype(np.int8)
        xs = rng.uniform(0.01, 0.2, size=(n, g)).astype(np.float32)
        w_q = rng.integers(-7, 8, size=(k, o)).astype(np.int8)
        ws = rng.uniform(0.01, 0.2, size=(g, o)).astype(np.float32)
        ks = 128
        x_sal = rng.normal(size=(n, ks)).astype(np.float32)
        w_sal = rng.normal(size=(ks, o)).astype(np.float32)

        got = int_group_matmul(
            jnp.asarray(x_q), jnp.asarray(xs), jnp.asarray(w_q),
            jnp.asarray(ws), jnp.asarray(x_sal), jnp.asarray(w_sal),
            group_size=gs,
        )
        ref = x_sal @ w_sal
        for gg in range(g):
            sl = slice(gg * gs, (gg + 1) * gs)
            partial = x_q[:, sl].astype(np.int32) @ w_q[sl].astype(np.int32)
            ref = ref + partial.astype(np.float32) * xs[:, gg : gg + 1] * ws[gg][None, :]
        np.testing.assert_allclose(np.asarray(got), ref, atol=2e-2, rtol=1e-4)

    def test_single_group_per_channel(self, rng):
        # weight per-channel: one group spanning all of K
        n, o, k = 8, 128, 256
        x_q = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
        xs = rng.uniform(0.01, 0.1, size=(n, 1)).astype(np.float32)
        w_q = rng.integers(-127, 128, size=(k, o)).astype(np.int8)
        ws = rng.uniform(0.01, 0.1, size=(1, o)).astype(np.float32)
        got = int_group_matmul(
            jnp.asarray(x_q), jnp.asarray(xs), jnp.asarray(w_q), jnp.asarray(ws),
            jnp.zeros((n, 128), jnp.float32), jnp.zeros((128, o), jnp.float32),
            group_size=k,
        )
        ref = (x_q.astype(np.int32) @ w_q.astype(np.int32)).astype(np.float32) * xs * ws
        np.testing.assert_allclose(np.asarray(got), ref, atol=1e-2, rtol=1e-4)


class TestIntPathEndToEnd:
    @pytest.mark.parametrize("cfg", [
        w4a4_group(group_size=64),
        w4a4_group(group_size=64, salient_prop=0.1),
        QuantConfig(weight_quant="per_channel", act_quant="per_token", quant_bits=8),
    ])
    def test_int_path_matches_dequant_path(self, rng, cfg):
        """Both real-path kernels must agree (same Q-DQ semantics)."""
        o, c, n = 128, 320, 16
        w = rng.normal(size=(o, c)).astype(np.float32)
        b = rng.normal(size=(o,)).astype(np.float32)
        x = rng.normal(size=(n, c)).astype(np.float32)
        imp = rng.uniform(0.1, 1.0, size=(c,)) if cfg.salient_prop else None
        packed = pack_linear({"weight": w, "bias": b}, cfg, importance=imp,
                             compute_dtype=jnp.float32)
        y_deq = real_quant_linear(packed, jnp.asarray(x), cfg,
                                  compute="dequant", interpret=True)
        y_int = real_quant_linear(packed, jnp.asarray(x), cfg,
                                  compute="int", interpret=True)
        np.testing.assert_allclose(np.asarray(y_int), np.asarray(y_deq),
                                   atol=2e-3, rtol=1e-3)

    def test_mismatched_group_sizes_rejected(self, rng):
        # per-channel weights (one whole-row group) + per-group activations:
        # act groups can't align with the single weight group, so the int
        # path's output-side scale factorization is unrepresentable.  The
        # recipe is carried by the packed meta itself (self-describing).
        cfg = QuantConfig(weight_quant="per_channel", act_quant="per_group",
                          quant_bits=4, group_size=32)
        w = rng.normal(size=(64, 256)).astype(np.float32)
        packed = pack_linear({"weight": w, "bias": None}, cfg,
                             compute_dtype=jnp.float32)
        assert packed.meta.act_group_size != packed.meta.group_size
        with pytest.raises(ValueError):
            real_quant_linear(packed, jnp.asarray(rng.normal(size=(4, 256)).astype(np.float32)),
                              compute="int", interpret=True)
        # auto must quietly fall back to the dequant kernel instead
        y = real_quant_linear(packed, jnp.asarray(rng.normal(size=(4, 256)).astype(np.float32)),
                              compute="auto", interpret=True)
        assert np.all(np.isfinite(np.asarray(y)))
