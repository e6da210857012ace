"""bf16 weight-group-scale storage (QuantConfig.scale_dtype).

The packed per-group scales may be stored bf16 in HBM (halving the scale
bytes streamed per decode step; the reference stores fp16 scales —
fake_quant.py keeps Q-DQ'd weights in the model dtype, so bf16 is the same
precision class).  Contract: storage-only narrowing — every kernel
casts the scale back to f32 before use, so the bf16-scale forward equals
the f32-scale forward with scales ROUNDED THROUGH bf16 (bit-exactly), and
stays within ~2^-8 relative of the full-f32 result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smoothquant_tpu.kernels.pack import pack_linear
from smoothquant_tpu.kernels.real_linear import real_quant_linear
from smoothquant_tpu.quant import w4a4_group
from smoothquant_tpu.quant.config import QuantConfig


def _rand_linear(rng, o, c):
    return {"weight": jnp.asarray(rng.normal(size=(o, c)).astype(np.float32)),
            "bias": None}


@pytest.mark.parametrize("salient", [0.0, 0.05])
def test_bf16_scales_match_f32_rounded(salient):
    rng = np.random.default_rng(0)
    o, c = 256, 512
    lin = _rand_linear(rng, o, c)
    imp = rng.uniform(0.1, 1.0, size=(c,)) if salient else None
    x = jnp.asarray(rng.normal(size=(4, c)).astype(np.float32))

    cfg32 = w4a4_group(group_size=64, salient_prop=salient)
    cfg16 = dataclasses.replace(cfg32, scale_dtype="bfloat16")

    p32 = pack_linear(lin, cfg32, importance=imp, nibble=True)
    p16 = pack_linear(lin, cfg16, importance=imp, nibble=True)

    assert p16.w_scales_t.dtype == jnp.bfloat16
    # storage-only: int values identical, scales are the bf16 rounding
    np.testing.assert_array_equal(np.asarray(p32.w_qt), np.asarray(p16.w_qt))
    np.testing.assert_array_equal(
        np.asarray(p32.w_scales_t.astype(jnp.bfloat16)),
        np.asarray(p16.w_scales_t))

    y32 = real_quant_linear(p32, x, compute="int", interpret=True,
                            out_dtype=jnp.float32)
    y16 = real_quant_linear(p16, x, compute="int", interpret=True,
                            out_dtype=jnp.float32)

    # oracle: run the f32 pack with bf16-rounded scales — must match the
    # bf16-stored pack bit-for-bit (the kernel math is f32 either way)
    p32_rounded = dataclasses.replace(
        p32, w_scales_t=p32.w_scales_t.astype(jnp.bfloat16))
    y_oracle = real_quant_linear(p32_rounded, x, compute="int",
                                 interpret=True, out_dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(y16), np.asarray(y_oracle))

    # and the rounding is second-order: <= ~2^-8 relative of the f32 result
    denom = np.maximum(np.abs(np.asarray(y32)), 1e-3)
    rel = np.abs(np.asarray(y16) - np.asarray(y32)) / denom
    assert float(np.median(rel)) < 6e-3, float(np.median(rel))


def test_bf16_scales_dequant_path():
    rng = np.random.default_rng(1)
    o, c = 128, 256
    lin = _rand_linear(rng, o, c)
    x = jnp.asarray(rng.normal(size=(8, c)).astype(np.float32))
    cfg16 = dataclasses.replace(w4a4_group(group_size=64),
                                scale_dtype="bfloat16")
    p16 = pack_linear(lin, cfg16)
    y = real_quant_linear(p16, x, compute="dequant", interpret=True,
                          out_dtype=jnp.float32)
    y_int = real_quant_linear(p16, x, compute="int", interpret=True,
                              out_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_int),
                               rtol=2e-2, atol=2e-2)


def test_bf16_scales_identity_lm_head():
    rng = np.random.default_rng(2)
    o, c = 512, 256
    lin = _rand_linear(rng, o, c)
    x = jnp.asarray(rng.normal(size=(4, c)).astype(np.float32))
    head = QuantConfig(weight_quant="per_channel", act_quant="per_token",
                       quant_bits=8, scale_dtype="bfloat16")
    p = pack_linear(lin, head)
    assert p.meta.layout == "identity"
    assert p.w_scales_t.dtype == jnp.bfloat16
    y = real_quant_linear(p, x, out_dtype=jnp.float32)
    ref = x @ lin["weight"].T
    # int8 per-channel + bf16 scale rounding: a loose functional check
    # (W8A8 noise accumulates ~0.5 absolute over a 256-deep contraction)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref),
                               rtol=0.1, atol=0.8)


def test_scale_dtype_validation():
    with pytest.raises(ValueError):
        QuantConfig(scale_dtype="float16")
