"""Nibble-packed int4 group matmul: the Triton kernel (interpret mode) vs
the unpacked int8 route."""

import numpy as np
import pytest
import jax.numpy as jnp

from smoothquant_tpu.kernels.int4_group_matmul import int4_group_matmul
from smoothquant_tpu.kernels.int_group_matmul import int_group_matmul
from smoothquant_tpu.utils import native


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("n,o,k,gs", [
    (8, 256, 512, 64),
    (16, 128, 512, 128),
    (8, 130, 384, 64),   # g_half=3: split-K tail; O not a block multiple
    (8, 128, 256, 64),   # g_half=2
])
def test_matches_unpacked_int_kernel(rng, n, o, k, gs):
    g = k // gs
    x_q = rng.integers(-7, 8, size=(n, k)).astype(np.int8)
    xs = rng.uniform(0.01, 0.2, size=(n, g)).astype(np.float32)
    w_qt = rng.integers(-8, 8, size=(k, o)).astype(np.int8)
    ws = rng.uniform(0.01, 0.2, size=(g, o)).astype(np.float32)
    ks = 128
    x_sal = rng.normal(size=(n, ks)).astype(np.float32)
    w_sal = rng.normal(size=(ks, o)).astype(np.float32)

    packed = native.pack_nibbles_split(w_qt)
    got = int4_group_matmul(
        jnp.asarray(x_q), jnp.asarray(xs), jnp.asarray(packed), jnp.asarray(ws),
        jnp.asarray(x_sal), jnp.asarray(w_sal), group_size=gs, kernel=True,
        interpret=True,
    )
    ref = int_group_matmul(
        jnp.asarray(x_q), jnp.asarray(xs), jnp.asarray(w_qt), jnp.asarray(ws),
        jnp.asarray(x_sal), jnp.asarray(w_sal), group_size=gs,
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-3, rtol=1e-4)


def test_negative_nibbles_sign_extend(rng):
    # all-(-8) weights stress the sign extension of both nibbles
    n, o, k, gs = 8, 128, 256, 64
    g = k // gs
    w_qt = np.full((k, o), -8, np.int8)
    x_q = rng.integers(-7, 8, size=(n, k)).astype(np.int8)
    xs = np.ones((n, g), np.float32)
    ws = np.ones((g, o), np.float32)
    packed = native.pack_nibbles_split(w_qt)
    got = int4_group_matmul(
        jnp.asarray(x_q), jnp.asarray(xs), jnp.asarray(packed), jnp.asarray(ws),
        jnp.zeros((n, 128), jnp.float32), jnp.zeros((128, o), jnp.float32),
        group_size=gs, kernel=True, interpret=True,
    )
    ref = (x_q.astype(np.int32) @ w_qt.astype(np.int32)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-2)


def test_no_salient_block(rng):
    # salient_prop=0 → k_s=0: kernels must run without any salient operands
    n, o, k, gs = 8, 128, 512, 64
    g = k // gs
    x_q = rng.integers(-7, 8, size=(n, k)).astype(np.int8)
    xs = rng.uniform(0.01, 0.2, size=(n, g)).astype(np.float32)
    w_qt = rng.integers(-8, 8, size=(k, o)).astype(np.int8)
    ws = rng.uniform(0.01, 0.2, size=(g, o)).astype(np.float32)
    empty_x = jnp.zeros((n, 0), jnp.float32)
    empty_w = jnp.zeros((0, o), jnp.float32)
    packed = native.pack_nibbles_split(w_qt)
    got = int4_group_matmul(
        jnp.asarray(x_q), jnp.asarray(xs), jnp.asarray(packed), jnp.asarray(ws),
        empty_x, empty_w, group_size=gs, kernel=True, interpret=True,
    )
    ref = int_group_matmul(
        jnp.asarray(x_q), jnp.asarray(xs), jnp.asarray(w_qt), jnp.asarray(ws),
        empty_x, empty_w, group_size=gs,
    )
    expected = ((x_q.astype(np.int32).reshape(n, g, gs)[..., None]
                 * w_qt.astype(np.int32).reshape(g, gs, o)[None]).sum(2)
                * xs[..., None] * ws[None]).sum(1)
    np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ref), expected, rtol=1e-4, atol=1e-3)


def test_half_group_alignment_guard(rng):
    with pytest.raises(AssertionError):
        int4_group_matmul(
            jnp.zeros((4, 192), jnp.int8), jnp.zeros((4, 3), jnp.float32),
            jnp.zeros((96, 64), jnp.int8), jnp.zeros((3, 64), jnp.float32),
            jnp.zeros((4, 128), jnp.float32), jnp.zeros((128, 64), jnp.float32),
            group_size=64, kernel=True, interpret=True,  # K/2=96 % 64 != 0
        )
