"""The two Triton kernels (Pallas interpret mode) against their plain XLA
routes, and the choice of route by platform and shape.

The kernels compile only for a GPU; here they run in the Pallas
interpreter, which executes the same kernel body (masks, layer offsets,
split-K and split-S merges).  `gpu`-marked tests run the compiled kernels
and skip on the CPU.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smoothquant_tpu.kernels import decode_attention as da
from smoothquant_tpu.kernels.int4_group_matmul import (
    int4_group_matmul_stacked,
    kernel_supported,
)
from smoothquant_tpu.kernels.route import use_kernel
from smoothquant_tpu.utils import native

L = 3


def _mm_operands(rng, n, k, o, gs, k_s, scale_dtype=jnp.float32):
    g = k // gs
    xq = jnp.asarray(rng.integers(-7, 8, (n, k)), jnp.int8)
    xs = jnp.asarray(rng.uniform(0.01, 0.2, (n, g)), jnp.float32)
    wp = jnp.asarray(np.stack([
        native.pack_nibbles_split(rng.integers(-8, 8, (k, o)).astype(np.int8))
        for _ in range(L)]))
    ws = jnp.asarray(rng.uniform(0.01, 0.2, (L, g, o)), scale_dtype)
    xsal = jnp.asarray(rng.normal(size=(n, k_s)), jnp.float32)
    wsal = jnp.asarray(rng.normal(size=(L, k_s, o)), jnp.float32)
    return xq, xs, wp, ws, xsal, wsal


def _mm_both(args, layer, gs):
    kw = dict(group_size=gs)
    plain = int4_group_matmul_stacked(jnp.int32(layer), *args, **kw)
    kern = int4_group_matmul_stacked(jnp.int32(layer), *args, kernel=True,
                                     interpret=True, **kw)
    return np.asarray(kern), np.asarray(plain)


@pytest.mark.parametrize("gs", [64, 128])
@pytest.mark.parametrize("k_s", [0, 256])
@pytest.mark.parametrize("n", [1, 4, 17])
def test_w4a4_kernel_matches_plain(n, k_s, gs):
    # O = 192: the second 128-column block is half masked; K = 768 gives
    # g_half = 6 (gs 64) or 3 (gs 128) byte groups, split over blocks
    rng = np.random.default_rng(n * 1000 + k_s + gs)
    args = _mm_operands(rng, n, 768, 192, gs, k_s)
    got, ref = _mm_both(args, 2, gs)
    assert got.shape == (n, 192)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_w4a4_kernel_reads_the_indexed_layer(layer):
    rng = np.random.default_rng(7)
    args = _mm_operands(rng, 4, 256, 128, 64, 128)
    got, ref = _mm_both(args, layer, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    other, _ = _mm_both(args, (layer + 1) % L, 64)
    assert np.abs(other - got).max() > 1.0   # another layer, other output


def test_w4a4_kernel_bf16_scales():
    rng = np.random.default_rng(8)
    args = _mm_operands(rng, 4, 512, 256, 64, 128, jnp.bfloat16)
    got, ref = _mm_both(args, 1, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n", [40, 70])
def test_w4a4_kernel_prefill_row_blocks(n):
    """N > 16 takes 64-row blocks; padded rows never reach the output."""
    rng = np.random.default_rng(n)
    args = _mm_operands(rng, n, 256, 128, 64, 0)
    got, ref = _mm_both(args, 0, 64)
    assert got.shape == (n, 128)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


def _attn_operands(rng, b, h, n_kv, s, d, kind):
    shape = (L, b, n_kv, s, d)
    if kind == "int8":
        k = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
        v = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
        ks = jnp.asarray(rng.uniform(1e-3, 2e-2, shape[:4]), jnp.float32)
        vs = jnp.asarray(rng.uniform(1e-3, 2e-2, shape[:4]), jnp.float32)
    else:
        dt = jnp.bfloat16 if kind == "bf16" else jnp.float32
        k = jnp.asarray(rng.normal(size=shape), dt)
        v = jnp.asarray(rng.normal(size=shape), dt)
        ks = vs = None
    q = jnp.asarray(rng.normal(size=(b, h, d)),
                    jnp.bfloat16 if kind == "bf16" else jnp.float32)
    return q, k, v, ks, vs


def _bias(rng, b, s, holes=True):
    valid = rng.integers(1, s + 1, size=b)
    ok = np.arange(s)[None] < valid[:, None]
    if holes:
        ok &= rng.random((b, s)) > 0.2
        ok[:, 0] = True
    return jnp.asarray(np.where(ok, 0.0, da.NEG_INF), jnp.float32)


def _attn_both(q, k, v, bias, ks, vs, slopes, layer=1):
    plain = da.decode_attention_stacked(jnp.int32(layer), q, k, v, bias, ks,
                                        vs, slopes)
    kern = da.decode_attention_stacked(jnp.int32(layer), q, k, v, bias, ks,
                                       vs, slopes, kernel=True,
                                       interpret=True)
    return (np.asarray(kern, np.float32), np.asarray(plain, np.float32))


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("h,n_kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
def test_decode_attention_kernel_matches_plain(kind, h, n_kv, alibi):
    rng = np.random.default_rng(len(kind) * 10 + h + alibi)
    b, s, d = 3, 300, 32           # S not a tile multiple: masked tail
    q, k, v, ks, vs = _attn_operands(rng, b, h, n_kv, s, d, kind)
    slopes = (jnp.asarray(rng.uniform(0.0, 0.1, h), jnp.float32)
              if alibi else None)
    got, ref = _attn_both(q, k, v, _bias(rng, b, s), ks, vs, slopes)
    # bf16: the kernel and the plain route round p to bf16 in other orders
    tol = 2e-2 if kind == "bf16" else 1e-4
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_decode_attention_sliding_window_bias():
    """A window is just more NEG_INF columns: keys older than W drop out."""
    from smoothquant_tpu.models.common import decode_bias

    rng = np.random.default_rng(11)
    b, h, s, d, w = 2, 4, 128, 32, 16
    q, k, v, ks, vs = _attn_operands(rng, b, h, h, s, d, "int8")
    pos = jnp.asarray([100, 40], jnp.int32)
    bias = decode_bias(pos, b, s, None, sliding_window=w)
    assert int((np.asarray(bias) == 0).sum(1)[0]) == w
    got, ref = _attn_both(q, k, v, bias, ks, vs, None)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_decode_attention_fully_masked_row_is_zero():
    rng = np.random.default_rng(12)
    b, h, s, d = 2, 4, 64, 16
    q, k, v, ks, vs = _attn_operands(rng, b, h, h, s, d, "f32")
    bias = np.zeros((b, s), np.float32)
    bias[1] = da.NEG_INF
    got, ref = _attn_both(q, k, v, jnp.asarray(bias), ks, vs, None)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [16, 600])
def test_decode_attention_split_merge(s):
    """Many cache tiles split over blocks and merged in a second pass."""
    rng = np.random.default_rng(s)
    q, k, v, ks, vs = _attn_operands(rng, 1, 2, 2, s, 16, "int8")
    got, ref = _attn_both(q, k, v, _bias(rng, 1, s, holes=False), ks, vs,
                          None, layer=0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------- routes


def test_no_kernel_on_cpu_unless_interpret():
    assert jax.default_backend() == "cpu"
    assert not use_kernel()
    assert use_kernel(interpret=True)
    assert not use_kernel(interpret=True, plain=True)


@pytest.mark.parametrize("gs,ok", [(16, False), (32, True), (64, True),
                                   (128, True), (96, False), (512, False)])
def test_matmul_kernel_shape_rule(gs, ok):
    assert kernel_supported(gs) is ok


def _has_pallas(fn, *args):
    return "pallas_call" in str(jax.make_jaxpr(fn)(*args))


def _packed_linear(gs):
    from smoothquant_tpu.kernels.pack import pack_linear
    from smoothquant_tpu.quant import w4a4_group

    rng = np.random.default_rng(gs)
    lin = {"weight": jnp.asarray(rng.normal(size=(128, 256)), jnp.float32),
           "bias": None}
    return pack_linear(lin, w4a4_group(group_size=gs, salient_prop=0.05),
                       importance=rng.uniform(0.1, 1.0, 256),
                       compute_dtype=jnp.float32, nibble=True)


@pytest.mark.parametrize("gs,interpret,plain,expect", [
    (64, False, False, False),   # CPU: plain route, never auto-interprets
    (64, True, False, True),     # explicit interpret runs the kernel
    (64, True, True, False),     # plain=True wins
    (16, True, False, False),    # group below the kernel's shape rule
])
def test_packed_linear_route(gs, interpret, plain, expect):
    from smoothquant_tpu.kernels.real_linear import real_quant_linear

    pk = _packed_linear(gs)
    x = jnp.ones((4, 256), jnp.float32)
    fn = lambda x: real_quant_linear(pk, x, interpret=interpret, plain=plain)
    assert _has_pallas(fn, x) is expect
    if expect:   # both routes agree
        ref = real_quant_linear(pk, x)
        np.testing.assert_allclose(np.asarray(fn(x)), np.asarray(ref),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("interpret,d,expect", [
    (False, 32, False), (True, 32, True), (True, 24, False)])
def test_cached_attention_route(interpret, d, expect):
    from smoothquant_tpu.models.common import (ForwardContext, QuantKVCache,
                                               cached_attention)

    cache = QuantKVCache.create(2, 64, 2, d)
    cache = cache.update(jnp.ones((2, 5, 2, d)), jnp.ones((2, 5, 2, d)))
    q = jnp.ones((2, 1, 4, d))
    ctx = ForwardContext(interpret=interpret)
    fn = lambda q: cached_attention(q, cache, causal_offset=cache.pos - 1,
                                    ctx=ctx)
    assert _has_pallas(fn, q) is expect


@pytest.mark.gpu
def test_gpu_kernels_compile(gpu):
    """Compiled Triton kernels against the plain routes (GPU only)."""
    rng = np.random.default_rng(0)
    args = _mm_operands(rng, 4, 1024, 512, 64, 128)
    kern = int4_group_matmul_stacked(jnp.int32(1), *args, group_size=64,
                                     kernel=True)
    plain = int4_group_matmul_stacked(jnp.int32(1), *args, group_size=64)
    np.testing.assert_allclose(np.asarray(kern), np.asarray(plain),
                               rtol=1e-4, atol=1e-2)
