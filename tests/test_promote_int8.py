"""int8-per-column promotion of int4-group packed weights (prefill recipe).

The promoted layout must (a) reconstruct the W4-dequantized weight to within
half an int8-per-column step, (b) run through the same real_quant_linear int
path, (c) stay close to the W4 simulation at the model level."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smoothquant_tpu.kernels.pack import (
    pack_linear,
    promote_int8,
    promote_model_int8,
    unpack_nibbles_to_int8,
)
from smoothquant_tpu.kernels.real_linear import real_quant_linear
from smoothquant_tpu.quant import w4a4_group


def _lin(rng, o, c):
    return {"weight": jnp.asarray(rng.normal(size=(o, c)) * 0.05, jnp.float32),
            "bias": jnp.asarray(rng.normal(size=(o,)), jnp.float32)}


@pytest.mark.parametrize("nibble", [False, True])
def test_promote_reconstructs_w4_weight(nibble):
    rng = np.random.default_rng(0)
    o, c = 40, 128
    qcfg = w4a4_group(group_size=16, salient_prop=0.1)
    imp = rng.uniform(0.1, 1.0, size=(c,))
    p4 = pack_linear(_lin(rng, o, c), qcfg, importance=imp, nibble=nibble)
    p8 = promote_int8(p4)

    w_qt4 = (unpack_nibbles_to_int8(p4.w_qt) if nibble else p4.w_qt)
    g = p4.meta.group_size
    gt = p4.meta.k_ns // g
    w4_deq = (np.asarray(w_qt4, np.float32).reshape(gt, g, o)
              * np.asarray(p4.w_scales_t)[:, None, :]).reshape(p4.meta.k_ns, o)
    w8_deq = np.asarray(p8.w_qt, np.float32) * np.asarray(p8.w_scales_t)

    # identity layout: w8 row perm[j] holds packed row j; salient rows zero
    k_ns_raw = c - p4.meta.num_salient
    perm = np.asarray(p4.perm)
    col_step = np.abs(w4_deq).max(0) / 127.0
    assert np.all(np.abs(w8_deq[perm[:k_ns_raw]] - w4_deq[:k_ns_raw])
                  <= 0.5 * col_step + 1e-8)
    if p4.meta.num_salient:
        assert np.all(np.asarray(p8.w_qt)[perm[k_ns_raw:]] == 0)
    assert p8.meta.layout == "identity" and not p8.meta.nibble
    assert p8.meta.act_quant == "per_token" and p8.meta.act_bits == 8


def test_promoted_forward_close_to_w4_path():
    rng = np.random.default_rng(1)
    o, c, n = 48, 160, 32
    qcfg = w4a4_group(group_size=16, salient_prop=0.05)
    imp = rng.uniform(0.1, 1.0, size=(c,))
    p4 = pack_linear(_lin(rng, o, c), qcfg, importance=imp)
    p8 = promote_int8(p4)
    x = jnp.asarray(rng.normal(size=(n, c)), jnp.float32)

    y4 = np.asarray(real_quant_linear(p4, x, compute="int", interpret=True),
                    np.float32)
    y8 = np.asarray(real_quant_linear(p8, x, compute="int", interpret=True),
                    np.float32)
    # the promoted recipe is a DIFFERENT (coarser-weight, finer-activation)
    # quantization of the same W4 parameterization: A4-per-group → A8-per-
    # token dominates the delta, which must stay the same order as the W4A4
    # quantization error itself (~5% of output range here)
    scale = np.abs(y4).max()
    assert np.abs(y8 - y4).max() <= 0.08 * scale, np.abs(y8 - y4).max()


def test_generator_with_promoted_prefill_params():
    """Serving integration: prefill on the promoted int8 tree, decode on the
    nibble tree — the intended production split."""
    from smoothquant_tpu.models import llama as jllama
    from smoothquant_tpu.models.registry import pack_model
    from smoothquant_tpu.serve import GenerationConfig, Generator

    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(jax.random.PRNGKey(5), cfg)
    qcfg = w4a4_group(group_size=32, salient_prop=0.0)
    p4 = pack_model("llama", params, cfg, qcfg, compute_dtype=jnp.float32,
                    nibble=True)
    p8 = promote_model_int8(p4)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(1, 5))
    gen = Generator(jllama, p4, cfg, quant=qcfg, max_len=32, compute="int",
                    interpret=True, prefill_params=p8)
    out = gen.generate(prompt, GenerationConfig(max_new_tokens=4))
    assert out.shape == (1, 9)
    assert np.all(out[:, :5] == prompt)


def test_promote_model_walks_tree():
    from smoothquant_tpu.models import ForwardContext, llama as jllama
    from smoothquant_tpu.models.registry import pack_model

    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(jax.random.PRNGKey(2), cfg)
    qcfg = w4a4_group(group_size=32, salient_prop=0.0)
    p4 = pack_model("llama", params, cfg, qcfg, compute_dtype=jnp.float32,
                    nibble=True)
    p8 = promote_model_int8(p4)
    ids = jnp.asarray(np.random.default_rng(3).integers(0, 256, size=(1, 8)))
    ctx = ForwardContext(quant=qcfg, compute="int", interpret=True)
    l4, _ = jllama.forward(p4, ids, cfg, ctx=ctx)
    l8, _ = jllama.forward(p8, ids, cfg, ctx=ctx)
    lf, _ = jllama.forward(params, ids, cfg)
    a4, a8, af = np.asarray(l4), np.asarray(l8), np.asarray(lf)
    # promotion swaps A4-per-group for A8-per-token on top of the W4
    # parameterization — a FINER activation recipe, so the promoted model
    # must approximate the fp model at least as well as the W4A4 path does
    rel4 = np.linalg.norm(a4 - af) / np.linalg.norm(af)
    rel8 = np.linalg.norm(a8 - af) / np.linalg.norm(af)
    assert rel8 <= rel4 * 1.1, (rel8, rel4)


@pytest.mark.parametrize("opts", [
    dict(fuse=True, fold_perms=True),            # pre_permuted down_proj
    dict(shared_residual_basis=True),            # pre_permuted qkv/gate_up
    dict(identity_keys=("o_proj",)),             # identity nibble o_proj
])
def test_promoted_model_tracks_nibble_model(opts):
    """promote_model_int8 must keep the input order each pack expects: a
    pre_permuted pack's input arrives in packed order and an identity pack's
    in original order — scattering either by perm scrambles the channels."""
    import dataclasses

    from smoothquant_tpu.models import ForwardContext, llama as jllama
    from smoothquant_tpu.models.registry import pack_model

    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(), hidden_size=128,
                              intermediate_size=256)
    params = jllama.init_params(jax.random.PRNGKey(3), cfg)
    qcfg = w4a4_group(group_size=16, salient_prop=0.05)
    rng = np.random.default_rng(4)
    feat = {key: rng.uniform(0.1, 1.0, size=(
        cfg.intermediate_size if "down_proj" in key else cfg.hidden_size,))
        for _, key, _ in jllama.quantizable_linears(cfg)}
    packed = pack_model("llama", params, cfg, qcfg, input_feat=feat,
                        act_scales=feat, compute_dtype=jnp.float32,
                        nibble=True, **opts)
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(1, 12)))
    ctx = ForwardContext(quant=qcfg)
    w4, _ = jllama.forward(packed, ids, cfg, ctx=ctx)
    w8, _ = jllama.forward(promote_model_int8(packed), ids, cfg, ctx=ctx)
    w4, w8 = np.asarray(w4), np.asarray(w8)
    # the int8 requantization and per-token activations move the logits a
    # little; a scrambled channel order moves them as far as the logits go
    rel = np.linalg.norm(w8 - w4) / np.linalg.norm(w4)
    assert rel < 0.3, rel
