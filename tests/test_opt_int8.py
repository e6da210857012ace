"""Real-INT8 OPT path: export from FP + forward accuracy vs FP model."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smoothquant_tpu.models import ForwardContext, opt as jopt
from smoothquant_tpu.models import opt_int8
from smoothquant_tpu.models.registry import smooth_lm
from smoothquant_tpu.quant.calibrate import (
    get_act_scales,
    get_static_act_dict,
    get_static_decoder_layer_scales_opt,
)


@pytest.fixture(scope="module")
def exported():
    cfg = jopt.OPTConfig.tiny()
    params = jopt.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    batches = [jnp.asarray(rng.integers(0, cfg.vocab_size, size=(1, 16)))
               for _ in range(3)]

    def fwd(p, ids, col):
        jopt.forward(p, ids, cfg, ctx=ForwardContext(taps=col))

    # reference export pipeline: smooth → static scales → from_float
    # (examples/export_int8_model.py:16-56)
    act_scales = get_act_scales(fwd, params, batches)
    smoothed = smooth_lm("opt", params, cfg, act_scales, alpha=0.5)
    act_dict = get_static_act_dict(fwd, smoothed, batches)
    layer_scales = get_static_decoder_layer_scales_opt(act_dict, cfg.num_hidden_layers)
    int8_params = opt_int8.from_float(smoothed, cfg, layer_scales)
    return cfg, params, smoothed, int8_params, batches


def test_static_scales_structure(exported):
    cfg, _, _, int8_params, _ = exported
    assert len(int8_params["int8_layers"]) == cfg.num_hidden_layers
    lp = int8_params["int8_layers"][0]
    for k in ("attn_input_scale", "q_output_scale", "k_output_scale",
              "v_output_scale", "out_input_scale", "fc1_input_scale",
              "fc2_input_scale"):
        assert lp.scales[k] > 0


def test_int8_weights_are_int8(exported):
    _, _, _, int8_params, _ = exported
    lp = int8_params["int8_layers"][0]
    assert lp.q_proj.w_q.dtype == jnp.int8
    assert lp.fc1.w_q.dtype == jnp.int8
    assert np.abs(np.asarray(lp.fc1.w_q)).max() <= 127


def test_int8_forward_tracks_fp(exported):
    cfg, _, smoothed, int8_params, batches = exported
    ids = batches[0]
    fp_logits, _ = jopt.forward(smoothed, ids, cfg)
    int8_logits, _ = opt_int8.forward(int8_params, ids, cfg)
    fp_np, i8_np = np.asarray(fp_logits), np.asarray(int8_logits)
    assert np.all(np.isfinite(i8_np))
    # top-1 agreement on most positions: int8 is lossy but must track FP
    agree = (fp_np.argmax(-1) == i8_np.argmax(-1)).mean()
    assert agree > 0.7, f"top-1 agreement {agree}"


def test_int8_forward_is_causal(exported):
    cfg, _, _, int8_params, batches = exported
    ids = np.asarray(batches[0])
    out_full = np.asarray(opt_int8.forward(int8_params, jnp.asarray(ids), cfg)[0])
    ids_perturbed = ids.copy()
    ids_perturbed[0, -1] = (ids_perturbed[0, -1] + 1) % cfg.vocab_size
    out_pert = np.asarray(opt_int8.forward(int8_params, jnp.asarray(ids_perturbed), cfg)[0])
    # changing the last token must not change logits at earlier positions
    np.testing.assert_allclose(out_full[:, :-1], out_pert[:, :-1], atol=1e-5)


def test_int8_cached_decode_matches_teacher_forced(exported):
    """KV-cached greedy decode must reproduce teacher-forced argmax token
    for token — the cache stores the exact static-scale int8 k/v the
    teacher-forced pass computes (opt.py:122-133 semantics)."""
    import jax

    from smoothquant_tpu.models.common import KVCache
    from smoothquant_tpu.serve import GenerationConfig, Generator

    cfg, _, _, int8_params, batches = exported
    prompt = np.asarray(batches[0])[:1, :6]

    # oracle: repeated teacher-forced full forward
    toks = list(prompt[0])
    for _ in range(4):
        lg, _ = opt_int8.forward(int8_params, jnp.asarray([toks]), cfg)
        toks.append(int(np.asarray(lg)[0, -1].argmax()))
    expected = toks[prompt.shape[1]:]

    gen = Generator(opt_int8, int8_params, cfg, kv_dtype=jnp.int8,
                    max_len=32)
    out = gen.generate(prompt, GenerationConfig(max_new_tokens=4))
    assert list(out[0, prompt.shape[1]:]) == expected


def test_int8_prefill_cache_consistent(exported):
    """Prefill-then-decode logits equal full-forward logits at the same
    position (cached int8 k/v are bit-identical to teacher-forced)."""
    from smoothquant_tpu.models.common import KVCache

    cfg, _, _, int8_params, batches = exported
    ids = np.asarray(batches[0])[:1, :7]
    full, _ = opt_int8.forward(int8_params, jnp.asarray(ids), cfg)

    caches = [KVCache.create(1, 16, cfg.num_attention_heads, cfg.head_dim,
                             jnp.int8) for _ in range(cfg.num_hidden_layers)]
    lg, caches = opt_int8.forward(int8_params, jnp.asarray(ids[:, :6]), cfg,
                                  caches=caches)
    lg2, _ = opt_int8.forward(int8_params, jnp.asarray(ids[:, 6:7]), cfg,
                              caches=caches)
    np.testing.assert_allclose(np.asarray(lg2)[0, -1], np.asarray(full)[0, -1],
                               atol=1e-4, rtol=1e-4)
