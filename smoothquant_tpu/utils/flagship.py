"""The flagship serving recipe and a random-weight build of it.

`chip_smoke.py` and `bench.py` both serve Llama at full width with random
weights from a seed; this module is what they share: the recipe, the
calibration statistics drawn from a seed, and the library path from float
weights to the packed tree (smooth_lm → pack_model).
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np


def recipes():
    """(body, lm_head) quantization configs of the flagship recipe: W4A4
    g64 with 5 % salient channels and bf16 group scales (a storage-only
    narrowing; the math stays f32), and an int8 per-channel lm_head."""
    from smoothquant_tpu.quant import w4a4_group
    from smoothquant_tpu.quant.config import QuantConfig

    qcfg = dataclasses.replace(w4a4_group(group_size=64, salient_prop=0.05),
                               scale_dtype="bfloat16")
    head = QuantConfig(weight_quant="per_channel", act_quant="per_token",
                       quant_bits=8)
    return qcfg, head


def random_stats(cfg, rng):
    """Per-channel activation absmax and salience for every quantizable
    input of a Llama config, drawn from `rng`: uniform with 1 % outlier
    channels ×20, the shape SmoothQuant's calibration sees in real LLM
    activations."""
    from smoothquant_tpu.models import llama

    def draw(c):
        v = rng.uniform(0.1, 1.0, size=(c,))
        v[rng.choice(c, max(1, c // 100), replace=False)] *= 20.0
        return v

    stats = {}
    for _, key, _ in llama.quantizable_linears(cfg):
        c = cfg.intermediate_size if "down_proj" in key else cfg.hidden_size
        stats[key] = draw(c)
    return stats


def pack_flagship(smoothed, cfg, qcfg, head_qcfg, stats):
    """pack_model with the flagship layout: nibble-packed, fused qkv and
    gate_up, permutations folded, one residual basis, identity o_proj."""
    from smoothquant_tpu.models.registry import pack_model

    return pack_model("llama", smoothed, cfg, qcfg, input_feat=stats,
                      act_scales=stats, nibble=True, lm_head_qcfg=head_qcfg,
                      fuse=True, fold_perms=True, shared_residual_basis=True,
                      identity_keys=("o_proj",))


def build_packed(cfg, qcfg, head_qcfg, seed: int, *, keep_layers: int = 0):
    """Random float weights (from `seed`) → smooth_lm → pack_flagship.
    Returns (packed per-layer tree, stats, the smoothed float tree cut to
    its first `keep_layers` layers, or None)."""
    import jax

    from smoothquant_tpu.models import llama
    from smoothquant_tpu.models.registry import smooth_lm

    rng = np.random.default_rng(seed)
    stats = random_stats(cfg, rng)
    params = llama.init_params(jax.random.PRNGKey(seed), cfg)
    smoothed = smooth_lm("llama", params, cfg, stats, alpha=0.5)
    del params
    gc.collect()
    kept = None
    if keep_layers:
        kept = {k: v for k, v in smoothed.items() if k != "layers"}
        kept["layers"] = {str(i): smoothed["layers"][str(i)]
                          for i in range(keep_layers)}
    packed = pack_flagship(smoothed, cfg, qcfg, head_qcfg, stats)
    del smoothed
    gc.collect()
    return packed, stats, kept
