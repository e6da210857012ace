"""Tensor-parallel partition specs for model params pytrees.

Megatron-style TP over the `tp` mesh axis (all-reduce after o_proj/down_proj
is inserted automatically by GSPMD from these layout annotations — the
equivalent of the NCCL layer the reference never had, SURVEY.md §2.9/§5.8):

  * column-parallel ("row"-sharded weight (out, in) → P(tp, None)):
    q/k/v/gate/up/fc1 — outputs become head/neuron-sharded, bias sharded.
  * row-parallel (weight sharded on in → P(None, tp)):
    o_proj/down_proj/fc2/out_proj — inputs arrive sharded, partial sums are
    all-reduced by XLA; bias replicated.
  * embeddings and lm_head vocab-sharded, norms replicated, salient-channel
    metadata replicated (it indexes input channels of the full layer).

TP×group-quant interaction (SURVEY.md §7): for column-parallel layers the
quantization axis (input channels) is unsharded, so groups never straddle
shards.  For row-parallel layers, groups straddle shards unless
group_size | (in_features / tp); assert_group_shardable checks this.
"""

from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from smoothquant_tpu.parallel.mesh import TP_AXIS

COL = "col_parallel"  # weight (out, in) sharded on out
ROW = "row_parallel"  # weight (out, in) sharded on in
REP = "replicated"

# projection-name → parallel style, per architecture
LLAMA_LINEAR_STYLES = {
    "q_proj": COL, "k_proj": COL, "v_proj": COL, "o_proj": ROW,
    "gate_proj": COL, "up_proj": COL, "down_proj": ROW,
}
OPT_LINEAR_STYLES = {
    "q_proj": COL, "k_proj": COL, "v_proj": COL, "out_proj": ROW,
    "fc1": COL, "fc2": ROW,
}
# falcon/bloom share the fused-QKV LayerNorm block shape
FALCON_LINEAR_STYLES = {
    "query_key_value": COL, "dense": ROW,
    "dense_h_to_4h": COL, "dense_4h_to_h": ROW,
}
# mixtral: expert mlps are Megatron-split per expert; the tiny router gate
# stays replicated (its output is num_experts logits, not shardable work)
MIXTRAL_LINEAR_STYLES = {
    "q_proj": COL, "k_proj": COL, "v_proj": COL, "o_proj": ROW,
    "gate": REP, "w1": COL, "w3": COL, "w2": ROW,
}

ARCH_LINEAR_STYLES = {
    "llama": LLAMA_LINEAR_STYLES, "mistral": LLAMA_LINEAR_STYLES,
    "opt": OPT_LINEAR_STYLES,
    "falcon": FALCON_LINEAR_STYLES, "bloom": FALCON_LINEAR_STYLES,
    "mixtral": MIXTRAL_LINEAR_STYLES,
}


def _linear_spec(style: str) -> dict:
    if style == COL:
        w, b = P(TP_AXIS, None), P(TP_AXIS)
    elif style == ROW:
        w, b = P(None, TP_AXIS), P()
    else:
        w, b = P(None, None), P()
    return {
        "weight": w,
        "bias": b,
        # salient metadata indexes input channels of the unsharded layer
        "sal_perm": P(None),
        "sal_inv_perm": P(None),
        "salient_indices": P(None),
    }


def _match_linear_specs(subtree: dict, styles: dict) -> dict:
    out = {}
    for name, child in subtree.items():
        if not isinstance(child, dict):
            out[name] = P()
            continue
        if "weight" in child and name in styles:
            spec = _linear_spec(styles[name])
            out[name] = {k: spec.get(k, P()) for k in child}
        elif "weight" in child:  # norms and other unlisted leaves: replicate
            out[name] = {k: (P(None) if child[k] is not None else None) for k in child}
        else:
            out[name] = _match_linear_specs(child, styles)
    return out


def param_specs(arch: str, params: dict) -> dict:
    """PartitionSpec pytree matching `params` for a registered architecture."""
    try:
        styles = ARCH_LINEAR_STYLES[arch]
    except KeyError:
        raise ValueError(
            f"no TP styles for arch {arch!r} (have {sorted(ARCH_LINEAR_STYLES)})"
        ) from None
    specs = _match_linear_specs(params, styles)
    # vocab-shard the big embeddings (falcon/bloom call them word_embeddings)
    for emb in ("embed_tokens", "word_embeddings"):
        if emb in specs:
            specs[emb] = {"weight": P(TP_AXIS, None)}
    if "lm_head" in specs:
        specs["lm_head"] = {"weight": P(TP_AXIS, None), "bias": P(TP_AXIS)}
    return specs


def shard_params(params: dict, specs: dict, mesh) -> dict:
    """device_put the params pytree onto the mesh with the given specs."""
    def put(x, spec):
        if x is None:
            return None
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, params, specs,
                        is_leaf=lambda x: x is None)


def assert_group_shardable(in_features: int, tp: int, group_size: int) -> None:
    """Groups must not straddle TP shards for row-parallel layers."""
    shard = in_features // tp
    if in_features % tp or shard % group_size:
        raise ValueError(
            f"group_size={group_size} straddles TP shards "
            f"(in_features={in_features}, tp={tp}, shard={shard}); "
            f"pick group_size | shard"
        )
