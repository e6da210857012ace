"""Checkpoint save/load for quantized models.

The reference's persistence is torch.save of act scales and HF
save_pretrained of the int8 model (SURVEY.md §5 "checkpoint/resume").  Here
checkpoints are flat .npz archives keyed by pytree paths — portable,
torch-free, and covering the full quantized state: int weights, group
scales, channel permutations, salient indices, fp embeddings.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), f"{prefix}{f.name}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_pytree(tree, path: str) -> None:
    np.savez(path, **_flatten(tree))


def load_flat(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def unflatten(flat: dict) -> dict:
    """Rebuild a nested dict (lists come back as dicts keyed by index str)."""
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def save_params(params: dict, path: str) -> None:
    """Save a model params pytree (fp or simulated-quantized)."""
    save_pytree(params, path)


def load_params(path: str, dtype=None) -> dict:
    import jax.numpy as jnp

    flat = load_flat(path)
    nested = unflatten(flat)

    def to_jnp(x):
        if isinstance(x, dict):
            return {k: to_jnp(v) for k, v in x.items()}
        arr = jnp.asarray(x)
        if dtype is not None and arr.dtype in (jnp.float32, jnp.float16, jnp.bfloat16):
            arr = arr.astype(dtype)
        return arr

    return to_jnp(nested)


# ---------------------------------------------------------------------------
# Packed-model checkpoints: int weights + group scales + permutation +
# salient metadata (the quantized checkpoint format of SURVEY.md §5).
# ---------------------------------------------------------------------------


def save_packed_model(params: dict, path: str) -> None:
    """Save a pack_model() pytree: PackedLinear leaves keep their static
    meta as a JSON sidecar entry so load reconstructs them exactly."""
    from smoothquant_tpu.kernels.pack import PackedLinear

    metas: dict = {}

    def walk(node, prefix=""):
        if isinstance(node, PackedLinear):
            metas[prefix[:-1]] = dataclasses.asdict(node.meta)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")

    walk(params)
    flat = _flatten(params)
    flat["__packed_metas__"] = np.frombuffer(
        json.dumps(metas).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_packed_model(path: str) -> dict:
    """Load a save_packed_model() checkpoint back into a packed pytree."""
    import jax.numpy as jnp

    from smoothquant_tpu.kernels.pack import PackedLinear, PackedMeta

    flat = load_flat(path)
    metas = json.loads(bytes(flat.pop("__packed_metas__")).decode())
    nested = unflatten(flat)

    def rebuild(node, prefix=""):
        key = prefix[:-1]
        if key in metas:
            return PackedLinear(
                w_qt=jnp.asarray(node["w_qt"]),
                w_scales_t=jnp.asarray(node["w_scales_t"]),
                w_sal_t=jnp.asarray(node["w_sal_t"]),
                bias=jnp.asarray(node["bias"]) if "bias" in node else None,
                perm=jnp.asarray(node["perm"]),
                ns_mask=(jnp.asarray(node["ns_mask"])
                         if "ns_mask" in node else None),
                meta=PackedMeta(**metas[key]),
            )
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        return jnp.asarray(node)

    return rebuild(nested)


# ---------------------------------------------------------------------------
# Per-host sharded packed checkpoints (SURVEY.md §5 checkpoint row: "sharded
# per host").  Each PackedLinear leaf is split along its tensor-parallel axis
# — the same partitioning parallel.tp_packed.packed_model_specs assigns at
# runtime (O axis for column-parallel, the K-concatenated leading axis for
# row-parallel) — into shard-<i>-of-<n>.npz files plus a manifest.json.  A
# host loads ONLY its shard file (shard=i) to get exactly the local params a
# shard_map forward consumes, or shard=None reassembles the global pytree.
# ---------------------------------------------------------------------------


def _tp_axis_of(spec) -> int | None:
    """Index of the TP-sharded axis in a PartitionSpec, else None."""
    from smoothquant_tpu.parallel.mesh import TP_AXIS

    if spec is None:
        return None
    for i, s in enumerate(spec):
        if s == TP_AXIS:
            return i
    return None


def save_packed_model_sharded(params: dict, dir_path: str, n_shards: int) -> None:
    """Split a pack_model()/pack_model_tp() pytree into per-host shard files.

    For row-parallel ("psum") leaves the leading axis is a concatenation of
    exactly the shards pack_linear_row_sharded built, so n_shards must match
    that tp degree; column-parallel leaves only need O % n_shards == 0.
    Replicated leaves (norms, embeddings, biases of psum layers, perms of
    column layers) are stored once, in every-host-reads manifest shard 0.
    """
    import os

    from smoothquant_tpu.kernels.pack import PackedLinear
    from smoothquant_tpu.parallel.tp_packed import packed_model_specs

    os.makedirs(dir_path, exist_ok=True)
    specs = packed_model_specs(params)
    flat_p = _flatten(params)
    flat_s = {}

    def walk_spec(node, prefix=""):
        if isinstance(node, PackedLinear):
            for f in dataclasses.fields(node):
                if f.name == "meta":
                    continue
                flat_s[f"{prefix}{f.name}"] = getattr(node, f.name)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk_spec(v, f"{prefix}{k}/")
        elif node is not None:
            flat_s[prefix[:-1]] = node

    walk_spec(specs)

    metas: dict = {}

    def walk_meta(node, prefix=""):
        if isinstance(node, PackedLinear):
            metas[prefix[:-1]] = dataclasses.asdict(node.meta)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk_meta(v, f"{prefix}{k}/")

    walk_meta(params)

    shards: list[dict] = [{} for _ in range(n_shards)]
    axes: dict = {}
    for key, arr in flat_p.items():
        ax = _tp_axis_of(flat_s.get(key))
        if ax is None:
            shards[0][key] = arr
            continue
        if arr.shape[ax] % n_shards:
            raise ValueError(
                f"{key}: axis {ax} size {arr.shape[ax]} not divisible by "
                f"n_shards={n_shards}")
        axes[key] = ax
        step = arr.shape[ax] // n_shards
        for i in range(n_shards):
            shards[i][key] = np.take(
                arr, np.arange(i * step, (i + 1) * step), axis=ax)

    manifest = {"n_shards": n_shards, "metas": metas, "axes": axes}
    with open(f"{dir_path}/manifest.json", "w") as f:
        json.dump(manifest, f)
    for i, flat in enumerate(shards):
        np.savez(f"{dir_path}/shard-{i:05d}-of-{n_shards:05d}.npz", **flat)


def load_packed_model_sharded(dir_path: str, shard: int | None = None) -> dict:
    """Load a sharded packed checkpoint.

    shard=i → this host's LOCAL params (sharded leaves hold only shard i;
    meta still records global dims, as under shard_map).  shard=None →
    reassemble the global pytree by concatenating every shard.
    """
    import jax.numpy as jnp

    from smoothquant_tpu.kernels.pack import PackedLinear, PackedMeta

    with open(f"{dir_path}/manifest.json") as f:
        manifest = json.load(f)
    n = manifest["n_shards"]
    axes = manifest["axes"]

    def shard_file(i):
        return load_flat(f"{dir_path}/shard-{i:05d}-of-{n:05d}.npz")

    if shard is not None:
        flat = shard_file(0) if shard == 0 else {}
        if shard != 0:
            flat = {k: v for k, v in shard_file(0).items() if k not in axes}
            flat.update(shard_file(shard))
    else:
        parts = [shard_file(i) for i in range(n)]
        flat = dict(parts[0])
        for key, ax in axes.items():
            flat[key] = np.concatenate([p[key] for p in parts], axis=ax)

    nested = unflatten(flat)
    metas = manifest["metas"]

    def rebuild(node, prefix=""):
        key = prefix[:-1]
        if key in metas:
            return PackedLinear(
                w_qt=jnp.asarray(node["w_qt"]),
                w_scales_t=jnp.asarray(node["w_scales_t"]),
                w_sal_t=jnp.asarray(node["w_sal_t"]),
                bias=jnp.asarray(node["bias"]) if "bias" in node else None,
                perm=jnp.asarray(node["perm"]),
                ns_mask=(jnp.asarray(node["ns_mask"])
                         if "ns_mask" in node else None),
                meta=PackedMeta(**metas[key]),
            )
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        return jnp.asarray(node)

    return rebuild(nested)


# ---------------------------------------------------------------------------
# INT8 OPT artifact (export_int8_model CLI)
# ---------------------------------------------------------------------------


def save_int8_opt(int8_params: dict, cfg, path: str) -> None:
    flat = _flatten(int8_params)
    flat["__config__"] = np.frombuffer(
        json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8
    )
    np.savez(path, **flat)


def load_int8_opt(path: str):
    """Returns (cfg, int8_params) ready for models.opt_int8.forward."""
    import jax.numpy as jnp

    from smoothquant_tpu.models.opt import OPTConfig
    from smoothquant_tpu.models.opt_int8 import Int8Linear, Int8OPTLayerParams

    flat = load_flat(path)
    cfg = OPTConfig(**json.loads(bytes(flat.pop("__config__")).decode()))
    nested = unflatten(flat)

    def lin(d):
        return Int8Linear(w_q=jnp.asarray(d["w_q"]), bias=jnp.asarray(d["bias"]),
                          alpha=jnp.asarray(d["alpha"]))

    layers = []
    raw_layers = nested["int8_layers"]
    for i in range(len(raw_layers)):
        d = raw_layers[str(i)]
        layers.append(Int8OPTLayerParams(
            ln_attn_gamma=jnp.asarray(d["ln_attn_gamma"]),
            ln_attn_beta=jnp.asarray(d["ln_attn_beta"]),
            ln_fc_gamma=jnp.asarray(d["ln_fc_gamma"]),
            ln_fc_beta=jnp.asarray(d["ln_fc_beta"]),
            q_proj=lin(d["q_proj"]), k_proj=lin(d["k_proj"]),
            v_proj=lin(d["v_proj"]), out_proj=lin(d["out_proj"]),
            fc1=lin(d["fc1"]), fc2=lin(d["fc2"]),
            scales={k: float(v) for k, v in d["scales"].items()},
        ))
    out = {"int8_layers": layers}
    for k in ("embed_tokens", "embed_positions", "final_layer_norm",
              "project_in", "project_out"):
        if k in nested:
            out[k] = {kk: jnp.asarray(vv) for kk, vv in nested[k].items()}
    return cfg, out
