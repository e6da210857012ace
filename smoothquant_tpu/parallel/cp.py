"""Context (sequence) parallelism: ring-attention prefill over a device ring.

The reference has no sequence parallelism of any kind (SURVEY.md §2.9 —
fixed 2048-token eval windows on one device).  Here long-context prefill
shards the SEQUENCE axis across a `cp` mesh axis: every device holds an
S/cp slice of the tokens, runs the full (replicated-weight) layer stack on
its slice, and attention streams the K/V chunks around the ring with
`jax.lax.ppermute` — Ring Attention (blockwise streaming softmax; each
hop is one collective permute, which XLA hands to NCCL on the GPU, and
XLA's latency-hiding scheduler overlaps the next hop's permute with the
current chunk's attention math).

Composes with the quantized execution path unchanged: weights (packed or
fp) are replicated over `cp`, so the per-device compute is the ordinary
single-chip forward on an S/cp-token slice — only `attention` becomes
collective (models/common.py:attention dispatches here when
ForwardContext.cp_axis is set).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

CP_AXIS = "cp"

NEG_INF = -1e30


def make_cp_mesh(cp: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """1-D (cp,) mesh in jax.devices() order: the GPUs of a host are joined
    all to all by NVLink, so every ring order is as good as another."""
    import numpy as np

    devices = list(devices if devices is not None else jax.devices())
    cp = cp or len(devices)
    return Mesh(np.array(devices[:cp]), (CP_AXIS,))


def ring_attention(
    q: jax.Array,   # (B, Sl, H, D) — this device's query slice
    k: jax.Array,   # (B, Hkv, Sl, D) — this device's key slice (head-major)
    v: jax.Array,   # (B, Hkv, Sl, D)
    axis_name: str,
    *,
    scale: Optional[float] = None,
    attn_mask: Optional[jax.Array] = None,  # (B, Sl) — LOCAL key validity
) -> jax.Array:
    """Causal ring attention inside shard_map.  Returns (B, Sl, H, D).

    Device r owns global rows [r*Sl, (r+1)*Sl).  Iteration t computes the
    local queries against the chunk that ORIGINATED at device (r - t) mod n
    (chunks rotate +1 every step), maintaining a streaming softmax
    (m, l, acc) exactly like the flash decode kernel
    (kernels/decode_attention.py:_flash_head) — so the result matches
    single-device `attention` to f32 rounding.  Chunks wholly in the
    causal future of this device's rows skip their FLOPs via lax.cond
    (the ppermute still runs — every device must participate).
    """
    n = jax.lax.axis_size(axis_name)
    r = jax.lax.axis_index(axis_name)
    b, sl, nh, d = q.shape
    n_kv = k.shape[1]
    rep = nh // n_kv
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    qh = q.transpose(0, 2, 1, 3).astype(jnp.float32)  # (B, H, Sl, D)
    q_off = r * sl

    qi = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sl, sl), 2)
    kj = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sl, sl), 3)

    perm = [(i, (i + 1) % n) for i in range(n)]

    def chunk_scores(k_c, k_off, mask_c):
        # GQA heads repeat here, per chunk — the ring only ever moves the
        # n_kv-head chunk, so ring traffic is H_kv/H of the naive scheme
        if rep != 1:
            k_c = jnp.repeat(k_c, rep, axis=1)
        s = jnp.einsum("bhqd,bhkd->bhqk", qh, k_c.astype(jnp.float32),
                       preferred_element_type=jnp.float32) * scale
        causal = (k_off + kj) <= (q_off + qi)
        s = jnp.where(causal, s, NEG_INF)
        if mask_c is not None:
            s = jnp.where(mask_c[:, None, None, :].astype(bool), s, NEG_INF)
        return s

    def body(t, carry):
        k_c, v_c, mask_c, m, l, acc = carry
        src = jnp.remainder(r - t, n)
        k_off = src * sl
        # issue next hop BEFORE the compute: independent of this chunk's
        # math, so the scheduler overlaps the transfer with it
        k_nx = jax.lax.ppermute(k_c, axis_name, perm)
        v_nx = jax.lax.ppermute(v_c, axis_name, perm)
        mask_nx = (None if mask_c is None
                   else jax.lax.ppermute(mask_c, axis_name, perm))

        def compute(args):
            m, l, acc = args
            s = chunk_scores(k_c, k_off, mask_c)
            m_new = jnp.maximum(m, jnp.max(s, axis=-1, keepdims=True))
            alpha = jnp.exp(m - m_new)
            # explicit zero where masked: a fully-masked chunk would
            # otherwise yield exp(NEG_INF - NEG_INF) = 1 for every position
            p = jnp.where(s <= NEG_INF * 0.5, 0.0, jnp.exp(s - m_new))
            l_new = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
            v_r = v_c if rep == 1 else jnp.repeat(v_c, rep, axis=1)
            acc_new = acc * alpha + jnp.einsum(
                "bhqk,bhkd->bhqd", p, v_r.astype(jnp.float32),
                preferred_element_type=jnp.float32)
            return m_new, l_new, acc_new

        # chunk entirely in the causal future of my rows → skip its FLOPs
        m, l, acc = jax.lax.cond(
            k_off <= q_off + sl - 1, compute, lambda a: a, (m, l, acc))
        return k_nx, v_nx, mask_nx, m, l, acc

    m0 = jnp.full((b, nh, sl, 1), NEG_INF, jnp.float32)
    l0 = jnp.zeros((b, nh, sl, 1), jnp.float32)
    acc0 = jnp.zeros((b, nh, sl, d), jnp.float32)
    *_, m, l, acc = jax.lax.fori_loop(
        0, n, body, (k, v, attn_mask, m0, l0, acc0))
    out = acc / jnp.maximum(l, 1e-30)          # every row sees itself: l > 0
    return out.transpose(0, 2, 1, 3).astype(q.dtype)


def make_cp_prefill(mod, cfg, mesh: Mesh, *, compute: str = "auto",
                    interpret: bool = False, quant=None):
    """Sequence-sharded prefill forward.

    Returns build(params) -> fwd(params, ids) -> logits (B, S, V).  ids are
    split S/cp per device (S % cp == 0 required); weights replicate; rotary
    positions are offset per shard; attention runs as ring_attention via
    ForwardContext.cp_axis.  Logits come back sequence-sharded and
    reassemble at the shard_map boundary.
    """
    from smoothquant_tpu.models.common import ForwardContext

    cp = mesh.shape[CP_AXIS]

    def build(params):
        spec_p = jax.tree.map(lambda _: P(), params)
        ctx = ForwardContext(quant=quant, compute=compute,
                             interpret=interpret, cp_axis=CP_AXIS)

        @jax.jit
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(spec_p, P(None, CP_AXIS)),
            out_specs=P(None, CP_AXIS, None),
            check_vma=False,
        )
        def fwd(local_params, ids):
            b, sl = ids.shape
            r = jax.lax.axis_index(CP_AXIS)
            positions = (r * sl
                         + jax.lax.broadcasted_iota(jnp.int32, (b, sl), 1))
            logits, _ = mod.forward(local_params, ids, cfg, ctx=ctx,
                                    positions=positions)
            return logits

        return fwd

    return build
