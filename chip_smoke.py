"""Proof that the W4A4 serving path runs on the GPU, end to end.

    python chip_smoke.py          # one GPU: kernel parity, then the main path
    python chip_smoke.py --four   # four GPUs: Megatron TP v2 vs one card

One process drives the card(s).  It fails unless JAX's first device is a
GPU — there is no CPU fallback — and any failed phase exits non-zero.

Phases (one card):
  1. device and card: JAX's device kind and `nvidia-smi`'s name and power
     limit (read by a child process that stays off JAX);
  2. kernel parity: every kernel the package keeps, and every plain route
     that replaced a removed kernel, against a float32 plain reference under
     jax.default_matmul_precision("highest") at Llama-2-7B widths;
  3. main path: Llama-2-7B (32 layers, hidden 4096, MLP 11008, 32 heads,
     vocab 32000; random weights from a seed) → smooth_lm → pack_model
     (W4A4 g64, 5 % salient channels, bf16 group scales) → stack_layers →
     ContinuousBatcher (int8 KV cache, 4 slots of 512) answering 8 greedy
     requests of 32 new tokens, with a promoted-int8 prefill twin;
  4. oracle, on the same smoothed weights cut to their first 2 layers at
     full width, prefill and 4 decode steps: the packed W8A8 path against
     the simulated quantize_model path (f32), the flagship-layout tree's
     kernels against plain XLA, and the promoted-int8 prefill twin against
     the nibble tree (see phase_oracle).

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np

CHECKOUT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
MAX_BATCH, MAX_LEN = 4, 512
N_REQUESTS, NEW_TOKENS = 8, 32


def _check(name: str, got, ref, tol_rel: float = 0.0,
           tol_abs: float = 0.0) -> float:
    """Max |got - ref| against tol_rel · max |ref| + tol_abs; raises when
    over."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float(np.abs(got - ref).max())
    tol = tol_rel * float(np.abs(ref).max()) + tol_abs
    print(f"parity {name}: max|err| {err:.4g} <= tol {tol:.4g}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: max|err| {err} > tol {tol}")
    return err


# Tolerances, each relative to max |reference|:
# - integer-product routes (int4 kernel, int8 GEMMs): the int32 products
#   are exact and so are the bf16 salient products; only the f32 sums run in
#   another order (≤ ~2^-24 relative per term over ≤ 11008 terms)
TOL_INT = 1e-4
# - bf16 routes (bf16 weights or activations, bf16 output rounding): one
#   bf16 rounding is 2^-9 relative; the sum of K rounded products and the
#   rounded output stay within 1 % of the largest output
TOL_BF16 = 1e-2
# - decode attention: probabilities enter the P·V dot as bf16 (2^-9
#   relative each), against an all-f32 reference
TOL_ATTN = 2e-2


def phase_parity(*, interpret: bool = False, widths=None, rng=None):
    """Each kept kernel and each plain route that replaced a removed kernel
    against its float32 reference, at real widths."""
    import jax
    import jax.numpy as jnp

    from smoothquant_tpu.kernels import decode_attention as da
    from smoothquant_tpu.kernels.cache_write import write_quant_cache_stacked
    from smoothquant_tpu.kernels.fp_matmul import fp_matmul_stacked
    from smoothquant_tpu.kernels.int4_group_matmul import (
        int4_group_matmul_stacked,
    )
    from smoothquant_tpu.kernels.int8 import int8_linear
    from smoothquant_tpu.kernels.int8_prefill import int8_prefill_matmul
    from smoothquant_tpu.kernels.int_group_matmul import int_group_matmul
    from smoothquant_tpu.kernels.norm_quant import rms_norm_q
    from smoothquant_tpu.kernels.pack import unpack_nibbles_to_int8
    from smoothquant_tpu.kernels.quant_matmul import dual_path_matmul

    rng = rng or np.random.default_rng(SEED)
    w = widths or dict(h=4096, inter=11008, vocab=32000, heads=32, hd=128,
                       n=(4, 1024), caches=(512, 4096), gs=64)
    hi = jax.default_matmul_precision("highest")
    gs = w["gs"]

    def f32(a):
        return jnp.asarray(a, jnp.float32)

    # --- the W4A4 kernel (Triton): fused qkv, fused gate_up, down ---------
    for name, k_in, o in (("qkv", w["h"], 3 * w["h"]),
                          ("gate_up", w["h"], 2 * w["inter"]),
                          ("down", w["inter"], w["h"])):
        n_sal = int(0.05 * k_in)
        k_s = -(-n_sal // 128) * 128
        k_ns = -(-(k_in - n_sal) // (2 * gs)) * (2 * gs)
        g = k_ns // gs
        layers = 2   # read layer 1: the kernel offsets into the stack
        wp = jnp.asarray(rng.integers(-128, 128, (layers, k_ns // 2, o)),
                         jnp.int8)
        ws = jnp.asarray(rng.uniform(1e-3, 2e-2, (layers, g, o)),
                         jnp.bfloat16)
        wsal = jnp.asarray(rng.normal(size=(layers, k_s, o)) * 0.02,
                           jnp.bfloat16)
        for n in w["n"]:
            xq = jnp.asarray(rng.integers(-7, 8, (n, k_ns)), jnp.int8)
            xs = jnp.asarray(rng.uniform(0.01, 0.2, (n, g)), jnp.float32)
            xsal = jnp.asarray(rng.normal(size=(n, k_s)), jnp.bfloat16)
            got = int4_group_matmul_stacked(
                jnp.int32(1), xq, xs, wp, ws, xsal, wsal, group_size=gs,
                kernel=True, interpret=interpret)
            with hi:
                xd = (f32(xq).reshape(n, g, gs) * xs[..., None]
                      ).reshape(n, k_ns)
                wd = (f32(unpack_nibbles_to_int8(wp[1])).reshape(g, gs, o)
                      * f32(ws[1])[:, None, :]).reshape(k_ns, o)
                ref = xd @ wd + f32(xsal) @ f32(wsal[1])
            _check(f"w4a4 kernel {name} {k_in}->{o} N={n}", got, ref,
                   TOL_INT)
            del xq, xs, xsal, got, ref, xd
        del wp, ws, wsal

    # --- plain routes that replaced removed kernels ----------------------
    h, inter, vocab = w["h"], w["inter"], w["vocab"]
    # int8 lm_head / promoted-int8 prefill GEMM with its scale epilogue
    w8 = jnp.asarray(rng.integers(-127, 128, (h, vocab)), jnp.int8)
    sw = jnp.asarray(rng.uniform(1e-3, 2e-2, (1, vocab)), jnp.float32)
    for n in w["n"]:
        x8 = jnp.asarray(rng.integers(-127, 128, (n, h)), jnp.int8)
        sx = jnp.asarray(rng.uniform(1e-3, 2e-2, (n, 1)), jnp.float32)
        got = int8_prefill_matmul(x8, sx, w8, sw, jnp.zeros((n, 0)),
                                  jnp.zeros((0, vocab)), out_dtype=jnp.float32)
        with hi:
            ref = (f32(x8) @ f32(w8)) * sx * sw
        _check(f"int8 GEMM lm_head {h}->{vocab} N={n}", got, ref, TOL_INT)
    del w8, sw
    # bf16 baseline's stacked matmul
    x = jnp.asarray(rng.normal(size=(4, h)), jnp.bfloat16)
    wt = jnp.asarray(rng.normal(size=(2, h, 3 * h)) * 0.02, jnp.bfloat16)
    got = fp_matmul_stacked(jnp.int32(1), x, wt)
    with hi:
        ref = f32(x) @ f32(wt[1])
    _check(f"bf16 stacked matmul {h}->{3 * h} N=4", got, ref, TOL_BF16)
    del wt
    # int8-container group matmul (integer route) and its dequant route
    g = h // gs
    wq = jnp.asarray(rng.integers(-7, 8, (h, inter)), jnp.int8)
    wsc = jnp.asarray(rng.uniform(1e-3, 2e-2, (g, inter)), jnp.float32)
    xq = jnp.asarray(rng.integers(-7, 8, (4, h)), jnp.int8)
    xs = jnp.asarray(rng.uniform(0.01, 0.2, (4, g)), jnp.float32)
    with hi:
        xd = (f32(xq).reshape(4, g, gs) * xs[..., None]).reshape(4, h)
        wd = (f32(wq).reshape(g, gs, inter) * wsc[:, None, :]).reshape(
            h, inter)
        ref = xd @ wd
    got = int_group_matmul(xq, xs, wq, wsc, jnp.zeros((4, 0)),
                           jnp.zeros((0, inter)), group_size=gs)
    _check(f"int group matmul {h}->{inter} N=4", got, ref, TOL_INT)
    got = dual_path_matmul(xd.astype(jnp.bfloat16), jnp.zeros((4, 0),
                           jnp.bfloat16), wq, wsc,
                           jnp.zeros((0, inter), jnp.bfloat16),
                           group_size=gs)
    _check(f"dequant matmul {h}->{inter} N=4", got, ref, TOL_BF16)
    # OPT real-INT8 path: int8 linear and RMSNorm→int8
    wl = jnp.asarray(rng.integers(-127, 128, (h, h)), jnp.int8)
    xl = jnp.asarray(rng.integers(-127, 128, (4, h)), jnp.int8)
    got = int8_linear(xl, wl, jnp.float32(1e-4))
    with hi:
        ref = (f32(xl) @ f32(wl).T) * 1e-4
    _check(f"int8 linear {h}->{h} N=4", got, ref, TOL_INT)
    xn = jnp.asarray(rng.normal(size=(4, h)), jnp.float32)
    gam = jnp.asarray(rng.uniform(0.5, 1.5, (h,)), jnp.float32)
    got = rms_norm_q(xn, gam, jnp.float32(0.05))
    ref = np.clip(np.round(
        np.asarray(xn) / np.sqrt((np.asarray(xn) ** 2).mean(-1,
                                                           keepdims=True)
                                 + 1e-6) * np.asarray(gam) / 0.05),
        -127, 127)
    # one int8 step where f32 rsqrt rounding flips a .5 tie
    _check(f"rms norm -> int8 C={h}", got, ref, tol_abs=1.0)

    # --- decode attention kernel (Triton) + the stacked cache write -----
    b, nh, d = MAX_BATCH, w["heads"], w["hd"]
    for s in w["caches"]:
        for kind in ("int8", "bf16"):
            layers = 2
            if kind == "int8":
                k = jnp.asarray(rng.integers(-127, 128, (layers, b, nh, s, d)),
                                jnp.int8)
                v = jnp.asarray(rng.integers(-127, 128, (layers, b, nh, s, d)),
                                jnp.int8)
                ks = jnp.asarray(rng.uniform(1e-3, 2e-2, (layers, b, nh, s)),
                                 jnp.float32)
                vs = jnp.asarray(rng.uniform(1e-3, 2e-2, (layers, b, nh, s)),
                                 jnp.float32)
            else:
                k = jnp.asarray(rng.normal(size=(layers, b, nh, s, d)),
                                jnp.bfloat16)
                v = jnp.asarray(rng.normal(size=(layers, b, nh, s, d)),
                                jnp.bfloat16)
                ks = vs = None
            q = jnp.asarray(rng.normal(size=(b, nh, d)), jnp.bfloat16)
            valid = np.array([s, s // 2 + 3, 100, 1])[:b]
            ok = np.arange(s)[None] < valid[:, None]
            ok &= rng.random((b, s)) > 0.05     # continuous-batching holes
            ok[:, 0] = True
            bias = jnp.asarray(np.where(ok, 0.0, da.NEG_INF), jnp.float32)
            got = da.decode_attention_stacked(
                jnp.int32(1), q, k, v, bias, ks, vs, kernel=True,
                interpret=interpret)
            with hi:
                ref = da._plain(f32(q), f32(k[1]), f32(v[1]), bias,
                                None if ks is None else ks[1],
                                None if vs is None else vs[1], None,
                                1.0 / d ** 0.5)
            _check(f"decode attention {kind} B={b} H={nh} D={d} S={s}",
                   got, ref, TOL_ATTN)
            del k, v, ks, vs
    # stacked int8 cache write (rotary + quantize + in-place row update)
    s = w["caches"][0]
    kq = jnp.zeros((2, b, nh, s, d), jnp.int8)
    ksc = jnp.zeros((2, b, nh, s), jnp.float32)
    kn = jnp.asarray(rng.normal(size=(b, nh, d)), jnp.float32)
    pos = jnp.asarray([0, 5, s - 1, 17][:b], jnp.int32)
    ang = rng.uniform(0, 6.28, (b, 1, d // 2))
    cos = jnp.asarray(np.cos(np.concatenate([ang, ang], -1)), jnp.float32)
    sin = jnp.asarray(np.sin(np.concatenate([ang, ang], -1)), jnp.float32)
    kq2, _, ks2, _ = write_quant_cache_stacked(
        jnp.int32(1), pos, kn, kn, cos, sin, kq, kq, ksc, ksc)
    rot = np.concatenate([-np.asarray(kn)[..., d // 2:],
                          np.asarray(kn)[..., : d // 2]], -1)
    kr = np.asarray(kn) * np.asarray(cos) + rot * np.asarray(sin)
    bi = np.arange(b)
    scale = np.asarray(ks2)[1, bi, :, np.asarray(pos)][..., None]
    got = np.asarray(kq2)[1, bi, :, np.asarray(pos)].astype(np.float32)
    # int8 storage: each value within half a step of its row's scale
    # (absmax / 127), with room for f32 rounding of the rotary
    _check(f"int8 cache write B={b} H={nh} D={d} (in row-scale steps)",
           got, kr / scale, tol_abs=0.5 + 1e-3)


def phase_main(cfg, *, interpret: bool = False, chunk: int = 8,
               oracle_layers: int = 2):
    """The serving path at full width; returns a dict of what it measured."""
    import jax
    import jax.numpy as jnp

    from smoothquant_tpu.kernels.pack import promote_model_int8
    from smoothquant_tpu.models import llama
    from smoothquant_tpu.serve.batching import ContinuousBatcher, Request
    from smoothquant_tpu.utils.flagship import build_packed, recipes

    qcfg, head_qcfg = recipes()
    t0 = time.perf_counter()
    packed, stats, kept = build_packed(cfg, qcfg, head_qcfg, SEED,
                                       keep_layers=oracle_layers)
    promoted = llama.stack_layers(promote_model_int8(packed), cfg)
    stacked = llama.stack_layers(packed, cfg)
    del packed
    gc.collect()
    jax.block_until_ready((promoted, stacked))
    print(f"main: built and packed {cfg.num_hidden_layers} layers in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    batcher = ContinuousBatcher(llama, stacked, cfg, quant=qcfg,
                                max_batch=MAX_BATCH, max_len=MAX_LEN,
                                quant_kv=True, interpret=interpret,
                                prefill_params=promoted)
    if not batcher._stacked:
        raise AssertionError("the batcher must decode on the stacked scan")

    # the decode step as the batcher runs it: compile it ahead, read its
    # memory plan, and make sure the kept kernels are in it
    step = batcher._get_decode_chunk(chunk)
    b = MAX_BATCH
    args = (batcher.params, jnp.zeros((b,), jnp.int32), batcher.caches,
            jnp.zeros((b,), jnp.int32), jnp.zeros((b, MAX_LEN), bool))
    t0 = time.perf_counter()
    lowered = step.lower(*args)
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0
    print(f"main: decode step ({chunk} tokens/call) compiled in "
          f"{compile_s:.1f} s", flush=True)
    print(f"main: decode step memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)
    if not interpret:
        text = lowered.as_text()
        for kname in ("w4a4_group_matmul", "decode_attention"):
            if kname not in text:
                raise AssertionError(
                    f"decode step lost the {kname} kernel (plain fallback)")
        print(f"main: decode step holds {text.count('__gpu$xla.gpu.triton')}"
              " Triton kernel calls (w4a4_group_matmul, decode_attention)",
              flush=True)
    del lowered, compiled

    def wave(uid0):
        # the same prompt lengths every wave: the second wave runs only
        # graphs the first one compiled
        rng = np.random.default_rng(SEED + 1)
        reqs = [Request(uid=uid0 + i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            size=(int(rng.integers(100,
                                                                   241)),)),
                        max_new_tokens=NEW_TOKENS)
                for i in range(N_REQUESTS)]
        for r in reqs:
            batcher.submit(r)
        t = time.perf_counter()
        batcher.run_to_completion(chunk=chunk)
        return reqs, time.perf_counter() - t

    reqs, cold_s = wave(0)
    toks = [len(r.generated) for r in reqs]
    print(f"main: {len(reqs)} requests, prompts "
          f"{[len(r.prompt) for r in reqs]}, tokens per request {toks}; "
          f"first wave {cold_s:.2f} s (compiles prefill buckets)", flush=True)
    if toks != [NEW_TOKENS] * N_REQUESTS or not all(r.done for r in reqs):
        raise AssertionError(f"requests did not finish: {toks}")
    vocab_ok = all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
    if not vocab_ok:
        raise AssertionError("generated token outside the vocabulary")
    reqs2, warm_s = wave(100)
    n_tok = sum(len(r.generated) for r in reqs2)
    print(f"main: warm wave {n_tok} tokens in {warm_s:.3f} s "
          f"({n_tok / warm_s:.1f} tokens/s, prefill included)", flush=True)
    stats_mem = jax.devices()[0].memory_stats() or {}
    print(f"main: peak_bytes_in_use {stats_mem.get('peak_bytes_in_use')}",
          flush=True)
    del batcher, stacked, promoted
    gc.collect()

    phase_oracle(kept, stats, cfg, qcfg, head_qcfg, interpret=interpret)
    return {"compile_s": compile_s, "tokens_per_request": toks}


# Oracle bounds, each on rel = ‖got − ref‖ / ‖ref‖ over a row of logits.
# All-zero or constant logits read 1; a scrambled channel order, a wrong
# cache row or a wrong layer of the stack reads about 1 or more (PERF.md
# lists such runs).  Two paths that are both right still differ: a
# last-bit difference moves a few activations across a quantization step,
# and on a random-weight model each later quantization amplifies that —
# with 8-bit activations to a few per cent over 2 layers, with 4-bit
# activations to the quantization's own scale.  Each bound sits ~3× above
# what right paths read on the card (PERF.md):
# A. packed W8A8 per-channel/per-token against its simulation, f32: the
#    recipe is permutation-invariant, so both paths quantize the same
#    values and differ in f32 summation order only
ORACLE_SIM_W8 = 0.1
# B. one decode step of the flagship-layout stacked tree with its Triton
#    kernels against the same tree and cache on plain XLA: exact int
#    products, so the paths differ in f32 summation order and where the
#    attention rounds its probabilities to bf16 — with the flagship's 8-bit
#    activation twin, and with the flagship itself (4-bit activations)
ORACLE_KERNEL = 0.1
ORACLE_KERNEL_W4A4 = 0.6
# C. the promoted-int8 prefill twin against the nibble tree it came from
#    (8-bit activation twin): it re-rounds each weight to 8 bits per column
#    and scales activations per token instead of per group
ORACLE_PROMOTE = 0.2


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _report(check: str, got, ref, bound: float) -> float:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    if got.shape != ref.shape:
        raise AssertionError(f"oracle {check}: shape {got.shape} != "
                             f"{ref.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"oracle {check}: non-finite logits")
    err = _rel(got, ref)
    agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
    print(f"oracle {check}: rel {err:.4g} <= {bound:.4g}; top-1 agreement "
          f"{agree:.2f}", flush=True)
    if not err <= bound:
        raise AssertionError(f"oracle {check}: rel {err} > {bound}")
    return err


def phase_oracle(kept, stats, cfg_full, qcfg, head_qcfg, *,
                 interpret: bool = False, steps: int = 4):
    """Three checks at full width on the model's first layers, prefill of
    128 tokens and `steps` cached decode steps:

      A. the packed path (stacked tree, stacked f32 cache, the layer scan)
         against the simulated quantize_model path in f32, in the
         permutation-invariant W8A8 per-channel/per-token recipe;
      B. the flagship-layout stacked tree (g64, 5 % salient, int8 cache) with
         its Triton kernels against the same tree on plain XLA
         (ForwardContext(plain=True)), one decode step from the same cache,
         with 8-bit activations and with the flagship's 4-bit ones;
      C. the promoted-int8 prefill twin against the nibble tree (8-bit
         activations).
    """
    import jax
    import jax.numpy as jnp

    from smoothquant_tpu.kernels.pack import promote_model_int8
    from smoothquant_tpu.models import ForwardContext, llama
    from smoothquant_tpu.models.common import KVCache, QuantKVCache
    from smoothquant_tpu.models.registry import pack_model, quantize_model
    from smoothquant_tpu.quant.config import QuantConfig
    from smoothquant_tpu.utils.flagship import pack_flagship

    n_layers = len(kept["layers"])
    cfg = dataclasses.replace(cfg_full, num_hidden_layers=n_layers)
    print(f"oracle: model cut to its first {n_layers} of "
          f"{cfg_full.num_hidden_layers} layers (full width)", flush=True)
    rng = np.random.default_rng(SEED + 2)
    s0, max_len = 128, 256
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(1, s0 + steps)))
    toks = [ids[:, :s0]] + [ids[:, s0 + t: s0 + t + 1] for t in range(steps)]
    names = ["prefill"] + [f"decode step {t + 1}" for t in range(steps)]

    # A: W8A8 packed vs simulated, f32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    w8 = QuantConfig(weight_quant="per_channel", act_quant="per_token",
                     quant_bits=8)
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), kept)
    sim = quantize_model("llama", f32, cfg32, w8)
    stacked8 = llama.stack_layers(
        pack_model("llama", f32, cfg32, w8, compute_dtype=jnp.float32), cfg32)
    del f32
    sim_ctx = ForwardContext(quant=w8)
    pk_ctx = ForwardContext(quant=w8, interpret=interpret)
    sim_c = [KVCache.create(1, max_len, cfg.num_key_value_heads,
                            cfg.head_dim, jnp.float32)
             for _ in range(n_layers)]
    pk_c = llama.stacked_caches(cfg32, 1, max_len, jnp.float32)
    with jax.default_matmul_precision("highest"):
        for name, tok in zip(names, toks):
            s_l, sim_c = llama.forward(sim, tok, cfg32, ctx=sim_ctx,
                                       caches=sim_c)
            p_l, pk_c = llama.forward(stacked8, tok, cfg32, ctx=pk_ctx,
                                      caches=pk_c)
            _report(f"A W8A8 packed vs simulated, {name}", p_l[0], s_l[0],
                    ORACLE_SIM_W8)
    del sim, stacked8, sim_c, pk_c
    gc.collect()

    # B on the flagship layout at 8-bit and at 4-bit activations; C on the
    # 8-bit twin (at 4 bits it would measure the 4-bit activation noise)
    twin = dataclasses.replace(qcfg, act_bits=8)
    for label, rq, bound in (("W4A8 twin", twin, ORACLE_KERNEL),
                             ("W4A4", qcfg, ORACLE_KERNEL_W4A4)):
        packed = pack_flagship(kept, cfg, rq, head_qcfg, stats)
        ctx = ForwardContext(quant=rq, interpret=interpret)
        caches = [QuantKVCache.create(1, max_len, cfg.num_key_value_heads,
                                      cfg.head_dim, jnp.bfloat16)
                  for _ in range(n_layers)]
        pro_l, caches = llama.forward(promote_model_int8(packed), toks[0],
                                      cfg, ctx=ctx, caches=caches)
        if rq is twin:
            nib_l, _ = llama.forward(packed, toks[0], cfg, ctx=ctx)
            _report(f"C {label} promoted-int8 prefill vs nibble tree",
                    pro_l[0], nib_l[0], ORACLE_PROMOTE)
        stacked = llama.stack_layers(packed, cfg)
        del packed
        caches = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
        plain = dataclasses.replace(ctx, plain=True)
        for name, tok in zip(names[1:], toks[1:]):
            k_l, nxt = llama.forward(stacked, tok, cfg, ctx=ctx,
                                     caches=caches)
            p_l, _ = llama.forward(stacked, tok, cfg, ctx=plain,
                                   caches=caches)
            _report(f"B {label} kernels vs plain XLA, {name}", k_l[0],
                    p_l[0], bound)
            caches = nxt
        del stacked, caches
        gc.collect()


def _tp_against_one_card(cfg, qcfg, label: str, bound_frac: float, *,
                         interpret: bool, steps: int,
                         generator: bool = False) -> list:
    """TP v2 (pack_model_tp, tp=4) against the one-card pack_model path on
    the same smoothed random weights: prefill logits and `steps` decode
    steps fed the one-card path's greedy tokens.  Each row must sit within
    bound_frac × the distance quantization moved the one-card prefill
    logits from the float model.  With generator=True, also the greedy run
    through serve.Generator(forward_fn=...) and each device's memory.
    Returns the rows' distances."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from smoothquant_tpu.models import ForwardContext, llama
    from smoothquant_tpu.models.common import QuantKVCache
    from smoothquant_tpu.models.registry import pack_model, smooth_lm
    from smoothquant_tpu.parallel.mesh import make_mesh
    from smoothquant_tpu.parallel.tp_packed import (make_tp_decode_v2,
                                                    pack_model_tp,
                                                    packed_model_specs)
    from smoothquant_tpu.serve import GenerationConfig, Generator
    from smoothquant_tpu.utils.flagship import random_stats

    devs = jax.devices()
    rng = np.random.default_rng(SEED)
    stats = random_stats(cfg, rng)
    params = llama.init_params(jax.random.PRNGKey(SEED), cfg)
    params = smooth_lm("llama", params, cfg, stats, alpha=0.5)
    prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(1, 100)))
    max_len = 256

    def new_caches():
        return [QuantKVCache.create(1, max_len, cfg.num_key_value_heads,
                                    cfg.head_dim)
                for _ in range(cfg.num_hidden_layers)]

    fp_logits, _ = jax.jit(lambda p, t: llama.forward(p, t, cfg))(params,
                                                                   prompt)
    single = pack_model("llama", params, cfg, qcfg, input_feat=stats,
                        act_scales=stats, nibble=True)
    ctx = ForwardContext(quant=qcfg, interpret=interpret)
    fwd1 = jax.jit(lambda p, t, c: llama.forward(p, t, cfg, ctx=ctx,
                                                 caches=c))
    logits, c1 = fwd1(single, prompt, new_caches())
    dist = _rel(logits, fp_logits)
    tol = bound_frac * dist
    print(f"four [{label}]: quantization moved the one-card prefill logits "
          f"{dist:.4g} (relative) from the float model", flush=True)
    ref, toks = [logits[:, -1]], []
    for _ in range(steps):
        toks.append(jnp.argmax(ref[-1], axis=-1).astype(jnp.int32))
        logits, c1 = fwd1(single, toks[-1][:, None], c1)
        ref.append(logits[:, -1])
    gcfg = GenerationConfig(max_new_tokens=steps + 1)
    out1 = None
    if generator:
        out1 = Generator(llama, single, cfg, quant=qcfg, max_len=max_len,
                         quant_kv=True, interpret=interpret).generate(
                             np.asarray(prompt), gcfg)
    del single, c1

    mesh = make_mesh(tp=4)
    tp_params = pack_model_tp("llama", params, cfg, qcfg, tp=4,
                              input_feat=stats, act_scales=stats,
                              nibble=True)
    del params
    # place the shards before the first call, so each device holds its own
    # quarter of every sharded weight (what bytes_in_use then shows)
    tp_params = jax.device_put(tp_params, jax.tree.map(
        lambda sp: NamedSharding(mesh, sp), packed_model_specs(tp_params),
        is_leaf=lambda x: isinstance(x, PartitionSpec)))
    gc.collect()
    if generator:
        for i, d in enumerate(devs):
            st = d.memory_stats() or {}
            print(f"four: device {i} bytes_in_use after sharding "
                  f"{st.get('bytes_in_use')}", flush=True)
    step = make_tp_decode_v2(llama, cfg, mesh, interpret=interpret)(
        tp_params, new_caches())
    logits, c4 = step(tp_params, prompt, new_caches())
    got = [logits[:, -1]]
    for t in toks:
        logits, c4 = step(tp_params, t[:, None], c4)
        got.append(logits[:, -1])
    rels = []
    for t, (g, r) in enumerate(zip(got, ref)):
        rel = _rel(g, r)
        rels.append(rel)
        name = "prefill" if t == 0 else f"decode step {t}"
        print(f"four [{label}]: {name} logits rel(tp=4, one card) "
              f"{rel:.4g} <= {tol:.4g}", flush=True)
        if not rel <= tol:
            raise AssertionError(f"tp=4 [{label}] {name} logits off by "
                                 f"{rel} > {tol}")
    if generator:
        gen4 = Generator(llama, tp_params, cfg, max_len=max_len,
                         quant_kv=True,
                         forward_fn=lambda p, ids, c: step(p, ids, c))
        out4 = gen4.generate(np.asarray(prompt), gcfg)
        tail1, tail4 = out1[0, -(steps + 1):], out4[0, -(steps + 1):]
        print(f"four: Generator greedy tokens one card {tail1.tolist()} vs "
              f"tp=4 {tail4.tolist()} ({int((tail1 == tail4).sum())}/"
              f"{steps + 1} equal)", flush=True)
        for i, d in enumerate(devs):
            st = d.memory_stats() or {}
            print(f"four: device {i} peak_bytes_in_use "
                  f"{st.get('peak_bytes_in_use')}", flush=True)
    del tp_params, c4
    gc.collect()
    return rels


def phase_four(cfg, *, interpret: bool = False, steps: int = 4):
    """Megatron TP v2 over four devices against the one-card packed path,
    in two recipes at full width (see _tp_against_one_card):

      1. W4A8 per_group_unsorted g64, no salient channels, f32, 2 layers.
         A K-shard of every row-parallel layer holds whole groups, so the
         per-shard packs form the same groups as the one-card pack, and the
         paths differ only in summation order (the psum; split-K follows
         each device's width).  A last-bit difference can still flip an
         activation across a quantization step, and each random-weight
         layer amplifies such flips, so the bound scales with the
         quantization: a tenth of its distance from the float model (a
         wrong shard, reduce or cache is as far as that distance or
         farther).  Then the same prompt through serve.Generator on the
         TP step, and each device's memory.
      2. The flagship recipe (W4A4 g64, 5 % salient, bf16 scales) in bf16
         at 1 and at 2 layers.  pack_linear_row_sharded sorts, picks
         salient channels and scales activations per K-shard — a finer
         grouping than the one-card pack — so the two paths quantize the
         row-parallel layers differently by design; on a random-weight
         model chained 4-bit activations amplify that to the quantization's
         own scale.  Bound: TP sits no farther from the one-card path than
         quantization moved the one-card logits from the float model.
    """
    import jax

    from smoothquant_tpu.quant.config import QuantConfig
    from smoothquant_tpu.utils.flagship import recipes

    n = len(jax.devices())
    if n != 4:
        raise AssertionError(f"--four needs 4 devices, found {n}")
    w4a8 = QuantConfig(weight_quant="per_group_unsorted",
                       act_quant="per_group_unsorted", quant_bits=4,
                       act_bits=8, group_size=64)
    _tp_against_one_card(
        dataclasses.replace(cfg, dtype="float32", num_hidden_layers=2),
        w4a8, "W4A8 unsorted g64, f32, 2 layers", 0.1,
        interpret=interpret, steps=steps, generator=True)
    qcfg, _ = recipes()
    for d in (1, 2):
        _tp_against_one_card(
            dataclasses.replace(cfg, num_hidden_layers=d), qcfg,
            f"W4A4 g64 5% salient, bf16, {d} layer{'s' * (d > 1)}", 1.0,
            interpret=interpret, steps=steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only Megatron TP v2 on four GPUs against the "
                         "one-card packed path")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    from smoothquant_tpu.models import llama
    from smoothquant_tpu.utils.benchtools import (card_line,
                                                  enable_compile_cache)

    print(f"compile cache: {enable_compile_cache(CHECKOUT)}", flush=True)
    print(f"device: {dev.device_kind} x{len(jax.devices())}", flush=True)
    print(f"card: {card_line()}", flush=True)
    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    if args.four:
        # depth cut to 1-2 layers: the mesh, the shards and the collectives
        # are the same at any depth, and each layer amplifies the paths'
        # rounding differences (see phase_four)
        phase_four(cfg)
    else:
        phase_parity()
        phase_main(cfg)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
