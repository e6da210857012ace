"""Continuous batching engine — slot-based dynamic batching over a shared
static KV cache.

New capability vs the reference (which never serves; SURVEY.md §5): requests
with different prompt lengths and arrival times share one decode batch.
Design for XLA:

  * all shapes static: a fixed pool of `max_batch` slots over per-slot-pos
    KV caches (KVCache with pos (B,)); prompts are right-padded to a small
    set of bucket lengths so prefill compiles once per bucket;
  * padded cache positions are masked forever via a host-maintained
    key-validity mask (passed as attn_mask), and rotary/learned positions
    use true sequence lengths, so padding never changes numerics;
  * one jitted decode step advances every active slot; finished slots are
    refilled from the queue between steps (host-side control, device-side
    compute).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from smoothquant_tpu.models.common import ForwardContext, KVCache, QuantKVCache


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket")


class ContinuousBatcher:
    def __init__(self, model_mod, params, cfg, quant=None, *,
                 max_batch: int = 4, max_len: int = 512, kv_dtype=None,
                 quant_kv: bool = False, compute: str = "auto",
                 interpret: bool = False, prefill_params=None):
        self.mod, self.params, self.cfg = model_mod, params, cfg
        # optional prefill-optimized params twin (promote_model_int8)
        self.prefill_params = params if prefill_params is None else prefill_params
        self.ctx = ForwardContext(quant=quant, compute=compute,
                                  interpret=interpret)
        self.max_batch, self.max_len = max_batch, max_len
        self.kv_dtype = kv_dtype or jnp.dtype(cfg.dtype)
        n_kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
        self._n_kv = n_kv
        cache_cls = QuantKVCache if quant_kv else KVCache
        # STACKED decode params (stack_layers trees) serve on the per-slot
        # scan decode: ONE pooled cache with a leading layers axis and
        # (L, B) per-slot positions, decoded by the same no-copy scan the
        # aligned decode uses.
        self._stacked = "stacked" in params.get("layers", {})
        self._prefill_stacked = "stacked" in self.prefill_params.get(
            "layers", {})
        n_layers = cfg.num_hidden_layers
        if self._stacked:
            pos0 = jnp.zeros((n_layers, max_batch), jnp.int32)
            if quant_kv:
                shape = (n_layers, max_batch, n_kv, max_len, cfg.head_dim)
                self.caches = QuantKVCache(
                    k_q=jnp.zeros(shape, jnp.int8),
                    v_q=jnp.zeros(shape, jnp.int8),
                    k_scale=jnp.zeros(shape[:4], jnp.float32),
                    v_scale=jnp.zeros(shape[:4], jnp.float32), pos=pos0)
            else:
                shape = (n_layers, max_batch, n_kv, max_len, cfg.head_dim)
                self.caches = KVCache(k=jnp.zeros(shape, self.kv_dtype),
                                      v=jnp.zeros(shape, self.kv_dtype),
                                      pos=pos0)
        else:
            self.caches = [
                cache_cls.create(max_batch, max_len, n_kv, cfg.head_dim,
                                 self.kv_dtype, per_slot=True)
                for _ in range(cfg.num_hidden_layers)
            ]
        self.key_valid = np.zeros((max_batch, max_len), bool)
        self.seq_pos = np.zeros(max_batch, np.int32)   # true sequence lengths
        # host-side mirror of the per-slot device cache positions: every
        # decode step advances EVERY slot's position by one (dead slots
        # included), and admission resets a slot to its prompt length — so
        # the host needs no device fetch to know them, and each chunk costs
        # one host round trip (its tokens) instead of three.
        self.pool_pos = np.zeros(max_batch, np.int64)
        self.slot_req: list[Optional[Request]] = [None] * max_batch
        self.queue: list[Request] = []
        self._steps = 0

        @jax.jit
        def _prefill(params, ids, lens):
            # fresh caches for a BATCH of same-bucket prompts (one row per
            # admitted request — same-bucket admissions share one prefill
            # launch; _admit pads rows to a power of two, so this compiles
            # at most (buckets x log2(max_batch)+1) times).  The FIRST
            # generated token is argmax'd ON DEVICE at each row's true last
            # prompt position: only (rows,) ints cross to the host, not the
            # (rows, S, V) logits (131 MB at bucket 256).
            caches = [
                cache_cls.create(ids.shape[0], ids.shape[1], n_kv,
                                 cfg.head_dim, self.kv_dtype)
                for _ in range(cfg.num_hidden_layers)
            ]
            if self._prefill_stacked:  # stacked tree expects a stacked cache
                caches = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
            logits, caches = self.mod.forward(params, ids, cfg, ctx=self.ctx,
                                              caches=caches)
            idx = jnp.clip(lens - 1, 0, ids.shape[1] - 1)
            last = jnp.take_along_axis(
                logits, idx[:, None, None], axis=1)[:, 0]
            first_tok = jnp.argmax(last, axis=-1).astype(jnp.int32)
            if self._stacked and not self._prefill_stacked:
                # per-layer prefill feeding the stacked pool: stack once
                # here (on device, inside the jit)
                caches = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
            elif not self._stacked and self._prefill_stacked:
                caches = [jax.tree.map(lambda a: a[i], caches)
                          for i in range(cfg.num_hidden_layers)]
            return first_tok, caches

        @jax.jit
        def _scatter(caches, batch_caches, row, slot, new_pos):
            """Copy row `row` of a batched prefill cache into pool slot
            `slot` (row/slot/new_pos are traced scalars — one compile)."""
            if self._stacked:
                # stacked pool: fields (L, B, ...), prefill fields
                # (L, rows, ...) — one dynamic_update_slice per field
                new_fields = {}
                for field in caches._fields:
                    if field == "pos":
                        new_fields["pos"] = caches.pos.at[:, slot].set(new_pos)
                        continue
                    buf = getattr(caches, field)
                    full = getattr(batch_caches, field)
                    r = jax.lax.dynamic_slice_in_dim(full, row, 1, axis=1)
                    # crop prefill-bucket positions past max_len (bucket
                    # padding, never attended to)
                    for ax in range(2, r.ndim):
                        if r.shape[ax] > buf.shape[ax]:
                            r = jax.lax.slice_in_dim(
                                r, 0, buf.shape[ax], axis=ax)
                    start = (0, slot) + (0,) * (buf.ndim - 2)
                    new_fields[field] = jax.lax.dynamic_update_slice(
                        buf, r.astype(buf.dtype), start)
                return type(caches)(**new_fields)
            out = []
            for c, rc in zip(caches, batch_caches):
                new_fields = {}
                for field in c._fields:
                    if field == "pos":
                        new_fields["pos"] = getattr(c, "pos").at[slot].set(new_pos)
                        continue
                    buf = getattr(c, field)
                    full = getattr(rc, field)
                    r = jax.lax.dynamic_index_in_dim(full, row, axis=0,
                                                     keepdims=False)
                    # a prefill bucket may exceed max_len; cache positions
                    # past max_len are bucket padding (never attended to) —
                    # drop them on whichever axis outgrew the pool buffer
                    # (S sits at a different axis per field in the
                    # head-major layout)
                    for ax in range(r.ndim):
                        if r.shape[ax] > buf.shape[1 + ax]:
                            r = jax.lax.slice_in_dim(
                                r, 0, buf.shape[1 + ax], axis=ax)
                    start = (slot,) + (0,) * (buf.ndim - 1)
                    new_fields[field] = jax.lax.dynamic_update_slice(
                        buf, r[None].astype(buf.dtype), start)
                out.append(type(c)(**new_fields))
            return out

        @jax.jit
        def _decode(params, tok, caches, positions, key_valid):
            logits, caches = self.mod.forward(
                params, tok[:, None], cfg, ctx=self.ctx, caches=caches,
                positions=positions[:, None], attn_mask=key_valid,
            )
            # greedy pick on device: only (B,) ints cross the host boundary
            return jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32), caches

        self._prefill, self._scatter, self._decode = _prefill, _scatter, _decode
        self._decode_chunks: dict[int, object] = {}

    def _get_decode_chunk(self, k: int):
        """Jitted K-step on-device greedy decode (lax.scan over _decode's
        body).  One host round trip per K tokens instead of per token —
        serving loops only need host control at EOS/admit granularity.  Tokens generated after a request's EOS inside a chunk
        are discarded host-side (attention is per-slot, so they cannot
        perturb other requests)."""
        if k in self._decode_chunks:
            return self._decode_chunks[k]
        cfg, b = self.cfg, self.max_batch
        rows = jnp.arange(b)

        @jax.jit
        def _decode_k(params, tok, caches, positions, key_valid):
            def body(carry, _):
                tok, caches, positions, key_valid = carry
                cache_pos = jnp.asarray(
                    caches.pos[0] if self._stacked else caches[0].pos,
                    jnp.int32)
                key_valid = key_valid.at[rows, cache_pos].set(True)
                logits, caches = self.mod.forward(
                    params, tok[:, None], cfg, ctx=self.ctx, caches=caches,
                    positions=positions[:, None], attn_mask=key_valid,
                )
                nxt = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
                return (nxt, caches, positions + 1, key_valid), nxt

            (_, caches, positions, key_valid), toks = jax.lax.scan(
                body, (tok, caches, positions, key_valid), None, length=k)
            # key_valid is NOT returned: the host mirrors it from pool_pos
            return toks, caches

        self._decode_chunks[k] = _decode_k
        return _decode_k

    # ------------------------------------------------------------------ API

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError("request exceeds max_len")
        self.queue.append(req)

    def _admit(self) -> None:
        free = [s for s in range((self.max_batch))
                if self.slot_req[s] is None]
        if not free or not self.queue:
            return
        # group waiting requests by prefill bucket: same-bucket admissions
        # share ONE batched prefill launch (weak #8: prefill used to run
        # one request at a time).  Scheduling POLICY (intended): within one
        # admission pass, later requests that share the head-of-queue's
        # bucket are admitted ahead of earlier different-bucket requests —
        # batching same-shape prefills beats strict FIFO on throughput, and
        # the pass always starts from the current queue head, so no bucket
        # can be starved.
        while free and self.queue:
            head_bucket = _bucket(len(self.queue[0].prompt))
            batch: list[Request] = []
            rest: list[Request] = []
            for req in self.queue:
                if (len(batch) < len(free)
                        and _bucket(len(req.prompt)) == head_bucket):
                    batch.append(req)
                else:
                    rest.append(req)
            self.queue = rest
            # pad the admission batch to a power-of-two row count: _prefill
            # then compiles per (bucket, pow2-rows) instead of per
            # (bucket, exact-rows) — at most log2(max_batch)+1 variants per
            # bucket.  Padding rows are dummy prompts, never scattered.
            n_rows = 1
            while n_rows < len(batch):
                n_rows *= 2
            ids = np.zeros((n_rows, head_bucket), np.int32)
            lens = np.ones((n_rows,), np.int32)
            for i, req in enumerate(batch):
                ids[i, : len(req.prompt)] = req.prompt
                lens[i] = len(req.prompt)
            first_toks, kv_batch = self._prefill(self.prefill_params,
                                                 jnp.asarray(ids),
                                                 jnp.asarray(lens))
            first_toks = np.asarray(first_toks)
            for i, req in enumerate(batch):
                slot = free.pop(0)
                s_true = len(req.prompt)
                # cache pos resumes at the TRUE length: bucket-pad rows are
                # never attended to (key_valid masks them) and decode
                # overwrites them one token at a time, so padding consumes
                # no cache capacity
                self.caches = self._scatter(self.caches, kv_batch,
                                            jnp.int32(i), jnp.int32(slot),
                                            jnp.int32(s_true))
                self.key_valid[slot, :] = False
                self.key_valid[slot, :s_true] = True
                self.seq_pos[slot] = s_true
                self.pool_pos[slot] = s_true
                self.slot_req[slot] = req
                # first generated token: the last TRUE prompt position
                self._emit(slot, int(first_toks[i]))

    def _emit(self, slot: int, token: int) -> None:
        req = self.slot_req[slot]
        req.generated.append(token)
        if (token == req.eos_token_id
                or len(req.generated) >= req.max_new_tokens):
            req.done = True
            self.slot_req[slot] = None
            self.key_valid[slot, :] = False
            self.seq_pos[slot] = 0

    def step(self) -> list[Request]:
        """Admit queued requests, run one decode step, return finished."""
        self._admit()
        active = [s for s in range(self.max_batch) if self.slot_req[s] is not None]
        if not active:
            return []

        tok = np.zeros(self.max_batch, np.int32)
        for s in active:
            tok[s] = self.slot_req[s].generated[-1]
        # mark the incoming token's cache position valid for every active
        # slot (pool_pos mirrors the device positions — no fetch)
        for s in active:
            self.key_valid[s, self.pool_pos[s]] = True

        next_tok, self.caches = self._decode(
            self.params, jnp.asarray(tok), self.caches,
            jnp.asarray(self.seq_pos), jnp.asarray(self.key_valid),
        )
        self._steps += 1
        next_np = np.asarray(next_tok)
        # every slot's device cache position advanced by one (dead slots
        # included — the batch decodes uniformly)
        self.pool_pos += 1

        finished = []
        for s in active:
            self.seq_pos[s] += 1
            req = self.slot_req[s]
            self._emit(s, int(next_np[s]))
            if req.done:
                finished.append(req)
        return finished

    def step_chunk(self, k: int) -> list[Request]:
        """Admit, then decode K tokens in ONE device dispatch (see
        _get_decode_chunk).  Admission happens only at chunk boundaries;
        emitted tokens match k calls of step() exactly under greedy
        decoding."""
        if k == 1:
            return self.step()
        self._admit()
        active = [s for s in range(self.max_batch)
                  if self.slot_req[s] is not None]
        if not active:
            return []
        tok = np.zeros(self.max_batch, np.int32)
        for s in active:
            tok[s] = self.slot_req[s].generated[-1]
        toks, self.caches = self._get_decode_chunk(k)(
            self.params, jnp.asarray(tok), self.caches,
            jnp.asarray(self.seq_pos), jnp.asarray(self.key_valid),
        )
        self._steps += k
        toks = np.asarray(toks)                       # (k, B)
        # mirror the device's in-chunk key_valid updates from pool_pos:
        # rows pos .. pos+k-1 became valid for every slot (no fetch)
        for s in range(self.max_batch):
            lo = min(int(self.pool_pos[s]), self.max_len)
            hi = min(lo + k, self.max_len)
            self.key_valid[s, lo:hi] = True
        self.pool_pos += k
        finished = []
        for s in active:
            self.seq_pos[s] += k
        for s in active:
            req = self.slot_req[s]
            for t in range(k):
                self._emit(s, int(toks[t, s]))
                if req.done:
                    finished.append(req)
                    break
        return finished

    def run_to_completion(self, max_steps: int = 10_000,
                          chunk: int = 1) -> list[Request]:
        done = []
        for _ in range(max_steps):
            done.extend(self.step_chunk(chunk) if chunk > 1 else self.step())
            if not self.queue and all(r is None for r in self.slot_req):
                break
        return done
