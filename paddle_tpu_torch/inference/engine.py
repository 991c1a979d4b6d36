"""Paged continuous-batching engine of the port (counterpart of the paged
greedy core of `paddle_tpu/inference/engine.py`).

A persistent pool of `slots` decodes together: every scheduler step admits
queued requests into free slots through a bucketed fresh prefill, then runs
ONE decode step over all slots.  Per-slot positions, page tables and the
active mask are data, so requests joining and finishing never change a
shape.  K/V live in a block-paged arena per layer (`[num_pages, page_size,
kv_heads, head_dim]`), addressed through per-slot page tables; a request
holds only the pages that cover `prompt + max_new_tokens`.

Why padding and inactive writes are safe: a prefill's bucket-padding rows
and every inactive slot's decode write land on scratch page 0, which no
live sequence maps; decode attends only rows j <= pos of a slot's own
pages, and every row it attends was written by that slot first.

Not ported yet (ROADMAP, Queue 1): the prefix cache with chunk prefill and
copy-on-write pages, speculative decoding, LoRA, int8 KV, tensor and
context parallelism, the serving fault domain (deadlines, cancel, warm
restart), sessions, disaggregation, the deferred token fetch and CUDA
graphs.  A knob that asks for one of them raises NotImplementedError; this
engine fetches each step's tokens to the host at once.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time

import numpy as np
import torch

from .. import profiler as _prof
from ..framework import core as _fcore
from ..models.llama import (
    PagedDecodeView,
    PagedKVCache,
    PagedPrefillView,
    to_index_tensor,
)
from ..ops.flash_attention import MAX_HEAD_DIM, MAX_PAGED_ROWS
from .paging import PagePool, check_table_bounds

logger = logging.getLogger("paddle_tpu_torch")


class QueueFull(RuntimeError):
    """Admission queue at capacity, or a request whose page need exceeds
    the whole pool; serve() answers 503 with a Retry-After header."""

    def __init__(self, msg, retry_after_s=0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ContextOverflow(ValueError):
    """The prompt does not fit the engine's context (max_len)."""


def _not_ported(knob, item):
    return NotImplementedError(
        f"{knob} is not ported to paddle_tpu_torch yet (ROADMAP Queue 1: "
        f"{item})"
    )


class EngineRequest:
    """Handle for one submitted generation.  Lifecycle: queued ->
    prefilling -> decoding -> one of {eos, length, error}, exactly once.
    With `keep_logits`, the float32 logits row behind every emitted token
    is kept in `logits` (a list of device tensors)."""

    def __init__(self, rid, prompt, max_new_tokens, temperature, eos_token_id,
                 keep_logits=False):
        self.id = int(rid)
        self.prompt = prompt  # np.int32 [L]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        self.keep_logits = bool(keep_logits)
        self.logits = []
        self.tokens = []  # generated ids (eos included when hit)
        self.finished = threading.Event()
        self.finish_reason = None
        self.state = "queued"
        self.error = None
        self.ttft_s = None
        self._submit_t = None

    def wait(self, timeout=None):
        """Block until the request finishes; returns prompt + generated ids
        (np.int32), or raises the request's error."""
        if not self.finished.wait(timeout):
            raise TimeoutError(
                f"request {self.id} not finished after {timeout}s "
                f"(state={self.state}, {len(self.tokens)}/"
                f"{self.max_new_tokens} tokens)"
            )
        if self.error is not None:
            raise self.error
        return np.concatenate([self.prompt, np.asarray(self.tokens, np.int32)])


class ContinuousBatchingEngine:
    """Paged continuous-batching engine over a port `LlamaForCausalLM`.

    submit() enqueues (bounded queue -> QueueFull); the scheduler -- the
    thread started by start()/serve(), or synchronous step() /
    run_until_idle() calls -- admits queued requests into free slots and
    advances every active slot one token per decode step.  `device=None`
    means the CUDA card; the model must live on the engine's device.
    """

    _req_ids = itertools.count(1)  # request ids unique across engines

    def __init__(self, model, slots=None, max_len=None, prefill_buckets=None,
                 queue_depth=None, seed=0, paged=None, page_size=None,
                 pool_pages=None, prefix_cache=None, spec_k=None, lora=None,
                 decode_kernel=None, tp=None, kv_quant=None, role=None, cp=None,
                 device=None):
        self.device = _fcore.resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine on {self.device}"
            )
        self._check_not_ported(paged, prefix_cache, spec_k, lora, tp, kv_quant,
                               role, cp)
        cfg = model.config
        self.model = model
        self.slots = int(slots if slots is not None else _fcore.flag("FLAGS_serve_slots"))
        max_len = max_len if max_len is not None else cfg.max_position_embeddings
        # rope tables (so positions) top out at max_position_embeddings
        self.max_len = int(min(max_len, cfg.max_position_embeddings))
        if prefill_buckets is None:
            raw = str(_fcore.flag("FLAGS_serve_prefill_buckets"))
            prefill_buckets = [int(x) for x in raw.split(",") if x.strip()]
        self.prefill_buckets = sorted(
            {int(b) for b in prefill_buckets if 0 < int(b) < self.max_len}
        )
        if not self.prefill_buckets:
            raise ValueError("prefill_buckets must contain a value < max_len")
        self.queue_depth = int(
            queue_depth if queue_depth is not None
            else _fcore.flag("FLAGS_serve_queue_depth")
        )

        head_dim = cfg.head_dim
        rep = cfg.num_attention_heads // cfg.num_key_value_heads
        ps = int(page_size if page_size is not None
                 else _fcore.flag("FLAGS_serve_kv_page_size"))
        # a page never needs to exceed a sequence
        self.page_size = max(1, min(ps, self.max_len))
        self.pages_per_seq = -(-self.max_len // self.page_size)
        dk = str(_fcore.flag("FLAGS_serve_decode_kernel")
                 if decode_kernel is None else decode_kernel)
        if dk not in ("auto", "fused", "gather"):
            raise ValueError(f"decode_kernel must be auto|fused|gather, got {dk!r}")
        # "auto" is the reference flag's default; with no silent fallback in
        # the port it is an alias of "fused"
        dk = "fused" if dk == "auto" else dk
        if dk == "fused" and (head_dim > MAX_HEAD_DIM or rep > MAX_PAGED_ROWS):
            raise ValueError(
                f"decode_kernel={dk!r} runs the fused kernel, which needs "
                f"head_dim <= {MAX_HEAD_DIM} and a GQA group <= "
                f"{MAX_PAGED_ROWS}; got head_dim={head_dim}, group={rep}"
            )
        self.decode_kernel = dk
        pp = int(pool_pages if pool_pages is not None
                 else _fcore.flag("FLAGS_serve_kv_pool_pages"))
        if pp <= 0:  # auto: every slot can hold a max_len sequence
            pp = self.slots * self.pages_per_seq + 1
        self.pool_pages = pp
        # the cache dtype follows the lm_head weight (bf16 serving stays bf16)
        cache_dtype = model.lm_head.weight.dtype
        with torch.no_grad():
            self._arenas = [
                PagedKVCache(pp, self.page_size, cfg.num_key_value_heads,
                             head_dim, cache_dtype, self.device)
                for _ in range(cfg.num_hidden_layers)
            ]
        self._pool = PagePool(pp)
        self._page_table = np.zeros((self.slots, self.pages_per_seq), np.int32)
        self._slot_pages = [[] for _ in range(self.slots)]
        self._tables_t = None  # device mirror, rebuilt with _dev
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))

        # host-side slot table, mutated under _mu by the scheduler
        self._slot_req = [None] * self.slots
        self._pos = np.zeros(self.slots, np.int32)
        self._last_tok = np.zeros(self.slots, np.int32)
        self._temps = np.zeros(self.slots, np.float32)
        # device decode state (toks, pos, active), rebuilt from the host
        # mirrors when slot membership changes
        self._dev = None

        self._queue = queue.Queue(maxsize=self.queue_depth)
        self._requeue = []  # page-deferred requests, ahead of the queue
        self._admitting = None  # request between queue pop and slot landing
        self._cv = threading.Condition()
        self._mu = threading.RLock()
        self._thread = None
        self._stop = False

    @staticmethod
    def _check_not_ported(paged, prefix_cache, spec_k, lora, tp, kv_quant,
                          role, cp):
        flag = _fcore.flag
        if not (flag("FLAGS_serve_paged_kv") if paged is None else paged):
            raise _not_ported("paged=False", "the dense slot-pool engine")
        if flag("FLAGS_serve_prefix_cache") if prefix_cache is None else prefix_cache:
            raise _not_ported("prefix_cache=True",
                              "prefix cache, chunk prefill and COW page copy")
        if int(flag("FLAGS_serve_spec_k") if spec_k is None else spec_k) > 0:
            raise _not_ported("spec_k > 0", "speculative decoding")
        if str(flag("FLAGS_serve_kv_quant") if kv_quant is None else kv_quant) != "none":
            raise _not_ported("kv_quant='int8'", "int8 KV pages (kernel K4)")
        if lora is not None:
            raise _not_ported("lora", "multi-tenant LoRA serving")
        if int(flag("FLAGS_serve_tp") if tp is None else tp) > 1:
            raise _not_ported("tp > 1", "tensor-parallel serving")
        if int(flag("FLAGS_serve_cp") if cp is None else cp) > 1:
            raise _not_ported("cp > 1", "context-parallel decode (kernel K5)")
        if role is not None and role != "colocated":
            raise _not_ported(f"role={role!r}", "disaggregated prefill/decode")

    # -- model steps -----------------------------------------------------------

    def _sample(self, logits, temps):
        """Greedy argmax, or a draw from softmax(logits / temp) with the
        engine's generator for rows with temp > 0.  logits: [N, V] float32;
        temps: host float32 [N]."""
        greedy = logits.argmax(dim=-1).to(torch.int32)
        if not (temps > 0).any():
            return greedy
        t = torch.from_numpy(np.maximum(temps, 1e-6)).to(logits.device)
        probs = torch.softmax(logits / t[:, None], dim=-1)
        samp = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        hot = torch.from_numpy(temps > 0).to(logits.device)
        return torch.where(hot, samp.to(torch.int32), greedy)

    @torch.no_grad()
    def _prefill(self, toks, row_table, true_len, temp):
        """Fresh paged prefill of one bucket-padded prompt: writes its K/V
        into the pages of `row_table` and returns (first token [1], logits
        [1, V] float32) read at row true_len - 1, not at the bucket end."""
        views = [PagedPrefillView(a, row_table, true_len) for a in self._arenas]
        hidden = self.model.llama(toks, caches=views)
        logits = self.model.lm_head(hidden[:, true_len - 1]).float()
        return self._sample(logits, np.full(1, temp, np.float32)), logits

    @torch.no_grad()
    def _decode_step(self, toks, pos, active, tables, temps):
        """One token for every slot: toks [S, 1], pos [S], active [S] bool,
        tables [S, P].  Inactive slots run at pos 0 over an all-zero table
        row (scratch).  Returns (next tokens [S], logits [S, V] float32)."""
        pos_eff = torch.where(active, pos, torch.zeros_like(pos))
        views = [
            PagedDecodeView(a, tables, self.max_len, kernel=self.decode_kernel)
            for a in self._arenas
        ]
        hidden = self.model.llama(toks, caches=views, pos=pos_eff)
        logits = self.model.lm_head(hidden[:, -1]).float()
        return self._sample(logits, temps), logits

    # -- public API ------------------------------------------------------------

    def submit(self, input_ids, max_new_tokens=32, temperature=0.0,
               eos_token_id=None, keep_logits=False):
        """Enqueue one request (1-D token ids); returns an EngineRequest at
        once.  Raises ContextOverflow when the prompt does not fit max_len
        and QueueFull when the queue is at capacity or the request's page
        need exceeds the whole pool.  Ids outside [0, vocab_size) raise
        ValueError: on the card an out-of-range embedding row is a
        device-side assert that poisons the CUDA context for every later
        step, where the reference's JAX gather clamps."""
        raw = np.asarray(input_ids).reshape(-1)
        if raw.size == 0:
            raise ValueError("empty prompt")
        if raw.dtype.kind not in "iu":  # floats, bools, ints past int64
            raise ValueError(f"input_ids must be integers, got {raw.dtype}")
        vocab = self.model.config.vocab_size
        bad = (raw < 0) | (raw >= vocab)
        if bad.any():
            raise ValueError(
                f"token id {raw[bad][0]} outside the vocabulary [0, {vocab})"
            )
        ids = raw.astype(np.int32)
        if ids.size >= self.max_len:
            raise ContextOverflow(
                f"prompt length {ids.size} exceeds engine capacity: "
                f"max_len={self.max_len}"
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        need = self._pages_for(ids.size, max_new_tokens)
        if need > self._pool.usable_pages:
            raise QueueFull(
                f"request needs {need} KV pages (prompt {ids.size} + max_new "
                f"{max_new_tokens} at page size {self.page_size}) but the "
                f"pool holds {self._pool.usable_pages}"
            )
        req = EngineRequest(next(self._req_ids), ids, max_new_tokens,
                            temperature, eos_token_id, keep_logits)
        req._submit_t = time.perf_counter()
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise QueueFull(
                f"admission queue full ({self.queue_depth} pending)"
            ) from None
        with self._cv:
            self._cv.notify()
        return req

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 eos_token_id=None, timeout=None):
        """Submit and wait; drives the scheduler inline when no thread runs.
        Returns prompt + generated ids (np.int32)."""
        req = self.submit(input_ids, max_new_tokens=max_new_tokens,
                          temperature=temperature, eos_token_id=eos_token_id)
        if self._thread is None:
            self.run_until_idle()
        return req.wait(timeout)

    def warmup(self):
        """Run every prefill bucket and the decode step once on dummy data
        before traffic (on the card this builds the kernels and warms the
        matmul library).  All-zero tables aim every write at scratch page
        0."""
        zero_row = to_index_tensor(np.zeros(self.pages_per_seq), self.device)
        for b in self.prefill_buckets:
            self._prefill(to_index_tensor(np.zeros((1, b)), self.device),
                          zero_row, b, 0.0)
        S = self.slots
        self._decode_step(
            to_index_tensor(np.zeros((S, 1)), self.device),
            to_index_tensor(np.zeros(S), self.device),
            torch.zeros(S, dtype=torch.bool, device=self.device),
            to_index_tensor(np.zeros((S, self.pages_per_seq)), self.device),
            np.zeros(S, np.float32),
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    @property
    def active_slots(self):
        return sum(1 for r in self._slot_req if r is not None)

    @property
    def pending(self):
        return self._queue.qsize() + len(self._requeue)

    def has_work(self):
        """True when anything is queued, being admitted, or decoding."""
        return bool(self._queue.qsize() or self._requeue
                    or self._admitting is not None or self.active_slots)

    def healthz(self):
        """Snapshot for serve()'s /healthz."""
        t = self._thread
        return {
            "status": "ready" if t is not None and t.is_alive() else "live",
            "slots": self.slots,
            "active_slots": self.active_slots,
            "occupancy": self.active_slots / self.slots,
            "queue_depth": self.pending,
            "page_free_frac": round(
                self._pool.free_count() / max(1, self._pool.usable_pages), 4
            ),
            "device": str(self.device),
        }

    def step(self):
        """One scheduling tick: admit queued requests into free slots
        (bucketed prefill), then advance every active slot one token.
        Returns the tokens emitted.  Do not mix with start()."""
        emitted = self._admit()
        return emitted + self._decode_once()

    def run_until_idle(self):
        """Drive step() until queue and slots are empty."""
        total = 0
        while self.has_work():
            total += self.step()
        return total

    def start(self):
        """Run the scheduler on a daemon thread (serve() calls this)."""
        if self._thread is not None:
            return self
        self._stop = False
        self._thread = threading.Thread(target=self._loop, name="cb-engine",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=30.0):
        """Stop the scheduler thread (bounded join)."""
        t = self._thread
        if t is None:
            return
        self._stop = True
        with self._cv:
            self._cv.notify_all()
        t.join(timeout)
        if t.is_alive():
            raise RuntimeError(f"engine scheduler did not stop within {timeout}s")
        self._thread = None

    # -- scheduler ---------------------------------------------------------------

    def _loop(self):
        while not self._stop:
            if not self.has_work():
                with self._cv:
                    if not (self._stop or self._queue.qsize() or self._requeue):
                        self._cv.wait(timeout=0.05)
                continue
            try:
                self.step()
            except Exception as e:  # fail the in-flight requests, keep serving
                logger.exception("engine step failed")
                with self._mu:
                    for s, req in enumerate(self._slot_req):
                        if req is not None:
                            req.error = e
                            self._finish(s, req, "error")

    def _bucket_for(self, n):
        for b in self.prefill_buckets:
            if n <= b:
                return b
        # over-bucket prompt: grow a next-power-of-two bucket
        b = min(1 << (n - 1).bit_length(), self.max_len - 1)
        with self._mu:
            self.prefill_buckets.append(b)
            self.prefill_buckets.sort()
        return b

    def _pages_for(self, prompt_len, max_new):
        """Pages a request occupies over its lifetime: positions
        [0, L + max_new'), with max_new clamped to the context."""
        span = int(prompt_len) + min(int(max_new), self.max_len - int(prompt_len))
        return -(-span // self.page_size)

    def _release_slot_pages_locked(self, s):
        for p in self._slot_pages[s]:
            self._pool.decref(p)
        self._slot_pages[s] = []
        self._page_table[s, :] = 0

    def _pop_request(self):
        """Next request, page-deferred ones first.  Caller holds _mu."""
        if self._requeue:
            return self._requeue.pop(0)
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def _admit(self):
        emitted = 0
        for s in range(self.slots):
            with self._mu:
                if self._slot_req[s] is not None:
                    continue
                req = self._pop_request()
                if req is None:
                    break
                need = self._pages_for(req.prompt.size, req.max_new_tokens)
                if need > self._pool.free_count():
                    # page pressure: park at the head of the line (FIFO kept)
                    # until finishing slots release pages
                    self._requeue.insert(0, req)
                    break
                self._admitting = req
                req.state = "prefilling"
            try:
                self._prefill_into_paged(s, req)
                emitted += 1
            except Exception as e:  # fail THIS request, keep the engine alive
                logger.exception("prefill of request %d failed", req.id)
                req.error = e
                with self._mu:
                    if self._slot_req[s] is req:
                        self._finish(s, req, "error")
                    else:
                        self._release_slot_pages_locked(s)
                        self._resolve(req, "error")
            finally:
                with self._mu:
                    if self._admitting is req:
                        self._admitting = None
        return emitted

    def _prefill_into_paged(self, s, req):
        L = int(req.prompt.size)
        with self._mu:
            req.max_new_tokens = min(req.max_new_tokens, self.max_len - L)
            # the admission check covered these pages
            pages = [self._pool.alloc()
                     for _ in range(self._pages_for(L, req.max_new_tokens))]
            self._page_table[s, :] = 0
            self._page_table[s, :len(pages)] = pages
            self._slot_pages[s] = pages
            row_table = self._page_table[s].copy()
        bucket = self._bucket_for(L)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :L] = req.prompt
        check_table_bounds(row_table, self.pool_pages)
        nxt, logits = self._prefill(
            to_index_tensor(toks, self.device),
            to_index_tensor(row_table, self.device), L, req.temperature,
        )
        tok = int(nxt.item())
        with self._mu:
            req.ttft_s = time.perf_counter() - req._submit_t
            self._slot_req[s] = req
            self._pos[s] = L
            self._last_tok[s] = tok
            self._temps[s] = req.temperature
            req.state = "decoding"
            self._dev = None  # membership changed: rebuild device state
            if req.keep_logits:
                req.logits.append(logits[0])
            self._emit(s, req, tok)

    def _decode_once(self):
        with self._mu:
            active_idx = [s for s in range(self.slots)
                          if self._slot_req[s] is not None]
            if not active_idx:
                return 0
            if self._dev is None:
                active = np.zeros(self.slots, bool)
                active[active_idx] = True
                # tables change exactly when membership does; bound-check
                # the host mirror before every upload
                check_table_bounds(self._page_table, self.pool_pages)
                self._tables_t = to_index_tensor(self._page_table, self.device)
                self._dev = (
                    to_index_tensor(self._last_tok.reshape(self.slots, 1),
                                    self.device),
                    to_index_tensor(self._pos, self.device),
                    torch.from_numpy(active).to(self.device),
                )
            toks_t, pos_t, active_t = self._dev
            temps = self._temps.copy()
        t0 = time.perf_counter()
        nxt, logits = self._decode_step(toks_t, pos_t, active_t,
                                        self._tables_t, temps)
        nxt_np = nxt.cpu().numpy()  # fetched every step in this slice
        busy = time.perf_counter() - t0
        with self._mu:
            self._dev = (nxt[:, None], torch.where(active_t, pos_t + 1, pos_t),
                         active_t)
            for s in active_idx:
                self._pos[s] += 1
            _prof.record_serving_tick(len(active_idx) / self.slots,
                                      self._queue.qsize(), busy)
            for s in active_idx:
                req = self._slot_req[s]
                tok = int(nxt_np[s])
                self._last_tok[s] = tok
                if req.keep_logits:
                    req.logits.append(logits[s])
                self._emit(s, req, tok)
        return len(active_idx)

    def _emit(self, s, req, tok):
        req.tokens.append(tok)
        if req.eos_token_id is not None and tok == req.eos_token_id:
            self._finish(s, req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(s, req, "length")

    def _finish(self, s, req, reason):
        """Recycle slot s at once (no scrub: its next prefill rewrites what
        it attends) and resolve the request.  Caller holds _mu."""
        self._slot_req[s] = None
        self._pos[s] = 0
        self._last_tok[s] = 0
        self._temps[s] = 0.0
        self._release_slot_pages_locked(s)
        self._dev = None
        self._resolve(req, reason)

    def _resolve(self, req, reason):
        """Terminal transition, exactly once."""
        if req.finished.is_set():
            return
        req.finish_reason = reason
        req.state = reason
        if reason in ("eos", "length"):
            _prof.record_serving_request(req.ttft_s or 0.0, len(req.tokens))
        req.finished.set()
