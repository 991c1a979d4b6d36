"""Host-side bookkeeping for the block-paged KV cache (counterpart of
`paddle_tpu/inference/paging.py`).

The device side is one `[num_pages, page_size, kv_heads, head_dim]` K/V
arena per layer plus per-slot page tables.  Which page holds which tokens
is decided here, on the host:

- `PagePool`: refcounted allocator over page ids with FIFO free lists.
  Page 0 is a permanent scratch page: inactive slots' table rows are
  all-zero and every masked write is redirected to it, so garbage never
  lands in a page a sequence attends.  Under context parallelism the ids
  split into `shards` equal ranges, each with its own scratch page first
  and its own free list; sequence page k comes from shard k % cp.
- `PrefixCache`: a token-chain index over committed prompt pages.  Full
  pages chain by `(parent_key, page_tokens)`; a partly filled last page is
  a tail under its parent.  A request maps every matched full page
  read-only (incref) and copy-on-writes the matched tail, the only shared
  page it would append into.  Entries are evicted LRU, leaves first, only
  when the allocator runs dry.  Chains hang from one root per LoRA adapter
  (the request's stable registry id, 0 the base model): K/V prefilled
  under an adapter embed its deltas, so equal prompts share pages within
  an adapter and never across adapters.
- `SessionStore`: named multi-turn sessions, each a pin on the cache chain
  of its committed conversation, so page pressure cannot evict it until
  the whole session goes (LRU).
- `spec_write_pages`: which page-table entries a speculative verify
  window writes through, split at the slot's mapped pages.
- `check_table_bounds`: every table entry must name a real page before a
  table is uploaded.  The fused decode kernels index the arena by the raw
  entry, and on CUDA an out-of-range id is an illegal address, not a
  clamped read.

Sharing contract: readers of a cached page trust only rows below the
entry's committed row count (later rows are masked by position), so the
owner may keep appending into its committed tail; a reader never writes a
shared page (full-page matches lie before its own rows, and the tail is
copied into a fresh page before any token lands).

Speculative verify widens the decode write from one row to a window
[pos, pos + k] per slot.  Every window row whose table entry is unmapped
(0) or past the table lands on scratch page 0, so rejected drafts need no
rollback: their rows sit on scratch or past the slot's advanced pos, where
the next window rewrites them before any query attends them.

int8 KV: values are stored as int8 with one float32 scale per (token row,
kv head) in a parallel `[num_pages, page_size, kv_heads, 1]` arena per K
and V, written by the same scatters and addressed by the same tables, so
holding a page holds its scale rows and no bookkeeping here changes.

Disaggregated prefill/decode handoff (`serialize_kv_handoff`,
`deserialize_kv_handoff`; reference: paging.py:210-340): a prefill worker
ships the committed prompt rows of every layer as `[L, kv_heads, head_dim]`
row payloads, raw little-endian bytes in base64 for the JSON hop, page-size
agnostic so the two sides may page differently.  int8 rows ship as stored,
with their float32 `[L, kv_heads, 1]` scale rows.  The JSON is the
reference's, byte for byte: a 16-bit row's bytes are its raw bit patterns,
so bfloat16 needs no numpy extension type here (rows come back as torch
tensors).
"""

from __future__ import annotations

import base64
import copy

import numpy as np
import torch

KV_QUANT_MODES = ("none", "int8")


def spec_write_pages(pos, width, page_size, mapped_entries):
    """Page-table entries a verify window [pos, pos + width) writes through,
    as (in_table, overrun): sorted entry indices inside the slot's mapped
    prefix (entry < mapped_entries) and those beyond it.  Overrun entries
    must scatter to scratch page 0: the engine's draft budget (at most
    remaining - 1 drafts) keeps every committed row in the mapped prefix,
    so only rejected drafts can overrun (reference: paging.py:48)."""
    pos, width, ps = int(pos), int(width), int(page_size)
    if width <= 0:
        return [], []
    entries = sorted({(pos + i) // ps for i in range(width)})
    in_table = [e for e in entries if e < mapped_entries]
    overrun = [e for e in entries if e >= mapped_entries]
    return in_table, overrun


class QuantConfigError(ValueError):
    """An invalid KV-quantization configuration (unknown mode, or a
    quantized arena without paging), raised at engine construction."""


def validate_kv_quant(mode, paged=True):
    """The normalised kv_quant mode, or QuantConfigError.  Quantization
    needs the paged engine: the dense slot pool stays full precision."""
    mode = "none" if mode is None else str(mode).strip().lower()
    if mode not in KV_QUANT_MODES:
        raise QuantConfigError(
            f"kv_quant must be one of {'|'.join(KV_QUANT_MODES)}, got {mode!r}"
        )
    if mode != "none" and not paged:
        raise QuantConfigError(
            f"kv_quant={mode!r} requires the paged engine (paged=True): the "
            "dense slot pool stays full-precision as the bit-identity oracle"
        )
    return mode


def kv_page_bytes(page_size, kv_heads, head_dim, dtype_bytes, quant="none"):
    """Device bytes ONE layer's K+V storage spends per page.  Under 'int8'
    an element costs 1 byte plus a 4-byte float32 scale per (token row, kv
    head); the int8 pool gets `head_dim * dtype_bytes / (head_dim + 4)`
    times the pages of the same budget (~1.94x at bf16, head_dim 128)."""
    if validate_kv_quant(quant) == "int8":
        return 2 * int(page_size) * int(kv_heads) * (int(head_dim) + 4)
    return 2 * int(page_size) * int(kv_heads) * int(head_dim) * int(dtype_bytes)


def check_scale_arenas(arenas, num_pages, page_size):
    """Every int8 arena carries float32 k_scale/v_scale shaped
    [num_pages, page_size, kv_heads, 1] (the tables index both, so page p's
    scale rows live and die with page p); a full-precision arena carries
    none.  Raises AssertionError otherwise."""
    for i, a in enumerate(arenas):
        ks, vs = getattr(a, "k_scale", None), getattr(a, "v_scale", None)
        if getattr(a, "quant", "none") != "int8":
            if ks is not None or vs is not None:
                raise AssertionError(
                    f"scale invariant: layer {i} arena is full precision "
                    "but carries scale buffers"
                )
            continue
        want = (int(num_pages), int(page_size), int(a.k.shape[2]), 1)
        for name, t in (("k_scale", ks), ("v_scale", vs)):
            if t is None:
                raise AssertionError(
                    f"scale invariant: layer {i} int8 arena missing {name}"
                )
            if tuple(int(d) for d in t.shape) != want:
                raise AssertionError(
                    f"scale invariant: layer {i} {name} shape "
                    f"{tuple(t.shape)} != {want}"
                )
            if "float32" not in str(t.dtype):
                raise AssertionError(
                    f"scale invariant: layer {i} {name} dtype {t.dtype} "
                    "is not float32"
                )


# The tensor-parallel layout of every KV buffer (reference: paging.py:
# 155-192): paged arenas [num_pages, page_size, kv_heads, head_dim], their
# int8 scale arenas [num_pages, page_size, kv_heads, 1] and dense caches
# [slots, max_len, kv_heads, head_dim] all split the kv heads axis over the
# 'mp' ranks.  Page ids, tables and all the host bookkeeping of this module
# stay rank-agnostic: a page is the same page id on every rank, narrower.
KV_TP_AXIS = 2


def shard_kv_for_tp(cache, mesh):
    """The ranks' shards of one layer's KV cache (a `PagedKVCache` or a
    `StaticKVCache`): rank r's cache holds kv heads [r*hk/N, (r+1)*hk/N) of
    every buffer as tensors of its own on its device (not views of one
    arena), and shares everything else (page size, quant mode, a dense
    cache's page table).  Returns the list of the N ranks' caches; the
    given cache itself, in a list, without an 'mp' axis above 1."""
    if mesh is None or mesh.mp <= 1:
        return [cache]
    hk = cache.k.shape[KV_TP_AXIS]
    if hk % mesh.mp:
        raise ValueError(
            f"{hk} kv heads do not split over {mesh.mp} 'mp' ranks")
    n = hk // mesh.mp
    out = []
    for r, dev in enumerate(mesh.devices):
        shard = copy.copy(cache)
        for name in ("k", "v", "k_scale", "v_scale"):
            t = getattr(cache, name, None)
            if t is not None:
                setattr(shard, name, t.narrow(KV_TP_AXIS, r * n, n).to(
                    dev, copy=True, memory_format=torch.contiguous_format))
        out.append(shard)
    return out


def join_kv_heads(parts):
    """The ranks' rows of one KV buffer joined into whole kv heads, in rank
    order: `parts[r]` is rank r's [..., rows, kv_heads/N, d] block (K or V,
    or under int8 a float32 scale block [..., rows, kv_heads/N, 1]), the
    kv heads on `KV_TP_AXIS`.  Inverse of `split_kv_heads`; one rank's
    block comes back as it is."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=KV_TP_AXIS)


def split_kv_heads(tiles, ranks):
    """Whole-head tiles ([..., rows, kv_heads, d], K or V or an int8 scale
    tile [..., rows, kv_heads, 1]) as `ranks` views, rank r's the kv heads
    [r*hk/N, (r+1)*hk/N) that `shard_kv_for_tp` gives rank r's arena."""
    hk = tiles.shape[KV_TP_AXIS]
    if hk % ranks:
        raise ValueError(f"{hk} kv heads do not split over {ranks} ranks")
    n = hk // ranks
    return [tiles.narrow(KV_TP_AXIS, r * n, n) for r in range(ranks)]


def check_table_bounds(table, num_pages):
    """Raise ValueError unless every entry of the host page table `table`
    ([..., P] int array) lies in [0, num_pages)."""
    t = np.asarray(table)
    if t.size == 0:
        return
    lo, hi = int(t.min()), int(t.max())
    if lo < 0 or hi >= int(num_pages):
        bad = np.argwhere((t < 0) | (t >= int(num_pages)))
        raise ValueError(
            f"page table entries out of arena bounds [0, {int(num_pages)}): "
            f"min={lo}, max={hi}, first bad index={bad[0].tolist()}"
        )


HANDOFF_VERSION = 1

# the wire's `dtype` names (numpy's names of the cache dtypes) and their
# torch types
_WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32}


class HandoffFormatError(ValueError):
    """A handoff payload the receiving decode engine cannot import: another
    version, quant mode, KV geometry, layer count or dtype, or row bytes of
    the wrong length.  Typed, so that serve() answers a 400 and nothing
    reaches a compiled step."""


def wire_dtype_name(dtype):
    """The wire's `dtype` string of a cache dtype (torch or numpy):
    "bfloat16", "float16" or "float32", numpy's names, as the reference
    stamps them."""
    name = str(dtype).replace("torch.", "")
    if name not in _WIRE_DTYPES:
        raise HandoffFormatError(f"no handoff encoding for cache dtype {name}")
    return name


def _raw(arr):
    """The C-order bytes of one row array (numpy, or a torch tensor on the
    host: 16-bit floats as their bit patterns) and their count."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.view(torch.int16)
        a = t.numpy()
    else:
        a = np.ascontiguousarray(arr)
    return a.tobytes(), a.nbytes


def _b64(buf):
    return base64.b64encode(buf).decode("ascii")


def _unb64(s, dtype, shape, what):
    """Rows of `shape` and torch `dtype` from base64 text, a fresh tensor."""
    try:
        buf = base64.b64decode(s.encode("ascii"), validate=True)
    except (AttributeError, ValueError) as e:
        raise HandoffFormatError(f"handoff {what}: not base64 ({e})") from None
    want = int(np.prod(shape)) * dtype.itemsize
    if len(buf) != want:
        raise HandoffFormatError(
            f"handoff {what}: {len(buf)} bytes, expected {want} for shape "
            f"{tuple(shape)} dtype {str(dtype).replace('torch.', '')}")
    raw = torch.from_numpy(np.frombuffer(buf, np.uint8).copy())
    return raw.view(dtype).reshape(shape)


def serialize_kv_handoff(layers, prompt_len, quant, dtype_name):
    """The JSON-safe handoff payload of one request's prompt rows.

    `layers` holds one dict per model layer: "k" and "v" of shape [L,
    kv_heads, head_dim] (int8 under quant "int8", else the cache dtype),
    and under "int8" "k_scale"/"v_scale" [L, kv_heads, 1] float32; numpy
    arrays or host torch tensors.  The payload's `payload_bytes` counts
    the raw row bytes before base64 (the `paddle_disagg_handoff_bytes`
    figure)."""
    if not layers:
        raise HandoffFormatError("handoff payload needs >= 1 layer")
    quant = validate_kv_quant(quant)
    names = ("k", "v", "k_scale", "v_scale") if quant == "int8" else ("k", "v")
    raw = 0
    packed = []
    for ly in layers:
        rec = {}
        for name in names:
            buf, n = _raw(ly[name])
            rec[name] = _b64(buf)
            raw += n
        packed.append(rec)
    shape = layers[0]["k"].shape
    return {
        "version": HANDOFF_VERSION,
        "prompt_len": int(prompt_len),
        "quant": quant,
        "kv_heads": int(shape[1]),
        "head_dim": int(shape[2]),
        "n_layers": len(layers),
        "dtype": str(dtype_name),
        "payload_bytes": int(raw),
        "layers": packed,
    }


def deserialize_kv_handoff(payload, quant, kv_heads, head_dim, n_layers,
                           dtype_name):
    """Unpack and validate a handoff payload against the receiving engine's
    arena geometry.  Returns (layers, prompt_len), `layers` in
    `serialize_kv_handoff`'s layout as host torch tensors.  Every mismatch
    raises HandoffFormatError."""
    if not isinstance(payload, dict):
        raise HandoffFormatError(
            f"handoff payload is {type(payload).__name__}, not a dict")
    if int(payload.get("version", -1)) != HANDOFF_VERSION:
        raise HandoffFormatError(
            f"handoff version {payload.get('version')!r} != {HANDOFF_VERSION}")
    quant = validate_kv_quant(quant)
    for field, want in (("quant", quant), ("kv_heads", int(kv_heads)),
                        ("head_dim", int(head_dim)), ("n_layers", int(n_layers)),
                        ("dtype", str(dtype_name))):
        got = payload.get(field)
        got = type(want)(got) if got is not None else got
        if got != want:
            raise HandoffFormatError(
                f"handoff {field} mismatch: payload has {got!r}, this engine "
                f"expects {want!r}")
    L = int(payload.get("prompt_len", 0))
    if L <= 0:
        raise HandoffFormatError(f"handoff prompt_len {L} must be positive")
    rows = payload.get("layers")
    if not isinstance(rows, list) or len(rows) != int(n_layers):
        raise HandoffFormatError(
            f"handoff carries {len(rows) if isinstance(rows, list) else '?'} "
            f"layer records, expected {int(n_layers)}")
    if quant == "int8":
        elem = torch.int8
    elif str(dtype_name) in _WIRE_DTYPES:
        elem = _WIRE_DTYPES[str(dtype_name)]
    else:
        raise HandoffFormatError(f"no handoff encoding for dtype {dtype_name!r}")
    kvh, hd = int(kv_heads), int(head_dim)
    out = []
    for i, rec in enumerate(rows):
        if not isinstance(rec, dict):
            raise HandoffFormatError(f"handoff layer {i} is not a record")
        try:
            ly = {n: _unb64(rec[n], elem, (L, kvh, hd), f"layer {i} {n}")
                  for n in ("k", "v")}
            if quant == "int8":
                for n in ("k_scale", "v_scale"):
                    ly[n] = _unb64(rec[n], torch.float32, (L, kvh, 1),
                                   f"layer {i} {n}")
        except KeyError as e:
            raise HandoffFormatError(f"handoff layer {i} lacks {e}") from None
        out.append(ly)
    return out, L


class PagePool:
    """Refcounted page allocator.  Page 0 is scratch: pinned at refcount 1,
    never handed out, the target of every redirected write.  Freed pages
    return to the tail of their shard's free list (FIFO reuse).

    Context parallelism splits the ids into `shards` equal contiguous
    ranges: shard s owns [s*per_shard, (s+1)*per_shard), and its first
    page is that shard's scratch, pinned like page 0.  Sequence page k must
    come from shard k % cp (the layout the cp decode kernel reads), so
    `alloc` takes the shard.  shards=1 is the single pool."""

    def __init__(self, num_pages, shards=1):
        shards = int(shards)
        if shards < 1:
            raise ValueError(f"page pool shards must be >= 1, got {shards}")
        if num_pages % shards:
            raise ValueError(
                f"page pool size {num_pages} must divide evenly into "
                f"{shards} shards"
            )
        if num_pages < 2 * shards:
            raise ValueError(
                "page pool needs >= 2 pages per shard (1 scratch + 1 usable)"
            )
        self.num_pages = int(num_pages)
        self.shards = shards
        self.per_shard = self.num_pages // shards
        self.scratch_pages = tuple(s * self.per_shard for s in range(shards))
        self.refs = np.zeros(self.num_pages, np.int64)
        self.refs[list(self.scratch_pages)] = 1
        self._free_by_shard = [
            list(range(s * self.per_shard + 1, (s + 1) * self.per_shard))
            for s in range(shards)
        ]

    @property
    def _free(self):
        """Every free page id, shard by shard (audits and tests)."""
        return [p for lst in self._free_by_shard for p in lst]

    @property
    def usable_pages(self):
        return self.num_pages - self.shards

    def shard_of(self, page):
        return int(page) // self.per_shard

    def is_scratch(self, page):
        return int(page) % self.per_shard == 0

    def free_count(self, shard=None):
        if shard is None:
            return sum(len(lst) for lst in self._free_by_shard)
        return len(self._free_by_shard[shard])

    def used_count(self):
        return self.usable_pages - self.free_count()

    def alloc(self, shard=0):
        """One page at refcount 1 from `shard`'s range.  The engine's
        admission check guarantees a free page; running dry is an
        accounting bug."""
        free = self._free_by_shard[shard]
        if not free:
            raise RuntimeError(
                f"page pool shard {shard} exhausted: admission should have "
                "deferred this allocation (accounting bug)"
            )
        p = free.pop(0)
        if self.refs[p] != 0:
            raise RuntimeError(f"free-list page {p} had refcount {self.refs[p]}")
        self.refs[p] = 1
        return p

    def incref(self, page):
        if self.is_scratch(page) or self.refs[page] <= 0:
            raise ValueError(f"incref on scratch or dead page {page}")
        self.refs[page] += 1

    def decref(self, page):
        """Drop one reference; a page reaching 0 returns to its shard's free
        list.  Returns True when it did."""
        if self.is_scratch(page) or self.refs[page] <= 0:
            raise ValueError(f"decref on scratch or dead page {page}")
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._free_by_shard[self.shard_of(page)].append(page)
            return True
        return False


class _Entry:
    __slots__ = ("key", "parent_key", "page", "rows", "children", "last_used",
                 "tokens", "pinned")

    def __init__(self, key, parent_key, page, rows, tokens):
        self.key = key
        self.parent_key = parent_key
        self.page = int(page)
        self.rows = int(rows)  # committed rows; readers trust only j < rows
        self.children = 0
        self.last_used = 0
        self.tokens = tokens  # the page's committed token ids (tuple)
        self.pinned = 0  # session holds; > 0 means never evictable


class PrefixCache:
    """Token-chain index over committed prompt pages.

    Full pages are keyed `(parent_key, page_tokens)`, so equal prefixes
    converge on one chain whichever request committed them; partial last
    pages are tails under their parent, matched by longest common prefix.
    Eviction is LRU over childless unpinned entries only: a parent outlives
    its children, so no chain dangles, and a session's chain outlives page
    pressure until the session itself is evicted.

    Chains hang from one root per LoRA adapter: `lookup`, `commit` and
    `chain` take the request's stable registry adapter id (0 = the base
    model) and walk from that adapter's root, so a prompt prefilled under
    adapter A is never reused under B or the base model, even for an
    identical token chain.
    """

    _ROOT = ()

    def _root(self, adapter):
        """Chain root of one adapter id.  The marker tuple cannot collide
        with a full-page key (whose first element is a key, never the
        marker string); no full entry is keyed by it, so `_adopt` and
        `_remove` find no parent there."""
        return self._ROOT if not adapter else ("__lora__", int(adapter))

    def __init__(self, page_size):
        self.page_size = int(page_size)
        self._full = {}   # key -> _Entry (rows == page_size)
        self._tails = {}  # parent_key -> [_Entry] (rows < page_size)
        self._clock = 0

    def __len__(self):
        return len(self._full) + sum(len(v) for v in self._tails.values())

    def entries(self):
        yield from self._full.values()
        for tails in self._tails.values():
            yield from tails

    def _tick(self, entry):
        self._clock += 1
        entry.last_used = self._clock

    def lookup(self, prompt, adapter=0):
        """Longest cached prefix of `prompt` (np.int32 [L]) committed under
        the same `adapter` id, capped at L - 1
        so at least one suffix token remains to prefill and sample from.
        Returns (match_len, full_pages, tail_page, tail_rows): full pages map
        read-only as they are, the tail page (if any) must be copied before
        the reader appends.  Bumps LRU on the matched chain; refcounts are
        the caller's job."""
        ps = self.page_size
        L = int(prompt.size)
        toks = prompt.tolist()
        key = self._root(adapter)
        full_pages, matched = [], []
        i = 0
        while i + ps <= L - 1:  # a full-page match must leave a suffix token
            child = self._full.get((key, tuple(toks[i:i + ps])))
            if child is None:
                break
            full_pages.append(child.page)
            matched.append(child)
            key = child.key
            i += ps
        tail_page, tail_rows, best = None, 0, None
        for e in self._tails.get(key, ()):
            lcp = 0
            for a, b in zip(e.tokens, toks[i:L - 1]):  # cap the match at L - 1
                if a != b:
                    break
                lcp += 1
            if lcp > tail_rows:
                tail_rows, tail_page, best = lcp, e.page, e
        if best is not None:
            matched.append(best)
        for e in matched:
            self._tick(e)
        return i + tail_rows, full_pages, tail_page, tail_rows

    def commit(self, prompt, pages, pool, adapter=0):
        """Insert-if-absent the prompt's pages after its prefill: one entry
        per complete page, one tail for the remainder, chained under the
        committing request's `adapter` root.  New entries incref
        their page (the cache's own hold); chain positions already cached
        are left alone (the committer may have mapped that very page).
        Returns the number of entries inserted."""
        ps = self.page_size
        L = int(prompt.size)
        toks = prompt.tolist()
        key = self._root(adapter)
        inserted = 0
        for i in range(L // ps):
            ek = (key, tuple(toks[i * ps:(i + 1) * ps]))
            e = self._full.get(ek)
            if e is None:
                e = _Entry(ek, key, pages[i], ps, ek[1])
                self._full[ek] = e
                pool.incref(e.page)
                self._adopt(key)
                inserted += 1
            self._tick(e)
            key = e.key
        rows = L % ps
        if rows:
            tokens = tuple(toks[L - rows:L])
            tails = self._tails.setdefault(key, [])
            for e in tails:
                if e.tokens == tokens:
                    self._tick(e)
                    return inserted
            e = _Entry((key, tokens), key, pages[L // ps], rows, tokens)
            tails.append(e)
            pool.incref(e.page)
            self._adopt(key)
            self._tick(e)
            inserted += 1
        return inserted

    def _adopt(self, parent_key):
        parent = self._full.get(parent_key) if parent_key else None
        if parent is not None:
            parent.children += 1

    def _remove(self, entry):
        if entry.rows == self.page_size:
            del self._full[entry.key]
            self._tails.pop(entry.key, None)  # only ever an empty list by now
        else:
            tails = self._tails.get(entry.parent_key, [])
            tails.remove(entry)
            if not tails:
                self._tails.pop(entry.parent_key, None)
        parent = self._full.get(entry.parent_key) if entry.parent_key else None
        if parent is not None:
            parent.children -= 1

    def evict_one(self, pool, shard=None):
        """Drop the LRU childless unpinned entry and release its page hold.
        Returns the evicted entry, or None when nothing is evictable.  The
        page only reaches the free list if no live slot still maps it:
        eviction never invalidates a reader.  A session-pinned entry is
        never a victim: its session is evicted first
        (`SessionStore.evict_lru` drops the pins).  `shard` restricts the
        victims to entries whose page lies in that pool shard: under cp,
        evicting elsewhere cannot relieve that shard."""
        victim = None
        for e in self.entries():
            if e.pinned > 0:
                continue  # a session's hold: the session goes first
            if shard is not None and pool.shard_of(e.page) != shard:
                continue
            if e.rows == self.page_size and (e.children > 0 or self._tails.get(e.key)):
                continue  # a parent outlives its children
            if victim is None or e.last_used < victim.last_used:
                victim = e
        if victim is None:
            return None
        self._remove(victim)
        pool.decref(victim.page)
        return victim

    def chain(self, tokens, adapter=0):
        """The committed entries covering the longest cached prefix of
        `tokens` (np.int32 [L] or a list) under `adapter`: full-page links
        and a tail that matches exactly.  Unlike `lookup` the coverage may
        reach all L tokens (it walks what `commit` wrote, not what a new
        reader may reuse) and the LRU clock is left alone.  Returns
        (entries, covered tokens); a session pins exactly these entries."""
        ps = self.page_size
        toks = tokens.tolist() if hasattr(tokens, "tolist") else list(tokens)
        L = len(toks)
        key = self._root(adapter)
        out = []
        i = 0
        while i + ps <= L:
            e = self._full.get((key, tuple(toks[i:i + ps])))
            if e is None:
                break
            out.append(e)
            key = e.key
            i += ps
        covered = i
        if 0 < L - i < ps:
            tail = tuple(toks[i:L])
            for e in self._tails.get(key, ()):
                if e.tokens == tail:
                    out.append(e)
                    covered = L
                    break
        return out, covered

    def clear(self, pool):
        """Release every cache hold; returns how many entries went.  Session
        pins go first: whoever tears the cache down tears its sessions down
        with it (a `SessionStore` holds no page refcounts of its own)."""
        for e in self.entries():
            e.pinned = 0
        n = 0
        while self.evict_one(pool) is not None:
            n += 1
        return n


class SessionStore:
    """Named multi-turn sessions (reference: paging.py:670).

    A session is a hold on the PrefixCache chain of its committed
    conversation: the prompt and generated tokens of every turn so far.
    `bind` pins every link of the chain `PrefixCache.chain` returns for
    the committed sequence (`entry.pinned += 1`) and unpins the previous
    turn's chain, so `evict_one` never reclaims a live session's pages;
    the page refcounts stay the cache's own, so the page audit needs no
    extra term.  The next turn's request then chunk-prefills only its
    unshared suffix through the ordinary prefix-cache admission, at its
    true positions, with no new trace.

    Sessions are evicted whole, LRU (half a pinned chain serves nobody):
    by capacity at bind time, or by the engine's allocator when evicting
    unpinned cache entries alone cannot free a page.  A warm `restart()`
    keeps them: they reference cache entries, and a restart keeps the pool
    and the cache."""

    def __init__(self, capacity=256):
        self.capacity = max(1, int(capacity))
        self._sessions = {}  # sid -> record dict
        self._clock = 0
        self.tokens_saved_total = 0  # prompt tokens served from pinned KV
        self.evictions = 0
        self.binds = 0

    def __len__(self):
        return len(self._sessions)

    def __contains__(self, sid):
        return sid in self._sessions

    def sessions(self):
        return list(self._sessions.values())

    def get(self, sid):
        return self._sessions.get(sid)

    def tokens(self, sid):
        s = self._sessions.get(sid)
        return None if s is None else s["tokens"]

    def touch(self, sid):
        """Bump `sid`'s LRU tick; returns its record or None."""
        s = self._sessions.get(sid)
        if s is not None:
            self._clock += 1
            s["last_used"] = self._clock
        return s

    def bind(self, sid, tokens, entries, adapter=0, tenant=""):
        """(Re)bind `sid` to the committed sequence `tokens` whose cache
        chain is `entries`: pin the new chain, then unpin the previous one
        (in that order, so a shared link never passes through 0).  Returns
        the session ids evicted to stay within capacity."""
        self._clock += 1
        old = self._sessions.pop(sid, None)
        for e in entries:
            e.pinned += 1
        if old is not None:
            for e in old["entries"]:
                e.pinned -= 1
        self._sessions[sid] = {
            "sid": sid,
            "tokens": np.asarray(tokens, np.int32).copy(),
            "entries": list(entries),
            "adapter": int(adapter),
            "tenant": str(tenant or ""),
            "last_used": self._clock,
            "turns": (old["turns"] + 1) if old else 1,
        }
        self.binds += 1
        evicted = []
        while len(self._sessions) > self.capacity:
            v = self.evict_lru(exclude=sid)
            if v is None:
                break
            evicted.append(v)
        return evicted

    def release(self, sid):
        """Unpin and drop `sid`; returns whether it was resident."""
        s = self._sessions.pop(sid, None)
        if s is None:
            return False
        for e in s["entries"]:
            e.pinned -= 1
        return True

    def evict_lru(self, exclude=None):
        """Unpin and drop the least recently used session other than
        `exclude`, whole.  Returns its id, or None."""
        victim = None
        for sid, s in self._sessions.items():
            if sid == exclude:
                continue
            if victim is None or s["last_used"] < victim["last_used"]:
                victim = s
        if victim is None:
            return None
        self.release(victim["sid"])
        self.evictions += 1
        return victim["sid"]

    def clear(self):
        for sid in list(self._sessions):
            self.release(sid)

    def pages_pinned(self):
        """Distinct cache entries (so pages) held by at least one session."""
        return len({id(e) for s in self._sessions.values() for e in s["entries"]})

    def stats(self):
        """The reference's keys: residency, tenants, pinned pages and the
        saved-token, eviction and bind counters."""
        tenants = {s["tenant"] for s in self._sessions.values()}
        return {
            "sessions_resident": len(self._sessions),
            "session_tenants": len(tenants),
            "session_pages_pinned": self.pages_pinned(),
            "session_prefill_tokens_saved_total": int(self.tokens_saved_total),
            "session_evictions_total": int(self.evictions),
            "session_binds_total": int(self.binds),
        }

    def check(self, cache, pool):
        """The session clause of FLAGS_serve_debug_invariants: every pin on
        a cache entry is explained by exactly the sessions that hold it,
        every pinned entry is still in the cache with a live page, and no
        session references an entry the cache dropped.  Raises
        AssertionError."""
        want = {}
        for s in self._sessions.values():
            for e in s["entries"]:
                want[id(e)] = want.get(id(e), 0) + 1
        live = {id(e) for e in cache.entries()}
        for s in self._sessions.values():
            for e in s["entries"]:
                if id(e) not in live:
                    raise AssertionError(
                        f"session invariant: session {s['sid']!r} pins page "
                        f"{e.page} whose cache entry was removed")
        for e in cache.entries():
            w = want.get(id(e), 0)
            if e.pinned != w:
                raise AssertionError(
                    f"session invariant: entry page {e.page} pinned="
                    f"{e.pinned} but {w} session hold(s) reference it")
            if e.pinned > 0 and pool.refs[e.page] <= 0:
                raise AssertionError(
                    f"session invariant: pinned page {e.page} has refcount "
                    f"{int(pool.refs[e.page])}")
