"""Host-side bookkeeping for the block-paged KV cache (counterpart of
`paddle_tpu/inference/paging.py`, cut to what fresh paged serving needs).

The device side is one `[num_pages, page_size, kv_heads, head_dim]` K/V
arena per layer plus per-slot page tables.  Which page holds which tokens
is decided here, on the host:

- `PagePool`: refcounted allocator over page ids with a FIFO free list.
  Page 0 is a permanent scratch page: inactive slots' table rows are
  all-zero and every masked write is redirected to it, so garbage never
  lands in a page a sequence attends.
- `check_table_bounds`: every table entry must name a real page before a
  table is uploaded.  The fused decode kernel indexes the arena by the raw
  entry, and on CUDA an out-of-range id is an illegal address, not a
  clamped read.

The prefix cache, the session store and the disaggregation wire format are
not ported yet (ROADMAP, Queue 1).
"""

from __future__ import annotations

import numpy as np


def kv_page_bytes(page_size, kv_heads, head_dim, dtype_bytes):
    """Device bytes ONE layer's K+V storage spends per page."""
    return 2 * int(page_size) * int(kv_heads) * int(head_dim) * int(dtype_bytes)


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


class PagePool:
    """Refcounted page allocator.  Page 0 is scratch: pinned at refcount 1,
    never handed out, the target of every redirected write.  Freed pages
    return to the tail of the free list (FIFO reuse)."""

    SCRATCH = 0

    def __init__(self, num_pages):
        if num_pages < 2:
            raise ValueError("page pool needs >= 2 pages (1 scratch + 1 usable)")
        self.num_pages = int(num_pages)
        self.refs = np.zeros(self.num_pages, np.int64)
        self.refs[self.SCRATCH] = 1
        self._free = list(range(1, self.num_pages))

    @property
    def usable_pages(self):
        return self.num_pages - 1

    def free_count(self):
        return len(self._free)

    def alloc(self):
        """One page at refcount 1.  The engine's admission check guarantees
        a free page; running dry is an accounting bug."""
        if not self._free:
            raise RuntimeError(
                "page pool exhausted: admission should have deferred this "
                "allocation (accounting bug)"
            )
        p = self._free.pop(0)
        if self.refs[p] != 0:
            raise RuntimeError(f"free-list page {p} had refcount {self.refs[p]}")
        self.refs[p] = 1
        return p

    def decref(self, page):
        """Drop one reference; a page reaching 0 returns to the free list.
        Returns True when it did."""
        if page == self.SCRATCH or self.refs[page] <= 0:
            raise ValueError(f"decref on scratch or dead page {page}")
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._free.append(page)
            return True
        return False
