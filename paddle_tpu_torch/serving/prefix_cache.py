"""Automatic prefix caching: radix-tree KV reuse over the paged pool (the
port's own copy of paddle_tpu/serving/prefix_cache.py; host Python over
ints).

A cached prefix is a list of page ids that several sequences' page tables
point at: the page table is already an indirection, so a request whose
prompt starts with a cached prefix prefills only its suffix, at an offset,
through the paged attention path.

Structure: a radix tree keyed on FULL-PAGE token chunks. Each node owns
one KV page whose `page_size` tokens are the node's chunk; the path from
the root to a node spells the token prefix whose K/V those pages hold. A
partial last page never enters the tree: the next request re-prefills it
into a fresh page, so no attention change is needed.

Sharing is by reference count (`BlockAllocator.acquire` / `free`): the
tree holds one reference per cached page, every sequence whose table holds
the page another, and the page returns to the free list when the last
holder drops it. Eviction is LRU over refcount-1 leaves (pages no live
sequence references), so a prefix pinned by running requests is never
evicted from under them. Over int8 / fp8 pools a page's scale slab is
indexed by the same page id, so it is shared with the page.

Invariants:
- `match` caps at len(tokens) - 1 so a fully cached prompt still prefills
  its final token (the engine samples from that token's logits);
- every page `match` returns carries a reference owned by the caller,
  released through the allocator's ordinary `free`;
- `evict` / `flush` only free refcount-1 pages (tree-only references);
- cached pages are never written again: suffix prefills and decode steps
  write positions >= the cached offset, which land in private pages.

Not ported here: `bind_faults` and the injected-fault degrade-to-miss path
(ROADMAP queue 1, S8), and the profiler span around a lookup (S9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..observability import MetricsRegistry
from .kv_cache import NULL_PAGE, BlockAllocator

__all__ = ["PrefixCache", "PrefixNode"]

Chunk = Tuple[int, ...]


@dataclasses.dataclass
class PrefixNode:
    """One cached page: `chunk` is the page_size token ids whose K/V the
    page holds; the root is a sentinel with page None."""

    chunk: Chunk
    page: Optional[int]
    parent: Optional["PrefixNode"]
    children: Dict[Chunk, "PrefixNode"] = dataclasses.field(
        default_factory=dict)
    last_used: int = 0


class PrefixCache:
    def __init__(self, allocator: BlockAllocator, page_size: int,
                 metrics: Optional[MetricsRegistry] = None):
        self.allocator = allocator
        self.page_size = page_size
        self._root = PrefixNode(chunk=(), page=None, parent=None)
        self._tick = 0
        self._num_pages = 0
        # hit / miss / eviction accounting lives in the metrics registry
        # (the engine's, so its stats share one source); a standalone
        # cache gets a private registry so `stats()` still works
        reg = metrics if metrics is not None else MetricsRegistry()
        self._m_lookups = reg.counter(
            "serving_prefix_lookups_total", "committed prefix lookups")
        self._m_hit = reg.counter(
            "serving_prefix_hit_tokens_total",
            "prompt tokens served from cached pages")
        self._m_miss = reg.counter(
            "serving_prefix_miss_tokens_total",
            "prompt tokens prefilled fresh")
        self._m_evict = reg.counter(
            "serving_prefix_evictions_total",
            "cached pages reclaimed by LRU eviction")
        self._m_pages = reg.gauge(
            "serving_prefix_cached_pages",
            "pages resident in the radix tree")
        # fault injection (bind_faults): a None check only when unbound
        self._faults = None

    def bind_faults(self, injector) -> None:
        """Attach a resilience.FaultInjector; `match` then consults its
        `prefix_match` site (the scheduler degrades an injected lookup
        fault to a miss). `peek` and `continuation` fire no fault."""
        self._faults = injector

    # ------------------------------------------------------------- lookup
    def _chunk(self, tokens: Sequence[int], i: int) -> Chunk:
        return tuple(tokens[i * self.page_size:(i + 1) * self.page_size])

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached full-page prefix of `tokens`, as page ids in
        prefix order. Acquires ONE reference per returned page: the caller
        owns them like allocated pages and releases them through
        `allocator.free`. Capped at len(tokens) - 1 tokens so a fully
        cached prompt still has a suffix to prefill."""
        self._tick += 1
        if self._faults is not None:
            # raises BEFORE any reference is acquired: nothing leaks
            self._faults.check("prefix_match")
        node = self._root
        pages: List[int] = []
        for i in range((len(tokens) - 1) // self.page_size):
            child = node.children.get(self._chunk(tokens, i))
            if child is None:
                break
            child.last_used = self._tick
            self.allocator.acquire(child.page)
            pages.append(child.page)
            node = child
        return pages

    def peek(self, tokens: Sequence[int]) -> int:
        """Longest cached full-page prefix of `tokens`, in TOKENS, read
        only: no references, no LRU tick, no lookup count. Same
        len(tokens) - 1 cap as `match`."""
        node = self._root
        n = 0
        for i in range((len(tokens) - 1) // self.page_size):
            child = node.children.get(self._chunk(tokens, i))
            if child is None:
                break
            n += self.page_size
            node = child
        return n

    def continuation(self, tokens: Sequence[int],
                     max_tokens: int) -> List[int]:
        """Up to `max_tokens` tokens CONTINUING `tokens`, from cached
        streams that share its prefix: the speculative decoder's radix
        draft probe. Read only, like `peek`.

        Walk the full-page chunks of `tokens` down the tree; at the
        deepest match the remainder r (the partial last page, possibly
        empty) selects a child whose chunk starts with r, and that child's
        chunk past r, then smallest-key descendants while more tokens are
        wanted, is the draft. Several matching children resolve to the
        smallest chunk key, so drafts are a function of the tree."""
        if max_tokens <= 0:
            return []
        node = self._root
        k = len(tokens) // self.page_size
        for i in range(k):
            node = node.children.get(self._chunk(tokens, i))
            if node is None:
                return []
        r = tuple(tokens[k * self.page_size:])
        out: List[int] = []
        if r:
            key = min((c for c in node.children
                       if len(c) > len(r) and c[:len(r)] == r),
                      default=None)
            if key is None:
                return []
            out.extend(key[len(r):])
            node = node.children[key]
        while len(out) < max_tokens and node.children:
            key = min(node.children)
            out.extend(key)
            node = node.children[key]
        return out[:max_tokens]

    def record(self, total_tokens: int, hit_tokens: int) -> None:
        """Count one committed lookup (called on successful admission, so
        a deferred and retried request is counted once)."""
        self._m_lookups.inc()
        self._m_hit.inc(hit_tokens)
        self._m_miss.inc(total_tokens - hit_tokens)

    # ------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register a just-prefilled request's FULL prompt pages (pages[i]
        holds tokens[i*ps:(i+1)*ps]); the partial last page never enters.
        A new node acquires a tree-owned reference on its page; a chunk
        already cached keeps its incumbent page (the request's duplicate
        stays private and is freed with the request). Returns the number
        of pages newly registered."""
        self._tick += 1
        node = self._root
        added = 0
        for i in range(min(len(tokens) // self.page_size, len(pages))):
            chunk = self._chunk(tokens, i)
            child = node.children.get(chunk)
            if child is None:
                child = PrefixNode(chunk=chunk, page=pages[i], parent=node)
                self.allocator.acquire(pages[i])
                node.children[chunk] = child
                self._num_pages += 1
                added += 1
            child.last_used = self._tick
            node = child
        if added:
            self._m_pages.set(self._num_pages)
        return added

    # ----------------------------------------------------------- eviction
    def _evictable_leaves(self) -> List[PrefixNode]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self.allocator.ref_count(n.page) == 1:
                out.append(n)          # only the tree references this page
        return out

    def evict(self, n: int) -> int:
        """Free up to `n` pages, LRU leaves first (a parent becomes
        evictable once its children are gone, so lookups never dangle).
        Pages any live sequence references are never touched. Returns the
        number of pages freed."""
        freed = 0
        while freed < n:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_used)
            del victim.parent.children[victim.chunk]
            self.allocator.free(victim.page)
            self._num_pages -= 1
            self._m_evict.inc()
            freed += 1
        if freed:
            self._m_pages.set(self._num_pages)
        return freed

    def flush(self) -> int:
        """Evict every page no live sequence references (end-of-run leak
        checks; a still-shared prefix survives)."""
        return self.evict(self._num_pages)

    # ----------------------------------------------------------- invariants
    def check_consistency(self) -> bool:
        """Radix-tree audit (run by `Scheduler.check_consistency`): every
        node below the root owns a real page with a live reference, chunks
        are exactly page_size tokens keyed under their own chunk, and the
        page count matches the tree. Raises RuntimeError on the first
        violation."""
        seen = 0
        stack = [(self._root, True)]
        while stack:
            node, is_root = stack.pop()
            if not is_root:
                seen += 1
                if node.page is None or node.page == NULL_PAGE:
                    raise RuntimeError(
                        "prefix cache corrupt: node without a real page "
                        f"(chunk {node.chunk!r})")
                if self.allocator.ref_count(node.page) < 1:
                    raise RuntimeError(
                        "prefix cache corrupt: cached page "
                        f"{node.page} has no live reference")
                if len(node.chunk) != self.page_size:
                    raise RuntimeError(
                        "prefix cache corrupt: chunk of "
                        f"{len(node.chunk)} tokens in a page_size="
                        f"{self.page_size} tree")
            for chunk, child in node.children.items():
                if chunk != child.chunk:
                    raise RuntimeError(
                        "prefix cache corrupt: child keyed under "
                        f"{chunk!r} but owns chunk {child.chunk!r}")
                stack.append((child, False))
        if seen != self._num_pages:
            raise RuntimeError(
                f"prefix cache corrupt: tree holds {seen} pages but "
                f"_num_pages says {self._num_pages}")
        return True

    # ------------------------------------------------------------ metrics
    @property
    def cached_pages(self) -> int:
        return self._num_pages

    def stats(self) -> Dict[str, object]:
        """A view over the registry counters, the reference's keys."""
        s = {"lookups": int(self._m_lookups.value),
             "hit_tokens": int(self._m_hit.value),
             "miss_tokens": int(self._m_miss.value),
             "evictions": int(self._m_evict.value)}
        seen = s["hit_tokens"] + s["miss_tokens"]
        s["hit_rate"] = s["hit_tokens"] / seen if seen else 0.0
        s["cached_pages"] = self._num_pages
        return s
