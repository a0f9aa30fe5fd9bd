"""Paged KV cache: fixed-size pages over one preallocated per-layer pool
(ported from paddle_tpu/serving/kv_cache.py).

A sequence owns a list of page ids (its page table); pages return to a
free list the moment the request finishes, so memory scales with tokens
actually resident. Page 0 is the null page: padding rows of a fixed-shape
batch, and positions past a table's capacity, write there, and nothing
reads page 0 through a real page table.

Host/device split: the allocator and per-request page lists live on the
host; the pools are CUDA tensors (or CPU tensors when the engine runs on
the CPU), one (k, v) pair per layer in the (kv_heads, num_pages,
page_size, head_dim) layout, and each step WRITES THEM IN PLACE
(`serving.attention.paged_attend`) where the JAX engine threads donated
arrays through its jitted steps.

Quantized pools (kv_dtype "int8" / "fp8") hold a (k, v, k_scale, v_scale)
4-tuple per layer: int8 or float8_e4m3fn data slabs and fp32 (kv_heads,
num_pages, page_size, 1) scale slabs, one scale per (head, page, slot),
written through the same page/slot arithmetic as the data. A logical page
is a data slab plus a scale slab, so the allocator and page tables never
see the difference. Only quantized pools import `serving.quant`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["BlockAllocator", "PagedKVCache", "PagedLayerCache",
           "NULL_PAGE", "pages_for", "overflow_position",
           "views_from_pools", "host_to_device"]

NULL_PAGE = 0

KV_DTYPES = {"fp32": torch.float32, "float32": torch.float32,
             "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def pages_for(num_tokens: int, page_size: int) -> int:
    """Pages needed to hold `num_tokens` tokens."""
    return -(-num_tokens // page_size)


def overflow_position(max_pages: int, page_size: int) -> int:
    """First position past a (max_pages,)-table's capacity. `paged_attend`
    routes K/V writes at or beyond it to the null page, so this doubles as
    the parking slot for rows that must stop writing real pages: padding
    rows of a fixed-shape batch, and decode-horizon rows that hit EOS or
    their token budget mid-block."""
    return max_pages * page_size


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`. For CUDA the copy goes through pinned
    memory and is asynchronous: a plain pageable copy would wait for the
    stream to drain and undo the engine's host/device overlap."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class BlockAllocator:
    """Refcounted free-list page allocator. Page ids are ints in
    [1, num_pages); page 0 is the reserved null page and is never handed
    out. A freshly allocated page carries one reference; the prefix cache
    `acquire`s more when the page enters its radix tree or another
    sequence's page table, and `free` drops one, returning the page to the
    free list when none is left. Without a prefix cache every page stays
    at refcount 1."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        # LIFO keeps recently-freed (cache-warm) pages in rotation
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: dict = {}
        # the most pages in use at once since construction or the last
        # reset_peak() (a pool-pressure reading; nothing schedules on it)
        self.peak_used = 0
        self._m_alloc = None
        self._m_recycle = None
        self._m_share = None
        # fault injection (bind_faults): a None check only when unbound
        self._faults = None

    def bind_metrics(self, registry) -> None:
        """Attach page-lifecycle counters from a MetricsRegistry (handles
        resolved once; unbound allocators pay one None check per event)."""
        self._m_alloc = registry.counter(
            "serving_kv_page_allocs_total", "pages handed out")
        self._m_recycle = registry.counter(
            "serving_kv_page_recycles_total",
            "pages returned to the free list (last reference dropped)")
        self._m_share = registry.counter(
            "serving_kv_page_shares_total",
            "extra references acquired on shared pages")

    def bind_faults(self, injector) -> None:
        """Attach a resilience.FaultInjector; every alloc / alloc_n entry
        then consults its `alloc` site (one check per entry, not per
        page)."""
        self._faults = injector

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocatable(self) -> int:
        """Pages the allocator can ever hand out: `num_pages` minus the
        reserved null page."""
        return self.num_pages - 1

    @property
    def num_used(self) -> int:
        return len(self._refs)

    def reset_peak(self) -> None:
        """Restart `peak_used` from the pages in use now."""
        self.peak_used = len(self._refs)

    def ref_count(self, page: int) -> int:
        """Live references on `page` (0 = free)."""
        return self._refs.get(page, 0)

    def live_pages(self) -> List[int]:
        """Sorted page ids holding at least one live reference (what a
        restore-side audit compares with the pages the rebuilt requests
        and the prefix cache account for)."""
        return sorted(self._refs)

    def _alloc_unchecked(self) -> Optional[int]:
        if not self._free:
            return None
        page = self._free.pop()
        self._refs[page] = 1
        self.peak_used = max(self.peak_used, len(self._refs))
        if self._m_alloc is not None:
            self._m_alloc.inc()
        return page

    def alloc(self) -> Optional[int]:
        """One free page id (refcount 1), or None when the pool is
        exhausted. May raise InjectedFault under a bound FaultInjector
        (the scheduler degrades it to the exhausted path)."""
        if self._faults is not None:
            self._faults.check("alloc")
        return self._alloc_unchecked()

    def alloc_n(self, n: int) -> Optional[List[int]]:
        """All-or-nothing batch alloc (request admission)."""
        if self._faults is not None:
            self._faults.check("alloc")
        if len(self._free) < n:
            return None
        return [self._alloc_unchecked() for _ in range(n)]

    def acquire(self, page: int) -> None:
        """Add one reference to an allocated page (prefix-cache sharing:
        the page enters another page table or the radix tree)."""
        if page == NULL_PAGE:
            raise ValueError("page 0 is the reserved null page")
        if page not in self._refs:
            raise ValueError(f"acquire of free/unknown page {page}")
        self._refs[page] += 1
        if self._m_share is not None:
            self._m_share.inc()

    def free(self, page: int) -> None:
        """Drop one reference; the page returns to the free list only when
        no references remain."""
        if page == NULL_PAGE:
            raise ValueError("page 0 is the reserved null page")
        if page not in self._refs:
            raise ValueError(f"double free or unknown page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            del self._refs[page]
            self._free.append(page)
            if self._m_recycle is not None:
                self._m_recycle.inc()

    def free_all(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.free(p)

    def check_consistency(self) -> bool:
        """The free list and the refcount table must exactly partition the
        allocatable ids [1, num_pages). Raises RuntimeError on the first
        violation; returns True when the pool is sound."""
        free = self._free
        if len(set(free)) != len(free):
            raise RuntimeError("allocator corrupt: duplicate free pages")
        if NULL_PAGE in self._refs or NULL_PAGE in free:
            raise RuntimeError(
                "allocator corrupt: null page entered circulation")
        both = set(free) & self._refs.keys()
        if both:
            raise RuntimeError(
                f"allocator corrupt: pages {sorted(both)} are both free "
                "and referenced")
        for page, refs in self._refs.items():
            if not 1 <= page < self.num_pages:
                raise RuntimeError(
                    f"allocator corrupt: page id {page} out of range")
            if refs < 1:
                raise RuntimeError(
                    f"allocator corrupt: page {page} held at refcount "
                    f"{refs}")
        if any(not 1 <= p < self.num_pages for p in free):
            raise RuntimeError(
                "allocator corrupt: free-list id out of range")
        if len(free) + len(self._refs) != self.num_pages - 1:
            raise RuntimeError(
                f"allocator corrupt: {len(free)} free + "
                f"{len(self._refs)} live != {self.num_pages - 1} "
                "allocatable pages (leak or double-account)")
        return True


@dataclasses.dataclass
class PagedLayerCache:
    """One layer's view of the pool, handed to the model's attention in
    place of a static (k_cache, v_cache) pair; `attend_with_cache`
    dispatches on it (duck-typed by `page_table`).

    k_pool/v_pool: (kv_heads, num_pages, page_size, head_dim), written in
                   place by `paged_attend`
    page_table:    (B, max_pages) int32 - logical page j of row i lives in
                   physical page page_table[i, j] (0 = null page padding)
    row_ids:       optional (T,) int32 - ragged flat-batch mode: the step
                   carries all rows' tokens in ONE (1, T) sequence axis and
                   row_ids[t] names the page-table row token t belongs to
    k_scale/v_scale: optional (kv_heads, num_pages, page_size, 1) fp32 -
                   quantized pools only: one dequantization scale per
                   (head, page, slot), written like the data
    routing:       a dict shared by the views of one step, where the first
                   layer's `paged_attend` leaves the write positions it
                   derived from the page table, `row_ids` and `start_pos`,
                   for the other layers to reuse (None: every layer
                   derives them)
    """

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    page_table: torch.Tensor
    row_ids: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    routing: Optional[dict] = None

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def views_from_pools(pools: Sequence[Tuple[torch.Tensor, ...]],
                     page_table: torch.Tensor,
                     row_ids: Optional[torch.Tensor] = None
                     ) -> List[PagedLayerCache]:
    """Per-layer PagedLayerCache list from pool tuples - (k, v) for plain
    pools, (k, v, k_scale, v_scale) for quantized ones - sharing one
    routing dict."""
    routing: dict = {}
    return [PagedLayerCache(p[0], p[1], page_table, row_ids,
                            k_scale=p[2] if len(p) == 4 else None,
                            v_scale=p[3] if len(p) == 4 else None,
                            routing=routing)
            for p in pools]


class PagedKVCache:
    """The per-layer pools plus the allocator, on `device` (default: the
    port's default device, which raises without a card)."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, kv_dtype: str = "fp32",
                 device: Optional[torch.device] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        if kv_dtype not in KV_DTYPES and kv_dtype not in ("int8", "fp8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}: expected one "
                             "of 'fp32', 'bf16', 'int8', 'fp8'")
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.device = resolve_device(device)
        shape = (num_kv_heads, num_pages, page_size, head_dim)
        self.quant_spec = None
        if kv_dtype in KV_DTYPES:
            self.dtype = KV_DTYPES[kv_dtype]
            self.pools = [(torch.zeros(shape, dtype=self.dtype,
                                       device=self.device),
                           torch.zeros(shape, dtype=self.dtype,
                                       device=self.device))
                          for _ in range(num_layers)]
        else:
            # quantized pools ONLY: the fp32/bf16 path above never
            # imports serving.quant
            from .quant import SCALE_DTYPE, resolve_kv_dtype

            self.quant_spec = resolve_kv_dtype(kv_dtype, compute_dtype)
            self.dtype = self.quant_spec.storage_dtype
            sshape = (num_kv_heads, num_pages, page_size, 1)

            def slab(shp, dt, fill):
                return torch.full(shp, fill, dtype=dt, device=self.device)

            self.pools = [(slab(shape, self.dtype, 0), slab(shape,
                                                            self.dtype, 0),
                           slab(sshape, SCALE_DTYPE, 1.0),
                           slab(sshape, SCALE_DTYPE, 1.0))
                          for _ in range(num_layers)]
        self.allocator = BlockAllocator(num_pages)

    @property
    def kv_dtype(self) -> str:
        """Canonical name of the pool storage format."""
        if self.quant_spec is not None:
            return self.quant_spec.name
        return "bf16" if self.dtype == torch.bfloat16 else "fp32"

    @property
    def quantized(self) -> bool:
        return self.quant_spec is not None

    @property
    def page_bytes(self) -> int:
        """Bytes one logical page occupies across all layers: K + V data
        slabs plus, for quantized pools, the 4-byte scale of every slot and
        head."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        per_slot = 2 * self.num_kv_heads * (
            self.head_dim * itemsize + (4 if self.quantized else 0))
        return self.num_layers * self.page_size * per_slot

    @property
    def pool_bytes(self) -> int:
        return self.num_pages * self.page_bytes

    @classmethod
    def for_model(cls, model, num_pages: int, page_size: int,
                  kv_dtype: str = "fp32") -> "PagedKVCache":
        """Pools sized from the model's config, on the model's device."""
        from ..models.generation import _config_of

        cfg = _config_of(model)
        kv_heads = getattr(cfg, "num_key_value_heads",
                           cfg.num_attention_heads)
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        param = next(iter(model.parameters()))
        if param.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"paged serving needs a float32/bfloat16 model, got "
                f"parameters of dtype {param.dtype}")
        return cls(cfg.num_hidden_layers, num_pages, page_size, kv_heads,
                   head_dim, kv_dtype, param.device, param.dtype)

    def page_table_array(self, page_lists: Sequence[Sequence[int]],
                         max_pages: int) -> torch.Tensor:
        """(B, max_pages) int32 page table on the pools' device, from host
        page lists, padded with the null page."""
        out = np.zeros((len(page_lists), max_pages), np.int32)
        for i, pages in enumerate(page_lists):
            if len(pages) > max_pages:
                raise ValueError(f"sequence holds {len(pages)} pages > "
                                 f"max_pages {max_pages}")
            out[i, :len(pages)] = pages
        return host_to_device(out, self.device)

    def layer_views(self, page_table: torch.Tensor,
                    row_ids: Optional[torch.Tensor] = None
                    ) -> List[PagedLayerCache]:
        """Per-layer PagedLayerCache list in the shape the models expect
        for their `caches` argument."""
        return views_from_pools(self.pools, page_table, row_ids)
