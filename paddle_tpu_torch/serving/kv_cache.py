"""Paged KV-cache allocator: block tables over a preallocated device pool,
with a cross-request prefix cache (content-hashed blocks, refcounted
sharing, copy-on-write, LRU reuse).  Counterpart of
``paddle_tpu/serving/kv_cache.py``.

Each layer owns two pooled tensors (K and V) of shape ``(num_blocks,
block_size, num_kv_heads, head_dim)``, and every request holds a block
table: the ordered page ids its tokens occupy.  Token ``p`` of a request
lives at ``(table[p // block_size], p % block_size)``.

Page 0 is RESERVED as the padding sink: padded batch slots write their
garbage K/V there and block tables are padded with 0, so every gather and
scatter a step issues is in bounds.

Prefix cache (``FLAGS_serving_prefix_cache``): every FULL block acquires a
content identity — a hash chained over ``(parent_block_hash, block token
ids)``, so a block's identity pins the whole token prefix up to its end.
``alloc(..., tokens=prompt)`` maps every cached hit into the new request's
table instead of allocating and prefilling it; shared pages are
refcounted; the first divergent append into a shared page copies it
(copy-on-write: the engine applies queued ``(src, dst)`` copies at its next
step); refcount-0 pages with registered content park in an LRU and are
evicted coldest-first only when the freelist runs dry.

``FLAGS_serving_kv_quant=int8`` (read at construction) makes the pools
int8 codes with a (num_blocks, block_size, num_kv_heads, 1) f32 scale pool
beside each, one scale per (token, kv head) vector.  The allocator, the
prefix cache and copy-on-write move page ids and do not care: codes and
scales travel together.

``_block_hash`` and ``block_chain`` are byte-identical to the reference's,
so block identities match across the two packages.  Host-side state is
plain Python; the device side is one (K, V) tensor pair per layer (plus a
(K, V) scale pair for an int8 pool), updated in place by the engine's
steps.
"""

from __future__ import annotations

import hashlib
import math
import struct
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.dtype import to_torch_dtype
from ..core.place import resolve_device
from ..flags import get_flags

__all__ = ["PagedKVCache", "block_chain"]


def _flag(name: str, override) -> int:
    if override is not None:
        return int(override)
    return int(get_flags(name))


def _prefix_cache_flag() -> bool:
    mode = str(get_flags("serving_prefix_cache")).strip().lower()
    return mode not in ("off", "0", "false", "")


def _kv_quant_flag() -> bool:
    """FLAGS_serving_kv_quant at pool construction: the pool dtype is
    decided once, here."""
    mode = str(get_flags("serving_kv_quant")).strip().lower()
    return mode in ("int8", "on", "1", "true")


# chain seed for block 0 (any fixed int; every process computes the
# same chain for the same tokens — block identity crosses processes)
_CHAIN_SEED = 0


def _block_hash(parent: int, tokens: Tuple[int, ...]) -> int:
    """Identity of a full block = stable digest of (whole-prefix identity,
    own tokens): blake2b over the little-endian parent digest and token
    ids, folded to a signed 64-bit int (never ``hash()``, which is salted
    per process)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<q", parent))
    h.update(struct.pack(f"<{len(tokens)}q", *tokens))
    return int.from_bytes(h.digest(), "little", signed=True)


def block_chain(tokens: Sequence[int], block_size: int) -> List[int]:
    """Chain hashes of every FULL block of ``tokens`` (the identity a
    cache would assign them)."""
    bs = int(block_size)
    if bs < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    chain: List[int] = []
    h = _CHAIN_SEED
    for k in range(len(tokens) // bs):
        h = _block_hash(h, tuple(int(t) for t in tokens[k * bs:(k + 1) * bs]))
        chain.append(h)
    return chain


class PagedKVCache:
    """Per-layer pooled KV pages + per-request block tables."""

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 dtype="float32", block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 max_seq_len: Optional[int] = None, device=None) -> None:
        self.block_size = _flag("serving_block_size", block_size)
        self.num_blocks = _flag("serving_num_blocks", num_blocks)
        if self.block_size < 1 or self.num_blocks < 2:
            raise ValueError(
                f"need block_size >= 1 and num_blocks >= 2 (page 0 is "
                f"reserved), got {self.block_size}/{self.num_blocks}")
        self.device = resolve_device(device)
        self.dtype = to_torch_dtype(dtype)
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        # fixed block-table width: every sequence's table is padded to the
        # worst case so step shapes never depend on length
        self.max_pages_per_seq = max(
            1, math.ceil((max_seq_len or
                          self.block_size * (self.num_blocks - 1)) /
                         self.block_size))
        self.quantized = _kv_quant_flag()
        pool_dtype = torch.int8 if self.quantized else self.dtype
        shape = (self.num_blocks, self.block_size, num_kv_heads, head_dim)
        sshape = (self.num_blocks, self.block_size, num_kv_heads, 1)
        self.k_pages: List[torch.Tensor] = []
        self.v_pages: List[torch.Tensor] = []
        self.k_scales: Optional[List[torch.Tensor]] = \
            [] if self.quantized else None
        self.v_scales: Optional[List[torch.Tensor]] = \
            [] if self.quantized else None
        for _ in range(num_layers):
            self.k_pages.append(torch.zeros(shape, dtype=pool_dtype,
                                            device=self.device))
            self.v_pages.append(torch.zeros(shape, dtype=pool_dtype,
                                            device=self.device))
            if self.quantized:
                self.k_scales.append(torch.zeros(
                    sshape, dtype=torch.float32, device=self.device))
                self.v_scales.append(torch.zeros(
                    sshape, dtype=torch.float32, device=self.device))
        # page 0 is the padding sink — never handed out
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}
        self._lens: Dict[int, int] = {}
        # -- prefix-cache state ------------------------------------------
        self.prefix_enabled = _prefix_cache_flag()
        # page -> live references (allocated pages only; shared = once)
        self._refcnt: Dict[int, int] = {}
        # refcount-0 pages still holding hash-registered content,
        # oldest-first: the evictable prefix cache
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._hash_to_page: Dict[int, int] = {}
        # page -> (parent_hash, block tokens, own_hash) for registered
        # pages; _children indexes them by parent for partial-tail match
        self._page_meta: Dict[int, Tuple[int, Tuple[int, ...], int]] = {}
        self._children: Dict[int, List[int]] = {}
        # per-request prefix bookkeeping (tokens known so far, chain of
        # full-block hashes, hit watermarks)
        self._tokens: Dict[int, List[int]] = {}
        self._chain: Dict[int, List[int]] = {}
        self._cached_upto: Dict[int, int] = {}
        self._hits_eff: Dict[int, int] = {}
        # (src, dst) page copies the engine applies at its next step,
        # BEFORE that step's KV writes
        self._pending_copies: List[Tuple[int, int]] = []
        self._stat_hits = 0
        self._stat_misses = 0
        self._stat_hit_tokens = 0
        self._stat_cow = 0
        self._stat_evictions = 0

    def prefix_stats(self) -> Dict[str, object]:
        """Capacity + lifetime hit/CoW/eviction counters for this pool."""
        looked = self._stat_hits + self._stat_misses
        return {
            "enabled": self.prefix_enabled,
            "cached_blocks": len(self._lru),
            "cached_tokens": len(self._lru) * self.block_size,
            "hits": self._stat_hits,
            "misses": self._stat_misses,
            "hit_rate": round(self._stat_hits / looked, 4) if looked
            else None,
            "hit_tokens_total": self._stat_hit_tokens,
            "cow_copies_total": self._stat_cow,
            "evictions_total": self._stat_evictions,
        }

    # -- pool accounting --------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Pages allocation can claim: the freelist plus every cached
        (refcount-0) page the LRU would evict on demand."""
        return len(self._free) + len(self._lru)

    @property
    def blocks_in_use(self) -> int:
        return (self.num_blocks - 1) - self.free_blocks

    def pool_bytes(self) -> int:
        pools = self.k_pages + self.v_pages
        if self.quantized:
            pools = pools + self.k_scales + self.v_scales
        return sum(t.numel() * t.element_size() for t in pools)

    def used_tokens(self) -> int:
        """Tokens occupying allocated pages, each physical page counted
        once (a block shared by N sequences counts its occupancy once)."""
        occ: Dict[int, int] = {}
        bs = self.block_size
        for rid, table in list(self._tables.items()):
            length = self._lens.get(rid, 0)
            for b, page in enumerate(list(table)):
                t = min(bs, max(0, length - b * bs))
                if t > occ.get(page, 0):
                    occ[page] = t
        return sum(occ.values())

    def utilization(self) -> float:
        """Allocated fraction of the usable pool (page 0 excluded); cached
        but unreferenced (LRU) pages count as free."""
        return self.blocks_in_use / (self.num_blocks - 1)

    def fragmentation(self) -> float:
        """Internal fragmentation: the fraction of allocated page capacity
        no token occupies (shared pages count once)."""
        cap = self.blocks_in_use * self.block_size
        if cap == 0:
            return 0.0
        return 1.0 - self.used_tokens() / cap

    def drop_cache(self) -> None:
        """Forget every cached identity (LRU pages to the freelist, all hash
        registrations cleared, pending copies dropped): the pools' content
        is about to become meaningless (``reset_pools``)."""
        for page in list(self._lru):
            self._free.append(page)
        self._lru.clear()
        self._hash_to_page.clear()
        self._page_meta.clear()
        self._children.clear()
        self._pending_copies.clear()

    def reset_pools(self) -> None:
        """Zero every pool IN PLACE after a failed step, and drop the
        prefix cache with the content.  In place because the engine's
        captured steps hold the pools' addresses: new pools would leave
        every graph writing into freed memory.  Callers first fold the
        active sequences back to recompute."""
        self.drop_cache()
        with torch.no_grad():
            for layer in self.layer_pools():
                for t in layer:
                    t.zero_()

    def layer_pools(self) -> List[Tuple[torch.Tensor, ...]]:
        """Each layer's pools: (k, v), or (k, v, k_scales, v_scales) for an
        int8 pool — the order ``PagedCacheView`` takes them in."""
        if self.quantized:
            return list(zip(self.k_pages, self.v_pages, self.k_scales,
                            self.v_scales))
        return list(zip(self.k_pages, self.v_pages))

    def blocks_needed(self, n_tokens: int) -> int:
        return math.ceil(max(n_tokens, 1) / self.block_size)

    # -- prefix-cache internals -------------------------------------------
    def _deregister(self, page: int) -> None:
        meta = self._page_meta.pop(page, None)
        if meta is None:
            return
        parent, _tokens, own = meta
        if self._hash_to_page.get(own) == page:
            del self._hash_to_page[own]
        sibs = self._children.get(parent)
        if sibs is not None:
            if page in sibs:
                sibs.remove(page)
            if not sibs:
                del self._children[parent]

    def _pop_page(self, exclude: Sequence[int] = ()) -> int:
        """One fresh page: freelist first, else evict the coldest cached
        page (refcounted pages are not in the LRU, so live pages are
        structurally un-evictable)."""
        if self._free:
            return self._free.pop()
        for page in self._lru:               # oldest-first
            if page in exclude:
                continue
            del self._lru[page]
            self._deregister(page)
            self._stat_evictions += 1
            return page
        raise RuntimeError("KV pool exhausted: no free or evictable page "
                           "(caller must check availability first)")

    def _queue_cow(self, src: int, exclude: Sequence[int] = ()) -> int:
        """Copy-on-write: claim a fresh destination page and queue the
        (src, dst) copy for the engine's next step."""
        dst = self._pop_page(exclude=exclude)
        self._refcnt[dst] = 1
        self._pending_copies.append((src, dst))
        self._stat_cow += 1
        return dst

    def _pin(self, page: int) -> None:
        """Take a reference on a matched page (an LRU page revives)."""
        if page in self._lru:
            del self._lru[page]
            self._refcnt[page] = 1
        else:
            self._refcnt[page] = self._refcnt.get(page, 0) + 1

    def _release(self, page: int) -> None:
        """Drop one reference; at zero a registered page parks in the LRU,
        an unregistered one returns to the freelist."""
        c = self._refcnt.get(page, 0)
        if c > 1:
            self._refcnt[page] = c - 1
            return
        self._refcnt.pop(page, None)
        if page in self._page_meta:
            self._lru[page] = None           # most-recently released
        else:
            self._free.append(page)

    def _match(self, tokens: Sequence[int]):
        """(full_pages, chain, tail, hit_tokens) for ``tokens``:
        consecutive full-block hash hits, then the best partial-tail reuse
        — ``tail`` is None, ("share", page) when a cached block's tokens
        cover the whole remainder, or ("cow", page, j) when a cached
        sibling shares only the first ``j`` remainder tokens."""
        bs = self.block_size
        n = len(tokens)
        pages: List[int] = []
        chain: List[int] = []
        h = _CHAIN_SEED
        k = 0
        while (k + 1) * bs <= n:
            t = tuple(int(x) for x in tokens[k * bs:(k + 1) * bs])
            nh = _block_hash(h, t)
            page = self._hash_to_page.get(nh)
            if page is None:
                break
            parent, ptoks, _own = self._page_meta[page]
            if parent != h or ptoks != t:    # hash collision: refuse
                break
            pages.append(page)
            chain.append(nh)
            h = nh
            k += 1
        hit = k * bs
        tail = None
        rem = tuple(int(x) for x in tokens[k * bs:])
        if rem:
            best_page, best_j = None, 0
            for page in self._children.get(h, ()):
                ptoks = self._page_meta[page][1]
                j = 0
                for a, b in zip(ptoks, rem):
                    if a != b:
                        break
                    j += 1
                if j > best_j:
                    best_page, best_j = page, j
            if best_page is not None and best_j > 0:
                if best_j == len(rem):
                    tail = ("share", best_page)
                else:
                    tail = ("cow", best_page, best_j)
                hit = k * bs + best_j
        return pages, chain, tail, hit

    def _register_full_blocks(self, rid: int, safe_tokens: int) -> None:
        """Give every block fully WRITTEN below ``safe_tokens`` a hash
        identity (the first page registered under a hash wins)."""
        toks = self._tokens.get(rid)
        if toks is None:
            return
        chain = self._chain[rid]
        table = self._tables[rid]
        bs = self.block_size
        while len(chain) < min(safe_tokens, len(toks)) // bs:
            b = len(chain)
            t = tuple(toks[b * bs:(b + 1) * bs])
            parent = chain[b - 1] if b else _CHAIN_SEED
            h = _block_hash(parent, t)
            chain.append(h)
            page = table[b]
            if (h not in self._hash_to_page
                    and page not in self._page_meta
                    and self._refcnt.get(page, 0) >= 1):
                self._hash_to_page[h] = page
                self._page_meta[page] = (parent, t, h)
                self._children.setdefault(parent, []).append(page)

    def take_pending_copies(self) -> List[Tuple[int, int]]:
        """Drain the queued CoW (src, dst) page copies."""
        out, self._pending_copies = self._pending_copies, []
        return out

    def prefix_hit_tokens(self, rid: int) -> int:
        """Prompt tokens of ``rid`` served from the cache (capped at
        prompt_len - 1: the final token always recomputes so its logits
        can seed decode)."""
        return self._hits_eff.get(rid, 0)

    # -- per-request lifecycle --------------------------------------------
    def alloc(self, rid: int, n_tokens: int,
              tokens: Optional[Sequence[int]] = None) -> bool:
        """Create ``rid``'s block table sized for ``n_tokens``.  With
        ``tokens`` (and the prefix cache enabled) cached blocks are mapped
        instead of allocated.  False (and no state change) when the new
        blocks cannot be covered."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already has a block table")
        if tokens is not None and not self.prefix_enabled:
            tokens = None
        matched: List[int] = []
        chain: List[int] = []
        tail = None
        hit_raw = 0
        if tokens is not None:
            matched, chain, tail, hit_raw = self._match(
                list(tokens)[:n_tokens])
        need_total = self.blocks_needed(n_tokens)
        shared_tail = 1 if tail is not None and tail[0] == "share" else 0
        new_needed = need_total - len(matched) - shared_tail
        pinned = set(matched)
        if tail is not None:
            pinned.add(tail[1])
        avail = len(self._free) + sum(1 for p in self._lru
                                      if p not in pinned)
        if new_needed > avail:
            return False                     # matching made no state change
        for page in matched:
            self._pin(page)
        table = list(matched)
        if shared_tail:
            self._pin(tail[1])
            table.append(tail[1])
        elif tail is not None:               # ("cow", src, j)
            table.append(self._queue_cow(tail[1], exclude=pinned))
        while len(table) < need_total:
            page = self._pop_page(exclude=pinned)
            self._refcnt[page] = 1
            table.append(page)
        hit_eff = min(hit_raw, max(n_tokens - 1, 0))
        self._tables[rid] = table
        self._lens[rid] = hit_eff
        self._cached_upto[rid] = hit_raw
        self._hits_eff[rid] = hit_eff
        if tokens is not None:
            self._tokens[rid] = [int(x) for x in list(tokens)[:n_tokens]]
            self._chain[rid] = chain
            if hit_eff > 0:
                self._stat_hits += 1
            else:
                self._stat_misses += 1
            self._stat_hit_tokens += hit_eff
        return True

    def append(self, rid: int, n_tokens: int = 1,
               token: Optional[int] = None,
               deferred_write: bool = False) -> bool:
        """Grow ``rid`` by ``n_tokens``: new pages only when the last page
        is full, copy-on-write first when the append position lands inside
        a SHARED page.  False = pool exhausted (side-effect free).
        ``token`` extends the request's known token stream;
        ``deferred_write=True`` marks the final position's write as not yet
        executed, so its block is not hash-registered yet."""
        table = self._tables[rid]
        length = self._lens[rid]
        need = self.blocks_needed(length + n_tokens) - len(table)
        bs = self.block_size
        cow_src = None
        bi = length // bs
        if (n_tokens > 0 and bi < len(table)
                and length >= self._cached_upto.get(rid, 0)):
            page = table[bi]
            if self._refcnt.get(page, 0) > 1:
                cow_src = page               # first divergent append
        if need + (1 if cow_src is not None else 0) > self.free_blocks:
            return False
        if cow_src is not None:
            table[bi] = self._queue_cow(cow_src)
            self._release(cow_src)
        elif (n_tokens > 0 and bi < len(table)
                and length >= self._cached_upto.get(rid, 0)
                and table[bi] in self._page_meta
                and self._refcnt.get(table[bi], 0) == 1):
            # sole owner mutating a registered page: its content is about
            # to diverge from its hash — forget the identity
            self._deregister(table[bi])
        for _ in range(max(0, need)):
            page = self._pop_page()
            self._refcnt[page] = 1
            table.append(page)
        self._lens[rid] = length + n_tokens
        if token is not None and rid in self._tokens:
            self._tokens[rid].append(int(token))
        self._register_full_blocks(
            rid, self._lens[rid] - (1 if deferred_write else 0))
        return True

    def free(self, rid: int) -> int:
        """Drop every reference ``rid`` holds (exclusively owned pages to
        the freelist, LIFO; registered pages whose last reference drops to
        the LRU); returns how many references were released."""
        table = self._tables.pop(rid, None)
        self._lens.pop(rid, None)
        self._tokens.pop(rid, None)
        self._chain.pop(rid, None)
        self._cached_upto.pop(rid, None)
        self._hits_eff.pop(rid, None)
        if not table:
            return 0
        freed = set(table)
        # a queued CoW copy into a page being released is dead work
        self._pending_copies = [(s, d) for (s, d) in self._pending_copies
                                if d not in freed]
        for page in reversed(table):
            self._release(page)
        return len(table)

    def seq_len(self, rid: int) -> int:
        return self._lens[rid]

    def padded_table(self, rid: Optional[int]) -> List[int]:
        """Block table padded with page 0 to the fixed width (None = an
        all-padding inert row)."""
        table = self._tables.get(rid, []) if rid is not None else []
        if len(table) > self.max_pages_per_seq:
            raise ValueError(
                f"request {rid} outgrew max_pages_per_seq "
                f"({len(table)} > {self.max_pages_per_seq})")
        return table + [0] * (self.max_pages_per_seq - len(table))

    def slot(self, rid: int, pos: int) -> Tuple[int, int]:
        """(page id, in-page offset) of absolute token position ``pos``."""
        return (self._tables[rid][pos // self.block_size],
                pos % self.block_size)

    def write_slot(self, rid: int, pos: int) -> Tuple[int, int]:
        """Where the engine may WRITE position ``pos``'s K/V.  A cached
        position redirects to the page-0 sink; a shared target means a
        missed copy-on-write and raises rather than corrupting another
        request's KV."""
        if pos < self._cached_upto.get(rid, 0):
            return (0, 0)
        page, off = self.slot(rid, pos)
        if self._refcnt.get(page, 0) > 1:
            raise RuntimeError(
                f"request {rid}: write at pos {pos} targets SHARED page "
                f"{page} (refcount {self._refcnt[page]}) — copy-on-write "
                f"was not performed")
        return (page, off)
