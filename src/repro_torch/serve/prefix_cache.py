"""Host-side shared-prefix index over page-aligned KV chunks: the
port's copy of ``repro/serve/prefix_cache.py``.

Requests in a serving mix frequently share long prompt prefixes (system
prompts, few-shot preambles, chat history).  The engine's chunked prefill
already works in ``page_len`` units, so a completed full-page chunk is a
natural cache entry: its KV rows are a pure function of the token chunk
*and everything before it*.  This module keeps that index on the host —
a radix-style tree over chunk chain-hashes — while the page payloads live
in a device-side pool owned by the engine (``ServeEngine`` copies pages
pool<->slot in place on its device).

Keying: a page is identified by ``sha1(parent_key || chunk_tokens)``, so
the key commits to the whole prefix, not just the local chunk — two
prompts sharing a chunk mid-stream but differing earlier never collide.
The root sentinel ``ROOT`` anchors chains.

Eviction is refcount + LRU, **leaves only**: a node may be evicted only
when no slot holds it (``refcount == 0``) and it has no children.  That
keeps the tree closed under parent-presence — every cached node's full
chain is cached — so ``lookup`` can always walk from ROOT.  When the pool
is exhausted and nothing is evictable, ``insert`` returns ``(None,
False)`` and the engine stops inserting for that slot (preserving the
same invariant from the writer side).

Pure host bookkeeping on numpy: no device code.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

ROOT = "root"


def chunk_key(parent_key: str, chunk: np.ndarray) -> str:
    """Chain hash: commits to the full prefix through ``parent_key``."""
    h = hashlib.sha1(parent_key.encode())
    h.update(np.ascontiguousarray(chunk, dtype=np.int32).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class PageNode:
    key: str
    parent: str                # parent node key, or ROOT
    pool_idx: int              # page index in the engine's device pool
    refcount: int = 0          # slots currently holding this page
    children: int = 0          # cached nodes chained on this one
    last_use: int = 0          # LRU clock at last acquire/insert


class PrefixCache:
    """Refcounted radix index mapping chunk chains to pool page indices."""

    def __init__(self, pool_pages: int, page_len: int):
        if pool_pages <= 0:
            raise ValueError("prefix cache needs pool_pages > 0")
        self.pool_pages = pool_pages
        self.page_len = page_len
        self.nodes: Dict[str, PageNode] = {}
        self.free: List[int] = list(range(pool_pages - 1, -1, -1))
        self._clock = 0
        # counters (surfaced through ServeEngine.stats)
        self.lookups = 0
        self.hits = 0
        self.pages_reused = 0
        self.inserts = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, tokens: np.ndarray, max_pages: int) -> List[PageNode]:
        """Longest cached page-aligned prefix of ``tokens``, as the chain of
        nodes from ROOT.  ``max_pages`` caps the walk (the engine passes
        ``(prompt_len - 1) // page_len`` so at least one real prefill chunk
        remains to produce last-token logits)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        self.lookups += 1
        chain: List[PageNode] = []
        key = ROOT
        P = self.page_len
        for i in range(max_pages):
            nxt = chunk_key(key, tokens[i * P:(i + 1) * P])
            node = self.nodes.get(nxt)
            if node is None:
                break
            chain.append(node)
            key = nxt
        if chain:
            self.hits += 1
            self.pages_reused += len(chain)
        return chain

    def acquire(self, chain: List[PageNode]) -> None:
        now = self._tick()
        for node in chain:
            node.refcount += 1
            node.last_use = now

    def release(self, chain: List[PageNode]) -> None:
        for node in chain:
            if node.refcount <= 0:
                raise RuntimeError(f"double release of page {node.key}")
            node.refcount -= 1

    # ------------------------------------------------------------------
    def _evict_one(self) -> Optional[int]:
        """Free the least-recently-used unreferenced leaf; its pool index."""
        victim = None
        for node in self.nodes.values():
            if node.refcount == 0 and node.children == 0:
                if victim is None or node.last_use < victim.last_use:
                    victim = node
        if victim is None:
            return None
        del self.nodes[victim.key]
        if victim.parent != ROOT:
            self.nodes[victim.parent].children -= 1
        self.evictions += 1
        return victim.pool_idx

    def insert(self, parent_key: str,
               chunk: np.ndarray) -> Tuple[Optional[PageNode], bool]:
        """Register a freshly prefetched full page chained on ``parent_key``.

        Returns ``(node, fresh)``; the node comes back acquired (one
        refcount for the calling slot) either way.  ``fresh=True`` means
        the caller must copy the page slot->pool; ``fresh=False`` means an
        identical chain already holds it.  ``(None, False)`` means the
        pool is full of held/interior pages — stop inserting for this
        chain (a dangling child would break the parent-presence
        invariant)."""
        if parent_key != ROOT and parent_key not in self.nodes:
            raise KeyError(f"parent {parent_key} not cached")
        key = chunk_key(parent_key, chunk)
        node = self.nodes.get(key)
        now = self._tick()
        if node is not None:
            node.refcount += 1
            node.last_use = now
            return node, False
        if self.free:
            pool_idx = self.free.pop()
        else:
            pool_idx = self._evict_one()
            if pool_idx is None:
                return None, False
        node = PageNode(key=key, parent=parent_key, pool_idx=pool_idx,
                        refcount=1, last_use=now)
        self.nodes[key] = node
        if parent_key != ROOT:
            self.nodes[parent_key].children += 1
        self.inserts += 1
        return node, True

    # ------------------------------------------------------------------
    @property
    def pool_used(self) -> int:
        return self.pool_pages - len(self.free)

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_lookups": self.lookups,
            "prefix_hits": self.hits,
            "prefix_hit_rate": self.hits / self.lookups if self.lookups else 0.0,
            "prefix_pages_reused": self.pages_reused,
            "prefix_inserts": self.inserts,
            "prefix_evictions": self.evictions,
            "prefix_pool_used": self.pool_used,
            "prefix_pool_pages": self.pool_pages,
        }
