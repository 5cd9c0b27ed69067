"""Content-addressed, reference-counted KV pages with radix-trie lookup.

Millions-of-users serving traffic is dominated by long shared system
prompts: two requests that start with the same tokens compute the same
keys and values for those positions (causal attention — K/V at position
``i`` depends only on token ``i`` and its rotary phase, never on what
comes after), so the KV pages for a shared prefix can be written once
and *read* by every slot that carries that prefix.  This module owns the
page pool and the sharing bookkeeping; the engine asks it two questions:

``admit(slot, prompt)``
    Walk the radix trie for the longest cached prefix of ``prompt``
    (whole ``page_size``-token chunks only — a page is the unit of
    sharing), pin every matched page with a reference, allocate private
    pages for the rest of the slot's sequence range, and *donate* the
    not-yet-cached full prompt chunks into the trie so the NEXT request
    with this prompt hits them.  Returns an :class:`Admission` whose
    ``page_row`` is the slot's page table — the backend gathers KV
    through it, so shared pages are read in place, never copied.

``release(slot)``
    Drop the slot's references.  Shared/donated pages stay resident
    (refcount may still be held by other slots or by the trie itself)
    and become LRU-evictable once nothing references them; private
    decode pages return to the free list immediately.

Eviction is leaf-only: a trie node's page can be dropped only when no
slot references it AND it has no children (an interior page being freed
would orphan the chunks hashed below it).  Evicting a leaf exposes its
parent as the new leaf, so memory pressure peels cached prefixes from
the tail back — exactly the order in which they stop being useful.
Capacity is sized so allocation can never fail: the pool holds one
scratch page (page 0 — inactive slots point at it) + ``num_slots *
pages_per_slot`` working pages + ``cache_pages`` of slack, and a slot
needs at most ``pages_per_slot`` pages, so the free list plus refs==0
leaves always cover a worst-case admission.

The cache is a *logical* allocator: it hands out integer page ids and
tracks sharing, while the arrays those ids index live in a paged backend
— or nowhere at all for the StubBackend, which uses the same admission
bookkeeping to model TTFT savings without materialising KV.

Own copy of ``horovod_tpu/serving/prefix_cache.py``: pure Python, kept
identical so the two engines admit the same way.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Admission", "PrefixCache"]


@dataclass
class _Node:
    """One radix-trie edge: ``chunk`` (a ``page_size`` token tuple) maps
    to one cached page.  ``refs`` counts live slots reading the page;
    ``stamp`` is the LRU clock (bumped on every hit)."""

    chunk: tuple
    pid: int
    parent: "_Node | None"
    refs: int = 0
    stamp: int = 0
    children: dict = field(default_factory=dict)


@dataclass(frozen=True)
class Admission:
    """What a slot got at admission time.

    ``prefix_len``    tokens served from cache (multiple of page_size;
                      always < len(prompt) so at least one suffix token
                      goes through prefill and yields the first logits).
    ``page_row``      the slot's full page table row, pages_per_slot
                      ids — shared prefix pages first, then private.
    ``shared``        trie nodes the slot holds a read reference on.
    ``donated``       trie nodes this admission created from its own
                      prompt chunks (the slot holds their first ref;
                      their content becomes valid when the engine's
                      synchronous prefill writes them).
    ``private``       page ids owned exclusively by this slot.
    """

    prefix_len: int
    page_row: tuple
    shared: tuple
    donated: tuple
    private: tuple


class PrefixCache:
    """Radix-trie prefix cache over a fixed pool of KV page ids."""

    def __init__(self, num_slots: int, pages_per_slot: int,
                 cache_pages: int, page_size: int):
        if num_slots < 1 or pages_per_slot < 1 or page_size < 1:
            raise ValueError("num_slots, pages_per_slot, page_size >= 1")
        if cache_pages < 0:
            raise ValueError("cache_pages must be >= 0")
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.num_pages = 1 + num_slots * pages_per_slot + cache_pages
        self._free = list(range(self.num_pages - 1, 0, -1))  # pop() -> 1..
        self._root = _Node(chunk=(), pid=0, parent=None)
        self._by_slot: dict = {}
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0

    # -- admission ---------------------------------------------------

    def lookup(self, prompt) -> int:
        """Longest cached prefix of ``prompt`` in tokens — read-only (no
        refs taken, no LRU bump).  The engine uses this to size the
        suffix bucket before committing via :meth:`admit`."""
        prompt = tuple(int(t) for t in prompt)
        ps = self.page_size
        hit, node = 0, self._root
        while hit // ps < (len(prompt) - 1) // ps:
            child = node.children.get(prompt[hit:hit + ps])
            if child is None:
                break
            hit += ps
            node = child
        return hit

    def admit(self, slot: int, prompt,
              max_prefix_len: int | None = None) -> Admission:
        """Pin the longest cached prefix of ``prompt`` for ``slot`` and
        lay out its page table row.  ``max_prefix_len`` caps the match
        (the engine shrinks a hit whose suffix bucket would overflow the
        slot's sequence range).  The engine must prefill the suffix
        (``prompt[prefix_len:]``) before the next admission so donated
        chunks hold real KV by the time anyone else matches them."""
        if slot in self._by_slot:
            raise RuntimeError(f"slot {slot} already admitted")
        prompt = tuple(int(t) for t in prompt)
        self.lookups += 1
        self._clock += 1
        ps = self.page_size
        # Longest match must leave >= 1 prompt token for the suffix
        # prefill (the first sampled token comes from its logits), so a
        # fully-cached prompt deliberately re-prefills its last chunk.
        full_chunks = (len(prompt) - 1) // ps
        match_chunks = full_chunks if max_prefix_len is None else \
            min(full_chunks, max_prefix_len // ps)
        shared, node = [], self._root
        while len(shared) < match_chunks:
            off = len(shared) * ps
            child = node.children.get(prompt[off:off + ps])
            if child is None:
                break
            child.refs += 1
            child.stamp = self._clock
            shared.append(child)
            node = child
        prefix_len = len(shared) * ps
        if shared:
            self.hits += 1
            self.hit_tokens += prefix_len
        # Donate the remaining full prompt chunks: create trie nodes
        # (slot holds their initial ref) so the next admission with the
        # same prompt reads them instead of re-prefilling.  Donation
        # runs to the full chunk count even when the *match* was capped:
        # the suffix prefill writes every position from prefix_len to
        # the end of the prompt, so all of these chunks hold valid KV
        # once it lands.  A chunk that already exists below the current
        # node can only appear when the match was capped short of it;
        # re-prefilling into a page other slots may be reading is not
        # guaranteed bit-stable (a different suffix bucket is a
        # different program), so donation stops there and private pages
        # carry the rest of the range.
        donated = []
        for ci in range(len(shared), full_chunks):
            off = ci * ps
            chunk = prompt[off:off + ps]
            if chunk in node.children:
                break
            child = _Node(chunk=chunk, pid=self._alloc(), parent=node,
                          refs=1, stamp=self._clock)
            node.children[chunk] = child
            donated.append(child)
            node = child
        # Private pages cover the rest of the slot's sequence range
        # (suffix prefill tail + decode growth).
        used = len(shared) + len(donated)
        private = [self._alloc() for _ in range(self.pages_per_slot - used)]
        row = tuple([n.pid for n in shared] + [n.pid for n in donated]
                    + private)
        adm = Admission(prefix_len=prefix_len, page_row=row,
                        shared=tuple(shared), donated=tuple(donated),
                        private=tuple(private))
        self._by_slot[slot] = adm
        return adm

    def release(self, slot: int) -> None:
        adm = self._by_slot.pop(slot, None)
        if adm is None:
            return
        for node in adm.shared + adm.donated:
            if node.refs <= 0:
                raise RuntimeError(
                    f"refcount underflow on page {node.pid}")
            node.refs -= 1
        self._free.extend(reversed(adm.private))

    # -- allocation / eviction ---------------------------------------

    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        victim = self._lru_leaf()
        if victim is None:  # unreachable by the capacity invariant
            raise RuntimeError("prefix cache page pool exhausted")
        self.evictions += 1
        del victim.parent.children[victim.chunk]
        return victim.pid

    def _lru_leaf(self):
        """Oldest trie node with no children and no live readers."""
        best, stack = None, [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node.children or node.refs > 0:
                continue
            if best is None or node.stamp < best.stamp:
                best = node
        return best

    # -- introspection ------------------------------------------------

    def resident_pages(self) -> int:
        """Pages currently held by the trie (cached prefix chunks)."""
        count, stack = 0, [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            count += node is not self._root
        return count

    def stats(self) -> dict:
        return {"lookups": self.lookups, "hits": self.hits,
                "hit_tokens": self.hit_tokens,
                "evictions": self.evictions,
                "resident_pages": self.resident_pages(),
                "free_pages": len(self._free)}
