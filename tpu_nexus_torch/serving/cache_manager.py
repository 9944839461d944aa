"""KV-cache management: slot and block allocators over the fixed-shape cache.

Two granularities, one admission contract:

**Slots** (:class:`KVSlotManager`): the decode cache is one ``[L,
num_slots, max_len, Hkv, D]`` buffer (the ``models/generate`` layout with
the batch axis reinterpreted as SLOTS).  A slot is the unit of admission:
a request owns exactly one slot row from prefill-insert to retirement, its
live tokens occupy the contiguous prefix ``[0, cursor)``, and a freed slot
is reused verbatim — the next prefill insert overwrites the whole row, so
no zeroing pass is needed between tenants.

**Blocks** (:class:`KVBlockManager` + :class:`PrefixIndex`, composed by
:class:`PagedCacheManager`): the paged cache is one ``[L, num_blocks,
page_size, Hkv, D]`` buffer.  A request still owns one slot (its decode
batch lane) but its KV rows live in ``page_size``-token BLOCKS mapped by a
per-slot block table, so HBM occupancy is ``actual tokens``, not ``slots ×
max_len`` — the PagedAttention layout (Kwon et al., SOSP'23).  Blocks are
ref-counted: a radix-style prefix trie maps token-id prefixes to cached
block chains, so a request whose prompt extends a cached prefix SHARES the
matching full blocks (prefilled exactly once, RadixAttention-style) and
copies-on-write the first block it diverges into.  Block 0 is the
reserved SCRATCH block — the garbage sink for right-pad scatter writes and
dead decode lanes; it is never allocated and never read unmasked.

All allocators here are deliberately pure host-side Python: the
randomized invariant tests drive hundreds of admission/eviction/COW
scenarios without touching a device.  :func:`init_cache` /
:func:`init_paged_cache` are the torch-aware pieces — they allocate the
buffers on an explicit device, int8-KV aware (int8 values + per-slot f32
scales, the ``models/generate`` cache contract).

A copy of ``tpu_nexus/serving/cache_manager.py`` (the host allocators
verbatim).  A sharded cache (``shardings``, serving/sharded.py's
``kv_cache_sharding``) is allocated per rank: each rank holds ``Hkv / tp``
heads of every slot or block, while ``num_blocks`` stays a global count,
so the admission arithmetic is the same on every mesh.
"""

from __future__ import annotations

import heapq
import itertools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


class SlotError(RuntimeError):
    """Slot accounting violation (double-free, free of an unowned slot) —
    an engine bug surfaced loudly, never a recoverable traffic condition."""


def _kv_shard_count(shardings: Any, cfg: Any) -> int:
    """How many ways ``shardings`` (serving/sharded.py's KV cache sharding:
    a spec over both cache layouts and the mesh it names) splits the
    KV-HEAD axis, dim 3 of both layouts; 1 when that dim is unsharded."""
    spec = getattr(shardings, "spec", None)
    mesh = getattr(shardings, "mesh", None)
    if spec is None or mesh is None:
        raise TypeError(
            f"shardings must be a KV cache sharding (serving/sharded.py: kv_cache_sharding), "
            f"got {type(shardings).__name__}"
        )
    if len(spec) <= 3 or spec[3] is None:
        return 1
    axes = spec[3] if isinstance(spec[3], tuple) else (spec[3],)
    n = 1
    for axis in axes:
        n *= mesh.axis_sizes[axis]
    return n


def _alloc_cache(kv_shape: tuple, cfg: Any, kv_quant: str, shardings: Any, device: Any):
    """Allocate the zeroed cache dict on ``device``.  Under ``shardings``
    the dict is this rank's part: ``Hkv / shards`` heads of every slot or
    block (kv-head divisibility is checked here)."""
    import torch

    if shardings is not None:
        shards = _kv_shard_count(shardings, cfg)
        if cfg.n_kv_heads % shards:
            raise ValueError(
                f"KV cache sharding splits the kv-head axis {shards} ways but "
                f"the model has {cfg.n_kv_heads} KV heads — not divisible; "
                "shrink the tp axis or pick a head count it divides"
            )
        kv_shape = kv_shape[:3] + (kv_shape[3] // shards,) + kv_shape[4:]
    if kv_quant == "int8":
        scale_shape = kv_shape[:-1] + (1,)
        return {
            "k": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "v": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(scale_shape, dtype=torch.float32, device=device),
            "v_s": torch.zeros(scale_shape, dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
    }


def init_cache(
    cfg: Any, num_slots: int, max_len: int, kv_quant: str = "", shardings: Any = None,
    device: Any = "cuda",
):
    """Zero-initialized decode cache ``{"k","v"[,"k_s","v_s"]}`` shaped
    ``[L, num_slots, max_len, Hkv, D]`` (scales ``[..., 1]`` f32), matching
    what :func:`tpu_nexus_torch.models.generate.prefill` emits row-for-row
    so a per-request prefill inserts with one slice copy, on ``device``.
    ``shardings``: this rank's heads only (see :func:`_alloc_cache`)."""
    if kv_quant not in ("", "int8"):
        raise ValueError(f"unknown kv_quant mode {kv_quant!r}; use 'int8' or ''")
    if num_slots < 1:
        raise ValueError(f"num_slots must be >= 1, got {num_slots}")
    if max_len < 2:
        raise ValueError(
            f"max_len must be >= 2 (one prompt + one generated token), got {max_len}"
        )
    kv_shape = (cfg.n_layers, num_slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    return _alloc_cache(kv_shape, cfg, kv_quant, shardings, device)


def init_paged_cache(
    cfg: Any, num_blocks: int, page_size: int, kv_quant: str = "", shardings: Any = None,
    device: Any = "cuda",
):
    """Zero-initialized PAGED decode cache ``{"k","v"[,"k_s","v_s"]}``
    shaped ``[L, num_blocks, page_size, Hkv, D]`` (scales ``[..., 1]``
    f32).  Block 0 is the reserved scratch block (see module doc); the
    usable token capacity is ``(num_blocks - 1) * page_size``.  On
    ``device``; ``shardings`` as in :func:`init_cache`."""
    if kv_quant not in ("", "int8"):
        raise ValueError(f"unknown kv_quant mode {kv_quant!r}; use 'int8' or ''")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (scratch block 0 + one usable), got {num_blocks}"
        )
    kv_shape = (cfg.n_layers, num_blocks, page_size, cfg.n_kv_heads, cfg.head_dim)
    return _alloc_cache(kv_shape, cfg, kv_quant, shardings, device)


class KVSlotManager:
    """Free-list slot allocator with ownership + admission-order tracking.

    Allocation order is deterministic (lowest free slot id first) so
    engine runs replay exactly under a fixed seed.  The eviction candidate
    is the YOUNGEST busy slot (least sunk decode work lost), consumed by
    the scheduler's starvation guard when no slot frees up for a bounded
    number of steps.  NOTE: unlike vLLM preemption, eviction here is
    TERMINAL — the victim retires EVICTED with its partial output
    delivered and is NOT re-queued (re-queueing with a starvation guard
    can ping-pong two requests through one slot forever); the client owns
    the retry.
    """

    def __init__(self, num_slots: int, max_len: int) -> None:
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.max_len = max_len
        self._free: List[int] = list(range(num_slots))  # min-heap: lowest id first
        #: slot -> owning request_id, in admission order (oldest first)
        self._owner: "OrderedDict[int, str]" = OrderedDict()
        #: slot -> recorded live token count (OPTIONAL — populated by the
        #: speculative engine so rollback is auditable; the plain decode
        #: path never records and verify_consistent tolerates absence)
        self._len: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._owner)

    def occupancy(self) -> float:
        return self.used_count / self.num_slots

    def fits(self, total_len: int) -> bool:
        """Can a request needing ``total_len`` cache rows ever run here?"""
        return total_len <= self.max_len

    def owner(self, slot: int) -> Optional[str]:
        return self._owner.get(slot)

    def owners(self) -> Dict[int, str]:
        return dict(self._owner)

    def allocate(self, request_id: str) -> Optional[int]:
        """Claim the lowest free slot id for ``request_id`` (min-heap, so
        the claim holds across out-of-order frees); None when full."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._owner[slot] = request_id
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._owner:
            raise SlotError(f"slot {slot} is not allocated (double free?)")
        del self._owner[slot]
        self._len.pop(slot, None)
        heapq.heappush(self._free, slot)

    def set_length(self, slot: int, n: int) -> None:
        """Record ``slot``'s live token count — the KV write high-water
        mark the speculative engine audits rollback against.  Recording is
        opt-in: the plain decode path never calls this and pays nothing."""
        if slot not in self._owner:
            raise SlotError(f"set_length of unallocated slot {slot}")
        if not 0 <= n <= self.max_len:
            raise SlotError(
                f"slot {slot} length {n} outside [0, max_len={self.max_len}]"
            )
        self._len[slot] = n

    def length(self, slot: int) -> Optional[int]:
        return self._len.get(slot)

    def truncate(self, slot: int, new_len: int) -> int:
        """Roll back ``slot``'s recorded live length to ``new_len``
        (speculative verify rejected a draft suffix: the KV rows above the
        clamped cursor are garbage the mask never reads).  Shrink-only —
        growing through truncate means the caller's cursor accounting went
        backwards, an engine bug surfaced loudly.  Returns the number of
        rolled-back rows."""
        if slot not in self._owner:
            raise SlotError(f"truncate of unallocated slot {slot}")
        current = self._len.get(slot)
        if current is None:
            raise SlotError(
                f"truncate of slot {slot} with no recorded length — "
                "set_length the write high-water mark first"
            )
        if not 0 <= new_len <= current:
            raise SlotError(
                f"truncate of slot {slot} to {new_len} outside [0, "
                f"recorded {current}] — rollback can only shrink"
            )
        self._len[slot] = new_len
        return current - new_len

    def eviction_candidate(self) -> Optional[int]:
        """Youngest busy slot (most recent admission), or None when idle."""
        return next(reversed(self._owner), None)

    def verify_consistent(self) -> None:
        """Audit the allocator's internal invariants: free ∪ owned is an
        exact partition of ``range(num_slots)`` (no leak, no overlap, no
        phantom id) and no request owns two slots.  Raises :class:`SlotError`
        on violation.  Pure host-side and O(num_slots) — the serving chaos
        fuzz calls it after EVERY engine step, so an accounting bug surfaces
        at the step that introduced it, not at drain time."""
        free = set(self._free)
        owned = set(self._owner)
        if len(free) != len(self._free):
            raise SlotError(f"free list holds duplicates: {sorted(self._free)}")
        if free & owned:
            raise SlotError(f"slots both free and owned: {sorted(free & owned)}")
        expected = set(range(self.num_slots))
        if free | owned != expected:
            raise SlotError(
                f"slot leak/phantom: free {sorted(free)} + owned {sorted(owned)} "
                f"!= {self.num_slots} slots"
            )
        owners = list(self._owner.values())
        if len(set(owners)) != len(owners):
            raise SlotError(f"request owns multiple slots: {owners}")
        stray = set(self._len) - owned
        if stray:
            raise SlotError(f"lengths recorded for unowned slots: {sorted(stray)}")
        for slot, n in self._len.items():
            if not 0 <= n <= self.max_len:
                raise SlotError(
                    f"slot {slot} recorded length {n} outside [0, {self.max_len}]"
                )


# -- paged KV: blocks, prefix sharing, copy-on-write ---------------------------

#: physical block 0 is reserved as the garbage sink: right-pad scatter
#: writes and dead decode lanes land here, block tables pad with it, and
#: every read of it is masked out.  It is never allocated, never
#: ref-counted, never indexed.
SCRATCH_BLOCK = 0


class BlockError(RuntimeError):
    """Block accounting violation (double free, COW of an exclusive block,
    allocation past capacity the admission gate promised) — an engine bug
    surfaced loudly, never a recoverable traffic condition."""


class KVBlockManager:
    """Ref-counted free-list allocator over the physical block axis.

    A block's refcount is the number of request block-tables referencing
    it plus one if the prefix index caches it; blocks return to the free
    list exactly when the count reaches zero.  ``reserve`` earmarks free
    blocks for a request's future copy-on-write (a request admitted onto a
    shared partial block is GUARANTEED its divergence copy — admission
    pays for it up front, so COW can never fail mid-flight).  Allocation
    order is deterministic (lowest free block id first, min-heap) so
    engine runs replay exactly under a fixed seed."""

    def __init__(self, num_blocks: int, page_size: int) -> None:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (scratch block 0 + one usable), "
                f"got {num_blocks}"
            )
        self.num_blocks = num_blocks
        self.page_size = page_size
        #: min-heap of free PHYSICAL block ids (block 0 excluded: scratch)
        self._free: List[int] = list(range(1, num_blocks))
        self._ref: Dict[int, int] = {}  # block -> refcount (absent == free)
        self._owned: Dict[str, List[int]] = {}  # request -> referenced blocks
        self._indexed: set = set()  # blocks the prefix index holds a ref on
        self._reserved: Dict[str, int] = {}  # request -> outstanding COW credits
        self.reserved_total = 0

    @property
    def usable(self) -> int:
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.usable - len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def request_blocks(self, request_id: str) -> List[int]:
        return list(self._owned.get(request_id, []))

    def owns(self, request_id: str) -> bool:
        return request_id in self._owned or request_id in self._reserved

    def _take(self) -> int:
        if not self._free:
            raise BlockError("out of KV blocks (free list empty)")
        block = heapq.heappop(self._free)
        self._ref[block] = 1
        return block

    def _decref(self, block: int) -> None:
        count = self._ref.get(block, 0)
        if count < 1:
            raise BlockError(f"decref of unreferenced block {block} (double free?)")
        if count == 1:
            if block in self._indexed:
                raise BlockError(
                    f"block {block} reached refcount 0 while still indexed"
                )
            del self._ref[block]
            heapq.heappush(self._free, block)
        else:
            self._ref[block] = count - 1

    def allocate(self, request_id: str, n: int) -> List[int]:
        """Claim ``n`` fresh exclusive blocks for ``request_id``.  Raises
        :class:`BlockError` when granting them would eat into OTHER
        requests' COW reservations — the admission gate (``can_admit``)
        must have checked availability first."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        headroom = len(self._free) - self.reserved_total
        if n > headroom:
            raise BlockError(
                f"allocate({n}) for {request_id} exceeds headroom {headroom} "
                f"({len(self._free)} free, {self.reserved_total} reserved)"
            )
        blocks = [self._take() for _ in range(n)]
        self._owned.setdefault(request_id, []).extend(blocks)
        return blocks

    def share(self, request_id: str, blocks: Sequence[int]) -> None:
        """Reference already-live blocks (a cached prefix chain) from
        ``request_id``'s table — the zero-copy half of prefix reuse."""
        owned = self._owned.setdefault(request_id, [])
        for block in blocks:
            if self._ref.get(block, 0) < 1:
                raise BlockError(f"share of unreferenced block {block}")
            self._ref[block] += 1
            owned.append(block)

    def reserve(self, request_id: str, n: int = 1) -> None:
        """Earmark ``n`` free blocks for ``request_id``'s future COW."""
        self._reserved[request_id] = self._reserved.get(request_id, 0) + n
        self.reserved_total += n

    def cow(self, request_id: str, src: int) -> int:
        """Copy-on-write: replace shared ``src`` in ``request_id``'s table
        with a fresh exclusive block (consuming the request's reservation)
        and drop the reference on ``src``.  Returns the destination block;
        the caller owns the device copy.  Raises on a non-shared source —
        writing an exclusive block needs no copy, and asking for one means
        the caller's sharing bookkeeping is wrong."""
        owned = self._owned.get(request_id, [])
        if src not in owned:
            raise BlockError(f"cow: request {request_id} does not reference {src}")
        if self._ref.get(src, 0) < 2:
            raise BlockError(f"cow of exclusively-owned block {src}")
        if self._reserved.get(request_id, 0) > 0:
            self._reserved[request_id] -= 1
            if not self._reserved[request_id]:
                del self._reserved[request_id]
            self.reserved_total -= 1
        dst = self._take()
        owned[owned.index(src)] = dst
        self._decref(src)
        return dst

    def truncate_request(self, request_id: str, keep: int) -> List[int]:
        """Drop ``request_id``'s block references past the first ``keep``
        (logical order — ``_owned`` lists blocks in table order: shared
        prefix first, exclusive tail after, COW replaces in place).  The
        speculative-rollback primitive: a verify overshoot wrote only
        rejected garbage into the tail blocks, so they return to the free
        list.  Every dropped block must be EXCLUSIVE (refcount 1, not
        indexed): decode-region blocks always are, and truncating a
        shared/indexed block would hand cached prefix KV back to the
        allocator — an engine bug surfaced loudly.  Returns the dropped
        physical blocks, in logical order."""
        owned = self._owned.get(request_id, [])
        if not 0 <= keep <= len(owned):
            raise BlockError(
                f"truncate of {request_id} to {keep} blocks outside "
                f"[0, {len(owned)} owned]"
            )
        dropped = owned[keep:]
        for block in dropped:
            if block in self._indexed or self._ref.get(block, 0) != 1:
                raise BlockError(
                    f"truncate of {request_id} would release shared/indexed "
                    f"block {block} (refcount {self._ref.get(block, 0)}) — "
                    "only exclusive decode-tail blocks roll back"
                )
        for block in dropped:
            self._decref(block)
        del owned[keep:]
        if not owned:
            self._owned.pop(request_id, None)
        return dropped

    def reclaim(self, request_id: str, n: int) -> List[int]:
        """Re-grow ``request_id``'s tail by ``n`` fresh exclusive blocks,
        CONSUMING its own reservation credits — the regrowth half of
        speculative rollback.  Truncated blocks were returned to the free
        list but earmarked (``reserve``), so this can never fail against
        concurrent admissions: the credits were excluded from every
        ``can_admit`` headroom in between."""
        if n < 0:
            raise ValueError(f"cannot reclaim {n} blocks")
        credits = self._reserved.get(request_id, 0)
        if n > credits:
            raise BlockError(
                f"reclaim({n}) for {request_id} exceeds its {credits} "
                "reservation credits — regrowth must be covered by a prior "
                "truncate/reserve"
            )
        blocks = [self._take() for _ in range(n)]
        self._owned.setdefault(request_id, []).extend(blocks)
        if n:
            self._reserved[request_id] = credits - n
            if not self._reserved[request_id]:
                del self._reserved[request_id]
            self.reserved_total -= n
        return blocks

    def index_ref(self, block: int) -> None:
        """The prefix index caches ``block`` (one extra reference)."""
        if block in self._indexed:
            raise BlockError(f"block {block} already indexed")
        if self._ref.get(block, 0) < 1:
            raise BlockError(f"index_ref of unreferenced block {block}")
        self._indexed.add(block)
        self._ref[block] += 1

    def index_unref(self, block: int) -> None:
        """Prefix-index eviction IS a refcount drop: the block returns to
        the free list iff no live request still references it."""
        if block not in self._indexed:
            raise BlockError(f"index_unref of unindexed block {block}")
        self._indexed.discard(block)
        self._decref(block)

    def release_request(self, request_id: str) -> None:
        """Drop every reference (and unused COW reservation) held by
        ``request_id`` — retirement.  Blocks also cached by the prefix
        index survive (refcount >= 1); exclusive blocks free."""
        for block in self._owned.pop(request_id, []):
            self._decref(block)
        credits = self._reserved.pop(request_id, 0)
        self.reserved_total -= credits

    def verify_consistent(self) -> None:
        """Audit the allocator invariants (the block-granular mirror of
        :meth:`KVSlotManager.verify_consistent`): free ∪ referenced is an
        exact partition of the usable blocks, every refcount equals the
        number of request references plus index membership (refcount >= 1
        ⇔ referenced), reservations are non-negative and covered by the
        free list, and the scratch block is never tracked anywhere.
        O(num_blocks + table entries); the paged fuzz calls it after every
        engine step."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise BlockError(f"free list holds duplicates: {sorted(self._free)}")
        referenced = set(self._ref)
        if free & referenced:
            raise BlockError(f"blocks both free and referenced: {sorted(free & referenced)}")
        expected = set(range(1, self.num_blocks))
        if free | referenced != expected:
            raise BlockError(
                f"block leak/phantom: free {len(free)} + referenced "
                f"{len(referenced)} != {self.usable} usable blocks"
            )
        counts: Dict[int, int] = {}
        for request_id, blocks in self._owned.items():
            if len(set(blocks)) != len(blocks):
                raise BlockError(
                    f"request {request_id} references a block twice: {blocks}"
                )
            for block in blocks:
                counts[block] = counts.get(block, 0) + 1
        for block in self._indexed:
            counts[block] = counts.get(block, 0) + 1
        if counts != self._ref:
            raise BlockError(
                f"refcounts drifted from references: counted {counts} vs "
                f"recorded {self._ref}"
            )
        if any(c < 1 for c in self._ref.values()):
            raise BlockError(f"zero/negative refcount recorded: {self._ref}")
        if self.reserved_total != sum(self._reserved.values()) or any(
            c < 0 for c in self._reserved.values()
        ):
            raise BlockError(
                f"reservation drift: total {self.reserved_total} vs {self._reserved}"
            )
        if self.reserved_total > len(self._free):
            raise BlockError(
                f"{self.reserved_total} blocks reserved but only "
                f"{len(self._free)} free — a guaranteed COW would fail"
            )
        tracked = free | referenced | set(counts)
        if SCRATCH_BLOCK in tracked:
            raise BlockError("scratch block 0 entered the allocator")


@dataclass
class _TrieNode:
    """One cached full block: ``key`` is its ``page_size`` token ids,
    ``block`` the physical block holding their KV rows."""

    key: Tuple[int, ...]
    block: int
    parent: Optional["_TrieNode"]
    last_used: int = 0
    children: Dict[Tuple[int, ...], "_TrieNode"] = field(default_factory=dict)


@dataclass(frozen=True)
class PrefixProbe:
    """Result of a prefix lookup: ``full_blocks`` are cached blocks shared
    by reference (their tokens match the prompt exactly), ``partial_block``
    a cached block whose first ``shared_len - page_size*len(full_blocks)``
    tokens match (shared by copy-on-write), ``shared_len`` the total
    matched token count — always clamped to ``prompt_len - 1`` so at least
    one prompt token re-runs the forward and produces the first-token
    logits (KV is cached; hidden states are not)."""

    full_blocks: Tuple[int, ...]
    partial_block: Optional[int]
    shared_len: int


class PrefixIndex:
    """Radix-style trie over FULL prompt blocks: token-id prefixes →
    shared block chains (RadixAttention, Zheng et al. 2023, at block
    granularity).  A node is one cached block keyed by its ``page_size``
    token ids under its parent chain; lookup walks exact-matching full
    blocks, then picks the child with the longest in-block token LCP as a
    copy-on-write partial match.  Eviction is LRU over strippable leaves
    (refcount 1, i.e. index-only): dropping a node drops its refcount and
    the block frees — a pinned node (live request) blocks its ancestors'
    eviction, which is exactly prefix-closure."""

    def __init__(self, page_size: int) -> None:
        self.page_size = page_size
        self._root = _TrieNode(key=(), block=SCRATCH_BLOCK, parent=None)
        self._clock = itertools.count(1)
        self.node_count = 0

    def _touch(self, node: _TrieNode) -> None:
        node.last_used = next(self._clock)

    def lookup(self, prompt: Sequence[int], touch: bool = True) -> PrefixProbe:
        """Longest cached match for ``prompt`` (read-only apart from LRU
        touches); see :class:`PrefixProbe` for the clamp contract.

        ``touch=False`` makes the probe FULLY read-only: the fleet router
        probes every replica per request to score prefix affinity, and an
        affinity probe that refreshed LRU clocks would mark blocks recent
        on replicas the request never lands on, distorting eviction order
        exactly like the transient-leader touches the scan below avoids."""
        tokens = [int(t) for t in prompt]
        limit = len(tokens) - 1  # >= 1 tail token must re-prefill for logits
        ps = self.page_size
        full: List[int] = []
        node = self._root
        pos = 0
        while pos + ps <= limit:
            child = node.children.get(tuple(tokens[pos : pos + ps]))
            if child is None:
                break
            full.append(child.block)
            if touch:
                self._touch(child)
            node = child
            pos += ps
        partial: Optional[int] = None
        winner: Optional[_TrieNode] = None
        lcp = 0
        if pos < limit:
            window = tokens[pos : pos + ps]
            cap = limit - pos
            for key, child in node.children.items():
                n = 0
                for have, cached in zip(window, key):
                    if have != cached:
                        break
                    n += 1
                n = min(n, cap)
                if n > lcp:
                    lcp, partial, winner = n, child.block, child
        if winner is not None and touch:
            # touch only the WINNING candidate: refreshing transient
            # leaders of the LCP scan would mark never-shared blocks
            # recent on every probe and distort the LRU eviction order
            self._touch(winner)
        return PrefixProbe(
            full_blocks=tuple(full), partial_block=partial, shared_len=pos + lcp
        )

    def register(
        self, prompt: Sequence[int], block_row: Sequence[int], manager: KVBlockManager
    ) -> int:
        """Cache ``prompt``'s FULL blocks (their KV is complete and
        deterministic in the token prefix) under the trie, taking one
        index reference per NEWLY created node; existing nodes keep their
        original block (first writer wins — both hold identical KV).
        Returns the number of new nodes.  Called only after the prefill
        that filled the blocks succeeded."""
        tokens = [int(t) for t in prompt]
        ps = self.page_size
        node = self._root
        created = 0
        for j in range(len(tokens) // ps):
            key = tuple(tokens[j * ps : (j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                block = int(block_row[j])
                if block == SCRATCH_BLOCK:
                    raise BlockError(
                        f"register: prompt block {j} maps to the scratch block"
                    )
                child = _TrieNode(key=key, block=block, parent=node)
                node.children[key] = child
                manager.index_ref(block)
                self.node_count += 1
                created += 1
            self._touch(child)
            node = child
        return created

    def _nodes(self) -> List[_TrieNode]:
        out: List[_TrieNode] = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            out.append(node)
            stack.extend(node.children.values())
        return out

    def reclaimable(
        self, manager: KVBlockManager, pinned: Optional[set] = None
    ) -> int:
        """Blocks a full LRU eviction cascade could free RIGHT NOW: nodes
        whose block is index-only (refcount 1) and whose whole subtree is
        too — a pinned descendant blocks its ancestors, so interior nodes
        above live requests are not counted (the admission gate must not
        overpromise).  ``pinned`` marks blocks the CALLER is about to
        share (an admission's cached prefix chain): they count as live
        even though their refcount is still 1, because the admission pins
        them before it evicts — crediting them as BOTH shareable and
        evictable would double-count the chain."""
        pinned = pinned or set()

        def walk(node: _TrieNode) -> Tuple[int, bool]:
            total, all_strip = 0, True
            for child in node.children.values():
                freed, strip = walk(child)
                total += freed
                all_strip &= strip
            if node is self._root:
                return total, all_strip
            if (
                all_strip
                and node.block not in pinned
                and manager.refcount(node.block) == 1
            ):
                return total + 1, True
            return total, False

        return walk(self._root)[0]

    def evict_until(self, manager: KVBlockManager, need_free: int) -> int:
        """Drop LRU strippable leaves until ``manager.free_count`` reaches
        ``need_free`` (or nothing evictable remains).  Eviction IS the
        refcount drop (docs/SERVING.md): the node leaves the trie and the
        block frees iff no live request still references it.  One DFS +
        a min-heap keyed by ``last_used`` (a parent joins the heap when
        its last child evicts), so reclaiming k blocks costs O(nodes +
        k log nodes), not k full traversals — and the common no-eviction
        admission returns before any traversal at all."""
        if manager.free_count >= need_free:
            return 0
        counter = itertools.count()
        heap: List[Tuple[int, int, _TrieNode]] = []

        def offer(node: _TrieNode) -> None:
            if (
                node is not self._root
                and not node.children
                and manager.refcount(node.block) == 1
            ):
                heapq.heappush(heap, (node.last_used, next(counter), node))

        for node in self._nodes():
            offer(node)
        evicted = 0
        while manager.free_count < need_free and heap:
            _, _, victim = heapq.heappop(heap)
            assert victim.parent is not None
            del victim.parent.children[victim.key]
            manager.index_unref(victim.block)
            self.node_count -= 1
            evicted += 1
            offer(victim.parent)
        return evicted

    def clear(self, manager: KVBlockManager) -> None:
        """Drop EVERY cached node (device block content was lost — e.g. a
        fault consumed the donated cache buffer and the executor
        reinstalled a zeroed one): a stale index would serve garbage KV as
        a prefix hit."""
        for node in self._nodes():
            manager.index_unref(node.block)
        self._root = _TrieNode(key=(), block=SCRATCH_BLOCK, parent=None)
        self.node_count = 0


@dataclass(frozen=True)
class AdmitPlan:
    """Block-table row + prefill split for one admitted request:
    ``block_row`` is the full logical→physical row (length
    ``blocks_per_slot``, tail padded with :data:`SCRATCH_BLOCK`),
    ``n_blocks`` how many leading entries are real, ``tail_start`` the
    first prompt position the engine must actually prefill (0 = no prefix
    hit, run the full prefill), ``shared_tokens`` how many prompt tokens
    were served from cache (full-block references + the partial block's
    LCP rows)."""

    block_row: List[int]
    n_blocks: int
    tail_start: int
    shared_tokens: int
    partial_block: Optional[int]


class PagedCacheManager:
    """The paged-serving facade the engine drives: block allocation,
    prefix sharing, copy-on-write, and eviction composed behind four
    calls — ``can_admit`` (the scheduler's block-availability gate),
    ``admit`` (build the block-table row, pinning shared chains and
    reserving the COW copy), ``prepare_write`` (COW any shared block a
    write is about to land in), ``release`` (retirement).  Pure host-side;
    the device copies it schedules are returned to the caller."""

    def __init__(self, num_blocks: int, page_size: int, max_len: int) -> None:
        self.manager = KVBlockManager(num_blocks, page_size)
        self.index = PrefixIndex(page_size)
        self.page_size = page_size
        self.max_len = max_len
        #: logical row length: every slot's table is padded to this, so the
        #: decode step's gather/index-map shapes stay static
        self.blocks_per_slot = -(-max_len // page_size)
        #: bumped by :meth:`reset` — an :class:`AdmitPlan` built before a
        #: reset references device block content that no longer exists, so
        #: the engine re-plans any admission whose generation is stale
        self.generation = 0

    @property
    def usable_blocks(self) -> int:
        return self.manager.usable

    @property
    def used_blocks(self) -> int:
        return self.manager.used_count

    @property
    def token_capacity(self) -> int:
        return self.manager.usable * self.page_size

    def blocks_needed(self, total_len: int) -> int:
        return -(-total_len // self.page_size)

    def fits(self, total_len: int) -> bool:
        """Can a request needing ``total_len`` cache rows EVER run here?
        Bounded by both the slot row length and the whole block pool."""
        return total_len <= self.max_len and self.blocks_needed(total_len) <= self.manager.usable

    def can_admit(
        self,
        prompt: Sequence[int],
        total_len: int,
        probe: Optional[PrefixProbe] = None,
    ) -> bool:
        """Admission gate: enough blocks free (net of COW reservations) or
        reclaimable by LRU eviction, AFTER crediting the prompt's cached
        prefix.  The prefix chain is PINNED out of the reclaimable count:
        admission shares it before evicting, so a chain block can reduce
        ``need`` or count as evictable — never both.  ``probe`` lets the
        caller reuse one :meth:`PrefixIndex.lookup` across the
        gate-then-admit sequence instead of walking the trie twice."""
        if probe is None:
            probe = self.index.lookup(prompt)
        chain = set(probe.full_blocks)
        if probe.partial_block is not None:
            chain.add(probe.partial_block)
        need = self.blocks_needed(total_len) - len(probe.full_blocks)
        available = (
            self.manager.free_count
            - self.manager.reserved_total
            + self.index.reclaimable(self.manager, pinned=chain)
        )
        return need <= available

    def admit(
        self,
        request_id: str,
        prompt: Sequence[int],
        total_len: int,
        probe: Optional[PrefixProbe] = None,
    ) -> AdmitPlan:
        """Build ``request_id``'s block-table row: pin the cached prefix
        (full blocks by reference, partial block by reference + a COW
        reservation), evict LRU index entries if the exclusive tail needs
        them, allocate the exclusive blocks (tail prefill + future decode
        rows).  Raises :class:`BlockError` when capacity falls short — the
        scheduler must have gated on :meth:`can_admit`.  ``probe`` must be
        a CURRENT lookup of ``prompt`` when supplied (the gate's — nothing
        may touch the index in between)."""
        mgr = self.manager
        if mgr.owns(request_id):
            raise BlockError(f"request {request_id} already admitted")
        if probe is None:
            probe = self.index.lookup(prompt)
        n_blocks = self.blocks_needed(total_len)
        shared: List[int] = list(probe.full_blocks)
        if probe.partial_block is not None:
            shared.append(probe.partial_block)
        # pin the chain FIRST: eviction below must not strip what we share
        mgr.share(request_id, shared)
        if probe.partial_block is not None:
            mgr.reserve(request_id)  # the divergence copy can never fail
        need_owned = n_blocks - len(shared)
        self.index.evict_until(mgr, need_owned + mgr.reserved_total)
        if mgr.free_count < need_owned + mgr.reserved_total:
            free, reserved = mgr.free_count, mgr.reserved_total
            mgr.release_request(request_id)
            raise BlockError(
                f"admission of {request_id} needs {need_owned} exclusive "
                f"blocks + {reserved} reserved, only {free} free after "
                "eviction"
            )
        owned = mgr.allocate(request_id, need_owned)
        row = shared + owned
        row += [SCRATCH_BLOCK] * (self.blocks_per_slot - len(row))
        return AdmitPlan(
            block_row=row,
            n_blocks=n_blocks,
            tail_start=probe.shared_len,
            shared_tokens=probe.shared_len,
            partial_block=probe.partial_block,
        )

    def prepare_write(
        self, request_id: str, block_row, logical_blocks: Sequence[int]
    ) -> List[Tuple[int, int, int]]:
        """Copy-on-write sweep before a write lands: for every logical
        index about to be written whose physical block is SHARED
        (refcount > 1), swap in a fresh exclusive block and return
        ``(src, dst, logical)`` triples — the caller issues the device
        copies and ``block_row`` (mutated in place) already points at the
        destinations.  Exclusive blocks pass through untouched, so the
        per-step cost is a refcount probe."""
        copies: List[Tuple[int, int, int]] = []
        for logical in logical_blocks:
            block = int(block_row[logical])
            if block == SCRATCH_BLOCK:
                raise BlockError(
                    f"write aimed at the scratch block (logical {logical} of "
                    f"{request_id}) — the table row is shorter than the write"
                )
            if self.manager.refcount(block) > 1:
                dst = self.manager.cow(request_id, block)
                block_row[logical] = dst
                copies.append((block, dst, logical))
        return copies

    def truncate(self, request_id: str, new_len: int) -> List[int]:
        """Speculative rollback: clamp ``request_id``'s KV
        footprint to ``new_len`` live tokens, releasing owned tail blocks
        past ``blocks_needed(new_len)`` back to the free list — they hold
        ONLY rejected-draft garbage.  Each released block is replaced by a
        reservation credit for this request, so the release is
        pool-neutral for admissions (credits are excluded from every
        ``can_admit`` headroom) and :meth:`extend` regrowth is GUARANTEED
        — the same pay-up-front discipline as the COW reservation.
        Returns the released physical blocks, logical order; the caller
        scrubs its table-row entries to :data:`SCRATCH_BLOCK`."""
        keep = self.blocks_needed(max(new_len, 1))
        owned = self.manager.request_blocks(request_id)
        if keep >= len(owned):
            return []
        dropped = self.manager.truncate_request(request_id, keep)
        self.manager.reserve(request_id, len(dropped))
        return dropped

    def extend(self, request_id: str, need_len: int) -> List[Tuple[int, int]]:
        """Regrow ``request_id``'s block-table coverage to ``need_len``
        tokens from its own truncate credits (see :meth:`truncate`) —
        called before a verify dispatch whose write window crosses past a
        previously rolled-back block.  Returns ``(logical_index,
        physical_block)`` pairs for the caller's table row; empty when
        coverage already suffices."""
        have = len(self.manager.request_blocks(request_id))
        need = self.blocks_needed(min(need_len, self.max_len)) - have
        if need <= 0:
            return []
        blocks = self.manager.reclaim(request_id, need)
        return [(have + i, block) for i, block in enumerate(blocks)]

    def register_prompt(self, request_id: str, prompt: Sequence[int], block_row) -> int:
        """Cache the request's full prompt blocks for future admissions
        (call AFTER its prefill succeeded — a failed prefill must not
        poison the index with unwritten blocks)."""
        return self.index.register(prompt, block_row, self.manager)

    def release(self, request_id: str) -> None:
        self.manager.release_request(request_id)

    def owns(self, request_id: str) -> bool:
        return self.manager.owns(request_id)

    def reset(self) -> None:
        """Device block content is gone (DeviceStateLost reinstalled a
        fresh cache): drop the whole prefix index and invalidate every
        outstanding :class:`AdmitPlan` (generation bump).  Callers retire
        every in-flight request first, so no request references remain."""
        self.index.clear(self.manager)
        self.generation += 1

    def verify_consistent(self) -> None:
        self.manager.verify_consistent()
        indexed = {node.block for node in self.index._nodes()}
        if indexed != self.manager._indexed:
            raise BlockError(
                f"prefix index drifted from allocator: trie holds "
                f"{sorted(indexed)}, allocator records "
                f"{sorted(self.manager._indexed)}"
            )
