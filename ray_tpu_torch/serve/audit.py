"""Engine-side invariant checks for the doctor plane (a copy of the
engine-local half of ``ray_tpu/serve/audit.py``).

``EngineAuditor`` owns the check bodies that need an LLMEngine's private
registries: the KV pool partition, prefix-trie refcount recount and
reachability, adapter-pool page/borrow accounting, the spec-decode
draft-pool partition, the slot table, and request-ring terminal
accounting.  It runs on the ENGINE LOOP (between dispatches: the loop
owns all of this state) or inline once the engine has stopped.

Two tiers, per the doctor contract:

  * ``maybe_incremental()`` — O(slots) conservation sums, run by the
    loop after slot-releasing work dirtied the allocator state;
  * ``run(deep=True)`` — the full walks, run on demand
    (``LLMEngine.doctor``), on engine idle, and as the final leak
    check on drain/stop.

The ``RAYTPU_FAILPOINTS``-gated corruption injectors (``corrupt``) let
tests prove that a check fires (``kv.lease_accounting`` has none, as in
the JAX auditor: tests corrupt ``_mig_leases`` directly).  The
controller/router census checks belong with a Serve control plane, which
the port does not have yet.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Set

from ray_tpu_torch.util import doctor
from ray_tpu_torch.util.doctor import InvariantViolation

# -- corruption injectors (tests only, RAYTPU_FAILPOINTS-gated) -------------

# Injector point names, all default-off.  Arming one via
# RAYTPU_FAILPOINTS flips exactly one bookkeeping update so the
# corresponding audit check has something real to find:
#   doctor.leak_trie_ref     - skip one borrowed-page release
#                              (phantom trie refcount)
#   doctor.leak_draft_page   - skip one draft-page free on slot
#                              release (draft-pool leak)
INJECT_TRIE_REF = "doctor.leak_trie_ref"
INJECT_DRAFT_PAGE = "doctor.leak_draft_page"


def corrupt(name: str) -> bool:
    """True when the named corruption injector is armed (consumes one
    RAYTPU_FAILPOINTS count).  Never raises — prod paths call this
    unconditionally and must behave identically when unarmed."""
    from ray_tpu_torch.utils.test_utils import FailPointError, fail_point

    try:
        fail_point(name)
    except FailPointError:
        return True
    except Exception:
        return False
    return False


# -- check definitions ------------------------------------------------------

CHECKS = {cd.name: cd for cd in (
    doctor.register_check(
        "kv.page_conservation", 1, doctor.INCREMENTAL, "critical",
        "free + cached + slot-owned page COUNTS sum to the pool size "
        "(the O(slots) conservation form of kv.pool_partition)."),
    doctor.register_check(
        "kv.borrow_balance", 1, doctor.INCREMENTAL, "error",
        "The trie's total borrow refcount equals the number of pages "
        "slots currently borrow (sum over _slot_borrowed)."),
    doctor.register_check(
        "adapter.borrow_balance", 1, doctor.INCREMENTAL, "error",
        "The adapter pool's total borrow refcount equals the number "
        "of slots holding an adapter."),
    doctor.register_check(
        "spec.draft_conservation", 1, doctor.INCREMENTAL, "critical",
        "free + slot-owned draft page COUNTS sum to the draft pool "
        "size."),
    doctor.register_check(
        "kv.pool_partition", 1, doctor.DEEP, "critical",
        "Every physical KV page is in exactly one of: the free list, "
        "the prefix trie, or a slot's owned allocation; borrowed "
        "pages are trie-owned."),
    doctor.register_check(
        "kv.trie_integrity", 1, doctor.DEEP, "critical",
        "Every trie page is reachable from the root and its borrow "
        "refcount equals a recount over the slots' borrowed lists."),
    doctor.register_check(
        "kv.lease_accounting", 1, doctor.DEEP, "error",
        "Migration leases pin only cached pages, and per-page lease "
        "counts equal the recount over the engine's open leases."),
    doctor.register_check(
        "adapter.pool_partition", 1, doctor.DEEP, "critical",
        "Adapter pool pages partition into the free list plus "
        "resident blocks of exactly pages_per_adapter pages each."),
    doctor.register_check(
        "adapter.block_refs", 1, doctor.DEEP, "error",
        "Each resident adapter block's refcount equals the number of "
        "slots borrowing one of its adapter ids."),
    doctor.register_check(
        "spec.draft_partition", 1, doctor.DEEP, "critical",
        "Every draft-pool page is in exactly one of: the draft free "
        "list or a slot's draft allocation."),
    doctor.register_check(
        "slots.table", 1, doctor.DEEP, "critical",
        "Every slot is exactly one of free, occupied, or prefilling; "
        "the free list holds no duplicates."),
    doctor.register_check(
        "ring.terminal_slots", 1, doctor.DEEP, "error",
        "No slot-occupying request is already terminal in the "
        "request ring (a terminal request must have released its "
        "slot)."),
)}


class EngineAuditor:
    """Invariant checks over one engine's allocator + scheduler state.

    Holds a weakref: the engine owns its auditor, which must not keep
    it alive."""

    # Seconds between opportunistic idle deep audits.  Long: idle
    # audits are a safety net behind the explicit RPC/drain/stop
    # audits, not a polling loop.
    IDLE_DEEP_PERIOD_S = 10.0

    def __init__(self, engine: Any):
        self._engine = weakref.ref(engine)
        self._dirty = False
        self._last_idle_deep = 0.0
        self.last_report: Optional[Dict[str, Any]] = None

    # -- loop hooks --------------------------------------------------------

    def mark_dirty(self) -> None:
        self._dirty = True

    def maybe_incremental(self) -> Optional[Dict[str, Any]]:
        """Run the incremental tier iff allocator state was dirtied
        since the last pass.  Called by the engine loop between
        dispatches; O(slots)."""
        if not self._dirty:
            return None
        self._dirty = False
        return self.run(deep=False)

    def maybe_idle_deep(self, now: float) -> Optional[Dict[str, Any]]:
        """Rate-limited deep audit from the loop's idle branch."""
        if now - self._last_idle_deep < self.IDLE_DEEP_PERIOD_S:
            return None
        self._last_idle_deep = now
        return self.run(deep=True)

    # -- audit passes ------------------------------------------------------

    def run(self, *, deep: bool) -> Dict[str, Any]:
        """One audit pass.  Caller must be the engine loop, or hold
        exclusivity another way (engine stopped / never started)."""
        eng = self._engine()
        if eng is None:
            return doctor.merge_reports([], deep=deep)
        fns = [(CHECKS["kv.page_conservation"],
                lambda: self._check_page_conservation(eng)),
               (CHECKS["kv.borrow_balance"],
                lambda: self._check_borrow_balance(eng)),
               (CHECKS["adapter.borrow_balance"],
                lambda: self._check_adapter_balance(eng)),
               (CHECKS["spec.draft_conservation"],
                lambda: self._check_draft_conservation(eng))]
        if deep:
            fns += [(CHECKS["kv.pool_partition"],
                     lambda: self._check_pool_partition(eng)),
                    (CHECKS["kv.trie_integrity"],
                     lambda: self._check_trie_integrity(eng)),
                    (CHECKS["kv.lease_accounting"],
                     lambda: self._check_lease_accounting(eng)),
                    (CHECKS["adapter.pool_partition"],
                     lambda: self._check_adapter_partition(eng)),
                    (CHECKS["adapter.block_refs"],
                     lambda: self._check_adapter_block_refs(eng)),
                    (CHECKS["spec.draft_partition"],
                     lambda: self._check_draft_partition(eng)),
                    (CHECKS["slots.table"],
                     lambda: self._check_slot_table(eng)),
                    (CHECKS["ring.terminal_slots"],
                     lambda: self._check_ring_terminals(eng))]
        report = doctor.run_audit(eng.engine_id, fns, deep=deep)
        self.last_report = report
        return report

    def last_critical(self) -> List[Dict[str, Any]]:
        """Critical violations from the most recent pass (the replica
        health verdict reads this: a corrupted pool must fail
        check_health, a mere census drift must not)."""
        rep = self.last_report
        if not rep:
            return []
        return [v for row in rep["checks"] for v in row["violations"]
                if v["severity"] == "critical"]

    # -- ownership views ---------------------------------------------------

    @staticmethod
    def _owned_pages(eng: Any) -> Dict[int, List[int]]:
        """Per-slot pages owned by the slot itself (its allocation
        minus the trie-owned borrowed prefix)."""
        out: Dict[int, List[int]] = {}
        for slot, pages in eng._slot_pages.items():
            nb = len(eng._slot_borrowed.get(slot, ()))
            out[slot] = list(pages[nb:])
        return out

    # -- incremental checks ------------------------------------------------

    def _check_page_conservation(self, eng):
        if not eng._paged:
            return []
        free = len(eng._free_pages)
        cached = eng._prefix.cached_pages if eng._prefix is not None else 0
        owned = sum(len(p) for p in self._owned_pages(eng).values())
        total = free + cached + owned
        if total == eng._num_pages:
            return []
        return [InvariantViolation(
            "kv.page_conservation", "critical", "kv-pool",
            expected=f"free+cached+owned == {eng._num_pages}",
            actual=f"{free}+{cached}+{owned} == {total}")]

    def _check_borrow_balance(self, eng):
        if eng._prefix is None:
            return []
        trie_refs = eng._prefix.stats()["borrowed_refs"]
        slot_refs = sum(len(b) for b in eng._slot_borrowed.values())
        if trie_refs == slot_refs:
            return []
        return [InvariantViolation(
            "kv.borrow_balance", "error", "prefix-trie",
            expected=f"trie borrowed_refs == {slot_refs} "
                     "(sum over slot borrows)",
            actual=trie_refs)]

    def _check_adapter_balance(self, eng):
        if eng._adapters is None:
            return []
        pool_refs = eng._adapters.stats()["borrowed_refs"]
        slot_refs = sum(1 for a in eng._slot_adapter.values() if a)
        if pool_refs == slot_refs:
            return []
        return [InvariantViolation(
            "adapter.borrow_balance", "error", "adapter-pool",
            expected=f"pool borrowed_refs == {slot_refs} "
                     "(slots holding an adapter)",
            actual=pool_refs)]

    def _check_draft_conservation(self, eng):
        if not eng._spec_on:
            return []
        free = len(eng._draft_free)
        owned = sum(len(p) for p in eng._draft_slot_pages.values())
        if free + owned == eng._draft_pages:
            return []
        return [InvariantViolation(
            "spec.draft_conservation", "critical", "draft-pool",
            expected=f"free+owned == {eng._draft_pages}",
            actual=f"{free}+{owned} == {free + owned}")]

    # -- deep checks -------------------------------------------------------

    def _check_pool_partition(self, eng):
        if not eng._paged:
            return []
        out: List[InvariantViolation] = []
        owners: Dict[int, List[str]] = {}

        def claim(page: int, owner: str) -> None:
            owners.setdefault(page, []).append(owner)

        for p in eng._free_pages:
            claim(p, "free")
        cached: Set[int] = (eng._prefix.pages()
                            if eng._prefix is not None else set())
        for p in cached:
            claim(p, "trie")
        for slot, pages in self._owned_pages(eng).items():
            for p in pages:
                claim(p, f"slot-{slot}")
        for slot, borrowed in eng._slot_borrowed.items():
            for p in borrowed:
                if p not in cached:
                    out.append(InvariantViolation(
                        "kv.pool_partition", "critical",
                        f"page-{p}",
                        expected=f"slot {slot}'s borrowed page is "
                                 "trie-owned",
                        actual="not in trie"))
        for p in range(eng._num_pages):
            who = owners.get(p, [])
            if len(who) != 1:
                out.append(InvariantViolation(
                    "kv.pool_partition",
                    "critical" if len(who) > 1 else "error",
                    f"page-{p}",
                    expected="exactly one owner",
                    actual=sorted(who) or "unowned (leaked)"))
        for p in owners:
            if not 0 <= p < eng._num_pages:
                out.append(InvariantViolation(
                    "kv.pool_partition", "critical", f"page-{p}",
                    expected=f"page id in [0, {eng._num_pages})",
                    actual=sorted(owners[p])))
        return out

    def _check_trie_integrity(self, eng):
        if eng._prefix is None:
            return []
        out: List[InvariantViolation] = []
        snap = eng._prefix.audit_snapshot()
        borrowers: Dict[int, int] = {}
        for borrowed in eng._slot_borrowed.values():
            for p in borrowed:
                borrowers[p] = borrowers.get(p, 0) + 1
        for p, info in sorted(snap["pages"].items()):
            if not info["reachable"]:
                out.append(InvariantViolation(
                    "kv.trie_integrity", "critical", f"page-{p}",
                    expected="node reachable from the trie root",
                    actual="orphaned node"))
            want = borrowers.get(p, 0)
            if info["refs"] != want:
                out.append(InvariantViolation(
                    "kv.trie_integrity", "critical", f"page-{p}",
                    expected=f"refs == {want} (recount over slot "
                             "borrows)",
                    actual=info["refs"]))
        for p in sorted(borrowers):
            if p not in snap["pages"]:
                out.append(InvariantViolation(
                    "kv.trie_integrity", "critical", f"page-{p}",
                    expected="borrowed page present in trie",
                    actual="missing"))
        for p in snap["unindexed"]:
            out.append(InvariantViolation(
                "kv.trie_integrity", "critical", f"page-{p}",
                expected="tree node present in the page index",
                actual="reachable but unindexed"))
        return out

    def _check_lease_accounting(self, eng):
        if eng._prefix is None:
            return []
        out: List[InvariantViolation] = []
        snap = eng._prefix.audit_snapshot()
        held: Dict[int, int] = {}
        for lease in eng._mig_leases.values():
            for p in lease["pages"]:
                held[p] = held.get(p, 0) + 1
        pages = {p: info["leases"] for p, info in snap["pages"].items()}
        for p in sorted(set(held) | {q for q, n in pages.items() if n}):
            want = held.get(p, 0)
            have = pages.get(p)
            if have is None:
                out.append(InvariantViolation(
                    "kv.lease_accounting", "error", f"page-{p}",
                    expected="leased page cached in trie",
                    actual="missing from trie"))
            elif have != want:
                out.append(InvariantViolation(
                    "kv.lease_accounting", "error", f"page-{p}",
                    expected=f"leases == {want} (recount over open "
                             "engine leases)",
                    actual=have))
        return out

    def _check_adapter_partition(self, eng):
        if eng._adapters is None:
            return []
        out: List[InvariantViolation] = []
        snap = eng._adapters.audit_snapshot()
        pp = snap["pages_per_adapter"]
        owners: Dict[int, List[str]] = {}
        for p in snap["free"]:
            owners.setdefault(p, []).append("free")
        for h, block in snap["blocks"].items():
            if len(block["pages"]) != pp:
                out.append(InvariantViolation(
                    "adapter.pool_partition", "critical",
                    f"block-{h[:12]}",
                    expected=f"{pp} pages per adapter block",
                    actual=len(block["pages"])))
            for p in block["pages"]:
                owners.setdefault(p, []).append(f"block-{h[:12]}")
        for p in range(snap["num_pages"]):
            who = owners.get(p, [])
            if len(who) != 1:
                out.append(InvariantViolation(
                    "adapter.pool_partition",
                    "critical" if len(who) > 1 else "error",
                    f"page-{p}",
                    expected="exactly one owner",
                    actual=sorted(who) or "unowned (leaked)"))
        return out

    def _check_adapter_block_refs(self, eng):
        if eng._adapters is None:
            return []
        out: List[InvariantViolation] = []
        snap = eng._adapters.audit_snapshot()
        want: Dict[str, int] = {}  # content hash -> borrowing slots
        for aid in eng._slot_adapter.values():
            h = snap["entries"].get(aid)
            if h is None:
                out.append(InvariantViolation(
                    "adapter.block_refs", "error", f"adapter-{aid}",
                    expected="slot-borrowed adapter known to the pool",
                    actual="unknown id"))
                continue
            want[h] = want.get(h, 0) + 1
        for h, block in sorted(snap["blocks"].items()):
            w = want.get(h, 0)
            if block["refs"] != w:
                out.append(InvariantViolation(
                    "adapter.block_refs", "error", f"block-{h[:12]}",
                    expected=f"refs == {w} (recount over slot "
                             "borrows)",
                    actual=block["refs"]))
        for h in sorted(set(want) - set(snap["blocks"])):
            out.append(InvariantViolation(
                "adapter.block_refs", "error", f"block-{h[:12]}",
                expected="borrowed adapter block resident",
                actual="evicted while borrowed"))
        return out

    def _check_draft_partition(self, eng):
        if not eng._spec_on:
            return []
        out: List[InvariantViolation] = []
        owners: Dict[int, List[str]] = {}
        for p in eng._draft_free:
            owners.setdefault(p, []).append("free")
        for slot, pages in eng._draft_slot_pages.items():
            for p in pages:
                owners.setdefault(p, []).append(f"slot-{slot}")
        for p in range(eng._draft_pages):
            who = owners.get(p, [])
            if len(who) != 1:
                out.append(InvariantViolation(
                    "spec.draft_partition",
                    "critical" if len(who) > 1 else "error",
                    f"draft-page-{p}",
                    expected="exactly one owner",
                    actual=sorted(who) or "unowned (leaked)"))
        return out

    def _check_slot_table(self, eng):
        out: List[InvariantViolation] = []
        free = list(eng._free_slots)
        if len(set(free)) != len(free):
            out.append(InvariantViolation(
                "slots.table", "critical", "free-slots",
                expected="no duplicate free slots",
                actual=sorted(free)))
        occupied = set(eng._slot_req)
        occupied |= {st["slot"] for st in eng._prefilling}
        for slot in sorted(set(free) & occupied):
            out.append(InvariantViolation(
                "slots.table", "critical", f"slot-{slot}",
                expected="slot free XOR occupied",
                actual="both free and occupied"))
        missing = (set(range(eng.config.max_slots))
                   - set(free) - occupied)
        for slot in sorted(missing):
            out.append(InvariantViolation(
                "slots.table", "critical", f"slot-{slot}",
                expected="slot free or occupied",
                actual="neither (leaked slot)"))
        return out

    def _check_ring_terminals(self, eng):
        out: List[InvariantViolation] = []
        for slot, req in sorted(eng._slot_req.items()):
            row = eng._ring.row(req.request_id)
            if row is None:
                continue
            from ray_tpu_torch.serve import request_events as _reqev
            if row.get("state") in _reqev.TERMINAL_STATES:
                out.append(InvariantViolation(
                    "ring.terminal_slots", "error",
                    f"slot-{slot}",
                    expected=f"request {req.request_id} live while "
                             "occupying a slot",
                    actual=row.get("state")))
        return out
