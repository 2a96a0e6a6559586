"""The pipelined engine loop's host bookkeeping: in-flight entries and the
FutureMap (counterpart of ``gllm_tpu/engine/pipeline.py``: ``InFlight:38``,
``FutureMap:82``).

A re-formed batch's input tokens are spliced on the device from the
previous entry's sampled tokens (``ModelRunner.step_async_chained``); the
host tracks only which sequences each such entry assumed alive. Deaths by
length are known at schedule time and drop there
(``Scheduler.schedule_reform``); EOS and stop tokens are assumed not to
happen. When a finish commits for a sequence a later entry promised
alive, that entry and every entry chained off it are invalidated: their
tokens never commit, their in-flight counts unwind
(``Scheduler.discard_batch``) and the sync path schedules the same
positions again from committed state, so greedy streams stay those of
the sync loop.

Under the unified step a re-form may be mixed: prefill chunks (a
promised mid-prefill row continued from its frontier, committed-state
chunks, waiting admissions) ride after the promised decode rows. Their
tokens are the host's, so the entry promises only its decode rows
(``src_rows`` >= 0). An invalidation cascade through it unwinds its
absorbed chunks like any other row: no computed count advances, and a
sequence it admitted stays RUNNING at its committed count (its pages
kept), whose prefill the sync pass schedules again.

Fused speculation schedules each spec block's links off worst-case
token counts (a sub-step may emit spec_k + 1 tokens); when a block is
collected, ``FutureMap.trim_overpromise`` rebases the spec entries still
in flight onto the committed frontiers. The device carries the actual
frontier across blocks, so the trim touches bookkeeping only.

No torch here: host bookkeeping only.
"""

from __future__ import annotations

import dataclasses

from gllm_tpu_torch.sequence import HOLE_SEQ_ID


@dataclasses.dataclass
class InFlight:
    """One dispatched entry not yet collected: its ``ScheduledBatch`` (a
    block's list of links) and the runner's handle; ``t_dispatch`` (when
    the runner call returned) and ``phases`` (the host walls up to then:
    ``LLM._entry_phases``) feed the attribution layer (obs/spans.py).
    ``chained``: its input tokens came off the
    previous entry's tokens on the device (a chained step or a re-form),
    so an invalidation cascades through it. ``roots``: a pure-decode batch
    scheduled from committed state, which roots a fresh chain; the cascade
    stops there. ``promises``: the sequences a re-form assumed alive.
    ``invalid``: reconciliation dropped it (collected as a discard)."""

    batch: object
    handle: object
    t_dispatch: float
    phases: dict
    chained: bool = False
    roots: bool = False
    promises: frozenset = frozenset()
    invalid: bool = False

    @property
    def tip(self):
        """(batch, handle): what the fill loop chains the next step off
        (a block's last link). Under persistent slots the engine keeps it
        as its chain tip past later entries (a ramp yield's prefill batch),
        and the next link splices from this handle's tokens, which no later
        entry overwrites."""
        batch = self.batch[-1] if isinstance(self.batch, list) else self.batch
        return batch, self.handle


class FutureMap:
    """Reconciliation of the pipelined loop's promises, with its counts:
    ``rebuilds`` (entries invalidated) and ``divergences`` (reconcile
    calls that invalidated any)."""

    def __init__(self):
        self.rebuilds = 0
        self.divergences = 0

    @staticmethod
    def promised_ids(batch) -> frozenset:
        """The sequences a re-formed batch (a block's first link) assumed
        alive: the rows whose input token is a promise (``src_rows``
        >= 0), hole rows never, and never a mixed re-form's prefill rows
        (src -1: their tokens are the host's)."""
        if batch.src_rows is None:
            return frozenset()
        return frozenset(it.seq.seq_id
                         for it, src in zip(batch.items, batch.src_rows)
                         if src >= 0 and it.seq.seq_id != HOLE_SEQ_ID)

    @staticmethod
    def trim_overpromise(in_flight, frontiers) -> int:
        """Fused speculation (JAX's ``trim_overpromise``,
        ``gllm_tpu/engine/pipeline.py:139-175``): rebase the per-link
        ``computed_before`` of every valid chained spec entry in flight
        onto the committed frontier ``frontiers[seq_id]``
        (``num_computed_tokens``). The delta of a sequence is fixed at the
        oldest such entry (where the over-promise accrued) and applied to
        every later one, whose strides stay upper bounds of what its
        parent emits. Returns the tokens trimmed."""
        trimmed = 0
        applied = {}              # seq_id -> the delta of the oldest entry
        for e in in_flight:
            if e.invalid or not e.chained:
                continue
            chain = e.batch if isinstance(e.batch, list) else [e.batch]
            if not chain[0].spec_block:
                continue
            deltas = {}
            for it in chain[0].items:
                sid = it.seq.seq_id
                if sid not in applied:
                    f = frontiers.get(sid)
                    if f is None:
                        continue
                    applied[sid] = max(0, it.computed_before - f)
                    trimmed += applied[sid]
                if applied[sid]:
                    deltas[sid] = applied[sid]
            for b in chain if deltas else ():
                for it in b.items:
                    it.computed_before -= deltas.get(it.seq.seq_id, 0)
        return trimmed

    def reconcile(self, in_flight, finished_ids) -> int:
        """Invalidate every in-flight entry whose promises meet
        ``finished_ids``, and every later chained entry after an invalid
        one (its input tokens come from a batch that never commits) up to
        a valid ``roots`` entry, from which later chained entries descend.
        Entries scheduled from committed state stay valid. Returns the
        number of entries newly invalidated."""
        if not finished_ids:
            return 0
        hit = 0
        cascading = False
        for e in in_flight:
            if e.invalid:
                cascading = True
                continue
            if (e.promises & finished_ids) or (cascading and e.chained):
                e.invalid = True
                cascading = True
                hit += 1
                continue
            if e.roots:
                cascading = False
        self.rebuilds += hit
        if hit:
            self.divergences += 1
        return hit
