"""FIFO id pool with O(1) operations (counterpart of
``gllm_tpu/id_allocator.py``): FIFO pop for fresh ids, O(1) targeted claim
(prefix-cache hits re-claim a specific page id), O(1) free."""

from __future__ import annotations

from collections import OrderedDict


class IDAllocator:
    def __init__(self, num_ids: int, start: int = 0):
        self._free: OrderedDict[int, None] = OrderedDict(
            (i, None) for i in range(start, start + num_ids))
        self.num_total = num_ids

    @property
    def num_free(self) -> int:
        return len(self._free)

    def allocate(self) -> int:
        """Pop the oldest free id (FIFO)."""
        if not self._free:
            raise RuntimeError("IDAllocator exhausted")
        id_, _ = self._free.popitem(last=False)
        return id_

    def allocate_id(self, id_: int) -> None:
        """Claim a specific id (must currently be free)."""
        del self._free[id_]

    def is_free(self, id_: int) -> bool:
        return id_ in self._free

    def free(self, id_: int) -> None:
        if id_ in self._free:
            raise RuntimeError(f"double free of id {id_}")
        self._free[id_] = None
