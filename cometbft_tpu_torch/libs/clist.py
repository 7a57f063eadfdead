"""Concurrent doubly-linked list with waitable next-element.

Reference: internal/clist/clist.go — the mempool and evidence pool iterate a
shared list while writers append/remove concurrently; a reader at the tail
blocks until a new element arrives (``wait_chan`` in the reference; a
condition variable here).  Removed elements stay traversable (``next`` of a
removed element keeps working) so iterators never see a torn list.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.libs import sync as libsync
from typing import Any, Iterator, Optional


class CElement:
    __slots__ = ("value", "_next", "_prev", "removed", "_list")

    def __init__(self, value: Any, list_: "CList"):
        self.value = value
        self._next: Optional[CElement] = None
        self._prev: Optional[CElement] = None
        self.removed = False
        self._list = list_

    def next(self) -> Optional["CElement"]:
        with self._list._mtx:
            return self._next

    def prev(self) -> Optional["CElement"]:
        with self._list._mtx:
            return self._prev

    def next_wait(self, timeout: Optional[float] = None) -> Optional["CElement"]:
        """Block until this element has a next, it is removed, or timeout."""
        with self._list._mtx:
            deadline = None
            if timeout is not None:
                import time

                deadline = time.monotonic() + timeout
            while self._next is None and not self.removed:
                if deadline is None:
                    self._list._cond.wait()
                else:
                    import time

                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._list._cond.wait(remaining):
                        if self._next is None and not self.removed:
                            return None
            return self._next


class CList:
    def __init__(self):
        self._mtx = libsync.rlock("clist")
        self._cond = libsync.condition(self._mtx)
        self._head: Optional[CElement] = None
        self._tail: Optional[CElement] = None
        self._len = 0

    def __len__(self) -> int:
        with self._mtx:
            return self._len

    def front(self) -> Optional[CElement]:
        with self._mtx:
            return self._head

    def back(self) -> Optional[CElement]:
        with self._mtx:
            return self._tail

    def front_wait(self, timeout: Optional[float] = None) -> Optional[CElement]:
        """Block until the list is non-empty (reference: WaitChan on root)."""
        with self._mtx:
            if self._head is not None:
                return self._head
            self._cond.wait(timeout)
            return self._head

    def push_back(self, value: Any) -> CElement:
        el = CElement(value, self)
        with self._mtx:
            if self._tail is None:
                self._head = self._tail = el
            else:
                el._prev = self._tail
                self._tail._next = el
                self._tail = el
            self._len += 1
            self._cond.notify_all()
        return el

    def remove(self, el: CElement) -> Any:
        with self._mtx:
            if el.removed:
                return el.value
            el.removed = True
            if el._prev is not None:
                el._prev._next = el._next
            else:
                self._head = el._next
            if el._next is not None:
                el._next._prev = el._prev
            else:
                self._tail = el._prev
            # keep el._next so in-flight iterators can continue
            el._prev = None
            self._len -= 1
            self._cond.notify_all()
            return el.value

    def __iter__(self) -> Iterator[CElement]:
        el = self.front()
        while el is not None:
            if not el.removed:
                yield el
            el = el.next()
