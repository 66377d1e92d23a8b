"""Bounded-slot priority scheduler (the queued_task_server role).

The reference keeps a max-heap of tasks ordered by priority and runs at most
``run_size`` at a time, with an actor message loop
(lib/base/queued_task_server.ml:30-88).  Here: a thread pool pulling from a
priority heap under a condition variable; ``submit`` returns a Future.
Deeper tree nodes get higher priority (the reference's depth-priority rule),
so the critical path drains first.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from concurrent.futures import Future
from typing import Callable


class PriorityScheduler:
    def __init__(self, run_size: int = 4, name: str = "pm-sched"):
        self._heap: list = []
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self._shutdown = False
        self._threads = [
            threading.Thread(target=self._worker, name=f"{name}-{i}", daemon=True)
            for i in range(max(1, run_size))
        ]
        for t in self._threads:
            t.start()

    @property
    def run_size(self) -> int:
        return len(self._threads)

    def submit(self, fn: Callable, *args, priority: int = 0, name: str = "") -> Future:
        """Higher priority runs first."""
        fut: Future = Future()
        with self._cv:
            if self._shutdown:
                raise RuntimeError("scheduler stopped")
            heapq.heappush(self._heap, (-priority, next(self._seq), fn, args, fut, name))
            self._cv.notify()
        return fut

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._heap:
                    return
                _, _, fn, args, fut, _ = heapq.heappop(self._heap)
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # propagate to waiter
                fut.set_exception(e)

    def stop(self, wait: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=30)


def spawn(fn: Callable, *args, name: str = "pm-span") -> Future:
    """Run a coordination function on its own (unbounded) thread.

    Tree-walk coordination must not occupy bounded scheduler slots, or
    parents waiting on children would deadlock the pool — the reference
    avoids this the same way by keeping the tree walk in the Async
    scheduler while tasks go to the bounded queue.
    """
    fut: Future = Future()

    def run():
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(fn(*args))
        except BaseException as e:
            fut.set_exception(e)

    threading.Thread(target=run, name=name, daemon=True).start()
    return fut
