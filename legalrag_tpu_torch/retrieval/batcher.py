"""Dynamic micro-batching of concurrent single-query channel searches (port
of ``legalrag_tpu/retrieval/batcher.py``).

A threaded HTTP server runs ``HybridRetriever.search`` on one thread per
request, and each search makes one channels call on the device. Under
concurrent load N requests would make N calls, though the channels call is
batched over queries (``ops.fused_query.fused_channels_topk``).

``MicroBatcher`` coalesces them: the first arriving thread becomes the
*leader*, waits one small window for followers, then runs the batched call
once for every pending question and hands out row slices. Requests that
arrive while it runs are picked up by the next drain round (a daemon
thread, so the leader's own request returns after its first batch).

The channels call is row-independent (per-query products and top-k), so a
coalesced call returns the solo rankings; scores agree to float tolerance.

Each execution feeds the server's ``/metrics`` (``utils.metrics.METRICS``,
the JAX package's names): executions, coalesced requests, batched requests,
the summed queue depth, and histograms of the execution time and of each
request's wait before its batch started.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from legalrag_tpu_torch.utils.metrics import METRICS

# res dict: {"dense"|"bm25"|"colbert": (scores [B,k], rows [B,k]),
#            "qvec": [B,d]} — see HybridRetriever._channels_topk_batch
Result = Optional[Dict[str, object]]
RunBatch = Callable[[Sequence[str], int], Result]


class _Slot:
    __slots__ = ("question", "eff_k", "event", "value", "error", "t_enqueue")

    def __init__(self, question: str, eff_k: int):
        self.question = question
        self.eff_k = eff_k
        self.event = threading.Event()
        self.value: Result = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()


def _slice_result(res: Result, i: int, eff_k: int) -> Result:
    """One question's view of a batched result, keeping the leading batch
    dim of 1 so downstream ``[0]`` indexing is unchanged."""
    if res is None:
        return None
    out: Dict[str, object] = {}
    for name, val in res.items():
        if name == "qvec":
            out[name] = np.asarray(val)[i:i + 1]
        else:
            s, rows = val
            out[name] = (np.asarray(s)[i:i + 1, :eff_k],
                         np.asarray(rows)[i:i + 1, :eff_k])
    return out


class MicroBatcher:
    """Leader/follower coalescing of concurrent ``run_batch`` calls.

    ``run_batch(questions, eff_k)`` must be row-independent over questions.
    Mixed ``eff_k`` values are served from one execution at the batch max
    (each request slices its own prefix — top-k lists nest).
    """

    def __init__(self, run_batch: RunBatch, window_s: float = 0.002,
                 max_batch: int = 32, wait_timeout_s: float = 300.0):
        self._run = run_batch
        self._window = max(float(window_s), 0.0)
        self._max = max(int(max_batch), 1)
        self._timeout = wait_timeout_s
        self._lock = threading.Lock()
        self._pending: List[_Slot] = []
        self._leader_active = False
        # executions run, and requests they served beyond the first each
        # (one executor at a time updates them)
        self.executions = 0
        self.coalesced = 0

    # ------------------------------------------------------------- public
    def run(self, question: str, eff_k: int) -> Result:
        slot = _Slot(question, eff_k)
        with self._lock:
            self._pending.append(slot)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        if lead:
            # the leader's own slot is always in its first drained batch
            # (it was appended before leadership was taken)
            self._lead()
        ok = slot.event.wait(self._timeout)
        if not ok:
            with self._lock:
                unclaimed = slot in self._pending
                if unclaimed:
                    self._pending.remove(slot)
            if unclaimed:
                # leader vanished before draining us (should not happen —
                # _lead never abandons a non-empty queue): solo execution
                res = self._run([question], eff_k)
                return _slice_result(res, 0, eff_k)
            # the slot is inside an in-flight execution, which will complete
            # it (errors too); a duplicate solo run would only add device
            # work at the slowest moment
            slot.event.wait()
        if slot.error is not None:
            raise slot.error
        return slot.value

    # ------------------------------------------------------------ leader
    def _lead(self) -> None:
        if self._window > 0:
            threading.Event().wait(self._window)  # interrupt-safe sleep
        with self._lock:
            batch = self._pending[: self._max]
            del self._pending[: len(batch)]
            if not batch:
                self._leader_active = False
                return
        self._execute(batch)
        # The leader's own slot was in that batch, so its request thread
        # must not be held past its own completion: under sustained load
        # the queue never empties. Hand the rest to a daemon drainer.
        with self._lock:
            if not self._pending:
                self._leader_active = False
                return
        try:
            threading.Thread(target=self._drain, daemon=True,
                             name="microbatch-drain").start()
        except BaseException:
            # a failed thread spawn must not leave a phantom leader flag,
            # or every later request would wait out the full timeout
            with self._lock:
                self._leader_active = False
            raise

    def _drain(self) -> None:
        while True:
            with self._lock:
                batch = self._pending[: self._max]
                del self._pending[: len(batch)]
                if not batch:
                    self._leader_active = False
                    return
            self._execute(batch)

    def _execute(self, batch: List[_Slot]) -> None:
        eff_k = max(s.eff_k for s in batch)
        t_start = time.perf_counter()
        with self._lock:
            depth = len(self._pending)
        try:
            res = self._run([s.question for s in batch], eff_k)
        except BaseException as e:  # propagate to every waiter
            for s in batch:
                s.error = e
                s.event.set()
            return
        self.executions += 1
        self.coalesced += len(batch) - 1
        # where a slow request's time goes: its wait before the batch
        # started, the execution itself, or a deep queue at that time
        METRICS.inc("legalrag_microbatch_executions")
        if len(batch) > 1:
            METRICS.inc("legalrag_microbatch_coalesced", value=len(batch) - 1)
        METRICS.observe("legalrag_microbatch_exec_seconds",
                        time.perf_counter() - t_start)
        for s in batch:
            METRICS.observe("legalrag_microbatch_wait_seconds",
                            t_start - s.t_enqueue)
        METRICS.inc("legalrag_microbatch_batched_requests", value=len(batch))
        METRICS.inc("legalrag_microbatch_queue_depth_sum", value=depth)
        for i, s in enumerate(batch):
            s.value = _slice_result(res, i, s.eff_k)
            s.event.set()
