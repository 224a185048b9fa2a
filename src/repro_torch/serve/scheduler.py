"""Shape-bucketed continuous-batching scheduler.

The paper's result is that a tile optimum holds for one *(problem shape,
hardware model)* cell. Tile plans compile those cells ahead of time, but a
serving engine that prefills requests at their raw prompt lengths lands on
arbitrary shapes: almost every lookup degrades to nearest-shape (or a
heuristic), and every distinct length is a fresh compile. The scheduler
fixes this at admission time: prompts are padded to a small family of
**bucket edges**, so every prefill lands on an exactly-compiled plan cell
and, in the JAX reference, a warm jit cache entry.

Components:

* :class:`BucketPolicy` — the shape family (ascending pad targets) plus the
  admission bound. ``from_plan`` derives edges from a compiled
  :class:`~repro.core.plans.TilePlan` so the scheduler's shapes are, by
  construction, the plan's shapes.
* :class:`ShapeBucketScheduler` — per-bucket queues with priority/deadline
  ordering (FIFO among equals), admission control (full queue or
  over-length prompt -> reject), and left-padding to the bucket edge.
* :class:`FifoScheduler` — the naive baseline: one queue, raw shapes. This
  is the pre-scheduler engine behavior, kept as the default so existing
  callers are unchanged and benchmarks have a control arm.

The engine owns the slots; the scheduler only decides *which request is
admitted next and at what shape*.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Shape family + admission bound for bucketed scheduling.

    ``edges`` are ascending prompt-length pad targets; a prompt is assigned
    the smallest edge >= its length. Prompts longer than the largest edge
    are rejected with an explicit reason (admission control) unless
    ``allow_overflow`` is set — the chunked-prefill admission mode, where
    an over-length prompt pads to the smallest *multiple* of the largest
    edge that covers it and the engine prefills it chunk by chunk. Submits
    beyond ``max_queue`` total backlog are rejected either way. Rejections
    are never silent: ``admit`` reports why.
    """

    edges: Tuple[int, ...]
    max_queue: int = 256
    allow_overflow: bool = False

    def __post_init__(self):
        if not self.edges:
            raise ValueError("BucketPolicy needs at least one edge")
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError(f"edges must be ascending/unique: {self.edges}")
        if any(e <= 0 for e in self.edges):
            raise ValueError(f"edges must be positive: {self.edges}")

    @classmethod
    def pow2(cls, lo: int = 16, hi: int = 1024, max_queue: int = 256,
             allow_overflow: bool = False) -> "BucketPolicy":
        edges = []
        e = lo
        while e < hi:
            edges.append(e)
            e *= 2
        edges.append(hi)
        return cls(tuple(edges), max_queue=max_queue,
                   allow_overflow=allow_overflow)

    @classmethod
    def from_plan(cls, plan, kernel: str = "flash_attention",
                  hardware: Optional[str] = None, dtype: Optional[str] = None,
                  max_queue: int = 256,
                  allow_overflow: bool = False) -> "BucketPolicy":
        """Derive the shape family from a compiled plan's prefill cells.

        Uses the full-sequence (sq > 1) cells of ``kernel`` — i.e. the
        shapes the plan was actually compiled for — so bucketed admission
        resolves exactly by construction.
        """
        edges = set()
        for e in plan.entries():
            if e.kernel != kernel:
                continue
            if hardware is not None and e.hardware != hardware:
                continue
            if dtype is not None and e.dtype != dtype:
                continue
            sq = e.problem_dict.get("sq", 0)
            if sq > 1:
                edges.add(sq)
        if not edges:
            raise ValueError(
                f"plan has no full-sequence {kernel!r} cells to derive "
                f"bucket edges from")
        return cls(tuple(sorted(edges)), max_queue=max_queue,
                   allow_overflow=allow_overflow)

    def bucket_for(self, prompt_len: int) -> Optional[int]:
        """Smallest admitted pad length >= prompt_len.

        Within the shape family this is the smallest edge that covers the
        prompt. Beyond the largest edge: with ``allow_overflow`` the prompt
        is still admitted — at the smallest multiple of the largest edge
        covering it, so a chunking engine splits it at bucket-edge-sized
        boundaries — otherwise None (the caller must surface an explicit
        over-length rejection, never drop silently; see ``admit``).
        """
        for e in self.edges:
            if prompt_len <= e:
                return e
        if self.allow_overflow:
            top = self.edges[-1]
            return math.ceil(prompt_len / top) * top
        return None

    def admit(self, prompt_len: int) -> Tuple[Optional[int], str]:
        """(pad length, reason) — reason is "ok" or why admission failed."""
        bucket = self.bucket_for(prompt_len)
        if bucket is None:
            return None, "over_length"
        return bucket, "ok"

    @staticmethod
    def parse(spec: str, max_queue: int = 256,
              allow_overflow: bool = False) -> "BucketPolicy":
        """Parse a CLI spec: "64,128,512" or "pow2:16:1024"."""
        if spec.startswith("pow2"):
            parts = spec.split(":")
            lo = int(parts[1]) if len(parts) > 1 else 16
            hi = int(parts[2]) if len(parts) > 2 else 1024
            return BucketPolicy.pow2(lo, hi, max_queue=max_queue,
                                     allow_overflow=allow_overflow)
        return BucketPolicy(
            tuple(sorted({int(x) for x in spec.split(",") if x})),
            max_queue=max_queue, allow_overflow=allow_overflow)


class FifoScheduler:
    """Naive admission: one unbounded queue, raw prompt shapes."""

    name = "fifo"

    def __init__(self, max_queue: Optional[int] = None):
        self.max_queue = max_queue
        self._queue: deque = deque()
        self.last_reject_reason = "ok"
        self._trace = None

    def bind_trace(self, trace) -> None:
        """Attach a per-engine trace handle (repro.obs.trace.ProcTrace):
        queue push/pop become instant events on the scheduler lane."""
        self._trace = trace

    def admit_length(self, prompt_len: int) -> int:
        """The sequence length a prompt would prefill at (raw — no padding)."""
        return prompt_len

    def submit(self, req) -> bool:
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self.last_reject_reason = "queue_full"
            return False
        req.bucket = len(req.prompt)
        self._queue.append(req)
        if self._trace is not None:
            self._trace.queue_push(req.rid, req.bucket)
        return True

    def next_request(self):
        req = self._queue.popleft() if self._queue else None
        if req is not None and self._trace is not None:
            self._trace.queue_pop(req.rid, req.bucket)
        return req

    def prepare(self, req) -> np.ndarray:
        return req.prompt

    def pending(self) -> int:
        return len(self._queue)

    def remove(self, rid: int):
        """Pop one queued request by rid (cancel / fleet recovery / work
        stealing); None when not queued here."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                return req
        return None

    def queued_buckets(self) -> List[int]:
        """Admitted length of every queued request (fleet load estimates)."""
        return [len(r.prompt) for r in self._queue]


class ShapeBucketScheduler:
    """Per-bucket queues, priority/deadline ordering, padded admission.

    Ordering within and across buckets is by ``(priority, deadline, seq)``:
    lower priority value = more urgent; ``deadline`` defaults to +inf;
    ``seq`` is the global submit order, so requests that tie on priority and
    deadline pop FIFO (fairness). Across buckets the scheduler picks the
    bucket whose *head* sorts first, which keeps bursts of one shape
    draining together (warm compile + exact plan cell) without starving an
    urgent request in another bucket.
    """

    name = "bucket"

    def __init__(self, policy: BucketPolicy, pad_id: int = 0):
        self.policy = policy
        self.pad_id = pad_id
        self._queues: Dict[int, List] = {e: [] for e in policy.edges}
        self._seq = 0
        self.last_reject_reason = "ok"
        self._trace = None

    def bind_trace(self, trace) -> None:
        """Attach a per-engine trace handle (repro.obs.trace.ProcTrace):
        queue push/pop become instant events on the scheduler lane."""
        self._trace = trace

    def admit_length(self, prompt_len: int):
        """The padded prefill length (bucket edge, or the overflow multiple
        under ``allow_overflow``); None when over-length."""
        return self.policy.bucket_for(prompt_len)

    def submit(self, req) -> bool:
        bucket, reason = self.policy.admit(len(req.prompt))
        if bucket is None:
            self.last_reject_reason = reason
            return False
        if self.pending() >= self.policy.max_queue:
            self.last_reject_reason = "queue_full"
            return False
        req.bucket = bucket
        key = (req.priority, req.deadline, self._seq)
        self._seq += 1
        # Overflow buckets (allow_overflow multiples of the top edge) get
        # their queue lazily — they are not part of the static edge family.
        heapq.heappush(self._queues.setdefault(bucket, []), (key, req))
        if self._trace is not None:
            self._trace.queue_push(req.rid, req.bucket)
        return True

    def next_request(self):
        return self.next_request_within(None)

    def next_request_within(self, max_bucket: Optional[int]):
        """Most urgent head among buckets with edge <= ``max_bucket``.

        The chunked engine's selective admission: while a multi-chunk
        prefill is in flight it only admits single-chunk (small-bucket)
        requests, and the per-bucket queues make that a filtered pop —
        queued long prompts stay in the scheduler, visible to ``max_queue``
        admission control and the queue-depth metric, without blocking the
        small buckets behind them.
        """
        heads = [(q[0][0], bucket) for bucket, q in self._queues.items()
                 if q and (max_bucket is None or bucket <= max_bucket)]
        if not heads:
            return None
        _, bucket = min(heads)
        _, req = heapq.heappop(self._queues[bucket])
        if self._trace is not None:
            self._trace.queue_pop(req.rid, req.bucket)
        return req

    def prepare(self, req) -> np.ndarray:
        """Left-pad the prompt to its bucket edge.

        Left padding keeps the prompt's last token at the final position, so
        the engine's last-position prefill logits stay the request's first
        sampled token. The pad prefix is visible to attention (no mask in
        this synthetic stack) — bucketed outputs are deterministic per
        bucket but not bit-identical to unpadded serving; that trade is the
        point of shape binding.
        """
        pad = req.bucket - len(req.prompt)
        if pad <= 0:
            return req.prompt
        return np.concatenate([
            np.full((pad,), self.pad_id, np.int32),
            np.asarray(req.prompt, np.int32),
        ])

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def remove(self, rid: int):
        """Pop one queued request by rid (cancel / fleet recovery / work
        stealing); None when not queued here. The affected bucket's heap is
        rebuilt — removal is O(queue), fine for a control-path operation."""
        for bucket, q in self._queues.items():
            for i, (_key, req) in enumerate(q):
                if req.rid == rid:
                    del q[i]
                    heapq.heapify(q)
                    return req
        return None

    def queue_depths(self) -> Dict[int, int]:
        return {bucket: len(q) for bucket, q in self._queues.items()}

    def queued_buckets(self) -> List[int]:
        """Admitted length of every queued request (fleet load estimates)."""
        return [req.bucket for q in self._queues.values() for _, req in q]


def pick_chunks(jobs: Sequence, budget: float, slots: int,
                aging: bool = False) -> List[Tuple[object, int]]:
    """Knapsack-style pick of the prefill chunks one packed step runs.

    ``jobs`` are the in-flight chunk-resumable prefills (objects with
    ``remaining``, ``chunk_len`` and a ``req`` carrying priority/deadline/
    rid — the engine's ``_ChunkJob`` view). The head job is the most urgent
    by SRPT order — priority, deadline, fewest remaining tokens — or, with
    ``aging`` set (the engine raises it every AGING_PERIOD-th step), the
    oldest by submit order, so a sustained stream of short prompts cannot
    starve a long prefill. The head ALWAYS packs (progress guarantee, even
    when the budget is smaller than its chunk); the remaining budget then
    fills greedily with further jobs in SRPT order — each contributes
    ``min(chunk_len, remaining)`` tokens and is skipped (not truncated)
    when it no longer fits, so every packed segment is a whole plan-sized
    chunk and the smaller-chunk jobs behind a skipped one stay reachable
    (the greedy knapsack step). At most ``slots`` segments ride one step.

    Returns ``[(job, take), ...]`` in pick order; ``sum(take)`` exceeds
    ``budget`` only via the guaranteed head chunk.
    """
    if not jobs:
        return []
    srpt = sorted(jobs, key=lambda j: (j.req.priority, j.req.deadline,
                                       j.remaining, j.req.rid))
    if aging:
        head = min(jobs, key=lambda j: (j.req.priority, j.req.deadline,
                                        j.req.rid))
        srpt.remove(head)
        srpt.insert(0, head)
    picks: List[Tuple[object, int]] = []
    left = budget
    for job in srpt:
        if len(picks) >= max(1, slots):
            break
        take = min(job.chunk_len, job.remaining)
        if picks and take > left:
            continue
        picks.append((job, take))
        left -= take
    return picks


def make_scheduler(kind: str, policy: Optional[BucketPolicy] = None,
                   pad_id: int = 0):
    """CLI-facing factory: "fifo" or "bucket" (bucket requires a policy)."""
    if kind == "fifo":
        return FifoScheduler()
    if kind == "bucket":
        if policy is None:
            policy = BucketPolicy.pow2()
        return ShapeBucketScheduler(policy, pad_id=pad_id)
    raise ValueError(f"unknown scheduler kind {kind!r} (fifo|bucket)")
