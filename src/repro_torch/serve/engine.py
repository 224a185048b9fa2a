"""Batched serving engine of the port: slot-based continuous batching (lite).

The unchunked engine of ``repro/serve/engine.py``: a fixed decode batch of
``slots``; each admitted request runs its whole prefill into its own cache
(batch 1), then every step decodes one token for every active slot. Greedy
sampling over the real (unpadded) vocabulary. Admission is delegated to a
scheduler (FIFO by default, or the shape-bucketed one).

There is no ``jax.jit``: the engine runs eagerly under
``torch.inference_mode()``. On the card the model's prefill and decode go
through the Hopper kernels; on the CPU (``device="cpu"``) through their
plain versions.

Without a plan every prefill kernel is recorded with plan source
``no_plan``, as the reference does, and the kernels take their Hopper
default tiles. Options not ported yet — ``plans``, ``hardware`` (it selects
plans), ``chunk_prefill``, ``pack_prefill``, ``paged``, ``shadow_fraction`` /
``refiner`` and ``tracer`` — raise ``NotImplementedError`` when set.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import FifoScheduler


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 16
    priority: int = 0           # lower = more urgent
    deadline: float = math.inf  # absolute, scheduler-clock units
    bucket: Optional[int] = None  # padded length (set at submit)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submit_t: Optional[float] = None


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, max_len: int = 512,
                 slots: int = 4, dtype=torch.float32,
                 plans=None,
                 hardware=None,
                 scheduler=None,
                 metrics: Optional[ServeMetrics] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 chunk_prefill: bool = False,
                 pack_prefill: bool = False,
                 paged: bool = False,
                 shadow_fraction: float = 0.0,
                 refiner=None,
                 tracer=None,
                 device=None):
        unported = {"plans": plans is not None,
                    "hardware": hardware is not None,
                    "chunk_prefill": chunk_prefill,
                    "pack_prefill": pack_prefill, "paged": paged,
                    "shadow_fraction": bool(shadow_fraction),
                    "refiner": refiner is not None,
                    "tracer": tracer is not None}
        wanted = sorted(k for k, on in unported.items() if on)
        if wanted:
            raise NotImplementedError(
                f"ServeEngine options not ported yet: {', '.join(wanted)}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.slots = slots
        self.dtype = dtype
        self.scheduler = scheduler or FifoScheduler()
        self.metrics = metrics or ServeMetrics(clock=clock)
        self._clock = clock
        self.last_step_stats: Dict[str, Any] = {"prefill_tokens": 0,
                                                "decode_tokens": 0,
                                                "packed_chunks": 0,
                                                "packed_rids": (),
                                                "prefill_segments": ()}
        self.steps_run = 0
        self._active: List[Optional[Request]] = [None] * slots
        self._finished: List[Request] = []
        self._next_rid = 0
        self.last_reject_reason = "ok"
        # Per-slot independent caches (batch 1).
        self._states: List[Any] = [None] * slots
        self._prefill_sources: Dict[int, Dict[str, str]] = {}

    def _prefill_fn(self, length: int):
        """The prefill for one admitted prompt length, with its tiles and
        plan sources resolved once per length (``no_plan`` without a plan)."""
        if length not in self._prefill_sources:
            from repro_torch.launch.specs import kernel_problems

            self._prefill_sources[length] = {
                kernel: "no_plan"
                for kernel in kernel_problems(self.cfg, 1, length, "prefill")
            }
        cfg, max_len, dtype = self.cfg, self.max_len, self.dtype

        def prefill(params, batch):
            return api.prefill(params, cfg, batch, max_len=max_len,
                               dtype=dtype, ring_local=bool(cfg.attn_window))
        return prefill

    def _decode(self, params, tok, state):
        return api.decode_step(params, self.cfg, tok, state)

    def add_request(self, prompt: np.ndarray, max_new_tokens: int = 16,
                    priority: int = 0,
                    deadline: float = math.inf,
                    submit_t: Optional[float] = None) -> Optional[int]:
        """Submit a request; returns its rid, or None when admission control
        rejects it (queue full, prompt longer than every bucket edge, or the
        padded prompt plus the generation would overflow the KV cache)."""
        prompt = np.asarray(prompt, np.int32)
        shaped = self.scheduler.admit_length(len(prompt))
        if shaped is None:
            return self._reject("over_length", len(prompt))
        # Decode writes KV at positions shaped..shaped+max_new-2 (the last
        # sampled token is never cached).
        if shaped + max_new_tokens - 1 > self.max_len:
            return self._reject("cache_overflow", len(prompt))
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new_tokens,
                      priority=priority, deadline=deadline)
        if not self.scheduler.submit(req):
            return self._reject(
                getattr(self.scheduler, "last_reject_reason", "admission"),
                len(prompt))
        self.metrics.record_submit(rid, t=submit_t)
        self._record_backlog(self.scheduler.pending())
        return rid

    def _reject(self, reason: str, prompt_len: int) -> None:
        """Account one admission rejection (reason counter + backlog
        sample); the reason also lands in ``self.last_reject_reason``."""
        self.last_reject_reason = reason
        self.metrics.record_reject(reason=reason)
        self._record_backlog(self.scheduler.pending())
        return None

    def _record_backlog(self, depth: int) -> None:
        self.metrics.record_queue_depth(depth)

    def _admit(self):
        """Admit into free slots, running each whole prefill. Returns
        (total prompt tokens prefilled, per-prefill (admit_len, tokens)
        segments)."""
        prefill_tokens = 0
        segments: List[Any] = []
        free = [i for i, r in enumerate(self._active) if r is None]
        while free:
            req = self.scheduler.next_request()
            if req is None:
                break
            prompt = self.scheduler.prepare(req)
            prefill_tokens += len(prompt)
            segments.append((len(prompt), len(prompt)))
            prefill = self._prefill_fn(len(prompt))
            for kernel, source in self._prefill_sources[len(prompt)].items():
                self.metrics.record_plan("prefill", kernel, source)
            batch = {"tokens": torch.as_tensor(prompt[None], dtype=torch.long,
                                               device=self.device)}
            with torch.inference_mode():
                logits, state = prefill(self.params, batch)
                tok = int(torch.argmax(logits[0, :self.cfg.vocab_size]))
            req.out_tokens.append(tok)
            self.metrics.record_first_token(req.rid, req.bucket)
            if len(req.out_tokens) >= req.max_new_tokens:
                # Satisfied by the prefill token alone — never occupy a slot.
                req.done = True
                self._finished.append(req)
                self.metrics.record_complete()
                continue
            i = free.pop(0)
            self._active[i] = req
            self._states[i] = state
        return prefill_tokens, tuple(segments)

    def _decode_all(self) -> int:
        """One decode step for every active slot. Returns #active."""
        n = 0
        active_buckets = []
        t0 = self._clock()
        for i, req in enumerate(self._active):
            if req is None:
                continue
            n += 1
            active_buckets.append(req.bucket)
            last = torch.tensor([[req.out_tokens[-1]]], dtype=torch.long,
                                device=self.device)
            with torch.inference_mode():
                logits, self._states[i] = self._decode(
                    self.params, last, self._states[i])
                tok = int(torch.argmax(logits[0, :self.cfg.vocab_size]))
            req.out_tokens.append(tok)
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self._active[i] = None
                self._states[i] = None
                self._finished.append(req)
                self.metrics.record_complete()
        self.metrics.record_decode_step(active_buckets, self._clock() - t0)
        return n

    def step(self) -> int:
        """One engine step: admit (each admission runs its whole prefill),
        one decode step over the active slots, then a second admission pass
        so slots freed by this decode are claimed in the same step. Returns
        the number of requests decoded."""
        prefill_tokens, segments = self._admit()
        self._record_backlog(self.scheduler.pending())
        n = self._decode_all()
        extra_tokens, extra_segments = self._admit()
        self.last_step_stats = {"prefill_tokens": prefill_tokens + extra_tokens,
                                "decode_tokens": n,
                                "packed_chunks": 0, "packed_rids": (),
                                "prefill_segments": segments + extra_segments}
        self.steps_run += 1
        return n

    def in_flight(self) -> int:
        """Requests holding engine state (occupied decode slots)."""
        return sum(r is not None for r in self._active)

    def run_until_done(self, max_steps: int = 1000) -> List[Request]:
        self._finished = []
        for _ in range(max_steps):
            if not self.in_flight() and not self.scheduler.pending():
                break
            self.step()
        return self._finished
