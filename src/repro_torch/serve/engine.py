"""Batched serving engine of the port: slot-based continuous batching (lite).

The unchunked engine of ``repro/serve/engine.py``: a fixed decode batch of
``slots``; each admitted request runs its whole prefill into its own cache
(batch 1), then every step decodes one token for every active slot. Greedy
sampling over the real (unpadded) vocabulary. Admission is delegated to a
scheduler (FIFO by default, or the shape-bucketed one). Requests are
tokens: a vision model's requests are its text (no patch embeddings), as
in the reference, and an encoder-decoder model, whose requests need
encoder frames, is refused with a ``NotImplementedError`` where the
reference fails on the missing ``frames`` key. MoE models are served like
any other decoder, in every mode.

Each slot owns static tensors for its whole life: its per-layer caches (KV
caches, rings on the windowed layers of a windowed arch; the conv tails
and recurrent state of an RG-LRU or SSD layer), a ``[1, 1]`` token buffer,
and the step's logits and greedy token. Admission runs the prefill eagerly
into the slot's caches, from an empty KV cache and a zeroed state, and
every step writes each state back into the same tensors. On the card, the
decode step is the port's counterpart of the reference's
``jax.jit(api.decode_step)``: on a slot's first decode the engine runs one
eager warm-up step (it loads the kernels' libraries and sets their
attributes), puts the slot's caches back as the prefill left them (the K/V
row, position and slot map the step wrote, and every recurrent state
whole), and captures the step, with its argmax, into a CUDA graph; every
later step writes the last token into the token buffer and replays the
graph. The slots' graphs share one memory pool, as they replay one after
another. A capture or replay that fails raises: nothing falls back to the
eager step on the card. On the CPU (``device="cpu"``) the step runs
eagerly, through the kernels' plain versions. A step reads back one token
per slot and nothing else. ``build.LAUNCHES`` counts the kernels that ran:
a capture launches nothing, so its counts are taken back and each replay
adds them.

Tile selection is the reference's: pass a compiled
:class:`~repro_torch.core.plans.TilePlan` (and the target
:class:`~repro_torch.core.hardware.HardwareModel`, by default the H100) and
the engine resolves the decode kernels' tiles once, at the ``(slots,
max_len)`` decode cell, and each prefill's tiles once per admitted length,
at the ``(1, length)`` cell — exact hit, nearest shape, cross-hardware
transfer, or else the kernel's default, never a sweep
(``launch.specs.resolve_model_tiles``). Every resolved tile is then held
against the calls the model makes of its kernel; one that would not launch
is replaced by the kernel's default and counted as ``tile_fallback``
(``launch.specs.launchable_tiles``). The decode tiles are baked into each
slot's captured graph, so :meth:`ServeEngine.set_plans` drops the graphs
and the next step recaptures. Tile-dispatch events of the call sites
(``models.attention.capture_tile_events``) count as ``tile_fallback`` too:
a prefill's once per admitted request, the decode step's once per engine.
Without a plan every kernel is recorded with plan source ``no_plan``, as
the reference does, and takes its Hopper default tile.

Chunked prefill (``chunk_prefill=True``) and step packing
(``pack_prefill=True``, which implies it) are the reference's mixed steps
with the reference's scheduling: each step runs one prefill chunk (or a
pack of several requests' chunks) beside the whole decode batch under
``step_token_budget`` tokens, up to ``prefill_slots`` prefills in flight,
the most urgent first (priority, deadline, fewest remaining tokens, and
every ``AGING_PERIOD``-th chunk the oldest), one multi-chunk prefill at a
time. The chunk is the resolved ``chunked_prefill`` tile's first dim and
the pack width the ``packed_prefill`` tile's, each clamped to the budget.
Chunk and pack programs run eagerly (no graph is captured per chunk
offset); on the card each chunk's attention launches the flash-attention
kernel at ``q_offset = start``. State ownership differs from the
reference, which hands a finished prefill's state object to the decode
slot: a slot's graph holds its tensors' addresses, so each prefill in
flight fills a cache set of its own, taken from a free list (emptied, at
most ``slots + prefill_slots`` ever made), and when its request takes slot
*i* the written K/V rows, positions, slot maps and recurrent states are
copied into slot *i*'s tensors and the set is freed.

Paged serving (``paged=True``) is the reference's: one engine-wide pool
(:class:`~repro_torch.serve.pool.PagedKVPool`) holds every attention
layer's K/V in pages, each request a page table, and pages are allocated
as chunks and decode steps write them (``prepare_span`` before every
write, copy-on-write splits of shared pages included) and released when
the request finishes. The page is ``page_size`` when given, else the
plan's ``kv_page`` tile, else min(512, max_len), as the reference orders
them. Every prefill runs as chunks (a whole prompt is one chunk when
chunking is off); admission is the pool's
reservation gate (``can_admit``, a FIFO pool-wait line), so more prefills
are in flight than ``prefill_slots`` (up to 8 x (slots + prefill_slots)),
and a prompt whose prefix another request registered maps those pages and
prefills only its tail. A request's state is its positions and recurrent
states; a slot keeps its own, and a fixed int32 ``[n_pt]`` table tensor
its captured step reads. Before each step the engine makes the row's page
writable and copies the request's table into that tensor when the table
changed (a new page, a split), then replays the same graph: crossing a
page needs no recapture.

Tracing (``tracer=``, a :class:`~repro_torch.obs.trace.Tracer`) is the
reference's: the engine attaches as process ``instance`` and records the
request lifecycle (submit, admit or reject, chunks with their pack lane and
queue age, the whole prefill, first token, decode, finish), one span a
step, queue depth, the pool's page events, and one ``plan_resolve``
instant per kernel each time a cell is resolved (the tile it launches,
after the launch check), at the reference's sites and on the engine's
clock. Without a tracer every site short-circuits on ``self._trace is
None``: no call and no allocation. What each span holds of the card's time
is set out in ``obs/trace.py``; tracing adds no synchronisation. One order
differs from the reference: a paged step frees the pages of each request
it finishes as the request's step launches (the reference's order, so the
pool's events match), but records the ``finish`` instants after the step's
single token readback, so in a step that finishes two requests both
``page_free`` events come before both ``finish`` events.

Shadow execution (``shadow_fraction=``, ``shadow_measure=``,
``refiner=``; ``serve/refine.py``) is the reference's: a counter-based
accumulator diverts that fraction of the steps, and each diverted step
measures the next resolved plan cell in round-robin order (the cells are
noted as the engine resolves them) at its incumbent, the plan's resolved
tile, and at the next candidate of the entry's sensitivity curve, records
both in the metrics, the trace and the refiner, and serves on. The default
measure is ``refine.make_shadow_measure(hardware)``: on ``h100_sxm`` it
times the cell's kernel on the card (a CPU engine raises ``RuntimeError``
there rather than score it with the cost model; CPU tests pass
``shadow_measure`` or a modelled ``hardware``). A measurement captures and
drops a graph of its own on operands of its own, so no slot's graph is
recaptured and the tokens are the same with shadowing on or off; only
``set_plans`` (with the refined artifact) drops the slots' graphs.

The fleet's hooks (``extract_queued``, ``evict_all``, ``cancel``;
``serve/fleet.py``) are the reference's, with its return values: a
request leaves with its tokens so far, its pages go back to the pool and
its TTFT anchor onto the request. Where the reference drops a slot's state
object, here an evicted slot keeps its tensors and its graph (the next
request is copied into them and replays it), and a prefill's cache set
goes back to the free list.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.hardware import PRODUCTION_TARGET
from repro_torch.core.plans import (PLAN_SCHEMA_VERSION,
                                    PlanTransferWarning, problem_key)
from repro_torch.core.tiling import TileShape
from repro_torch.kernels import build
from repro_torch.launch import specs
from repro_torch.models import api
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as T
from repro_torch.models.transformer import is_kv_cache
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.pool import PagedKVPool, cdiv
from repro_torch.serve.scheduler import FifoScheduler, pick_chunks


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


@dataclasses.dataclass
class _ChunkJob:
    """One request's prefill in flight, chunk by chunk."""

    req: Request
    prompt: np.ndarray            # padded to the admitted length
    chunk_len: int
    state: Any = None             # its cache set, taken at the first chunk
    done: int = 0                 # prompt tokens prefilled so far
    chunks_run: int = 0
    packed_runs: int = 0          # chunks that rode a multi-segment pack
    table: Optional[torch.Tensor] = None  # paged: its page table tensor
    last_t: float = 0.0           # last progress (chunk queue age)
    # Tile events of every chunk it ran, deduplicated once at the end so
    # an N-chunk prefill counts each distinct fallback once.
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    @property
    def remaining(self) -> int:
        return len(self.prompt) - self.done


@dataclasses.dataclass
class _Slot:
    """The static tensors of one decode slot, and its captured step."""
    caches: List[Any]
    token: torch.Tensor             # [1, 1] long: the step's input
    logits: torch.Tensor            # [1, Vpad]: the step's logits
    next_token: torch.Tensor        # 0-d long: their greedy token
    graph: Optional[Any] = None     # torch.cuda.CUDAGraph once captured
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Paged: the int32 [n_pt] table the step reads, and the host table it
    # holds (None until the first copy).
    table: Optional[torch.Tensor] = None
    table_host: Optional[List[int]] = None


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, max_len: int = 512,
                 slots: int = 4, dtype=torch.float32,
                 plans=None,
                 hardware=None,
                 scheduler=None,
                 metrics: Optional[ServeMetrics] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 chunk_prefill: bool = False,
                 step_token_budget: int = 0,
                 prefill_slots: int = 2,
                 pack_prefill: bool = False,
                 paged: bool = False,
                 pool_pages: Optional[int] = None,
                 page_size: Optional[int] = None,
                 prefix_sharing: bool = True,
                 shadow_fraction: float = 0.0,
                 shadow_measure=None,
                 refiner=None,
                 tracer=None,
                 instance: Optional[str] = None,
                 device=None):
        if api.is_encdec(cfg):
            raise NotImplementedError(
                f"{cfg.name} is an encoder-decoder model: its requests need "
                "encoder frames, and the engine takes tokens only; serve it "
                "through api.prefill (with 'frames') and api.decode_step")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.slots = slots
        self.dtype = dtype
        self.hardware = hardware or PRODUCTION_TARGET
        self.plans = plans
        self.scheduler = scheduler or FifoScheduler()
        self.metrics = metrics or ServeMetrics(clock=clock)
        self._clock = clock
        # Tracing: None unless a tracer is given, and every site is guarded
        # by ``if self._trace is not None``.
        self._trace = None
        self._plan_schema: Optional[int] = None
        if tracer is not None:
            self._trace = tracer.attach(instance or "engine", kind="engine",
                                        hardware=self.hardware.name)
            bind = getattr(self.scheduler, "bind_trace", None)
            if bind is not None:
                bind(self._trace)
        # Shadow execution: a fractional accumulator (no randomness), a
        # round-robin cursor over the cells resolved so far and a candidate
        # cursor per cell.
        self.shadow_fraction = float(shadow_fraction)
        if not 0.0 <= self.shadow_fraction <= 1.0:
            raise ValueError(
                f"shadow_fraction must be in [0, 1]: {shadow_fraction}")
        self.refiner = refiner
        self._shadow_measure = shadow_measure
        self._shadow_acc = 0.0
        self._shadow_rr = 0
        self._shadow_idx: Dict[str, int] = {}
        # cell key -> (kernel, problem), in the order resolved.
        self._shadow_cell_map: Dict[str, Any] = {}
        self._shadow_order: List[str] = []
        # cell key -> (incumbent dims, candidate dims) | None.
        self._shadow_views: Dict[str, Any] = {}
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
        # Chunked prefill: ``step_token_budget`` bounds one mixed step's
        # tokens (0: the plan's chunk unclamped), ``prefill_slots`` the
        # prefills in flight; ``pack_prefill`` packs several chunks a step.
        self.pack_prefill = pack_prefill
        # Paged: every prefill runs as chunks, a whole prompt as one chunk
        # when chunking is off (the reference's one paged prefill path).
        self.paged = paged
        self._paged_whole = paged and not (chunk_prefill or pack_prefill)
        self.chunk_prefill = chunk_prefill or pack_prefill or paged
        self.step_token_budget = step_token_budget
        self.prefill_slots = max(1, prefill_slots)
        self._chunking: List[_ChunkJob] = []
        # Paged admission: requests the pool cannot reserve pages for yet
        # (FIFO: the head gets the first claim on freed pages), and each
        # decoding request's next cache position.
        self._pool_wait: List[Request] = []
        self._pos: Dict[int, int] = {}
        self._ready: List[Any] = []   # (request, cache set, length) waiting
        #                               for a free decode slot
        self._held: List[Request] = []  # deferred multi-chunk (FIFO only)
        self._free_sets: List[Any] = []  # emptied cache sets for new jobs
        self.cache_sets_made = 0
        self._single_chunk_edge: Optional[int] = None
        self._chunk_ticks = 0
        self._chunk_plans: Dict[int, Any] = {}
        self._pack_plan_cache: Optional[Any] = None
        # The paged pool (``_page_size``); by default as many pages as
        # whole caches for every decode and prefill slot, plus the
        # copy-on-write slack.
        self.pool: Optional[PagedKVPool] = None
        if paged:
            page = self._page_size(page_size)
            n_pages = pool_pages if pool_pages is not None else (
                (slots + self.prefill_slots)
                * (cdiv(max_len, page) + PagedKVPool.RESERVE_SLACK))
            self.pool = PagedKVPool(
                cfg, n_pages=n_pages, page=page, max_len=max_len,
                dtype=dtype, prefix_sharing=prefix_sharing,
                metrics=self.metrics, trace=self._trace, device=self.device)
        # Per-slot independent caches (batch 1) and step buffers.
        self._slots = [self._make_slot() for _ in range(slots)]
        self._graph_pool = None
        # Per admitted length: the resolved prefill tiles with the events
        # of the tiles replaced at resolution, and their plan sources.
        self._prefill_tiles: Dict[int, Any] = {}
        self._prefill_sources: Dict[int, Dict[str, str]] = {}
        # The decode step's tiles (resolved once per engine and plan) and
        # its deduplicated tile events (None until the step first runs).
        self.tiles: Dict[str, TileShape] = {}
        self.tile_sources: Dict[str, str] = {}
        self._decode_tile_events: Optional[List[Dict[str, Any]]] = None
        if plans is not None:
            self._resolve_tiles()

    def _page_size(self, page_size: Optional[int]) -> int:
        """The pool's page: ``page_size``, else the plan's ``kv_page`` tile
        at the ``(slots, max_len)`` decode cell, else min(512, max_len)."""
        if page_size is not None:
            return int(page_size)
        if self.plans is not None:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", PlanTransferWarning)
                tiles, _ = specs.resolve_model_tiles(
                    self.plans, self.cfg, self.slots, self.max_len, "decode",
                    self._dtype_name, self.hardware)
            if "kv_page" in tiles:
                return int(tiles["kv_page"][0])
        return min(512, self.max_len)

    def _new_state(self):
        """A request's serve state: whole caches, or paged positions."""
        if self.paged:
            return api.make_paged_state(self.cfg, self.dtype,
                                        device=self.device)
        return api.make_serve_state(self.cfg, 1, self.max_len, self.dtype,
                                    device=self.device,
                                    ring_local=bool(self.cfg.attn_window))

    def _make_slot(self) -> _Slot:
        cfg, dev = self.cfg, self.device
        return _Slot(
            caches=self._new_state(),
            table=self.pool.new_table() if self.paged else None,
            token=torch.zeros((1, 1), dtype=torch.long, device=dev),
            logits=torch.zeros((1, cfg.padded_vocab),
                               dtype=self.params["embed"].dtype, device=dev),
            next_token=torch.zeros((), dtype=torch.long, device=dev))

    @property
    def _dtype_name(self) -> str:
        return str(self.dtype).replace("torch.", "")

    @staticmethod
    def _dedupe_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Drop repeats: identical per-layer call sites, and the warm-up and
        capture of a slot's step, emit the same event."""
        seen, out = set(), []
        for ev in events:
            key = tuple(sorted((k, str(v)) for k, v in ev.items()))
            if key not in seen:
                seen.add(key)
                out.append(ev)
        return out

    def _record_tile_event(self, event: Dict[str, Any]) -> None:
        """A ``fallback`` event — a resolved tile that did not apply as
        resolved at its call site — counts as ``tile_fallback``."""
        if event.get("fallback"):
            self.metrics.record_plan(event["phase"], event["kernel"],
                                     "tile_fallback")

    def _resolve(self, batch: int, seq_len: int, kind: str, tokens: int,
                 cache_lens=()):
        """One cell's tiles from the plan, each held against the calls the
        model makes of its kernel. Returns ``(tiles, sources, events)``:
        a replaced tile is one ``tile_fallback`` event."""
        phase = "decode" if kind == "decode" else "prefill"
        with warnings.catch_warnings():
            # resolve() warns once per transfer; the counters record it.
            warnings.simplefilter("ignore", PlanTransferWarning)
            tiles, resolutions = specs.resolve_model_tiles(
                self.plans, self.cfg, batch, seq_len, kind, self._dtype_name,
                self.hardware)
        tiles, replaced = specs.launchable_tiles(
            tiles, self.cfg, batch, seq_len, kind, self._dtype_name,
            tokens=tokens, cache_lens=cache_lens)
        sources = {kernel: (resolutions[kernel].source
                            if kernel in resolutions else "fallback")
                   for kernel in tiles}
        events = [dict(kernel=k, phase=phase, impl="launch_check",
                       tile=tuple(tiles[k]), fallback=True)
                  for k in replaced]
        return tiles, sources, events

    def _cache_lens(self):
        """The KV cache lengths a decode attends over (none for an
        attention-free arch: recurrent states have no length). Paged, the
        gathered view's ``n_pt * page`` rows, which may exceed max_len."""
        if self.paged:
            attends = any(leaf is not None for leaf in self.pool.arrays)
            return [self.pool.n_pt * self.pool.page] if attends else []
        return sorted({int(c["k"].shape[2]) for c in self._slots[0].caches
                       if is_kv_cache(c)})

    def _resolve_tiles(self) -> None:
        """The decode kernels' tiles at the ``(slots, max_len)`` decode cell,
        with one plan source per kernel recorded under ``decode``. The step
        runs each slot at batch 1, so the tiles are held against M = 1."""
        self._plan_schema = int(self.plans.meta.get(
            "schema_version", PLAN_SCHEMA_VERSION))
        self.tiles, self.tile_sources, events = self._resolve(
            self.slots, self.max_len, "decode", tokens=1,
            cache_lens=self._cache_lens())
        problems = specs.kernel_problems(self.cfg, self.slots, self.max_len,
                                         "decode")
        for kernel, source in self.tile_sources.items():
            self.metrics.record_plan("decode", kernel, source)
            if self._trace is not None:
                self._trace.plan_resolve(
                    "decode", kernel, problem_key(problems.get(kernel, {})),
                    tuple(self.tiles[kernel].dims), source,
                    self._plan_schema)
        for ev in events:
            self._record_tile_event(ev)
        self._note_shadow_cells(problems)

    def _trace_plan_table(self, phase: str, tiles, sources, problems) -> None:
        """One ``plan_resolve`` instant per kernel of a resolved cell: the
        tile it launches (``()`` where no tile was resolved), its source,
        the artifact's schema."""
        for kernel in sorted(sources):
            tile = tiles.get(kernel)
            self._trace.plan_resolve(
                phase, kernel, problem_key(problems.get(kernel) or {}),
                tuple(tile.dims) if tile is not None else (),
                sources[kernel], self._plan_schema)

    # -- live plan refinement ------------------------------------------------
    def _note_shadow_cells(self, problems: Dict[str, Dict[str, int]]) -> None:
        """Register plan cells this engine resolved as shadow targets."""
        for kernel, problem in problems.items():
            key = f"{kernel}|{problem_key(problem)}"
            if key not in self._shadow_cell_map:
                self._shadow_cell_map[key] = (kernel, dict(problem))
                self._shadow_order.append(key)

    def _shadow_view(self, key: str):
        """``(incumbent dims, candidate dims)`` of one cell, or None: the
        incumbent is the plan's resolved tile, the candidates every other
        tile on the resolved entry's sensitivity curve."""
        if key in self._shadow_views:
            return self._shadow_views[key]
        kernel, problem = self._shadow_cell_map[key]
        view = None
        if self.plans is not None:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", PlanTransferWarning)
                res = self.plans.resolve(kernel, problem, self._dtype_name,
                                         self.hardware)
            if res is not None:
                inc = tuple(int(x) for x in res.tile.dims)
                cands, seen = [], {inc}
                for dims, _score in res.entry.curve:
                    dims = tuple(int(x) for x in dims)
                    if dims not in seen:
                        seen.add(dims)
                        cands.append(dims)
                if cands:
                    view = (inc, tuple(cands))
        self._shadow_views[key] = view
        return view

    def _shadow_measure_fn(self):
        if self._shadow_measure is None:
            from repro_torch.serve.refine import make_shadow_measure

            self._shadow_measure = make_shadow_measure(self.hardware)
        return self._shadow_measure

    def _maybe_shadow(self) -> None:
        """When the fractional accumulator crosses 1, measure the next cell
        with a view (round robin) at its incumbent and at its next
        candidate, and record both in the metrics, the trace and the
        refiner. Nothing of the serve is touched."""
        if not self.shadow_fraction or self.plans is None:
            return
        self._shadow_acc += self.shadow_fraction
        if self._shadow_acc < 1.0:
            return
        self._shadow_acc -= 1.0
        if not self._shadow_order:
            return
        measure = self._shadow_measure_fn()
        dtype = self._dtype_name
        for _ in range(len(self._shadow_order)):
            key = self._shadow_order[self._shadow_rr
                                     % len(self._shadow_order)]
            self._shadow_rr += 1
            view = self._shadow_view(key)
            if view is None:
                continue
            inc, cands = view
            kernel, problem = self._shadow_cell_map[key]
            idx = self._shadow_idx.get(key, 0)
            self._shadow_idx[key] = idx + 1
            cand = cands[idx % len(cands)]
            dt_inc = float(measure(kernel, problem, dtype, inc))
            dt_cand = float(measure(kernel, problem, dtype, cand))
            self.metrics.record_shadow(kernel, inc, dt_inc, incumbent=True)
            self.metrics.record_shadow(kernel, cand, dt_cand)
            if self._trace is not None:
                self._trace.shadow(kernel, problem_key(problem), inc, cand,
                                   dt_inc, dt_cand)
            if self.refiner is not None:
                self.refiner.observe(kernel, problem, dtype,
                                     self.hardware.name, inc, dt_inc,
                                     incumbent=True)
                self.refiner.observe(kernel, problem, dtype,
                                     self.hardware.name, cand, dt_cand)
            self.metrics.record_shadow_step()
            return

    def set_plans(self, plans) -> None:
        """Swap the engine onto another plan artifact (or none), live.

        Every plan-derived cache goes: the prefill tiles and sources, the
        tile events, the shadow views, and every slot's captured graph,
        since a graph bakes its tiles in at capture; the next step of each
        slot recaptures with the new decode tiles. Tiles never change the
        math, so requests in flight keep their caches.
        """
        self.plans = plans
        self._prefill_tiles.clear()
        self._prefill_sources.clear()
        self._chunk_plans.clear()
        self._pack_plan_cache = None
        self._single_chunk_edge = None
        self._decode_tile_events = None
        self._shadow_views.clear()
        self.tiles, self.tile_sources = {}, {}
        self._plan_schema = None
        for slot in self._slots:
            slot.graph, slot.launches = None, {}
        if plans is not None:
            self._resolve_tiles()
        if self._trace is not None:
            refined_from = (plans.meta.get("refined_from")
                            if plans is not None else None)
            self._trace.plan_swap(self._plan_schema, refined_from)

    def _prefill_fn(self, length: int):
        """The prefill for one admitted prompt length, with its tiles and
        plan sources resolved once per length (``no_plan`` and the Hopper
        defaults without a plan)."""
        if length not in self._prefill_sources:
            if self.plans is not None:
                tiles, sources, events = self._resolve(1, length, "prefill",
                                                       tokens=length)
            else:
                tiles, events = {}, []
                sources = {kernel: "no_plan" for kernel in
                           specs.kernel_problems(self.cfg, 1, length,
                                                 "prefill")}
            self._prefill_tiles[length] = (tiles, events)
            self._prefill_sources[length] = sources
            problems = specs.kernel_problems(self.cfg, 1, length, "prefill")
            if self._trace is not None:
                self._trace_plan_table("prefill", tiles, sources, problems)
            if self.plans is not None:
                self._note_shadow_cells(problems)
        cfg, max_len, dtype = self.cfg, self.max_len, self.dtype
        tiles = self._prefill_tiles[length][0] or None

        def prefill(params, batch, caches):
            return api.prefill(params, cfg, batch, max_len=max_len,
                               dtype=dtype, caches=caches, tiles=tiles)
        return prefill

    def _run_step(self, slot: _Slot) -> None:
        """One decode step of a slot on its static tensors: the step the
        graph captures, and the eager step on the CPU."""
        tiles = self.tiles or None
        if self.paged:
            logits, _, _ = api.decode_step_paged(
                self.params, self.cfg, slot.token, slot.caches,
                self.pool.arrays, slot.table, tiles=tiles)
        else:
            logits, _ = api.decode_step(self.params, self.cfg, slot.token,
                                        slot.caches, tiles=tiles)
        slot.logits.copy_(logits)
        slot.next_token.copy_(torch.argmax(logits[0, :self.cfg.vocab_size]))

    def _capture(self, slot: _Slot) -> None:
        """Warm up, put the caches back, and capture the slot's step. A
        paged warm-up writes its row into the page the engine has just
        made the request's own; the replay writes the same row again."""
        saved = _snapshot(slot.caches)
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._run_step(slot)
        stream.wait_stream(side)
        _restore(slot.caches, saved)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        before = dict(build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # Relaxed: the wrappers may call cudaFuncSetAttribute (already done
        # by the warm-up, so never for the first time under capture).
        with torch.cuda.graph(graph, pool=self._graph_pool,
                              capture_error_mode="relaxed"):
            self._run_step(slot)
        slot.launches = {k: build.LAUNCHES[k] - n for k, n in before.items()}
        for k, n in slot.launches.items():
            build.LAUNCHES[k] -= n          # captured, not run
        slot.graph = graph

    def _step(self, slot: _Slot) -> None:
        if self._decode_tile_events is None:
            # The step's first run in Python (eager, or the warm-up and
            # capture of a graph): its tile events, once per engine.
            captured: List[Dict[str, Any]] = []
            with attn_mod.capture_tile_events(captured.append):
                self._step_once(slot)
            self._decode_tile_events = self._dedupe_events(captured)
            for ev in self._decode_tile_events:
                self._record_tile_event(ev)
            return
        self._step_once(slot)

    def _step_once(self, slot: _Slot) -> None:
        if self.device.type != "cuda":
            self._run_step(slot)
            return
        if slot.graph is None:
            self._capture(slot)
        slot.graph.replay()
        for k, n in slot.launches.items():
            build.LAUNCHES[k] += n

    # -- chunked prefill ---------------------------------------------------
    def _resolve_serve_cell(self, kind: str, seq_len: int):
        """One serving attention cell (``chunked_prefill`` or
        ``packed_prefill``) from the plan, or the kernel's Hopper default:
        ``(problem | None, tile | None, source)``; problem is None for an
        attention-free model (the cell never runs)."""
        from repro_torch import kernels
        from repro_torch.core import registry

        kernels.register_all()
        problem = specs.kernel_problems(self.cfg, 1, seq_len, kind).get(kind)
        tile, source = None, "no_plan"
        if problem is not None:
            if self.plans is not None:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", PlanTransferWarning)
                    res = self.plans.resolve(kind, problem, self._dtype_name,
                                             self.hardware)
                if res is not None:
                    tile, source = res.tile, res.source
                else:
                    source = "fallback"
            if tile is None:
                tile = registry.get(kind).default_tile(problem,
                                                       self._dtype_name)
        return problem, tile, source

    def _model_tiles_for(self, seq_len: int):
        """The FF and recurrent kernels' prefill tiles at one geometry, with
        their plan sources and the events of tiles replaced as unlaunchable.
        The whole-prompt ``flash_attention`` cell is left out: chunk and
        pack programs run the ``chunked_prefill`` / ``packed_prefill``
        cells instead."""
        if self.plans is None:
            return {}, {kernel: "no_plan" for kernel in specs.kernel_problems(
                self.cfg, 1, seq_len, "prefill") if kernel != "flash_attention"
            }, []
        tiles, sources, events = self._resolve(1, seq_len, "prefill",
                                               tokens=seq_len)
        tiles.pop("flash_attention", None)
        sources.pop("flash_attention", None)
        return tiles, sources, events

    def _chunk_plan(self, admit_len: int):
        """``(chunk_len, tiles, sources, events)`` for one admitted length.

        The chunk is the resolved ``chunked_prefill`` tile's first dim,
        clamped so one chunk plus a full decode batch fits
        ``step_token_budget`` (the reference's rule); the FF and recurrent
        tiles are resolved at the chunk, the geometry the chunks run."""
        hit = self._chunk_plans.get(admit_len)
        if hit is not None:
            return hit
        problem, tile, source = self._resolve_serve_cell(
            "chunked_prefill", admit_len)
        chunk = int(tile[0]) if tile is not None else min(512, admit_len)
        if self.step_token_budget:
            chunk = min(chunk, max(1, self.step_token_budget - self.slots))
        chunk = max(1, min(chunk, admit_len))
        if self._paged_whole:
            # Paged without chunking: the whole prompt is one chunk, the
            # unchunked engine's schedule.
            chunk = admit_len
        tiles, sources, events = self._model_tiles_for(chunk)
        if tile is not None:
            tiles["chunked_prefill"] = tile
        if problem is not None:
            # No phantom counter for a kernel an attention-free model
            # never runs.
            sources["chunked_prefill"] = source
        entry = (chunk, tiles, sources, events)
        self._chunk_plans[admit_len] = entry
        if self._trace is not None or self.plans is not None:
            cells = specs.kernel_problems(self.cfg, 1, chunk, "prefill")
            if problem is not None:
                cells["chunked_prefill"] = problem
            if self._trace is not None:
                self._trace_plan_table("prefill", tiles, sources, cells)
            if self.plans is not None:
                cells.pop("flash_attention", None)
                self._note_shadow_cells(cells)
        return entry

    def chunk_len_for(self, admit_len: int) -> int:
        """Chunk length one admitted prompt prefills in (``admit_len`` when
        chunking is off: the whole prefill is one quantum)."""
        if not self.chunk_prefill:
            return admit_len
        return self._chunk_plan(admit_len)[0]

    # -- step packing --------------------------------------------------------
    def _pack_plan(self):
        """``(pack width, tiles, source, events)`` of packed steps: the
        resolved ``packed_prefill`` tile's first dim at the single-chunk
        bucket bound (the short prompts packing exists for), the FF and
        recurrent tiles at the pack's width."""
        if self._pack_plan_cache is not None:
            return self._pack_plan_cache
        policy = getattr(self.scheduler, "policy", None)
        edge = self._single_chunk_bound() or (
            min(policy.edges) if policy is not None else 512)
        problem, tile, source = self._resolve_serve_cell("packed_prefill",
                                                         edge)
        width = int(tile[0]) if tile is not None else max(512, edge)
        tiles, _, events = self._model_tiles_for(min(width, self.max_len))
        if tile is not None:
            tiles["packed_prefill"] = tile
        self._pack_plan_cache = (width, tiles, source, events)
        if problem is not None:
            if self._trace is not None:
                self._trace_plan_table("prefill", tiles,
                                       {"packed_prefill": source},
                                       {"packed_prefill": problem})
            if self.plans is not None:
                self._note_shadow_cells({"packed_prefill": problem})
        return self._pack_plan_cache

    def _pack_budget(self) -> float:
        """Max prefill-chunk tokens one packed step may carry: the pack
        width, clamped so pack + decode batch fits the step budget."""
        width = self._pack_plan()[0]
        if self.step_token_budget:
            return min(width, max(1, self.step_token_budget - self.slots))
        return width

    def _ensure_state(self, job: _ChunkJob) -> None:
        """Give a job its cache set at its first chunk: one from the free
        list (or a new one), emptied for the new sequence."""
        if job.state is not None:
            return
        if self._free_sets:
            job.state = self._free_sets.pop()
            T.reset_caches(job.state)
        else:
            job.state = self._new_state()
            self.cache_sets_made += 1
        if self.paged and job.table is None:
            job.table = self.pool.new_table()

    def _advance_job(self, job: _ChunkJob, take: int, events, logits,
                     packed: bool = False, pack_n: int = 1, lane: int = 0,
                     t0: Optional[float] = None) -> None:
        """Per-chunk bookkeeping of the one-chunk and packed paths (one
        implementation, as the reference keeps it): events accrue, the
        chunk is counted (and traced on its pack lane), progress advances,
        a finished prefill leaves."""
        job.events.extend(events)
        now = self._clock()
        age = now - job.last_t
        self.metrics.record_chunk(job.req.bucket, age)
        if self._trace is not None:
            self._trace.chunk(job.req.rid, lane, now if t0 is None else t0,
                              job.done, take, pack_n, age)
        job.last_t = now
        job.done += take
        job.chunks_run += 1
        job.packed_runs += packed
        if job.done >= len(job.prompt):
            self._chunking.remove(job)
            self._finish_prefill(job, logits)

    def _run_pack(self, picks) -> int:
        """Advance every picked job by one chunk in one packed step;
        returns the pack's token count."""
        jobs = [job for job, _ in picks]
        layout = tuple((job.done, take) for job, take in picks)
        t0 = self._clock() if self._trace is not None else None
        for job in jobs:
            self._ensure_state(job)
        toks = np.concatenate([job.prompt[start:start + take]
                               for job, (start, take) in zip(jobs, layout)])
        _, tiles, _, plan_events = self._pack_plan()
        events: List[Dict[str, Any]] = list(plan_events)
        tokens = torch.as_tensor(toks[None], dtype=torch.long,
                                 device=self.device)
        states = tuple(job.state for job in jobs)
        if self.paged:
            # Every segment's pages before the first launch: the pack
            # writes in place, and a split must copy what the step found.
            for job, (start, take) in zip(jobs, layout):
                self.pool.prepare_span(job.req.rid, start, take)
            for job in jobs:
                self.pool.device_table(job.req.rid, job.table)
        with torch.inference_mode(), \
                attn_mod.capture_tile_events(events.append):
            if self.paged:
                logits, _, _ = api.prefill_packed_paged(
                    self.params, self.cfg, tokens, states, layout,
                    self.pool.arrays, tuple(job.table for job in jobs),
                    tiles=tiles or None)
            else:
                logits, _ = api.prefill_packed(
                    self.params, self.cfg, tokens, states, layout,
                    tiles=tiles or None)
        events = self._dedupe_events(events)
        for i, (job, (_, take)) in enumerate(zip(jobs, layout)):
            self._advance_job(job, take, events, logits[i][None],
                              packed=True, pack_n=len(jobs), lane=i, t0=t0)
        return sum(take for _, take in layout)

    def _is_multi_chunk(self, req: Request) -> bool:
        """Will this request's prefill span more than one chunk?"""
        admit_len = req.bucket if req.bucket is not None else len(req.prompt)
        return admit_len > self._chunk_plan(admit_len)[0]

    def _single_chunk_bound(self) -> int:
        """Largest bucket edge whose prefill fits one chunk (0 if none)."""
        if self._single_chunk_edge is None:
            policy = getattr(self.scheduler, "policy", None)
            edges = policy.edges if policy is not None else ()
            self._single_chunk_edge = max(
                (e for e in edges if self._chunk_plan(e)[0] >= e), default=0)
        return self._single_chunk_edge

    def _next_admission(self, long_ok: bool) -> Optional[Request]:
        """Next request to start prefilling (the reference's rule): with
        ``long_ok=False`` only single-chunk requests qualify. A bucketed
        scheduler pops within the single-chunk bound, so queued longs stay
        queued; a FIFO one cannot, and deferred longs wait in ``_held``
        (at most ``prefill_slots`` of them)."""
        for i, req in enumerate(self._held):
            if long_ok or not self._is_multi_chunk(req):
                return self._held.pop(i)
        within = getattr(self.scheduler, "next_request_within", None)
        if not long_ok and within is not None:
            return within(self._single_chunk_bound())
        while len(self._held) < self.prefill_slots:
            req = self.scheduler.next_request()
            if req is None:
                return None
            if long_ok or not self._is_multi_chunk(req):
                return req
            self._held.append(req)
        return None

    def _admit_chunked(self) -> None:
        """Move ready prefills into free decode slots, then queued requests
        into free prefill slots, at most one multi-chunk prefill at a time.

        A ready request's state is copied into its slot's own tensors (the
        ones the slot's captured graph holds) and its cache set goes back
        to the free list. Admission stalls while the ready backlog covers
        every decode slot, so at most ``slots + prefill_slots - 1`` cache
        sets ever live besides the slots'.

        Paged, the pool's reservation gate bounds the prefills in flight
        (up to 8 x (slots + prefill_slots)) in place of ``prefill_slots``,
        requests the pool cannot reserve for wait in FIFO order, the
        one-long rule is lifted, and a prompt's registered prefix is mapped
        at admission (the job starts after it)."""
        free = [i for i, r in enumerate(self._active) if r is None]
        while free and self._ready:
            req, state, length = self._ready.pop(0)
            i = free.pop(0)
            _move_state(state, self._slots[i].caches, length)
            self._free_sets.append(state)
            self._active[i] = req
        if len(self._ready) >= self.slots:
            return
        long_in_flight = any(len(j.prompt) > j.chunk_len
                             for j in self._chunking)
        cap = (8 * (self.slots + self.prefill_slots) if self.paged
               else self.prefill_slots)
        while len(self._chunking) < cap:
            req = None
            if self.paged and self._pool_wait:
                # The head of the pool-wait line admits first or nobody
                # does.
                if not self.pool.can_admit(
                        self._pool_estimate(self._pool_wait[0])):
                    break
                req = self._pool_wait.pop(0)
            if req is None:
                req = self._next_admission(
                    long_ok=self.paged or not long_in_flight)
            if req is None:
                break
            if self.paged and not self.pool.can_admit(
                    self._pool_estimate(req)):
                self._pool_wait.append(req)
                break
            prompt = np.asarray(self.scheduler.prepare(req), np.int32)
            chunk_len, _, _, plan_events = self._chunk_plan(len(prompt))
            long_in_flight = long_in_flight or len(prompt) > chunk_len
            submit_t = self.metrics.submit_time(req.rid)
            if self._trace is not None:
                self._trace.admit(
                    req.rid, len(prompt),
                    self._clock() - submit_t if submit_t is not None else 0.0)
            hit = 0
            if self.paged:
                self.pool.register_request(
                    req.rid, len(prompt) + req.max_new_tokens - 1)
                hit = self.pool.lookup_prefix(req.rid, prompt.tolist())
            self._chunking.append(_ChunkJob(
                req=req, prompt=prompt, chunk_len=chunk_len, done=hit,
                events=list(plan_events),
                last_t=submit_t if submit_t is not None else self._clock()))

    def _pool_estimate(self, req: Request) -> int:
        """The cache positions a request may write, for the pool's gate:
        the admitted prompt and the generation, less the last sampled token
        (never cached)."""
        admit_len = req.bucket if req.bucket is not None else len(req.prompt)
        return admit_len + req.max_new_tokens - 1

    # Every AGING_PERIOD-th chunk goes to the oldest in-flight prefill
    # instead of the shortest-remaining one, so a stream of short prompts
    # cannot starve a long prefill (the reference's floor).
    AGING_PERIOD = 4

    def _next_chunk_job(self) -> Optional[_ChunkJob]:
        """The most urgent in-flight prefill: priority, deadline, then
        fewest remaining tokens, with periodic aging."""
        if not self._chunking:
            return None
        self._chunk_ticks += 1
        if self._chunk_ticks % self.AGING_PERIOD == 0:
            return min(self._chunking,
                       key=lambda j: (j.req.priority, j.req.deadline,
                                      j.req.rid))
        return min(self._chunking,
                   key=lambda j: (j.req.priority, j.req.deadline,
                                  j.remaining, j.req.rid))

    def _run_chunk(self, job: _ChunkJob) -> int:
        """Advance one job by one chunk (eager, with the tiles of its
        admitted length); returns the chunk's token count."""
        start = job.done
        length = min(job.chunk_len, len(job.prompt) - start)
        t0 = self._clock() if self._trace is not None else None
        self._ensure_state(job)
        _, tiles, _, _ = self._chunk_plan(len(job.prompt))
        events: List[Dict[str, Any]] = []
        tokens = torch.as_tensor(job.prompt[None, start:start + length],
                                 dtype=torch.long, device=self.device)
        if self.paged:
            self.pool.prepare_span(job.req.rid, start, length)
            self.pool.device_table(job.req.rid, job.table)
        with torch.inference_mode(), \
                attn_mod.capture_tile_events(events.append):
            if self.paged:
                logits, _, _ = api.prefill_chunk_paged(
                    self.params, self.cfg, tokens, job.state, start,
                    self.pool.arrays, job.table, tiles=tiles or None)
            else:
                logits, _ = api.prefill_chunk(
                    self.params, self.cfg, tokens, job.state, start,
                    tiles=tiles or None)
        self._advance_job(job, length, self._dedupe_events(events), logits,
                          t0=t0)
        return length

    def _finish_prefill(self, job: _ChunkJob, logits) -> None:
        """Last chunk done: sample the first token and count the prefill's
        plan sources and tile events once per request, not per chunk."""
        req = job.req
        for kernel, source in self._chunk_plan(len(job.prompt))[2].items():
            self.metrics.record_plan("prefill", kernel, source)
        if job.packed_runs:
            self.metrics.record_plan("prefill", "packed_prefill",
                                     self._pack_plan()[2])
        for ev in self._dedupe_events(job.events):
            self._record_tile_event(ev)
        self.metrics.record_prefill_chunks(job.chunks_run)
        req.out_tokens.append(
            int(torch.argmax(logits[0, :self.cfg.vocab_size])))
        self._first_token(req)
        if self.paged:
            # Its pages become shareable (a weak registry: no references).
            self.pool.register_prefix(req.rid, job.prompt.tolist())
        if len(req.out_tokens) >= req.max_new_tokens:
            req.done = True
            if self.paged:
                self.pool.release(req.rid)
            self._free_sets.append(job.state)
            self._finished.append(req)
            self.metrics.record_complete()
            if self._trace is not None:
                self._trace.finish(req.rid, len(req.out_tokens))
        else:
            if self.paged:
                # The first decode writes right after the prompt.
                self._pos[req.rid] = len(job.prompt)
            self._ready.append((req, job.state, len(job.prompt)))

    def _first_token(self, req: Request) -> None:
        """Record a request's first token. Traced, the submit time is read
        before ``record_first_token`` pops it, and one clock reading is
        both the metric's and the ``ttft`` span's end."""
        if self._trace is None:
            self.metrics.record_first_token(req.rid, req.bucket)
            return
        sub_t = self.metrics.submit_time(req.rid)
        now = self.metrics.clock()
        self.metrics.record_first_token(req.rid, req.bucket, t=now)
        self._trace.first_token(req.rid, req.bucket, sub_t, now=now)

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
        self._record_backlog(self._backlog())
        if self._trace is not None:
            self._trace.submit(rid, len(prompt), req.bucket)
        return rid

    def _reject(self, reason: str, prompt_len: int) -> None:
        """Account one admission rejection (reason counter + backlog
        sample); the reason also lands in ``self.last_reject_reason``."""
        self.last_reject_reason = reason
        self.metrics.record_reject(reason=reason)
        self._record_backlog(self._backlog())
        if self._trace is not None:
            self._trace.reject(reason, prompt_len)
        return None

    def _backlog(self) -> int:
        """Queued requests: the scheduler's, deferred multi-chunk ones and
        the pool-wait line."""
        return (self.scheduler.pending() + len(self._held)
                + len(self._pool_wait))

    def _record_backlog(self, depth: int) -> None:
        self.metrics.record_queue_depth(depth)
        if self._trace is not None:
            self._trace.queue_depth(depth)

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
            # Into the first free slot's caches; a request that its prefill
            # token satisfies leaves the slot free.
            # Tile events count once per admitted request, as its plan
            # sources do: the replaced tiles' and the call sites'.
            events = list(self._prefill_tiles[len(prompt)][1])
            sub_t = (self.metrics.submit_time(req.rid)
                     if self._trace is not None else None)
            t0 = self._clock() if self._trace is not None else None
            with torch.inference_mode(), \
                    attn_mod.capture_tile_events(events.append):
                logits, _ = prefill(self.params, batch,
                                    self._slots[free[0]].caches)
                tok = int(torch.argmax(logits[0, :self.cfg.vocab_size]))
            for ev in self._dedupe_events(events):
                self._record_tile_event(ev)
            req.out_tokens.append(tok)
            if self._trace is None:
                self.metrics.record_first_token(req.rid, req.bucket)
            else:
                self._trace.admit(req.rid, len(prompt),
                                  t0 - sub_t if sub_t is not None else 0.0)
                self._trace.prefill(req.rid, t0, len(prompt))
                self._first_token(req)
            if len(req.out_tokens) >= req.max_new_tokens:
                # Satisfied by the prefill token alone — never occupy a slot.
                req.done = True
                self._finished.append(req)
                self.metrics.record_complete()
                if self._trace is not None:
                    self._trace.finish(req.rid, len(req.out_tokens))
                continue
            self._active[free.pop(0)] = req
        return prefill_tokens, tuple(segments)

    def _decode_all(self) -> int:
        """One decode step for every active slot. Returns #active."""
        active_buckets = []
        t0 = self._clock()
        stepped = [(i, req) for i, req in enumerate(self._active)
                   if req is not None]
        with torch.inference_mode():
            for i, req in stepped:
                active_buckets.append(req.bucket)
                if self.paged:
                    self._prepare_paged_step(self._slots[i], req.rid)
                self._slots[i].token.fill_(req.out_tokens[-1])
                self._step(self._slots[i])
                if self.paged and len(req.out_tokens) + 1 >= \
                        req.max_new_tokens:
                    # Its last step: the pages go back before the next
                    # slot's, in the reference's order (the stream keeps
                    # this step's reads ahead of any reuse).
                    self.pool.release(req.rid)
                    self._pos.pop(req.rid, None)
            toks = (torch.stack([self._slots[i].next_token
                                 for i, _ in stepped]).tolist()
                    if stepped else [])
        for (i, req), tok in zip(stepped, toks):
            req.out_tokens.append(tok)
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self._active[i] = None
                self._finished.append(req)
                self.metrics.record_complete()
                if self._trace is not None:
                    self._trace.finish(req.rid, len(req.out_tokens))
        self.metrics.record_decode_step(active_buckets, self._clock() - t0)
        if self._trace is not None and stepped:
            self._trace.decode(t0, [req.rid for _, req in stepped])
        return len(stepped)

    def _prepare_paged_step(self, slot: _Slot, rid: int) -> None:
        """Before a paged step (and before its warm-up and capture): make
        the page the row lands in the request's own, then copy the table
        into the slot's table tensor if it changed (a new page, a split, a
        new request). The graph reads the tensor, so it replays as is."""
        pos = self._pos[rid]
        self.pool.prepare_span(rid, pos, 1)
        self._pos[rid] = pos + 1
        if slot.table_host != self.pool.tables[rid]:
            self.pool.device_table(rid, slot.table)
            slot.table_host = list(self.pool.tables[rid])

    def step(self) -> int:
        """One engine step. Unchunked: admit (each admission runs its whole
        prefill), one decode step over the active slots, then a second
        admission pass so slots freed by this decode are claimed in the same
        step; returns the number of requests decoded. Chunked: a mixed step
        (:meth:`_step_chunked`)."""
        if self.chunk_prefill:
            return self._step_chunked()
        t0 = self._clock() if self._trace is not None else 0.0
        prefill_tokens, segments = self._admit()
        self._record_backlog(self.scheduler.pending())
        n = self._decode_all()
        extra_tokens, extra_segments = self._admit()
        self.last_step_stats = {"prefill_tokens": prefill_tokens + extra_tokens,
                                "decode_tokens": n,
                                "packed_chunks": 0, "packed_rids": (),
                                "prefill_segments": segments + extra_segments}
        self._maybe_shadow()
        self.steps_run += 1
        if self._trace is not None:
            self._trace.step_mark(t0, self.last_step_stats, self.steps_run)
        return n

    def _step_chunked(self) -> int:
        """A mixed step: one prefill chunk for the most urgent prefill in
        flight (or, packed, the scheduler's knapsack of chunks), then the
        whole decode batch, then a second admission pass. Returns the
        requests in service, as the reference does."""
        t0 = self._clock() if self._trace is not None else 0.0
        self._admit_chunked()
        self._record_backlog(self._backlog())
        prefill_tokens = 0
        packed_rids: tuple = ()
        segments: tuple = ()
        if self.pack_prefill:
            picks = self._next_pack()
            if picks:
                packed_rids = tuple(job.req.rid for job, _ in picks)
                segments = tuple((len(job.prompt), take)
                                 for job, take in picks)
                self.metrics.record_packed_step(len(picks))
                if len(picks) == 1:
                    prefill_tokens = self._run_chunk(picks[0][0])
                else:
                    prefill_tokens = self._run_pack(picks)
                self._admit_chunked()
        else:
            job = self._next_chunk_job()
            if job is not None:
                packed_rids = (job.req.rid,)
                segments = ((len(job.prompt),
                             min(job.chunk_len, job.remaining)),)
                prefill_tokens = self._run_chunk(job)
                # A prefill that chunk finished may decode this very step.
                self._admit_chunked()
        n = self._decode_all()
        # Second pass: what this decode finished freed its slot (and its
        # pages, which a pool-waiting request may now claim).
        self._admit_chunked()
        if self.paged:
            self.metrics.record_pool(self.pool.used_pages,
                                     self.pool.n_pages)
            if self._trace is not None:
                self._trace.pool_occupancy(self.pool.used_pages,
                                           self.pool.n_pages)
        self.last_step_stats = {"prefill_tokens": prefill_tokens,
                                "decode_tokens": n,
                                "packed_chunks": len(packed_rids),
                                "packed_rids": packed_rids,
                                "prefill_segments": segments}
        self._maybe_shadow()
        self.steps_run += 1
        if self._trace is not None:
            self._trace.step_mark(t0, self.last_step_stats, self.steps_run)
        return (n + len(self._chunking) + len(self._ready)
                + len(self._held) + len(self._pool_wait))

    def _next_pack(self):
        """The chunks a packed step runs: the scheduler's knapsack over the
        prefills in flight under the pack budget, at most
        ``prefill_slots`` segments, with the one-chunk path's head rule."""
        if not self._chunking:
            return []
        self._chunk_ticks += 1
        aging = self._chunk_ticks % self.AGING_PERIOD == 0
        return pick_chunks(self._chunking, self._pack_budget(),
                           self.prefill_slots, aging=aging)

    def in_flight(self) -> int:
        """Requests holding engine state: decode slots, prefills in
        flight, finished prefills waiting for a slot, deferred longs, and
        the pool-wait line."""
        return (sum(r is not None for r in self._active)
                + len(self._chunking) + len(self._ready) + len(self._held)
                + len(self._pool_wait))

    # -- eviction and handoff (the fleet's fault tolerance) -------------------
    def _evict_state(self, req: Request) -> None:
        """Tear down one request's bookkeeping: its pages released
        (``missing_ok``: a queued, held or pool-waiting request never
        registered), its decode cursor dropped, and its pending TTFT anchor
        moved onto the request (the router re-anchors it on the next
        engine). Cache sets and slots are the caller's."""
        if self.paged:
            self.pool.release(req.rid, missing_ok=True)
            self._pos.pop(req.rid, None)
        t = self.metrics.drop_submit(req.rid)
        if t is not None:
            req.submit_t = t

    def extract_queued(self) -> List[Request]:
        """Hand off every request that has not started prefilling: the
        scheduler's queue (in its order), the deferred multi-chunk requests
        and the pool-wait line. None holds a cache set, a slot or a page.
        The caller queues them elsewhere (drain, work handoff)."""
        out: List[Request] = []
        while True:
            req = self.scheduler.next_request()
            if req is None:
                break
            out.append(req)
        out.extend(self._held)
        self._held.clear()
        out.extend(self._pool_wait)
        self._pool_wait.clear()
        for req in out:
            self._evict_state(req)
        return out

    def evict_all(self) -> List[Request]:
        """Evict every request that has not finished (queued, prefilling,
        ready or decoding) and return them with their tokens so far; the
        fleet re-prefills them from their prompts elsewhere. Each cache set
        goes back to the free list and each page to the pool. A decode
        slot only loses its request: its tensors (caches, token, logits,
        table) stay, since the slot's captured graph holds their addresses,
        and the next request copied into them replays the same graph.
        Finished requests stay in ``self._finished``."""
        out = self.extract_queued()
        for job in self._chunking:
            self._release_job(job)
            out.append(job.req)
        self._chunking.clear()
        for req, state, _ in self._ready:
            self._evict_state(req)
            self._free_sets.append(state)
            out.append(req)
        self._ready.clear()
        for i, req in enumerate(self._active):
            if req is not None:
                self._evict_state(req)
                self._active[i] = None
                out.append(req)
        return out

    def _release_job(self, job: _ChunkJob) -> None:
        """A prefill in flight leaves: its cache set (taken at its first
        chunk) back to the free list, and its request's bookkeeping."""
        self._evict_state(job.req)
        if job.state is not None:
            self._free_sets.append(job.state)

    def cancel(self, rid: int) -> Optional[Request]:
        """Remove one request wherever it is (queued, held, pool-waiting,
        prefilling, ready or decoding), torn down as :meth:`evict_all`
        tears down each. Returns it, or None when ``rid`` is not here
        (finished, or never admitted)."""
        remove = getattr(self.scheduler, "remove", None)
        req = remove(rid) if remove is not None else None
        for pen in (self._held, self._pool_wait):
            if req is None:
                req = next((r for r in pen if r.rid == rid), None)
                if req is not None:
                    pen.remove(req)
        if req is not None:
            self._evict_state(req)
            return req
        for job in self._chunking:
            if job.req.rid == rid:
                self._chunking.remove(job)
                self._release_job(job)
                return job.req
        for i, (r, state, _) in enumerate(self._ready):
            if r.rid == rid:
                del self._ready[i]
                self._free_sets.append(state)
                self._evict_state(r)
                return r
        for i, r in enumerate(self._active):
            if r is not None and r.rid == rid:
                self._active[i] = None
                self._evict_state(r)
                return r
        return None

    def run_until_done(self, max_steps: int = 1000) -> List[Request]:
        self._finished = []
        for _ in range(max_steps):
            if not self.in_flight() and not self.scheduler.pending():
                break
            self.step()
        return self._finished


def _move_state(src, dst, length: int) -> None:
    """Copy a prefilled cache set into a decode slot's own tensors: the K/V
    rows ``length`` positions wrote (all of a ring's written slots), the
    position and slot map, and every recurrent state whole (a paged state
    has no K/V: its positions and recurrent states). ``dst`` keeps its
    tensors, so a graph captured on them stays valid."""
    for s, d in zip(src, dst):
        if not is_kv_cache(s):
            for key, t in s.items():
                d[key].copy_(t)
            continue
        rows = min(length, s["k"].shape[2])
        d["k"][:, :, :rows].copy_(s["k"][:, :, :rows])
        d["v"][:, :, :rows].copy_(s["v"][:, :, :rows])
        d["pos"].copy_(s["pos"])
        if "slot_pos" in s:
            d["slot_pos"].copy_(s["slot_pos"])


def _snapshot(caches):
    """What one decode step changes in each cache: in a KV cache the
    position, the K/V row it writes (at ``pos % length``) and a ring's slot
    map; in a recurrent state all of it (conv tails and ``h``)."""
    saved = []
    for c in caches:
        if not is_kv_cache(c):
            saved.append({k: t.clone() for k, t in c.items()})
            continue
        row = (c["pos"] % c["k"].shape[2]).to(torch.long).view(1)
        saved.append((c["pos"].clone(), row, c["k"].index_select(2, row),
                       c["v"].index_select(2, row),
                       c["slot_pos"].clone() if "slot_pos" in c else None))
    return saved


def _restore(caches, saved) -> None:
    for c, snap in zip(caches, saved):
        if not is_kv_cache(c):
            for k, t in snap.items():
                c[k].copy_(t)
            continue
        pos, row, k, v, slot_pos = snap
        c["k"].index_copy_(2, row, k)
        c["v"].index_copy_(2, row, v)
        c["pos"].copy_(pos)
        if slot_pos is not None:
            c["slot_pos"].copy_(slot_pos)
