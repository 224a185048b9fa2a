"""Deterministic synthetic LM data pipeline — the port's copy of
``repro/data/pipeline.py`` (numpy only, so the two give the same bits).

Per-host sharding (each host makes only its slice of the global batch),
a checkpointable iterator state (a step counter: the stream is a pure
function of (seed, step, host)), document packing and a background
prefetch thread. The text is a Zipf-like token stream with document
structure, so losses are not degenerate. Batches are int32 numpy arrays;
the model API moves them to the parameters' device as int64.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    eos_id: int = 1
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _zipf_tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    # Zipf over the real vocab (ids >= 2; 0 = pad, 1 = eos).
    ranks = rng.zipf(1.3, size=n)
    return np.clip(ranks + 1, 2, vocab - 1).astype(np.int32)


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Pure function of (cfg, step): host-local {"tokens", "targets"}."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    b, s = cfg.host_batch, cfg.seq_len
    toks = _zipf_tokens(rng, b * (s + 1), cfg.vocab_size).reshape(b, s + 1)
    # Document packing: insert EOS at geometric boundaries.
    doc_end = rng.random((b, s + 1)) < (1.0 / cfg.mean_doc_len)
    toks = np.where(doc_end, cfg.eos_id, toks)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class DataIterator:
    """Checkpointable, prefetching iterator over :func:`make_batch`."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self._step = step + 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    @property
    def state(self) -> Dict[str, int]:
        """Checkpointable state: resume with DataIterator(cfg, state['step'])."""
        return {"step": self._step}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
