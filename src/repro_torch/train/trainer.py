"""Trainer: the fault-tolerant training loop — the port of
``repro/train/trainer.py``.

It drives the data pipeline, takes the train step, checkpoints every N
steps (async, atomic), restores and continues after a failure (simulated
with ``run(fail_at=)`` or real), tracks step-time health and stragglers,
and logs. All state lives in (params, opt_state, data step), and all of it
round-trips through the :class:`CheckpointManager`: a process can die at
any step and resume.

The port runs on one device (``device=``, default ``cuda``; the CPU runs
the kernels' plain versions). On the card the FF GEMMs and the attention
launch the matmul and flash-attention kernels, forward and backward.

``mesh=`` (``launch/mesh.py``, built over an initialised process group;
one Trainer a rank) runs the step of ``train/step.py`` on the mesh: every
rank makes the global batch of the step and reads its rows
(``sharding_rules.local_batch``), holds its blocks of the parameters and
moments (``api.rank_shardings``: over the model axis where it has more
than one rank, and with FSDP, the default, over the data axis where it
has more than one), and takes the update averaged over the batch axes, so
the ranks of one model coordinate hold one model between them. Every rank calls the
checkpoint's save and restore with those shardings (the save gathers each
leaf whole, a collective; the restore cuts each rank's blocks from the
whole arrays on disk), and only rank 0 writes; before a restore every rank
waits for its writes (a barrier), so all restart from the same step. A rank restarts in
place only on the injected failure, which every rank raises at the same
step before the step's collectives. Any other failure on a mesh raises: a
rank that failed alone would leave its peers inside the step's all-reduce,
and its restore's barrier would pair with it. The group then restarts as a
whole, and ``try_restore`` resumes it from the last checkpoint.

Tile selection: ``TrainerConfig.tile_plans`` names a compiled
:class:`~repro_torch.core.plans.TilePlan` artifact (or pass it as
``plans=``). The trainer resolves the ``kind="train"`` cell's tiles from
it once, at construction (``launch/specs.py:resolve_model_tiles``); a
corrupt or missing artifact degrades to the kernels' defaults, and on the
card a tile the forward's calls would not launch is swapped for the
default (``launchable_tiles``). No sweep runs on the step loop.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core.hardware import PRODUCTION_TARGET
from repro_torch.core.hardware import get as get_hardware
from repro_torch.core.plans import PlanResolution, TilePlan
from repro_torch.core.tiling import TileShape
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed import sharding_rules as rules
from repro_torch.distributed.fault_tolerance import HealthMonitor, StepTimer
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.step import make_train_step

log = logging.getLogger("repro_torch.trainer")


class InjectedFailure(RuntimeError):
    """The worker failure ``Trainer.run(fail_at=)`` raises."""


def default_checkpoint_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(
        default_factory=default_checkpoint_dir)
    keep: int = 3
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    microbatches: int = 1
    seed: int = 0
    param_dtype: Any = torch.float32
    log_every: int = 10
    # AOT tile plans: a compiled artifact and the hardware to resolve for
    # ("" = the production target, the H100). Corrupt or missing artifacts
    # are tolerated (the kernels' defaults), never swept around.
    tile_plans: Optional[str] = None
    hardware: str = ""


class Trainer:
    def __init__(self, cfg: ArchConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig, mesh=None,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 plans: Optional[TilePlan] = None, device=None):
        self.mesh = mesh
        self.ctx = rules.make_context(mesh) if mesh is not None else None
        self.cfg = cfg
        self._shardings = None
        if self.ctx is not None:
            sh = api.rank_shardings(cfg, self.ctx)
            self._shardings = {"params": sh,
                               "opt": rules.opt_state_shardings(sh, mesh)}
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.monitor = HealthMonitor()
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep)
        # On a mesh rank 0 alone writes, so no two ranks write one folder.
        self._writes = self.ctx is None or dist.get_rank() == 0
        self.hardware = (get_hardware(tcfg.hardware) if tcfg.hardware
                         else PRODUCTION_TARGET)
        self.tiles: Dict[str, TileShape] = {}
        self.tile_resolutions: Dict[str, PlanResolution] = {}
        if plans is None:
            plans = TilePlan.load_or_none(tcfg.tile_plans)
        if plans is not None:
            self._resolve_tiles(plans)

        lr_fn = lambda step: warmup_cosine(
            step, peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
            total_steps=tcfg.steps)
        self._step = make_train_step(
            cfg, self.opt_cfg, lr_fn, microbatches=tcfg.microbatches,
            tiles=self.tiles or None, ctx=self.ctx)

    def _dtype_name(self) -> str:
        return str(self.tcfg.param_dtype).replace("torch.", "")

    def _resolve_tiles(self, plans: TilePlan) -> None:
        """Resolve the train step's kernel tiles from the plan store. No
        sweeps. The step takes per-host batches, so the cell is at
        host_batch (on a mesh, a rank's share of it)."""
        from repro_torch.launch import specs

        b, s = self.data_cfg.host_batch, self.data_cfg.seq_len
        if self.ctx is not None:         # a rank's rows
            b //= self.ctx.axis_size("batch")
        dtype = self._dtype_name()
        self.tiles, self.tile_resolutions = specs.resolve_model_tiles(
            plans, self.cfg, b, s, "train", dtype, self.hardware)
        if self.device.type == "cuda":
            rows = b // self.tcfg.microbatches * s
            self.tiles, _ = specs.launchable_tiles(
                self.tiles, self.cfg, b, s, "train", dtype, tokens=rows)

    # -- state --------------------------------------------------------------
    def init_state(self, device=None):
        """Parameters from the seed (the rank's blocks on a mesh) and fresh
        moments; ``device="meta"`` gives the whole-shaped template a
        restore reads into."""
        meta = device is not None and torch.device(device).type == "meta"
        params = api.init_params(self.cfg, self.tcfg.seed,
                                 dtype=self.tcfg.param_dtype,
                                 device=device or self.device,
                                 ctx=None if meta else self.ctx)
        opt_state = adamw.init_state(params, self.opt_cfg)
        return params, opt_state, 0

    def _save(self, step: int, params, opt_state) -> None:
        """A checkpoint of the state (on a mesh, every rank gathers it and
        rank 0 writes)."""
        self.ckpt.save(step, {"params": params, "opt": opt_state},
                       extra={"data_step": step}, shardings=self._shardings,
                       write=self._writes)

    def try_restore(self):
        # An async save still in flight lands before anyone looks for the
        # latest checkpoint (on a mesh, rank 0's, before every rank looks).
        # Without the wait a restart soon after a save resumed from the
        # checkpoint before it.
        self.ckpt.wait()
        if self.ctx is not None:
            dist.barrier()
        latest = self.ckpt.latest_step()
        if latest is None:
            return self.init_state()
        if self.ctx is None:
            params, opt_state, _ = self.init_state()
            tree = self.ckpt.restore({"params": params, "opt": opt_state})
        else:
            # Each rank reads its blocks of the whole arrays on disk.
            params, opt_state, _ = self.init_state(device="meta")
            tree = self.ckpt.restore({"params": params, "opt": opt_state},
                                     device=self.device,
                                     shardings=self._shardings)
        meta = self.ckpt.meta()
        log.info("restored checkpoint at step %d", meta["step"])
        return tree["params"], tree["opt"], meta["step"]

    # -- loop ---------------------------------------------------------------
    def run(self, fail_at: Optional[int] = None,
            max_restarts: int = 2) -> Dict[str, Any]:
        """Run to tcfg.steps; survives ``max_restarts`` worker failures.

        ``fail_at``: raise an injected RuntimeError at that step once
        (the fault-tolerance test hook).
        """
        restarts = 0
        failed_once = False
        losses = []
        while True:
            try:
                params, opt_state, start = self.try_restore()
                for step in range(start, self.tcfg.steps):
                    if fail_at is not None and step == fail_at and not failed_once:
                        failed_once = True
                        raise InjectedFailure("injected worker failure")
                    batch = rules.local_batch(
                        make_batch(self.data_cfg, step), self.ctx)
                    # The step and the loss's readback: a synchronised step.
                    with StepTimer() as t:
                        params, opt_state, metrics = self._step(
                            params, opt_state, batch)
                        loss = float(metrics["loss"])
                    straggler = self.monitor.record_step(t.seconds)
                    if straggler:
                        log.warning("straggler step %d: %.3fs (baseline %.3fs)",
                                    step, t.seconds, self.monitor.baseline_s)
                    losses.append(loss)
                    if step % self.tcfg.log_every == 0:
                        log.info("step %d loss %.4f (%.3fs)", step, loss,
                                 t.seconds)
                    if (step + 1) % self.tcfg.checkpoint_every == 0:
                        self._save(step + 1, params, opt_state)
                self._save(self.tcfg.steps, params, opt_state)
                self.ckpt.wait()
                if self.ctx is not None:
                    # Every rank returns once rank 0's last save is on disk.
                    dist.barrier()
                return {
                    "losses": losses,
                    "restarts": restarts,
                    "straggler_events": self.monitor.straggler_events,
                    "params": params,
                }
            except NotImplementedError:
                raise               # a missing path, not a worker failure
            except RuntimeError as e:
                if self.ctx is not None and not isinstance(e, InjectedFailure):
                    raise           # see the module's docstring
                restarts += 1
                log.warning("worker failure (%s); restart %d", e, restarts)
                if restarts > max_restarts:
                    raise
