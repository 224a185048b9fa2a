"""Checkpoint manager: async, atomic, retention — the port of
``repro/checkpoint/manager.py``, with the same layout on disk, so either
package restores what the other saved.

* Saves are ATOMIC: written to ``<dir>/tmp.<step>`` and then renamed to
  ``step_%010d`` (``arrays.npz`` + ``meta.json``), so a crash mid-save never
  corrupts the latest checkpoint.
* Saves are ASYNC: the tensors are copied to host numpy on the caller's
  thread (a synchronising copy off the card), then a background thread
  writes them, so the train loop goes on.
* Retention keeps the newest ``keep`` checkpoints.
* Keys flatten the tree as the reference does: dict keys sorted, list and
  tuple indices, joined by ``/``.

``restore(template, step=None, device=None, shardings=None)``: each leaf
comes back as a tensor of its template leaf's dtype, on ``device``
(default: the template leaf's device). numpy has no bfloat16 on the card's
machine, so a bfloat16 tensor is saved as float32 (exact) and cast back to
the template's dtype on restore.

On a mesh (``distributed/sharding_rules.py``): ``save(..., shardings=)``
takes a tree of this rank's blocks, gathers each leaf whole (a collective:
every rank of the mesh calls it) and writes whole arrays, so the layout on
disk stays the one both packages read; ``restore(template, shardings=)``
(the template's leaves whole-shaped, ``meta`` tensors will do) gives each
rank its blocks under another mesh's shardings (elastic restore), cutting
each array as it is read, so a rank holds one whole array at a time. The
caller says which rank writes (``save(..., write=False)`` on the others,
which return once the gather is done).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat, leaf):
    def walk(t, prefix=""):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(walk(v, f"{prefix}{i}/") for i, v in enumerate(t))
        if isinstance(t, list):
            return [walk(v, f"{prefix}{i}/") for i, v in enumerate(t)]
        return leaf(t, flat[prefix[:-1]])
    return walk(template)


def _to_host(x) -> np.ndarray:
    """A host copy: the trainer updates its tensors in place while an async
    save writes, and a CPU tensor's ``.numpy()`` would share its memory."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             shardings: Any = None, write: bool = True):
        """Snapshot ``tree`` at ``step`` (with ``shardings``, a tree of this
        rank's blocks, gathered whole first). Returns once the tensors are
        on the host if async. ``write=False``: only the gather, for the
        ranks of a mesh that do not write."""
        if shardings is not None:
            from repro_torch.distributed.sharding_rules import unshard_tree

            tree = unshard_tree(tree, shardings)
        if not write:
            return
        self.wait()  # at most one in-flight save
        host_flat = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_flat, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_flat, extra or {})

    def _write(self, step: int, flat: Dict[str, np.ndarray], extra: Dict):
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **extra}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)           # atomic publish
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Any:
        """Load into the structure of ``template``: tensors of each template
        leaf's dtype on ``device`` (default: the template leaf's). With
        ``shardings`` (a tree of ``sharding_rules.NamedSharding`` matching
        ``template``), each leaf is this rank's block of the saved array."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}", "arrays.npz")
        # With shardings, each array is cut to this rank's block (a copy)
        # as it is read, on the host: only the block is kept, and only it
        # reaches the device.
        cut = _flatten(shardings) if shardings is not None else {}
        with np.load(path) as z:
            flat = {k: cut[k].local_block(torch.from_numpy(z[k]))
                    if k in cut else z[k] for k in z.files}

        def leaf(t, arr):
            if not isinstance(t, torch.Tensor):
                return arr
            x = arr if isinstance(arr, torch.Tensor) else \
                torch.from_numpy(np.array(arr))
            return x.to(device=device if device is not None else t.device,
                        dtype=t.dtype)

        return _unflatten_into(template, flat, leaf)

    def meta(self, step: Optional[int] = None) -> Dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self.dir, f"step_{step:010d}", "meta.json")) as f:
            return json.load(f)
