"""The port's Trainer (``repro_torch/train/trainer.py``) on the CPU: the
reference's six trainer behaviours (``tests/test_trainer.py``: the loss
falls, an injected failure restores and finishes, a failure before any
checkpoint, too many failures raise, stragglers, microbatches), and a run
interrupted by ``fail_at`` ending with the same parameters as one that was
not. Also the launcher, the refusals of what is not a mesh, of a mesh
without a process group and of a missing card."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.distributed.fault_tolerance import HealthMonitor  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: these runs are many small
    ops, and with torch's default pool (a thread a core in each of the
    suite's six workers) the threads spin on their barriers: this file's
    tests took 509 s of a whole run's worker time so, 32 s on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(tmp_path, steps=30, arch="qwen2-1.5b", **kw):
    cfg = configs.get_smoke(arch)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=4)
    tcfg = TrainerConfig(steps=steps, checkpoint_every=10,
                         checkpoint_dir=str(tmp_path), peak_lr=1e-3,
                         warmup_steps=5, log_every=1000, **kw)
    return Trainer(cfg, data_cfg, tcfg,
                   opt_cfg=adamw.AdamWConfig(weight_decay=0.01),
                   device="cpu")


def test_loss_decreases(tmp_path):
    out = _trainer(tmp_path, steps=30).run()
    losses = out["losses"]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert out["restarts"] == 0


def test_failure_recovery(tmp_path):
    """Injected crash at step 15 -> restore from step-10 checkpoint -> finish."""
    out = _trainer(tmp_path, steps=25).run(fail_at=15)
    assert out["restarts"] == 1
    assert len(out["losses"]) >= 25


def test_failure_before_any_checkpoint(tmp_path):
    out = _trainer(tmp_path, steps=12).run(fail_at=3)
    assert out["restarts"] == 1
    assert len(out["losses"]) >= 12


def test_too_many_failures_raises(tmp_path):
    t = _trainer(tmp_path, steps=10)
    with pytest.raises(RuntimeError):
        t.run(fail_at=2, max_restarts=0)


def test_straggler_detection():
    hm = HealthMonitor(warmup_steps=2, straggler_factor=2.0)
    flags = [hm.record_step(s) for s in [1.0] * 8 + [5.0] + [1.0] * 3]
    assert flags[8] is True
    assert hm.straggler_events == 1
    assert sum(flags) == 1
    assert hm.baseline_s == pytest.approx(1.0, rel=0.05)


def test_microbatched_step_matches_plain(tmp_path):
    """Gradient accumulation (2 microbatches) trains to a similar loss."""
    out1 = _trainer(tmp_path / "a", steps=15).run()
    out2 = _trainer(tmp_path / "b", steps=15, microbatches=2).run()
    assert abs(out1["losses"][-1] - out2["losses"][-1]) < 0.5


def test_an_interrupted_run_ends_with_the_uninterrupted_params(tmp_path):
    """A failure at step 13 restores the step-10 checkpoint and replays
    steps 10-19: the final parameters equal, bit for bit, those of a run
    that never failed (the data is a function of the step, the state is
    all in the checkpoint, and the CPU sums in a fixed order)."""
    clean = _trainer(tmp_path / "clean", steps=20).run()
    failed = _trainer(tmp_path / "failed", steps=20).run(fail_at=13)
    assert failed["restarts"] == 1 and len(failed["losses"]) == 23
    assert failed["losses"][-10:] == clean["losses"][-10:]
    for a, b in zip(tree_leaves(clean["params"]),
                    tree_leaves(failed["params"])):
        assert torch.equal(a, b)


def test_a_restart_waits_for_the_save_in_flight(tmp_path, monkeypatch):
    """A failure one step after an async save whose write is slow (here
    held 0.5 s) restores that save's checkpoint, not the one before it,
    and ends with the uninterrupted run's parameters."""
    from repro_torch.checkpoint.manager import CheckpointManager

    clean = _trainer(tmp_path / "clean", steps=14).run()
    write = CheckpointManager._write

    def slow_write(self, *args):
        time.sleep(0.5)
        return write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", slow_write)
    failed = _trainer(tmp_path / "failed", steps=14).run(fail_at=11)
    assert failed["restarts"] == 1
    assert len(failed["losses"]) == 11 + 14 - 10
    assert failed["losses"][-4:] == clean["losses"][-4:]
    for a, b in zip(tree_leaves(clean["params"]),
                    tree_leaves(failed["params"])):
        assert torch.equal(a, b)


def test_a_missing_path_is_not_retried(tmp_path, monkeypatch):
    """NotImplementedError (a kernel without a backward on the card) is not
    a worker failure: it is raised at once, not restored and retried."""
    t = _trainer(tmp_path, steps=3)
    calls = []

    def refuse(*args):
        calls.append(1)
        raise NotImplementedError("no backward")

    monkeypatch.setattr(t, "_step", refuse)
    with pytest.raises(NotImplementedError):
        t.run()
    assert len(calls) == 1


def test_a_mesh_raises(tmp_path):
    """A mesh needs a process group (``launch/mesh.py``): without one,
    building it raises, and the Trainer refuses what is not a mesh. A
    Trainer on a mesh runs in ``tests/test_torch_mesh.py``."""
    from repro_torch.launch.mesh import make_local_mesh

    cfg = configs.get_smoke("qwen2-1.5b")
    with pytest.raises(TypeError, match="not a mesh"):
        Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                global_batch=2),
                TrainerConfig(checkpoint_dir=str(tmp_path)), mesh=object(),
                device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh(1, 1, device="cpu")


_ONE_RANK_FAILS = r"""
import sys
import torch
sys.path.insert(0, sys.argv[4])
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed.process_group import init_process_group
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train.trainer import Trainer, TrainerConfig

rank, store, ckpt = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
init_process_group("gloo", rank, 2, store, timeout_s=60)
cfg = configs.get_smoke("qwen2-1.5b")
trainer = Trainer(
    cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2),
    TrainerConfig(steps=4, checkpoint_every=1, checkpoint_dir=ckpt,
                  log_every=10 ** 6),
    mesh=make_local_mesh(2, 1, device="cpu"), device="cpu")
step, calls = trainer._step, []


def failing(*args):
    calls.append(1)
    if rank == 1 and len(calls) == 2:
        raise torch.OutOfMemoryError("rank 1 alone ran out of memory")
    return step(*args)


trainer._step = failing
trainer.run(max_restarts=2)
print("finished", flush=True)
"""


def test_a_failure_of_one_mesh_rank_raises_on_every_rank(tmp_path):
    """A RuntimeError on one rank of a mesh (here an out-of-memory error
    before the step's collectives) is not restarted in place: that rank
    raises it, and its peer, left in the step's all-reduce, raises the
    group's error, well before the collectives' 60 s timeout. Restarting
    the failed rank alone would pair its restore's barrier with its peer's
    all-reduce."""
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ONE_RANK_FAILS, str(r),
         str(tmp_path / "store"), str(tmp_path / "ckpt"), src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=50) for p in procs]
    finally:
        for p in procs:
            p.kill()
    took = time.monotonic() - t0
    assert all(p.returncode != 0 for p in procs), [o[1][-2000:]
                                                   for o in outs]
    assert "rank 1 alone ran out of memory" in outs[1][1]
    assert all("finished" not in o[0] for o in outs)
    assert all("restart 1" not in o[1] for o in outs)
    assert took < 50


def test_tile_plans_resolve_the_train_cell(tmp_path):
    """A plan compiled for the train cell resolves every kernel the step
    launches, exactly; a corrupt artifact degrades to the defaults."""
    from repro_torch.launch import compile_plans

    cfg = configs.get_smoke("qwen2-1.5b")
    plan_path = tmp_path / "plans.json"
    compile_plans.main(["--measure", "analytic", "--archs", "qwen2-1.5b",
                        "--dtypes", "float32", "--hardware", "h100_sxm",
                        "--out", str(plan_path)])
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=4)
    t = Trainer(cfg, data_cfg, TrainerConfig(
        checkpoint_dir=str(tmp_path / "ck"), tile_plans=str(plan_path)),
        device="cpu")
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema_version": 99, "entries": []}')
    t2 = Trainer(cfg, data_cfg, TrainerConfig(
        checkpoint_dir=str(tmp_path / "ck2"), tile_plans=str(bad)),
        device="cpu")
    assert t2.tiles == {} and t2.tile_resolutions == {}
    assert set(t.tiles) == {"matmul", "flash_attention"}


def test_launcher_trains_and_restarts(tmp_path, capsys):
    out = train_launcher.main([
        "--device", "cpu", "--steps", "12", "--seq-len", "16",
        "--global-batch", "4", "--checkpoint-every", "5", "--fail-at", "7",
        "--checkpoint-dir", str(tmp_path)])
    assert out["restarts"] == 1
    assert "restarts: 1" in capsys.readouterr().out


def test_entry_points_need_a_card_unless_given_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = configs.get_smoke("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                global_batch=2),
                TrainerConfig(checkpoint_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--steps", "1", "--checkpoint-dir",
                             str(tmp_path)])
