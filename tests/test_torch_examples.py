"""The paper's examples on the port (``repro_torch.examples``), each run
through its ``main`` on the CPU at a small size: every one finishes and
prints what its reference in ``examples/`` prints."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import TilePlan  # noqa: E402
from repro_torch.examples import (quickstart, resize_images,  # noqa: E402
                                  serve_lm, train_lm, tune_tiles)


def test_quickstart(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "matches the oracle" in out
    assert "gtx260" in out and "geforce_8800gts" in out
    assert "robust fleet tile" in out and "h100_sxm matmul tile" in out


def test_resize_images(capsys):
    resize_images.main(["--device", "cpu", "--size", "32", "--count", "2",
                        "--scale", "3"])
    out = capsys.readouterr().out.splitlines()
    images = [line for line in out if line.startswith("image ")]
    assert len(images) == 2 and "(32, 32) -> (96, 96)" in images[0]
    assert out[-1].startswith("total ")


def test_tune_tiles_cache_and_plans(tmp_path, capsys):
    cache = tmp_path / "tiles.json"
    tune_tiles.main(["--device", "cpu", "--cache", str(cache),
                     "--hardware", "gtx260", "geforce_8800gts"])
    out = capsys.readouterr().out
    assert "bilinear_cuda" in out and len(json.loads(cache.read_text())) == 6
    plan_path = tmp_path / "plan.json"
    tune_tiles.main(["--device", "cpu", "--compile-plans", str(plan_path)])
    plan = TilePlan.load(str(plan_path))
    assert plan.hardware_names() == ["geforce_8800gts", "gtx260",
                                     "h100_sxm"]
    assert {"matmul", "flash_attention", "bilinear",
            "bilinear_cuda"} <= set(plan.kernels())
    assert plan.meta["generated_by"] == "examples.tune_tiles"


def test_serve_lm(capsys):
    serve_lm.main(["--device", "cpu", "--arch", "qwen2-1.5b", "--requests",
                   "3", "--slots", "2", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert out.count("-> 4 new tokens") == 3
    assert "3 requests, 12 tokens" in out


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: a training run is many small ops, and with
    torch's default pool (a thread a core in each of the suite's six
    workers) the threads spin on their barriers (the trainer's tests took
    509 s of a whole run's worker time so, 32 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_lm(tmp_path, capsys, one_torch_thread):
    """The 100M-parameter example at two steps of 16 tokens (the loss
    assertion needs 100 steps, which chip_smoke runs on the card)."""
    out = train_lm.main(["--device", "cpu", "--steps", "2", "--seq-len",
                         "16", "--global-batch", "2", "--checkpoint-dir",
                         str(tmp_path)])
    text = capsys.readouterr().out
    assert "config demo-100m: 109M params" in text
    assert "over 2 steps (restarts=0)" in text
    assert len(out["losses"]) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000002"]


def test_examples_need_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    for example in (quickstart, resize_images, tune_tiles, serve_lm,
                    train_lm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main([])
