"""The port's checkpoint manager (``repro_torch/checkpoint/manager.py``):
the reference's cases (the elastic restore onto a mesh runs in
``tests/test_torch_mesh.py``), checkpoints crossing between the two
packages in both directions, and bfloat16 moments kept exactly through
their float32 copy."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager, _flatten  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402


def _by_key(tree):
    """Leaves by the checkpoint's flat key, as numpy arrays."""
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g),
                   "groups": [{"a": torch.arange(6, dtype=torch.int32)
                               .reshape(2, 3)}]},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    tree = _tree()
    cm.save(10, tree)
    _assert_trees_equal(cm.restore(tree), tree)
    assert cm.meta()["step"] == 10


def test_a_save_that_does_not_write_leaves_nothing(tmp_path):
    """``save(..., write=False)``, a mesh rank that is not the writer,
    writes nothing and leaves nothing in flight."""
    cm = CheckpointManager(str(tmp_path), async_save=True)
    cm.save(3, _tree(), write=False)
    cm.wait()
    assert cm.latest_step() is None and os.listdir(tmp_path) == []


def test_async_roundtrip_snapshots_before_returning(tmp_path):
    """An async save copies the tensors before it returns: an in-place
    update right after it (as the trainer's AdamW makes) is not saved."""
    cm = CheckpointManager(str(tmp_path), async_save=True)
    tree = _tree(1)
    want = tree["params"]["w"].clone()
    cm.save(5, tree)
    tree["params"]["w"].add_(1.0)
    cm.wait()
    assert torch.equal(cm.restore(tree)["params"]["w"], want)


def test_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = _tree(2)
    for s in (1, 2, 3, 4):
        cm.save(s, tree)
    assert cm.all_steps() == [3, 4]


def test_latest_and_specific_step(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    t1, t2 = _tree(3), _tree(4)
    cm.save(1, t1)
    cm.save(2, t2)
    _assert_trees_equal(cm.restore(t1, step=1), t1)
    _assert_trees_equal(cm.restore(t2), t2)
    assert cm.latest_step() == 2


def test_corrupt_tmp_never_published(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    os.makedirs(os.path.join(str(tmp_path), "tmp.99"))
    assert cm.latest_step() is None
    cm.save(1, _tree())
    assert cm.latest_step() == 1


def test_missing_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        cm.restore({"w": torch.zeros(3)})


def test_same_layout_on_disk_as_the_reference(tmp_path):
    tree = _tree(5)
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(3, tree)
    JaxManager(str(tmp_path / "j"), async_save=False).save(
        3, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree))
    for side in ("t", "j"):
        assert sorted(os.listdir(tmp_path / side)) == ["step_0000000003"]
        assert sorted(os.listdir(tmp_path / side / "step_0000000003")) == [
            "arrays.npz", "meta.json"]
    with np.load(tmp_path / "t" / "step_0000000003" / "arrays.npz") as a, \
            np.load(tmp_path / "j" / "step_0000000003" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files) == [
            "opt/step", "params/groups/0/a", "params/w"]


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    tree_np = {"params": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                          "layers": [{"b": rng.standard_normal(3)
                                      .astype(np.float32)}]},
               "opt": {"step": np.asarray(11, np.int32)}}
    JaxManager(str(tmp_path), async_save=False).save(
        11, jax.tree.map(jnp.asarray, tree_np), extra={"data_step": 11})
    template = jax.tree.map(lambda a: torch.zeros(a.shape,
                                                  dtype=torch.from_numpy(a).dtype),
                            tree_np)
    cm = CheckpointManager(str(tmp_path))
    out = cm.restore(template)
    assert cm.meta() == {"step": 11, "data_step": 11}
    ours, ref = _by_key(out), _by_key(tree_np)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree(6)
    CheckpointManager(str(tmp_path), async_save=False).save(4, tree)
    template = jax.tree.map(lambda t: jnp.zeros(t.shape, t.numpy().dtype),
                            tree)
    out = JaxManager(str(tmp_path)).restore(template)
    ours, ref = _by_key(out), _by_key(tree)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def test_bf16_moments_round_trip_exactly(tmp_path):
    g = torch.Generator().manual_seed(7)
    tree = {"m": {"w": torch.randn((5, 9), generator=g).to(torch.bfloat16)},
            "p": {"w": torch.randn((5, 9), generator=g)}}
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, tree)
    with np.load(tmp_path / "step_0000000001" / "arrays.npz") as z:
        assert z["m/w"].dtype == np.float32     # numpy has no bfloat16
    out = cm.restore({"m": {"w": torch.zeros((5, 9), dtype=torch.bfloat16)},
                      "p": {"w": torch.zeros((5, 9))}})
    _assert_trees_equal(out, tree)
