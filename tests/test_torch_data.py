"""The port's data pipeline (``repro_torch/data/pipeline.py``) against the
reference's: the same batches, bit for bit, for the same (seed, step,
host), and the iterator's resume from its state."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig, DataIterator, make_batch,
)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=32, global_batch=8),
    dict(vocab_size=257, seq_len=64, global_batch=4, seed=3,
         mean_doc_len=16),
    dict(vocab_size=151646, seq_len=16, global_batch=8, num_hosts=2,
         host_id=1),
], ids=["plain", "short-docs", "host-1-of-2"])
@pytest.mark.parametrize("step", [0, 7, 1234])
def test_batches_are_the_references_bit_for_bit(kw, step):
    ours = make_batch(DataConfig(**kw), step)
    ref = jax_pipeline.make_batch(jax_pipeline.DataConfig(**kw), step)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype == np.int32
        np.testing.assert_array_equal(ours[k], ref[k])


def test_deterministic_and_steps_differ():
    cfg = DataConfig(vocab_size=1000, seq_len=32, global_batch=8)
    np.testing.assert_array_equal(make_batch(cfg, 7)["tokens"],
                                  make_batch(cfg, 7)["tokens"])
    assert not np.array_equal(make_batch(cfg, 0)["tokens"],
                              make_batch(cfg, 1)["tokens"])


def test_targets_shifted_and_in_vocab():
    cfg = DataConfig(vocab_size=257, seq_len=64, global_batch=4)
    b = make_batch(cfg, 5)
    assert b["tokens"].shape == b["targets"].shape == (4, 64)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert b["tokens"].min() >= 1 and b["tokens"].max() < 257


def test_host_sharding_disjoint():
    c0 = DataConfig(vocab_size=1000, seq_len=16, global_batch=8,
                    num_hosts=2, host_id=0)
    c1 = DataConfig(vocab_size=1000, seq_len=16, global_batch=8,
                    num_hosts=2, host_id=1)
    b0, b1 = make_batch(c0, 3), make_batch(c1, 3)
    assert b0["tokens"].shape == (4, 16)
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_iterator_resume():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=4)
    it = DataIterator(cfg)
    first = next(it)
    next(it)
    state = it.state
    it.close()
    assert state == {"step": 2}
    it2 = DataIterator(cfg, start_step=state["step"])
    third = next(it2)
    it2.close()
    np.testing.assert_array_equal(third["tokens"],
                                  make_batch(cfg, 2)["tokens"])
    np.testing.assert_array_equal(
        third["tokens"], jax_pipeline.make_batch(
            jax_pipeline.DataConfig(vocab_size=1000, seq_len=16,
                                    global_batch=4), 2)["tokens"])
    assert not np.array_equal(first["tokens"], third["tokens"])
