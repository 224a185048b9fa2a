"""``api.train_loss`` and its gradients against the reference's for the two
MoE configs (loss = ce + aux); ``tests/test_torch_train_step.py`` holds
the check and states the tolerances (the ten configs are split over four
files so none runs long)."""
import pytest

pytest.importorskip("torch")

from test_torch_train_step import (  # noqa: E402,F401
    check_train_loss, one_torch_thread,
)

ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_gradients_match_the_reference(name):
    check_train_loss(name)
