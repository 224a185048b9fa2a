"""``api.train_loss`` and its gradients against the reference's for mamba2
and recurrentgemma (SSD and RG-LRU mixers);
``tests/test_torch_train_step.py`` holds the check and states the
tolerances (the ten configs are split over four files so none runs
long)."""
import pytest

pytest.importorskip("torch")

from test_torch_train_step import (  # noqa: E402,F401
    check_train_loss, one_torch_thread,
)

ARCHS = ["mamba2-2.7b", "recurrentgemma-9b"]


@pytest.mark.parametrize("name", ARCHS)
def test_train_loss_and_gradients_match_the_reference(name):
    check_train_loss(name)
