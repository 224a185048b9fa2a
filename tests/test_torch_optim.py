"""The port's AdamW and schedule (``repro_torch/optim``) on their own and
against the reference's, on the CPU. The reference's two gradient
compression cases wait for the distributed layers. Parity: float32, 1e-6
relative (each side rounds ``b1 ** step``, the clip scale and the schedule
in float32; only the order of the global norm's sum differs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402

REL = 1e-6


def test_adamw_minimizes_quadratic():
    cfg = adamw.AdamWConfig(weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_state(params, cfg)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), (w,))
        params, state, _ = adamw.apply_updates(params, {"w": g}, state, cfg,
                                               lr=torch.tensor(0.1))
    assert float(torch.sum(params["w"] ** 2)) < 1e-3
    assert int(state["step"]) == 200


def test_clipping():
    cfg = adamw.AdamWConfig(clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = adamw.init_state(params, cfg)
    g = {"w": torch.full((4,), 100.0)}
    _, _, m = adamw.apply_updates(params, g, state, cfg, lr=torch.tensor(0.0))
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert float(m["clip_scale"]) == pytest.approx(1.0 / 200.0)


def test_bf16_moments():
    cfg = adamw.AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones((4, 4))}
    state = adamw.init_state(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    before = params["w"].clone()
    p2, s2, _ = adamw.apply_updates(params, {"w": torch.ones((4, 4))}, state,
                                    cfg, lr=torch.tensor(0.01))
    assert s2["m"]["w"].dtype == torch.bfloat16
    assert p2["w"].dtype == torch.float32
    assert not torch.allclose(p2["w"], before)


def test_schedule_shape():
    kw = dict(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(warmup_cosine(torch.tensor(0), **kw)) == pytest.approx(0.0)
    assert float(warmup_cosine(torch.tensor(10), **kw)) == pytest.approx(1e-3)
    assert float(warmup_cosine(torch.tensor(100), **kw)) == pytest.approx(
        1e-4, rel=0.05)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_schedule_is_the_references_in_float32(as_tensor):
    kw = dict(peak_lr=3e-4, warmup_steps=7, total_steps=53)
    for step in range(0, 60):
        ours = warmup_cosine(torch.tensor(step, dtype=torch.int32)
                             if as_tensor else step, **kw)
        ref = jax_warmup_cosine(jnp.asarray(step, jnp.int32)
                                if as_tensor else step, **kw)
        assert ours.dtype == torch.float32 and ours.dim() == 0
        np.testing.assert_allclose(float(ours), float(ref), rtol=REL,
                                   atol=0)


def _tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((6, 5)).astype(dtype),
            "layers": [{"w": rng.standard_normal((3, 4)).astype(dtype),
                        "b": rng.standard_normal((4,)).astype(dtype)}
                       for _ in range(2)]}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_three_updates_match_the_reference(moments, clip):
    """Three apply_updates from the same params and gradients on both
    sides: params, moments and metrics within 1e-6 relative."""
    rng = np.random.default_rng(0)
    cfg_j = jax_adamw.AdamWConfig(moment_dtype=moments, clip_norm=clip)
    cfg_t = adamw.AdamWConfig(moment_dtype=moments, clip_norm=clip)
    p_np = _tree(rng)
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = jax.tree.map(torch.tensor, p_np)
    sj, st = jax_adamw.init_state(pj, cfg_j), adamw.init_state(pt, cfg_t)
    for step in range(3):
        g_np = jax.tree.map(lambda x: x * (1 + step), _tree(rng))
        lr = 1e-2 * (step + 1)
        pj, sj, mj = jax_adamw.apply_updates(
            pj, jax.tree.map(jnp.asarray, g_np), sj, cfg_j,
            jnp.asarray(lr, jnp.float32))
        pt, st, mt = adamw.apply_updates(
            pt, jax.tree.map(torch.tensor, g_np), st, cfg_t,
            torch.tensor(lr, dtype=torch.float32))
        for k in ("grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=REL)
        assert int(st["step"]) == int(sj["step"]) == step + 1
        for ours, ref in zip(adamw.tree_leaves(pt), jax.tree.leaves(pj)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(ours.numpy(), ref, rtol=REL,
                                       atol=REL * np.abs(ref).max())
        for key in ("m", "v"):
            for ours, ref in zip(adamw.tree_leaves(st[key]),
                                 jax.tree.leaves(sj[key])):
                ref = np.asarray(ref, np.float32)
                assert str(ours.dtype) == f"torch.{moments}"
                # bf16 moments may round one ulp apart (2^-8) where the
                # float32 value before the cast differs in its last bit.
                tol = REL if moments == "float32" else 2 ** -8
                np.testing.assert_allclose(ours.float().numpy(), ref,
                                           rtol=tol,
                                           atol=tol * np.abs(ref).max())


def test_global_norm_and_trees():
    tree = {"x": torch.tensor([3.0]), "y": [torch.tensor([4.0]),
                                            (torch.tensor([0.0]),)]}
    assert float(adamw.global_norm(tree)) == pytest.approx(5.0)
    assert [float(t) for t in adamw.tree_leaves(tree)] == [3.0, 4.0, 0.0]
    doubled = adamw.tree_map(lambda a, b: a + b, tree, tree)
    assert isinstance(doubled["y"][1], tuple)
    assert float(doubled["y"][0]) == 8.0
