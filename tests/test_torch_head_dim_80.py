"""Head dim 80 (h2o-danube-1.8b) in the port's attention kernels, on the CPU.

Every full-width head dim of the ten configs (64, 80, 128, 256) must have a
launchable tile in both flash_attention regimes and a launchable flash_decode
block. The plain versions the CUDA kernels are held against match the JAX
Pallas kernels at D = 80 in interpret mode (GQA 4, a window, ``q_offset``,
a ``kv_pos`` map; tolerance 1e-5 in float32, summation order only). The
bf16 regime zero-pads D = 80 to 128 columns with the scale of the true D:
the plain padded computation equals the unpadded one. The kernels
themselves run at D = 80 on the card in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.decode import (  # noqa: E402
    flash_decode as pallas_decode,
)
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention as pallas_flash,
)
from repro_torch import configs  # noqa: E402
from repro_torch.core import Autotuner, compile_plan  # noqa: E402
from repro_torch.kernels.flash_attention import decode as fa_decode  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch import compile_plans  # noqa: E402
from repro_torch.launch.specs import kernel_problems  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_ARCHS = [a for a in configs.list_archs() if configs.get_arch(a).n_heads]
DTYPES = ("float32", "bfloat16")


def _inputs(seed, shapes, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in shapes]


def test_the_full_width_head_dims_are_64_80_128_256():
    dims = {configs.get_arch(a).head_dim_ for a in ATTN_ARCHS}
    assert dims == {64, 80, 128, 256}
    assert set(dims) <= set(fa.HEAD_DIMS)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_every_full_width_head_dim_launches(arch, dtype):
    cfg = configs.get_arch(arch)
    for seq in (512, 4096):
        prob = kernel_problems(cfg, 1, seq, "prefill")["flash_attention"]
        d = prob["d"]
        assert fa.regime(dtype, d) == ("mma" if dtype == "float32" else "wgmma")
        tiles = fa.regime_tiles(dtype, d)
        assert tiles
        for t in tiles + (tuple(fa_ops.FLASH_SPEC.default_tile(prob, dtype)),):
            assert fa.launch_tile(t, d, dtype) == tuple(t)
    for slots in (1, 4, 128):
        prob = kernel_problems(cfg, slots, 4096, "decode")["flash_decode"]
        bkv = fa_ops.DECODE_SPEC.default_tile(prob, dtype)[0]
        n_rep = prob["hq"] // prob["hkv"]
        assert fa_decode.launch_bkv(bkv, prob["skv"], prob["d"], n_rep) == bkv


def test_head_dim_80_tiles_shared_memory_and_threads():
    bf16, f32 = torch.bfloat16, torch.float32
    assert fa.regime(f32, 80) == "mma" and fa.regime(bf16, 80) == "wgmma"
    assert fa.regime_tiles(f32, 80) == ((64, 32), (64, 64), (128, 32), (128, 64))
    assert fa.regime_tiles(bf16, 80) == ((64, 64), (64, 128), (128, 64),
                                         (128, 128))
    # mma: rows of 80 + 4 floats; wgmma: two 64-column panels, as D = 128.
    assert fa.smem_bytes(128, 64, 80, f32) == 4 * 84 * (128 + 4 * 64)
    assert fa.panel_dim(80) == 128 and fa.panel_dim(16) == 64
    for t in fa.regime_tiles(bf16, 80):
        assert fa.smem_bytes(*t, 80, bf16) == fa.smem_bytes(*t, 128, bf16)
    # The padded products: 1.6x the float32 regime's at the same tile.
    prob = dict(sq=512, skv=512, d=80, hq=32, hkv=8, window=0)
    wg = fa_ops.FLASH_SPEC.workload((64, 64), prob, "bfloat16").flops
    mma = fa_ops.FLASH_SPEC.workload((64, 64), prob, "float32").flops
    assert wg == pytest.approx(1.6 * mma)
    # The decode block: 320 threads at D = 80 (whole warps and rows), 256
    # at every head dim that divides 256.
    assert fa_decode.threads(80) == 320
    assert {fa_decode.threads(d) for d in fa.HEAD_DIMS if d != 80} == {256}
    dprob = dict(b=1, skv=4096, d=80, hq=32, hkv=8, window=0)
    assert fa_ops.DECODE_SPEC.workload((64,), dprob, "float32").threads == 320
    assert fa_decode.launch_bkv(64, 4096, 80, 4) == 64


def test_h2o_danube_compiles_a_legal_tile_for_every_cell():
    jobs, _ = compile_plans.build_jobs(["h2o-danube-1.8b"], ["h100_sxm"],
                                       ["float32", "bfloat16"])
    assert any(k == "flash_attention" and p["d"] == 80 for k, p, _, _ in jobs)
    assert any(k == "flash_decode" and p["d"] == 80 for k, p, _, _ in jobs)
    plan = compile_plan(jobs, autotuner=Autotuner())
    assert plan.meta["skipped_jobs"] == 0
    assert len(plan) == len(jobs)


@pytest.mark.parametrize("kw,sq,skv", [
    (dict(causal=True), 96, 96),
    (dict(causal=True, window=40), 96, 96),
    (dict(causal=True, q_offset=64), 32, 96),
    (dict(causal=False, softcap=20.0), 64, 128),
])
def test_flash_attention_plain_vs_pallas_at_head_dim_80(kw, sq, skv):
    q, k, v = _inputs(80, ((1, 8, sq, 80), (1, 2, skv, 80), (1, 2, skv, 80)))
    want = np.asarray(pallas_flash(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                   tile=(32, 32), interpret=True, **kw))
    out = fa.flash_attention(q, k, v, **kw)
    np.testing.assert_allclose(out.numpy(), want, **TOL)


@pytest.mark.parametrize("case", ["linear", "window", "kv_pos"])
def test_flash_decode_plain_vs_pallas_at_head_dim_80(case):
    s = 256
    q, k, v = _inputs(81, ((2, 8, 80), (2, 2, s, 80), (2, 2, s, 80)))
    kw = dict(pos=200)
    if case == "window":
        kw["window"] = 70
    if case == "kv_pos":
        kv_pos = np.arange(s, dtype=np.int32)
        kv_pos[np.random.default_rng(3).random(s) < 0.3] = -1
        kw["kv_pos"] = kv_pos
    jkw = {n: jnp.asarray(x) if n == "kv_pos" else x for n, x in kw.items()}
    want = np.asarray(pallas_decode(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                    bkv=64, interpret=True, **jkw))
    tkw = {n: torch.from_numpy(x) if n == "kv_pos" else x for n, x in kw.items()}
    np.testing.assert_allclose(fa_decode.flash_decode(q, k, v, **tkw).numpy(),
                               want, **TOL)
    # The kernel's split arithmetic, split and not.
    for splits in (1, 3):
        got = fa_decode.flash_decode_split_ref(q, k, v, bkv=64, splits=splits,
                                               **tkw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=30),
                                dict(causal=True, q_offset=20)])
def test_zero_padded_head_dim_gives_the_unpadded_attention(dtype, kw):
    # The wgmma regime's D = 80: Q, K and V zero-filled to 128 columns, the
    # scale that of D = 80; only the first 80 output columns are stored.
    sq = 44 if "q_offset" in kw else 64
    q, k, v = _inputs(82, ((1, 8, sq, 80), (1, 2, 64, 80), (1, 2, 64, 80)),
                      dtype)

    def pad(x):
        return torch.nn.functional.pad(x, (0, 48))

    want = flash_attention_ref(q, k, v, **kw)
    got = flash_attention_ref(pad(q), pad(k), pad(v), scale=80 ** -0.5, **kw)
    assert got.shape[-1] == 128 and torch.equal(
        got[..., 80:], torch.zeros_like(got[..., 80:]))
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(got[..., :80].float().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)
