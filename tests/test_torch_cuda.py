"""The port's CUDA kernels on an NVIDIA card, against their plain versions.

Every test here needs the card (marker ``cuda``) and skips without one. The
file imports neither JAX nor the JAX package, so it also runs on a machine
without JAX, with the repository's JAX-loading ``conftest.py`` left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances, max |kernel - plain| relative to max |plain| (at least 1):
float32 2e-5 (summation order only), bfloat16 1e-2 (plus one rounding of
the output, at most 2^-8 relative). TF32 is off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    flash_decode, flash_decode_ref,
)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.bilinear import ops as bil_ops  # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as rg_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = [("float32", 2e-5), ("bfloat16", 1e-2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, rtol):
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.float().abs().max()))
    err = float((out.float() - ref.float()).abs().max())
    assert err <= rtol * scale, (err, rtol * scale)


def _randn(dev, seed, *shapes, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype) for s in shapes]


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("m,k,n", [(1, 1536, 8960), (37, 8960, 1536),
                                   (600, 1536, 8960), (5, 70, 33),
                                   (130, 257, 9)])
def test_matmul_vs_plain(dev, dtype, rtol, m, k, n):
    a, b = _randn(dev, 0, (m, k), (k, n), dtype=getattr(torch, dtype))
    _close(mm_ops.mm(a, b), matmul_ref(a, b), rtol)


@pytest.mark.parametrize("tile", mm_ops.COMPILED_TILES)
def test_matmul_every_compiled_tile(dev, tile):
    a, b = _randn(dev, 1, (70, 300), (300, 130))
    _close(mm_ops.mm(a, b, tile=tile), matmul_ref(a, b), 2e-5)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("s,kw", [(16, {}), (257, {}), (600, {}),
                                  (300, dict(window=64)),
                                  (300, dict(softcap=5.0))])
def test_flash_attention_vs_plain(dev, dtype, rtol, s, kw):
    q, k, v = _randn(dev, 2, (1, 16, s, 128), (1, 2, s, 128), (1, 2, s, 128),
                     dtype=getattr(torch, dtype))
    _close(flash_attention(q, k, v, causal=True, **kw),
           flash_attention_ref(q, k, v, causal=True, **kw), rtol)


@pytest.mark.parametrize("tile", [(4, 4), (64, 32), (128, 64), (32, 128)])
def test_flash_attention_tiles_and_q_offset(dev, tile):
    q, k, v = _randn(dev, 3, (2, 4, 40, 64), (2, 2, 90, 64), (2, 2, 90, 64))
    _close(flash_attention(q, k, v, causal=True, q_offset=50, tile=tile),
           flash_attention_ref(q, k, v, causal=True, q_offset=50), 2e-5)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("kw", [dict(pos=0), dict(pos=511), dict(pos=1023),
                                dict(pos=511, window=100),
                                dict(pos=300, softcap=5.0)])
def test_flash_decode_vs_plain(dev, dtype, rtol, kw):
    q, k, v = _randn(dev, 4, (1, 16, 128), (1, 2, 1024, 128),
                     (1, 2, 1024, 128), dtype=getattr(torch, dtype))
    _close(flash_decode(q, k, v, **kw), flash_decode_ref(q, k, v, **kw), rtol)


@pytest.mark.parametrize("bkv", [7, 64, 128, 200])
def test_flash_decode_kv_pos_and_blocks(dev, bkv):
    s = 1000
    q, k, v = _randn(dev, 5, (2, 8, 64), (2, 4, s, 64), (2, 4, s, 64))
    kv_pos = torch.arange(s, dtype=torch.int32)
    kv_pos[torch.rand(s, generator=torch.Generator().manual_seed(0)) < 0.3] = -1
    kv_pos = kv_pos.to(dev)
    _close(flash_decode(q, k, v, pos=900, kv_pos=kv_pos, bkv=bkv),
           flash_decode_ref(q, k, v, pos=900, kv_pos=kv_pos), 2e-5)
    _close(flash_decode(q, k, v, pos=433, window=57, bkv=bkv),
           flash_decode_ref(q, k, v, pos=433, window=57), 2e-5)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("case", ["prefill", "decode"])
def test_attention_at_head_dim_256(dev, dtype, rtol, case):
    # recurrentgemma-9b's local attention: Hq 16, Hkv 1, D 256, window 2048
    # (cut to 300 here), at the largest bq and bkv the head dim takes.
    dt = getattr(torch, dtype)
    if case == "prefill":
        q, k, v = _randn(dev, 8, (1, 16, 700, 256), (1, 1, 700, 256),
                         (1, 1, 700, 256), dtype=dt)
        for tile in ((64, 64), (32, 32), (4, 100)):
            _close(flash_attention(q, k, v, causal=True, window=300, tile=tile),
                   flash_attention_ref(q, k, v, causal=True, window=300), rtol)
        with pytest.raises(ValueError):
            flash_attention(q, k, v, tile=(128, 32))
    else:
        q, k, v = _randn(dev, 9, (2, 16, 256), (2, 1, 1500, 256),
                         (2, 1, 1500, 256), dtype=dt)
        for bkv in (64, 50):
            _close(flash_decode(q, k, v, pos=1400, window=300, bkv=bkv),
                   flash_decode_ref(q, k, v, pos=1400, window=300), rtol)
        _close(flash_decode(q, k, v, pos=1400),
               flash_decode_ref(q, k, v, pos=1400), rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("scale,hw,tile", [
    (2, (800, 800), (4, 32)), (6, (800, 800), (8, 32)),
    (3, (37, 53), (7, 33)), (10, (40, 30), (32, 32)),
    (1, (64, 48), (1, 1024)), (4, (50, 70), (16, 4))])
def test_bilinear_vs_plain(dev, dtype, rtol, scale, hw, tile):
    (src,) = _randn(dev, 10, hw, dtype=getattr(torch, dtype))
    build.reset_launches()
    out = bil_ops.upscale(src, scale, tile=tile)
    assert build.LAUNCHES["bilinear"] == 1
    _close(out, bil_ops.bilinear_upscale_ref(src, scale), rtol)


def _ssd_inputs(dev, seed, b, s, h, p, n, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=dev).to(dtype)
    dt = (torch.rand((b, s, h), generator=g, device=dev) * 0.09 + 0.01).to(dtype)
    A = -(torch.rand((h,), generator=g, device=dev) + 0.5)
    Bm = torch.randn((b, s, n), generator=g, device=dev).to(dtype)
    C = torch.randn((b, s, n), generator=g, device=dev).to(dtype)
    h0 = torch.randn((b, h, n, p), generator=g, device=dev).to(dtype)
    return x, dt, A, Bm, C, h0


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 256, 4, 64, 128, 64), (2, 100, 3, 16, 8, 32), (1, 77, 2, 64, 128, 16),
    (1, 1, 80, 64, 128, 64), (2, 40, 2, 8, 16, 1)])
def test_ssd_vs_plain(dev, dtype, rtol, b, s, h, p, n, chunk):
    x, dt, A, Bm, C, h0 = _ssd_inputs(dev, 11, b, s, h, p, n,
                                      getattr(torch, dtype))
    y, hl = ssd_ops.ssd(x, dt, A, Bm, C, h0=h0, chunk=chunk)
    ycpu, hcpu = ssd_ops.ssd(*(t.cpu() for t in (x, dt, A, Bm, C)),
                             h0=h0.cpu(), chunk=chunk)
    _close(y, ycpu.to(dev), rtol)
    _close(hl, hcpu.to(dev), rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("b,s,f,tile", [
    (1, 300, 4096, (64, 128)), (2, 77, 100, (16, 32)), (1, 1, 4096, (1, 1024)),
    (3, 50, 33, (7, 64))])
def test_rglru_vs_plain(dev, dtype, rtol, b, s, f, tile):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(12)
    a = torch.rand((b, s, f), generator=g, device=dev).to(dt)
    x = torch.randn((b, s, f), generator=g, device=dev).to(dt)
    h0 = torch.randn((b, f), generator=g, device=dev).to(dt)
    build.reset_launches()
    y, hl = rg_ops.rglru_scan(a, x, h0, tile=tile)
    assert build.LAUNCHES["rglru"] == 1
    yr, hr = rg_ops.rglru_scan_ref(a, x, h0)
    _close(y, yr, rtol)
    _close(hl, hr, rtol)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    a, b = _randn(dev, 6, (8, 16), (16, 8))
    with pytest.raises(TypeError):
        mm_ops.mm(a.half(), b.half())
    with pytest.raises(ValueError):
        mm_ops.mm(a, b.t().contiguous().t())      # not contiguous
    with pytest.raises(ValueError):
        mm_ops.mm(a, b, tile=(16, 16, 16))        # not a compiled tile
    q, k = _randn(dev, 7, (1, 4, 8, 48), (1, 2, 8, 48))
    with pytest.raises(ValueError):
        flash_attention(q, k, k)                  # head dim 48
    with pytest.raises(ValueError):
        flash_decode(q[:, :, 0].contiguous(), k.cpu(), k.cpu(), pos=1)
    (img,) = _randn(dev, 13, (16, 16))
    with pytest.raises(ValueError):
        bil_ops.upscale(img, 2, tile=(64, 32))    # 2048 threads
    with pytest.raises(TypeError):
        bil_ops.upscale(img.half(), 2)
    with pytest.raises(ValueError):
        rg_ops.rglru_scan(img[None], img[None], img[:1].cpu())
    x, dt, A, Bm, C, h0 = _ssd_inputs(dev, 14, 1, 128, 1, 64, 128,
                                      torch.float32)
    with pytest.raises(ValueError):               # 258 KB of shared memory
        ssd_ops.ssd(x, dt, A, Bm, C, h0=h0, chunk=128)


def test_smoke_engine_runs_every_kernel_and_matches_the_plain_path(dev):
    cfg = configs.get_smoke("qwen2-1.5b")
    params = api.init_params(cfg, 0, device="cuda")
    prompts = [np.arange(2, 2 + n) for n in (5, 17, 9)]
    build.reset_launches()
    eng = ServeEngine(cfg, params, max_len=64, slots=2, device="cuda")
    for p in prompts:
        eng.add_request(p, max_new_tokens=5)
    done = eng.run_until_done()
    assert len(done) == 3 and all(len(r.out_tokens) == 5 for r in done)
    assert all(build.LAUNCHES[name] > 0 for name in
               ("matmul", "flash_attention", "flash_decode")), build.LAUNCHES
    with torch.inference_mode():
        lk, sk = api.prefill(params, cfg, {"tokens": prompts[1][None]},
                             max_len=64)
        lr, sr = api.prefill(params, cfg, {"tokens": prompts[1][None]},
                             max_len=64, impl="reference")
        _close(lk, lr, 1e-4)
        for _ in range(3):
            tok = torch.argmax(lr[:, :cfg.vocab_size], dim=-1, keepdim=True)
            lk, sk = api.decode_step(params, cfg, tok, sk)
            lr, sr = api.decode_step(params, cfg, tok, sr, impl="reference")
            _close(lk, lr, 1e-4)
