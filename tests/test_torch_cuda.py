"""The port's CUDA kernels on an NVIDIA card, against their plain versions.

Every test here needs the card (marker ``cuda``) and skips without one. The
file imports neither JAX nor the JAX package, so it also runs on a machine
without JAX, with the repository's JAX-loading ``conftest.py`` left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances, max |kernel - plain| relative to max |plain| (at least 1):
float32 2e-5 (summation order only; flash_attention's 3xTF32 products keep
about 21 bits), bfloat16 1e-2 (plus one rounding of the output to bf16, at
most 2^-8 relative: the kernel and the plain version both sum in float32
and round once; flash_attention also rounds P to bf16, an error of the same
order). TF32 is off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    flash_decode, flash_decode_ref,
)
from repro_torch.kernels.flash_attention import decode as fa_decode  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
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


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("m", [1, 4, 16, 17, 600, 601])
@pytest.mark.parametrize("n", [1536, 8960, 1000, 1001])
@pytest.mark.parametrize("k", [1536, 8960, 1000])
def test_matmul_regimes_vs_plain(dev, dtype, rtol, m, n, k):
    # skinny (M <= 16), simt (float32) or wgmma (bf16) above it; N = 1001
    # in bf16 (2002-byte rows) and in float32 takes the plain path.
    dt = getattr(torch, dtype)
    a, b = _randn(dev, 20, (m, k), (k, n), dtype=dt)
    build.reset_launches()
    out = mm_ops.mm(a, b)
    assert build.LAUNCHES["matmul"] == 1
    _close(out, matmul_ref(a, b), rtol)


# Every compiled tile on a problem of its regime (K split or not).
_TILE_CASES = [(t, "float32", (5, 300, 136)) for t in mm_ops.REGIME_TILES["skinny"]]
_TILE_CASES += [(t, "bfloat16", (16, 4096, 264)) for t in mm_ops.REGIME_TILES["skinny"]]
_TILE_CASES += [(t, "float32", (70, 300, 132)) for t in mm_ops.REGIME_TILES["simt"]]
_TILE_CASES += [(t, "bfloat16", (70, 300, 131)) for t in mm_ops.REGIME_TILES["plain"]]
_TILE_CASES += [(t, "bfloat16", (70, 320, 136)) for t in mm_ops.REGIME_TILES["wgmma"]]
_TILE_CASES += [(t, "bfloat16", (300, 4096, 256)) for t in mm_ops.REGIME_TILES["wgmma"]]


@pytest.mark.parametrize("tile,dtype,mkn", _TILE_CASES)
def test_matmul_every_compiled_tile(dev, tile, dtype, mkn):
    m, k, n = mkn
    a, b = _randn(dev, 1, (m, k), (k, n), dtype=getattr(torch, dtype))
    _close(mm_ops.mm(a, b, tile=tile), matmul_ref(a, b),
           dict(DTYPES)[dtype])


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("s,kw", [(16, {}), (257, {}), (600, {}),
                                  (300, dict(window=64)),
                                  (300, dict(softcap=5.0))])
def test_flash_attention_vs_plain(dev, dtype, rtol, s, kw):
    q, k, v = _randn(dev, 2, (1, 16, s, 128), (1, 2, s, 128), (1, 2, s, 128),
                     dtype=getattr(torch, dtype))
    _close(flash_attention(q, k, v, causal=True, **kw),
           flash_attention_ref(q, k, v, causal=True, **kw), rtol)


# Every tile each regime launches at head dim 64 (float32: mma, bf16: wgmma).
_FA_TILES = [(dt, t) for dt in ("float32", "bfloat16")
             for t in fa.regime_tiles(dt, 64)]


@pytest.mark.parametrize("dtype,tile", _FA_TILES)
def test_flash_attention_tiles_and_q_offset(dev, dtype, tile):
    q, k, v = _randn(dev, 3, (2, 4, 40, 64), (2, 2, 90, 64), (2, 2, 90, 64),
                     dtype=getattr(torch, dtype))
    _close(flash_attention(q, k, v, causal=True, q_offset=50, tile=tile),
           flash_attention_ref(q, k, v, causal=True, q_offset=50),
           dict(DTYPES)[dtype])


@pytest.mark.parametrize("dtype,d,tile", [
    ("float32", 64, (4, 4)), ("float32", 64, (32, 128)),
    ("float32", 64, (64, 128)), ("float32", 256, (128, 32)),
    ("float32", 256, (64, 64)), ("bfloat16", 64, (64, 32)),
    ("bfloat16", 128, (32, 64)), ("bfloat16", 256, (64, 128)),
    ("bfloat16", 256, (128, 128))])
def test_flash_attention_refuses_tiles_it_does_not_compile(dev, dtype, d, tile):
    # Never clamped or rerouted to another tile or to the plain version.
    q, k, v = _randn(dev, 23, (1, 2, 70, d), (1, 2, 70, d), (1, 2, 70, d),
                     dtype=getattr(torch, dtype))
    build.reset_launches()
    with pytest.raises(ValueError):
        flash_attention(q, k, v, tile=tile)
    assert build.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 15, 64, 65, 600])
def test_flash_attention_head_dims_and_lengths(dev, dtype, rtol, d, s):
    dt = getattr(torch, dtype)
    q, k, v = _randn(dev, 24, (1, 4, s, d), (1, 2, s, d), (1, 2, s, d),
                     dtype=dt)
    build.reset_launches()
    out = flash_attention(q, k, v, causal=True)
    assert build.LAUNCHES["flash_attention"] == 1
    _close(out, flash_attention_ref(q, k, v, causal=True), rtol)


# (b, hq, hkv, sq, skv, kwargs): causal and not, window, softcap, B = 2,
# n_rep 1 and 8, and q_offset with Skv > Sq and Skv no multiple of any bkv
# (the ragged last KV block comes from TMA's or cp.async's zero fill).
_MASK_CASES = [
    (1, 16, 2, 300, 300, dict(causal=False)),
    (2, 16, 2, 300, 300, dict(causal=True, window=37)),
    (1, 8, 8, 257, 257, dict(causal=False, window=50)),
    (2, 2, 2, 200, 200, dict(causal=True, softcap=5.0)),
    (1, 16, 2, 70, 237, dict(causal=True, q_offset=167)),
    (2, 8, 1, 33, 301, dict(causal=True, q_offset=268, window=100)),
    (1, 4, 4, 129, 400, dict(causal=False, softcap=20.0)),
]


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", _MASK_CASES)
def test_flash_attention_masks_gqa_and_offsets(dev, dtype, rtol, d, case):
    b, hq, hkv, sq, skv, kw = case
    q, k, v = _randn(dev, 25, (b, hq, sq, d), (b, hkv, skv, d),
                     (b, hkv, skv, d), dtype=getattr(torch, dtype))
    for tile in fa.regime_tiles(dtype, d):
        _close(flash_attention(q, k, v, tile=tile, **kw),
               flash_attention_ref(q, k, v, **kw), rtol)


def _qwen2_prefill_tiles():
    # The tiles the plan compiler sweeps at qwen2-1.5b's 600-token prefill.
    from repro_torch.core import H100_SXM, registry, tiling
    from repro_torch.kernels import register_all

    register_all()
    spec = registry.get("flash_attention")
    prob = dict(sq=600, skv=600, d=128, hq=16, hkv=2, window=0)
    out = []
    for dtype in ("float32", "bfloat16"):
        tiles = tiling.enumerate_tiles(
            spec.constraints(prob), H100_SXM, dtype,
            lambda t: spec.vmem_bytes(t, prob, dtype), max_candidates=256)
        out += [(dtype, tuple(t)) for t in tiles]
    return out


@pytest.mark.parametrize("dtype,tile", _qwen2_prefill_tiles())
def test_flash_attention_every_swept_tile_at_qwen2_prefill(dev, dtype, tile):
    q, k, v = _randn(dev, 26, (1, 16, 600, 128), (1, 2, 600, 128),
                     (1, 2, 600, 128), dtype=getattr(torch, dtype))
    _close(flash_attention(q, k, v, causal=True, tile=tile),
           flash_attention_ref(q, k, v, causal=True), dict(DTYPES)[dtype])


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
@pytest.mark.parametrize("b", [1, 128])
@pytest.mark.parametrize("hkv,d", [(2, 128), (1, 256)])
@pytest.mark.parametrize("cache", ["linear", "window", "ring"])
def test_flash_decode_split_kv(dev, dtype, rtol, b, hkv, d, cache):
    # One split per ~132 // (B * Hkv) blocks at B = 1, one at B = 128; the
    # ring cache (kv_pos, -1 slots) visits every block.
    s, hq = 1024, 16
    dt = getattr(torch, dtype)
    q, k, v = _randn(dev, 21, (b, hq, d), (b, hkv, s, d), (b, hkv, s, d),
                     dtype=dt)
    kw = dict(pos=700)
    if cache == "window":
        kw["window"] = 300
    if cache == "ring":
        pos = 1500
        ring = torch.full((s,), -1, dtype=torch.int32)
        written = torch.arange(pos - s + 1 + 100, pos + 1, dtype=torch.int32)
        ring[(written % s).long()] = written
        kw = dict(pos=pos, kv_pos=ring.to(dev), window=600)
    build.reset_launches()
    out = flash_decode(q, k, v, **kw)
    assert build.LAUNCHES["flash_decode"] == 1
    _close(out, flash_decode_ref(q, k, v, **kw), rtol)


def test_flash_decode_all_masked_averages_the_cache(dev):
    q, k, v = _randn(dev, 22, (1, 8, 64), (1, 2, 300, 64), (1, 2, 300, 64))
    kv_pos = torch.full((300,), -1, dtype=torch.int32, device=dev)
    out = flash_decode(q, k, v, pos=10, kv_pos=kv_pos, bkv=16)
    _close(out, flash_decode_ref(q, k, v, pos=10, kv_pos=kv_pos), 2e-5)
    _close(out, v.mean(dim=2).repeat_interleave(4, dim=1), 2e-5)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("case", ["prefill", "decode"])
def test_attention_at_head_dim_256(dev, dtype, rtol, case):
    # recurrentgemma-9b's local attention: Hq 16, Hkv 1, D 256, window 2048
    # (cut to 300 here), at every tile the head dim takes.
    dt = getattr(torch, dtype)
    if case == "prefill":
        q, k, v = _randn(dev, 8, (1, 16, 700, 256), (1, 1, 700, 256),
                         (1, 1, 700, 256), dtype=dt)
        for tile in fa.regime_tiles(dtype, 256):
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


# The paper's Fig. 3 axis: every (bh, bw) of {4, 8, 16, 32}^2.
_FIG3 = [(h, w) for h in (4, 8, 16, 32) for w in (4, 8, 16, 32)]


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("tile", _FIG3)
def test_bilinear_fig3_tiles(dev, dtype, rtol, tile):
    (src,) = _randn(dev, 31, (50, 70), dtype=getattr(torch, dtype))
    for scale in (2, 10):
        build.reset_launches()
        out = bil_ops.upscale(src, scale, tile=tile)
        assert build.LAUNCHES["bilinear"] == 1
        _close(out, bil_ops.bilinear_upscale_ref(src, scale), rtol)


# Rows of 16-byte multiples take vector stores, the others scalar stores:
# float32 ow 159, 290, 2002, 35; ow 36 is 144 bytes in float32, 72 in bf16;
# ow 272 (s = 16); s = 1. Each case names the path the source takes.
@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("hw,scale,tile,paths", [
    ((37, 53), 3, (7, 33), "ss"), ((41, 29), 10, (8, 32), "ss"),
    ((33, 1001), 2, (4, 32), "ss"), ((9, 7), 5, (16, 16), "ss"),
    ((9, 12), 3, (4, 8), "vs"), ((23, 17), 16, (32, 4), "vv"),
    ((64, 48), 1, (1, 1024), "vv")])
def test_bilinear_store_paths(dev, dtype, rtol, hw, scale, tile, paths):
    dt = getattr(torch, dtype)
    prob = dict(src_h=hw[0], src_w=hw[1], scale=scale)
    want = {"v": "vector", "s": "scalar"}[paths[dtype == "bfloat16"]]
    assert bil_ops.store_path(prob, dt) == want
    (src,) = _randn(dev, 32, hw, dtype=dt)
    build.reset_launches()
    out = bil_ops.upscale(src, scale, tile=tile)
    assert build.LAUNCHES["bilinear"] == 1
    _close(out, bil_ops.bilinear_upscale_ref(src, scale), rtol)


def test_bilinear_grid_y_limit_raises(dev):
    # 300000 output rows: 75000 block rows at bh = 1, R = 4 (the grid takes
    # 65535), 37500 at bh = 2.
    (src,) = _randn(dev, 33, (300000, 2))
    build.reset_launches()
    with pytest.raises(ValueError):
        bil_ops.upscale(src, 1, tile=(1, 32))
    assert build.LAUNCHES["bilinear"] == 0
    out = bil_ops.upscale(src, 1, tile=(2, 32))
    assert build.LAUNCHES["bilinear"] == 1
    _close(out, bil_ops.bilinear_upscale_ref(src, 1), 2e-5)


# h2o-danube-1.8b's attention: Hq 32, Hkv 8 (GQA 4), head_dim 80; every
# tile of each regime (bf16 zero-pads D to 128).
@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("sq,skv,kw", [
    (240, 240, dict(causal=True)), (240, 240, dict(causal=True, window=100)),
    (90, 240, dict(causal=True, q_offset=150)),
    (130, 201, dict(causal=False, softcap=20.0))])
def test_flash_attention_at_head_dim_80(dev, dtype, rtol, sq, skv, kw):
    q, k, v = _randn(dev, 27, (1, 32, sq, 80), (1, 8, skv, 80),
                     (1, 8, skv, 80), dtype=getattr(torch, dtype))
    ref = flash_attention_ref(q, k, v, **kw)
    for tile in fa.regime_tiles(dtype, 80):
        build.reset_launches()
        out = flash_attention(q, k, v, tile=tile, **kw)
        assert build.LAUNCHES["flash_attention"] == 1
        _close(out, ref, rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("case", ["linear", "window", "kv_pos"])
def test_flash_decode_at_head_dim_80(dev, dtype, rtol, b, case):
    # B = 1 splits the KV over the card; at B = 32, B * Hkv fills it: one
    # split, no combine.
    from repro_torch.kernels.flash_attention.decode import decode_splits
    from repro_torch.kernels.flash_attention.ops import DECODE_SPEC

    s = 1024
    q, k, v = _randn(dev, 28, (b, 32, 80), (b, 8, s, 80), (b, 8, s, 80),
                     dtype=getattr(torch, dtype))
    kw = dict(pos=1000)
    if case == "window":
        kw["window"] = 300
    if case == "kv_pos":
        kv_pos = torch.arange(s, dtype=torch.int32)
        kv_pos[torch.rand(s, generator=torch.Generator().manual_seed(2)) < 0.3] = -1
        kw = dict(pos=900, kv_pos=kv_pos.to(dev))
    bkv = DECODE_SPEC.default_tile(dict(b=b, skv=s, d=80, hq=32, hkv=8,
                                        window=kw.get("window", 0)), dtype)[0]
    sp = decode_splits(b, 8, s, bkv, kw["pos"], case != "kv_pos",
                       kw.get("window"))
    assert (sp.splits > 1) == (b == 1)
    build.reset_launches()
    out = flash_decode(q, k, v, **kw)
    assert build.LAUNCHES["flash_decode"] == 1
    _close(out, flash_decode_ref(q, k, v, **kw), rtol)


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
    (1, 1, 80, 64, 128, 64), (2, 40, 2, 8, 16, 1), (1, 300, 2, 64, 128, 128),
    (1, 600, 2, 64, 128, 256), (2, 200, 3, 136, 256, 72), (1, 50, 3, 64, 128, 64),
    (2, 1, 3, 136, 16, 64)])
def test_ssd_vs_plain(dev, dtype, rtol, b, s, h, p, n, chunk):
    x, dt, A, Bm, C, h0 = _ssd_inputs(dev, 11, b, s, h, p, n,
                                      getattr(torch, dtype))
    build.reset_launches()
    y, hl = ssd_ops.ssd(x, dt, A, Bm, C, h0=h0, chunk=chunk)
    assert build.LAUNCHES["ssd"] == 1
    ycpu, hcpu = ssd_ops.ssd(*(t.cpu() for t in (x, dt, A, Bm, C)),
                             h0=h0.cpu(), chunk=chunk)
    _close(y, ycpu.to(dev), rtol)
    _close(hl, hcpu.to(dev), rtol)


def test_ssd_shared_memory_rule_is_the_sources(dev):
    import ctypes

    fn = build.load("ssd").repro_ssd_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    for dtype in (torch.float32, torch.bfloat16):
        for n in (8, 16, 24, 128, 136, 256, 368, 376, 544, 552, 1024):
            assert fn(n, build.dtype_code(dtype)) == \
                ssd_ops.smem_bytes(n, dtype), (n, dtype)


def test_flash_decode_thread_rule_is_the_sources(dev):
    fn = build.load("flash_decode").repro_flash_decode_threads
    for d in fa.HEAD_DIMS:
        assert fn(d) == fa_decode.threads(d), d


def test_ssd_bf16_takes_a_state_wider_than_float32_does(dev):
    # N = 376 fits a bf16 block's shared memory, not a float32 one's.
    x, dt, A, Bm, C, h0 = _ssd_inputs(dev, 15, 1, 100, 2, 16, 376,
                                      torch.bfloat16)
    y, hl = ssd_ops.ssd(x, dt, A, Bm, C, h0=h0, chunk=64)
    ycpu, hcpu = ssd_ops.ssd(*(t.cpu() for t in (x, dt, A, Bm, C)),
                             h0=h0.cpu(), chunk=64)
    _close(y, ycpu.to(dev), 1e-2)
    _close(hl, hcpu.to(dev), 1e-2)
    with pytest.raises(ValueError):
        ssd_ops.ssd(*(t.float() for t in (x, dt, A, Bm, C)), h0=h0.float(),
                    chunk=64)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("b,s,f,tile", [
    (1, 300, 4096, (64, 128)), (2, 77, 100, (16, 32)), (1, 1, 4096, (1, 1024)),
    (3, 50, 33, (7, 64)), (1, 4096, 4096, (64, 256)), (2, 130, 96, (1, 1000))])
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
    with pytest.raises(ValueError):
        mm_ops.mm(a, b, tile=(128, 64, 128))      # a wgmma tile, float32
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
    x, dt, A, Bm, C, h0 = _ssd_inputs(dev, 14, 1, 128, 1, 64, 1024,
                                      torch.float32)
    with pytest.raises(ValueError):               # 552 KB of shared memory
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


# ---------------------------------------------------------------------------
# The position on the device and the captured decode step
# ---------------------------------------------------------------------------

def _ring_map(s, pos, dev):
    """Slot -> position of a ring of ``s`` slots after position ``pos``; the
    first tenth of the slots not reached again (-1) once the ring wraps."""
    kv_pos = torch.full((s,), -1, dtype=torch.int32)
    written = torch.arange(max(0, pos - s + 1 + s // 10), pos + 1,
                           dtype=torch.int32)
    kv_pos[(written % s).long()] = written
    return kv_pos.to(dev)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 80), (16, 2, 128), (16, 1, 256)])
@pytest.mark.parametrize("cache", ["linear", "ring"])
def test_flash_decode_reads_its_position_from_device_memory(dev, dtype, rtol,
                                                            hq, hkv, d, cache):
    """pos over {0, bkv - 1, bkv, S / 2, S - 1} (and past S for the ring),
    given as the cache's 0-d int32 tensor; the grid is the same at every
    position."""
    from repro_torch.kernels.flash_attention.ops import DECODE_SPEC

    s = 1024
    q, k, v = _randn(dev, 29, (1, hq, d), (1, hkv, s, d), (1, hkv, s, d),
                     dtype=getattr(torch, dtype))
    bkv = DECODE_SPEC.default_tile(dict(b=1, skv=s, d=d, hq=hq, hkv=hkv,
                                        window=0), dtype)[0]
    sweep = [0, bkv - 1, bkv, s // 2, s - 1]
    if cache == "ring":
        sweep += [s + 37, 3 * s - 1]
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    for p in sweep:
        pos.fill_(p)
        kw = dict(kv_pos=_ring_map(s, p, dev)) if cache == "ring" else {}
        out = flash_decode(q, k, v, pos=pos, **kw)
        _close(out, flash_decode_ref(q, k, v, pos=p, **kw), rtol)
        _close(out, fa_decode.flash_decode_split_ref(q, k, v, pos=p, bkv=bkv,
                                                     **kw), rtol)


@pytest.mark.parametrize("cache", ["linear", "window", "ring"])
def test_a_replay_reads_the_moved_position(dev, cache):
    """One captured launch, replayed after the position moves across key
    blocks (and splits that go empty and full again): each replay matches
    the plain version at the new position, so nothing was baked in."""
    s, bkv = 1024, 64
    q, k, v = _randn(dev, 30, (1, 16, 128), (1, 2, s, 128), (1, 2, s, 128))
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    kv_pos = torch.full((s,), -1, dtype=torch.int32, device=dev)
    kw = dict(window=300) if cache == "window" else {}
    if cache == "ring":
        kw = dict(kv_pos=kv_pos)
    flash_decode(q, k, v, pos=pos, bkv=bkv, **kw)          # warm-up
    torch.cuda.synchronize()
    out = torch.empty_like(q)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out.copy_(flash_decode(q, k, v, pos=pos, bkv=bkv, **kw))
    for p in (5, 63, 64, 700, 130, 1023, 0):
        if cache == "ring":
            p += s                                  # the ring has wrapped
            kv_pos.copy_(_ring_map(s, p, dev))
        pos.fill_(p)
        graph.replay()
        want = flash_decode_ref(q, k, v, pos=p, bkv=bkv, **kw)
        _close(out, want, 2e-5)


def test_captured_decode_gives_the_eager_loop_s_tokens(dev):
    """Two slots of a ring-cache smoke model, one reused by a third request,
    40 tokens each (the 16-slot rings wrap): the engine's replayed graphs
    give the tokens of an eager ``api.decode_step`` loop, and the launch
    counts count what ran (warm-ups and replays, not captures)."""
    cfg = configs.get_smoke("h2o-danube-1.8b")
    params = api.init_params(cfg, 0, device="cuda")
    prompts = [np.arange(3, 3 + n) % cfg.vocab_size for n in (9, 21, 5)]
    new = 40
    build.reset_launches()
    eng = ServeEngine(cfg, params, max_len=64, slots=2, device="cuda")
    for p in prompts:
        eng.add_request(p, max_new_tokens=new)
    done = sorted(eng.run_until_done(), key=lambda r: r.rid)
    steps = 3 * (new - 1)
    assert build.LAUNCHES["flash_decode"] == cfg.n_layers * (steps + 2)
    assert all(eng._slots[i].graph is not None for i in range(2))
    with torch.inference_mode():
        for p, req in zip(prompts, done):
            logits, st = api.prefill(params, cfg, {"tokens": p[None]},
                                     max_len=64, ring_local=True)
            toks = [int(torch.argmax(logits[0, :cfg.vocab_size]))]
            while len(toks) < new:
                tok = torch.tensor([[toks[-1]]], device="cuda")
                logits, st = api.decode_step(params, cfg, tok, st)
                toks.append(int(torch.argmax(logits[0, :cfg.vocab_size])))
            assert req.out_tokens == toks, req.rid


# ---------------------------------------------------------------------------
# Tile plans in the engine
# ---------------------------------------------------------------------------

PLAN_EDGES = (8, 16)


def _serve_plan(arch="qwen2-1.5b", max_len=64, slots=2):
    """An analytic h100_sxm plan of the smoke config's serving cells."""
    from repro_torch.core import H100_SXM, compile_plan, registry
    from repro_torch.launch.compile_plans import serve_bucket_cells

    cells = serve_bucket_cells([arch], PLAN_EDGES, slots, max_len, smoke=True)
    return compile_plan([(k, p, "float32", H100_SXM) for k, p in cells
                         if k in registry.names()])


def _plan_tokens(eng, prompts, new=8):
    rids = [eng.add_request(p, max_new_tokens=new) for p in prompts]
    done = {r.rid: r.out_tokens for r in eng.run_until_done()}
    return [done[r] for r in rids]


def _same_tokens_or_tie(params, cfg, prompt, got, want):
    """Equal tokens, or the first difference where the plain versions' top-2
    margin is within 1e-3 of max |logit| (float32 sums in another order)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            ctx = np.concatenate([prompt, want[:i]])[None]
            with torch.inference_mode():
                logits, _ = api.prefill(params, cfg, {"tokens": ctx},
                                        max_len=ctx.shape[1],
                                        impl="reference")
            top = torch.topk(logits[0, :cfg.vocab_size].float(), 2).values
            scale = float(logits[0, :cfg.vocab_size].abs().max())
            assert float(top[0] - top[1]) <= 1e-3 * scale, (i, a, b)
            return
    assert len(got) == len(want)


@pytest.mark.parametrize("bucket", [True, False], ids=["bucket", "fifo"])
def test_plan_engine_serves_the_no_plan_tokens_through_the_kernels(dev,
                                                                  bucket):
    from repro_torch.launch import specs
    from repro_torch.serve import BucketPolicy, ShapeBucketScheduler

    cfg = configs.get_smoke("qwen2-1.5b")
    params = api.init_params(cfg, 0, device="cuda")
    plan = _serve_plan()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n) for n in (3, 11, 16)]

    def engine(plans):
        sched = (ShapeBucketScheduler(BucketPolicy(PLAN_EDGES)) if bucket
                 else None)
        return ServeEngine(cfg, params, max_len=64, slots=2, plans=plans,
                           scheduler=sched, device="cuda")

    want = _plan_tokens(engine(None), prompts)
    build.reset_launches()
    eng = engine(plan)
    got = _plan_tokens(eng, prompts)
    assert all(build.LAUNCHES[k] > 0 for k in
               ("matmul", "flash_attention", "flash_decode")), build.LAUNCHES
    for p, a, b in zip(prompts, got, want):
        _same_tokens_or_tie(params, cfg, p, a, b)
    # Every tile the engine resolved is one its kernel launches.
    for length, (tiles, _) in eng._prefill_tiles.items():
        for kernel, tile in tiles.items():
            assert specs.tile_launches(kernel, tile, cfg, "float32", length)
    lens = sorted({c["k"].shape[2] for c in eng._slots[0].caches})
    for kernel, tile in eng.tiles.items():
        assert specs.tile_launches(kernel, tile, cfg, "float32", 1, lens)
    counts = eng.metrics.as_dict()["plan"]["by_phase"]
    assert counts["decode"]["exact"] == 3      # matmul, flash_decode, kv_page
    assert counts["prefill"]["tile_fallback"] == 0
    if bucket:
        assert eng.metrics.plan_hit_rate("prefill") == 1.0
    # A swap drops every captured graph; the next steps recapture.
    assert all(s.graph is not None for s in eng._slots)
    eng.set_plans(None)
    assert all(s.graph is None for s in eng._slots)
    again = _plan_tokens(eng, prompts)
    assert again == want


def test_plan_tiles_that_do_not_launch_are_replaced_and_counted(dev):
    """A bf16 (wgmma) matmul tile in the float32 16-token cell: the engine
    replaces it by the default before the kernel sees it (the kernel would
    raise) and counts one tile_fallback per request admitted at 16."""
    import dataclasses

    from repro_torch.core import TilePlan
    from repro_torch.core.tiling import TileShape
    from repro_torch.kernels.flash_attention.ops import chunk_launch_tile
    from repro_torch.launch import specs
    from repro_torch.serve import BucketPolicy, ShapeBucketScheduler

    cfg = configs.get_smoke("qwen2-1.5b")
    params = api.init_params(cfg, 0, device="cuda")
    plan = TilePlan(_serve_plan().entries())
    prob = specs.kernel_problems(cfg, 1, 16, "prefill")["matmul"]
    entry = plan.lookup("matmul", prob, "float32", "h100_sxm")
    plan.add(dataclasses.replace(entry, tile=TileShape((64, 64, 128))))
    a = torch.zeros((16, cfg.d_model), device=dev)
    with pytest.raises(ValueError):
        mm_ops.mm(a, torch.zeros((cfg.d_model, cfg.d_ff), device=dev),
                  tile=(64, 64, 128))
    eng = ServeEngine(cfg, params, max_len=64, slots=2, plans=plan,
                      scheduler=ShapeBucketScheduler(BucketPolicy(PLAN_EDGES)),
                      device="cuda")
    rng = np.random.default_rng(1)
    lengths = (12, 5, 16, 14)
    out = _plan_tokens(eng, [rng.integers(2, cfg.vocab_size, size=n)
                             for n in lengths], new=4)
    assert all(len(t) == 4 for t in out)
    replaced = sum(n > 8 for n in lengths)
    counts = eng.metrics.as_dict()["plan"]["by_phase"]
    assert counts["prefill"]["tile_fallback"] == replaced
    assert counts.get("decode", {}).get("tile_fallback", 0) == 0


# ---------------------------------------------------------------------------
# The recurrent mixers on a model's path
# ---------------------------------------------------------------------------

def _two_layers(arch):
    """``arch`` at full width and its first 2 layers (two SSD layers of
    mamba2-2.7b, two RG-LRU layers of recurrentgemma-9b)."""
    import dataclasses

    full = configs.get_arch(arch)
    return dataclasses.replace(full, n_layers=2,
                               layer_pattern=full.layer_pattern[:2]).validate()


@pytest.mark.parametrize("arch,block", [("mamba2-2.7b", "ssm"),
                                        ("recurrentgemma-9b", "rglru")])
@pytest.mark.parametrize("s", [1, 64, 257, 600])
def test_recurrent_blocks_at_full_width_vs_plain(dev, arch, block, s):
    """``ssm_forward`` / ``rglru_forward`` through the kernels against the
    plain versions (``impl="reference"``) over 2 full-width layers: a
    prefill of ``s`` tokens, then 4 decode steps, each path carrying its
    own states in place. Tolerance 1e-4 of max |plain| (at least 1): the
    two scans sum in another order and the states carry it through."""
    from repro_torch.models import rglru, ssm, transformer

    cfg = _two_layers(arch)
    params = api.init_params(cfg, 0, device=dev)
    forward = ssm.ssm_forward if block == "ssm" else rglru.rglru_forward
    states = {impl: transformer.make_caches(cfg, 1, 8, torch.float32,
                                            device=dev)
              for impl in ("auto", "reference")}
    ptrs = [t.data_ptr() for c in states["auto"] for t in c.values()]
    (x,) = _randn(dev, s, (1, s, cfg.d_model))
    kernel = "ssd" if block == "ssm" else "rglru"
    build.reset_launches()
    with torch.inference_mode():
        for step in range(5):
            outs = {}
            for impl, caches in states.items():
                y = x
                for layer, cache in zip(params["layers"], caches):
                    y, _ = forward(layer[block], cfg, y, state=cache,
                                   impl=impl)
                outs[impl] = y
            _close(outs["auto"], outs["reference"], 1e-4)
            for got, want in zip(*states.values()):
                for k in got:
                    _close(got[k], want[k], 1e-4)
            (x,) = _randn(dev, 100 + step, (1, 1, cfg.d_model))
    assert build.LAUNCHES[kernel] == 2 * 5
    assert [t.data_ptr() for c in states["auto"] for t in c.values()] == ptrs


@pytest.mark.parametrize("arch,kernels", [
    ("mamba2-2.7b", ("ssd",)),
    ("recurrentgemma-9b", ("matmul", "flash_attention", "flash_decode",
                           "rglru"))])
def test_captured_recurrent_decode_gives_the_eager_loop_s_tokens(dev, arch,
                                                                 kernels):
    """The smoke configs through the captured engine, two slots and a third
    request on a reused slot, 24 tokens each (recurrentgemma's 16-slot
    rings wrap): the replayed graphs give an eager ``api.decode_step``
    loop's tokens, and each kernel of the path ran."""
    cfg = configs.get_smoke(arch)
    params = api.init_params(cfg, 0, device="cuda")
    prompts = [np.arange(3, 3 + n) % cfg.vocab_size for n in (9, 21, 5)]
    new = 24
    build.reset_launches()
    eng = ServeEngine(cfg, params, max_len=64, slots=2, device="cuda")
    for p in prompts:
        eng.add_request(p, max_new_tokens=new)
    done = sorted(eng.run_until_done(), key=lambda r: r.rid)
    assert all(build.LAUNCHES[k] > 0 for k in kernels), build.LAUNCHES
    assert all(eng._slots[i].graph is not None for i in range(2))
    with torch.inference_mode():
        for p, req in zip(prompts, done):
            logits, st = api.prefill(params, cfg, {"tokens": p[None]},
                                     max_len=64,
                                     ring_local=bool(cfg.attn_window))
            toks = [int(torch.argmax(logits[0, :cfg.vocab_size]))]
            while len(toks) < new:
                tok = torch.tensor([[toks[-1]]], device="cuda")
                logits, st = api.decode_step(params, cfg, tok, st)
                toks.append(int(torch.argmax(logits[0, :cfg.vocab_size])))
            assert req.out_tokens == toks, req.rid


# ---------------------------------------------------------------------------
# Chunked and packed prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("sq", [1, 64, 256])
@pytest.mark.parametrize("start", [0, 255, 511, 767])
def test_flash_attention_at_continuation_shapes(dev, dtype, rtol, sq, start):
    """A chunk's call: Sq queries at q_offset = start over Skv = start + Sq
    keys, qwen2's padded Hq 16, Hkv 2, D 128, with the tile the chunked
    path launches."""
    from repro_torch.kernels.flash_attention.ops import chunk_launch_tile

    dt = getattr(torch, dtype)
    q, k, v = _randn(dev, sq + start, (1, 16, sq, 128),
                     (1, 2, start + sq, 128), (1, 2, start + sq, 128),
                     dtype=dt)
    for bkv in sorted({b for _, b in fa.regime_tiles(dt, 128)}):
        tile = chunk_launch_tile((sq, bkv), sq, 12, 128, dt)
        _close(flash_attention(q, k, v, causal=True, q_offset=start,
                               tile=tile),
               flash_attention_ref(q, k, v, causal=True, q_offset=start),
               rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_packed_segments_through_the_kernel_vs_plain(dev, dtype, rtol):
    """``attn_prefill_packed`` on the card (one flash-attention launch a
    segment over its own prefix) against the packed plain version, over
    qwen2-1.5b's full-width attention block, and the caches it writes."""
    from repro_torch.models import attention

    cfg = configs.get_arch("qwen2-1.5b")
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    p = {k: (torch.randn(d.shape, generator=g, device=dev) * 0.05).to(dt)
         for k, d in attention.attn_defs(cfg).items()}
    layout = ((300, 64), (0, 100), (511, 1))
    caches = {impl: [] for impl in ("kernel", "reference")}
    for start, _ in layout:
        (hist,) = _randn(dev, start + 1, (1, max(start, 1), cfg.d_model),
                         dtype=dt)
        for impl, out in caches.items():
            c = attention.make_kv_cache(cfg, 1, 640, dt, device=dev)
            if start:
                attention.attn_prefill_chunk(
                    p, cfg, hist, torch.arange(start, device=dev)[None],
                    cache=c, start=0, impl="reference")
            out.append(c)
    n = sum(ln for _, ln in layout)
    (x,) = _randn(dev, 7, (1, n, cfg.d_model), dtype=dt)
    pos = torch.cat([s + torch.arange(ln, device=dev)
                     for s, ln in layout])[None]
    build.reset_launches()
    got, _ = attention.attn_prefill_packed(p, cfg, x, pos,
                                           caches=caches["kernel"],
                                           layout=layout, impl="kernel")
    assert build.LAUNCHES["flash_attention"] == len(layout)
    want, _ = attention.attn_prefill_packed(p, cfg, x, pos,
                                            caches=caches["reference"],
                                            layout=layout, impl="reference")
    _close(got, want, rtol)
    for a, b in zip(caches["kernel"], caches["reference"]):
        _close(a["k"], b["k"], rtol)
        assert int(a["pos"]) == int(b["pos"])


def test_a_chunked_tile_that_does_not_launch_is_a_tile_fallback(dev):
    """A ``chunked_prefill`` plan tile whose bkv no regime compiles: each
    chunk's launch snaps it to a compiled one, counted as one tile_fallback
    per request, and the chunks still run the kernel."""
    import dataclasses

    from repro_torch.core import TilePlan
    from repro_torch.core.tiling import TileShape
    from repro_torch.kernels.flash_attention.ops import chunk_launch_tile
    from repro_torch.launch import specs
    from repro_torch.serve import BucketPolicy, ShapeBucketScheduler

    cfg = configs.get_smoke("qwen2-1.5b")
    params = api.init_params(cfg, 0, device="cuda")
    plan = TilePlan(_serve_plan().entries())
    prob = specs.kernel_problems(cfg, 1, 16, "chunked_prefill")[
        "chunked_prefill"]
    entry = plan.lookup("chunked_prefill", prob, "float32", "h100_sxm")
    plan.add(dataclasses.replace(entry, tile=TileShape((16, 48))))
    assert chunk_launch_tile((16, 48), 16, cfg.n_heads, cfg.head_dim_,
                             torch.float32)[1] != 48
    eng = ServeEngine(cfg, params, max_len=64, slots=2, plans=plan,
                      chunk_prefill=True, step_token_budget=10,
                      scheduler=ShapeBucketScheduler(BucketPolicy(PLAN_EDGES)),
                      device="cuda")
    rng = np.random.default_rng(1)
    build.reset_launches()
    out = _plan_tokens(eng, [rng.integers(2, cfg.vocab_size, size=n)
                             for n in (12, 5, 16)], new=4)
    assert all(len(t) == 4 for t in out)
    assert build.LAUNCHES["flash_attention"] > 0
    by_kernel = eng.metrics.as_dict()["plan"]["by_kernel"]
    assert by_kernel["chunked_prefill"].get("tile_fallback") == 2


def _serve_chunked_on_card(arch, packed, prompts, monkeypatch, max_len):
    """``arch``'s smoke config served chunked (or packed) through the
    kernels and captured decode, against the same engine on the plain
    versions; returns the card's engine and the q_offsets of its
    flash-attention launches."""
    from repro_torch.models import attention
    from repro_torch.serve import BucketPolicy, ShapeBucketScheduler

    offsets = []
    real = attention.flash_attention

    def spy(*args, q_offset=0, **kw):
        if args[0].is_cuda:
            offsets.append(q_offset)
        return real(*args, q_offset=q_offset, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)

    cfg = configs.get_smoke(arch)
    params = api.init_params(cfg, 0, device="cuda")

    def serve(impl_device):
        eng = ServeEngine(
            cfg, params if impl_device == "cuda" else _to_cpu(params),
            max_len=max_len, slots=2, chunk_prefill=True,
            pack_prefill=packed, step_token_budget=14, prefill_slots=3,
            scheduler=ShapeBucketScheduler(BucketPolicy((8, 32),
                                                        allow_overflow=True)),
            device=impl_device)
        return eng, _plan_tokens(eng, prompts, new=6)

    build.reset_launches()
    eng, got = serve("cuda")
    assert all(build.LAUNCHES[k] > 0 for k in
               ("matmul", "flash_attention", "flash_decode")), build.LAUNCHES
    assert max(eng.metrics.chunks_per_prefill) > 1
    assert eng.cache_sets_made <= eng.slots + eng.prefill_slots
    _, want = serve("cpu")
    for p, a, b in zip(prompts, got, want):
        assert len(a) == len(b) == 6
        if a != b:      # only at a near-tie of the plain top-2 logits
            i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            ctx = np.concatenate([p, b[:i]])[None]
            logits, _ = api.prefill(_to_cpu(params), cfg, {"tokens": ctx},
                                    max_len=ctx.shape[1])
            top = torch.topk(logits[0, :cfg.vocab_size], 2).values
            assert float(top[0] - top[1]) <= 1e-3 * float(
                logits[0, :cfg.vocab_size].abs().max())
    return eng, offsets


@pytest.mark.parametrize("packed", [False, True], ids=["chunked", "packed"])
def test_chunked_engine_on_the_card_gives_the_plain_tokens(dev, packed,
                                                            monkeypatch):
    """The smoke qwen2 served chunked (and packed) through the kernels and
    captured decode, against the same engine on the plain versions; the
    chunks at start > 0 launch flash_attention with q_offset."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, configs.get_smoke("qwen2-1.5b").vocab_size,
                            size=n) for n in (40, 5, 7, 30, 3)]
    _, offsets = _serve_chunked_on_card("qwen2-1.5b", packed, prompts,
                                        monkeypatch, max_len=96)
    assert any(o > 0 for o in offsets) and 0 in offsets


@pytest.mark.parametrize("packed", [False, True], ids=["chunked", "packed"])
def test_ring_chunks_on_the_card_give_the_plain_tokens(dev, packed,
                                                       monkeypatch):
    """The smoke gemma2, whose local layers keep a ring of 16 slots, served
    chunked (and packed) on the card: every chunk of every layer launches
    flash_attention, those past the ring's wrap at q_offset 16 over its
    rotated survivors, and the tokens are the plain engine's."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, configs.get_smoke("gemma2-9b").vocab_size,
                            size=n) for n in (40, 5, 30, 3)]
    eng, offsets = _serve_chunked_on_card("gemma2-9b", packed, prompts,
                                          monkeypatch, max_len=96)
    assert 16 in offsets and any(o > 16 for o in offsets)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_ring_chunks_through_the_kernel_vs_plain(dev, dtype, rtol):
    """h2o-danube-1.8b's full-width attention block (D 80) over a ring of
    256 slots, 700 tokens in chunks of 100 (a chunk at start 200 straddles
    the wrap, the rest are past it): the kernel over the rotated survivors
    against the positioned plain version, chunk by chunk, and the rings
    they write; then two ring segments packed."""
    from repro_torch.models import attention

    cfg = configs.get_arch("h2o-danube-1.8b")
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    p = {k: (torch.randn(d.shape, generator=g, device=dev) * 0.05).to(dt)
         for k, d in attention.attn_defs(cfg).items()}
    w = 256
    (x,) = _randn(dev, 11, (1, 700, cfg.d_model), dtype=dt)
    caches = {impl: attention.make_kv_cache(cfg, 1, w, dt, ring=True,
                                            device=dev)
              for impl in ("kernel", "reference")}
    for start in range(0, 700, 100):
        pos = torch.arange(start, start + 100, device=dev)[None]
        out = {}
        build.reset_launches()
        for impl, cache in caches.items():
            out[impl], _ = attention.attn_prefill_chunk(
                p, cfg, x[:, start:start + 100], pos, cache=cache,
                start=start, window=w, impl=impl)
        assert build.LAUNCHES["flash_attention"] == 1
        _close(out["kernel"], out["reference"], rtol)
    a, b = caches["kernel"], caches["reference"]
    _close(a["k"], b["k"], rtol)
    assert torch.equal(a["slot_pos"], b["slot_pos"])
    layout = ((700, 30), (700, 20))
    pairs = {impl: [attention.make_kv_cache(cfg, 1, w, dt, ring=True,
                                            device=dev) for _ in layout]
             for impl in caches}
    for impl, cs in pairs.items():
        for c in cs:
            for key in c:
                c[key].copy_(caches[impl][key])
    (y,) = _randn(dev, 12, (1, 50, cfg.d_model), dtype=dt)
    pos = torch.cat([s + torch.arange(ln, device=dev)
                     for s, ln in layout])[None]
    build.reset_launches()
    got, _ = attention.attn_prefill_packed(p, cfg, y, pos,
                                           caches=pairs["kernel"],
                                           layout=layout, window=w,
                                           impl="kernel")
    assert build.LAUNCHES["flash_attention"] == len(layout)
    want, _ = attention.attn_prefill_packed(p, cfg, y, pos,
                                            caches=pairs["reference"],
                                            layout=layout, window=w,
                                            impl="reference")
    _close(got, want, rtol)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# ---------------------------------------------------------------------------
# The paged pool on the card
# ---------------------------------------------------------------------------

def _paged_pool(dev, seed, n_pages, hkv, page, d, dtype):
    """K and V pages filled everywhere (unwritten rows hold garbage the
    masks and cuts must hide) and a shuffled table of 5 entries."""
    kp, vp = _randn(dev, seed, (n_pages, hkv, page, d),
                    (n_pages, hkv, page, d), dtype=dtype)
    table = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        seed))[:5].to(device=dev, dtype=torch.int32)
    return kp, vp, table


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("pos", [0, 63, 64, 200, 319])
@pytest.mark.parametrize("window", [None, 100])
def test_paged_decode_through_flash_decode_vs_plain(dev, dtype, rtol, pos,
                                                    window):
    """The paged decode's route: the table's gathered view through
    ``flash_decode`` with the position on the device (no kv_pos), against
    ``flash_decode_paged_ref``."""
    dt = getattr(torch, dtype)
    kp, vp, table = _paged_pool(dev, 30, 9, 2, 64, 128, dt)
    (q,) = _randn(dev, 32, (1, 12, 128), dtype=dt)
    k, v = fa_decode.paged_gather(kp, table), fa_decode.paged_gather(vp, table)
    assert k.shape == (1, 2, 320, 128) and k.is_contiguous()
    build.reset_launches()
    got = flash_decode(q, k, v, pos=torch.tensor(pos, dtype=torch.int32,
                                                 device=dev), window=window)
    assert build.LAUNCHES["flash_decode"] == 1
    want = fa_decode.flash_decode_paged_ref(q, kp, vp, table, pos=pos,
                                            window=window)
    _close(got, want, rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("start,c", [(0, 37), (100, 28), (128, 64),
                                     (250, 1)])
def test_paged_chunk_through_flash_attention_vs_plain(dev, dtype, rtol,
                                                      start, c):
    """A full-width qwen2 attention chunk over the paged pool: the card's
    route (the prefix pages gathered and cut at ``start``, then
    ``flash_attention`` at q_offset = start) against the plain paged chunk
    (``flash_prefill_chunk_paged_ref``). At start 100 the last prefix page
    is partial and its rows 100..127 hold another request's tokens, as a
    prefix donor's shared page does; the cut must hide them. The chunk's
    rows land in the same pages on both routes."""
    from repro_torch.models import attention
    from repro_torch.models.layers import init_tree

    dt = getattr(torch, dtype)
    cfg = configs.get_arch("qwen2-1.5b")
    p = init_tree(attention.attn_defs(cfg),
                  torch.Generator(device=dev).manual_seed(5), dt, dev)
    kp, vp, table = _paged_pool(dev, 40, 9, cfg.padded_kv_heads, 64,
                                cfg.head_dim_, dt)
    (x,) = _randn(dev, 42, (1, c, cfg.d_model), dtype=dt)
    positions = (start + torch.arange(c, device=dev))[None]
    outs, pools = [], []
    for impl in ("kernel", "reference"):
        cache = {"k_pages": kp.clone(), "v_pages": vp.clone(),
                 "table": table, "pos": torch.zeros((), dtype=torch.int32,
                                                    device=dev)}
        build.reset_launches()
        y, cache = attention.attn_prefill_chunk(p, cfg, x, positions,
                                                cache=cache, start=start,
                                                impl=impl)
        assert build.LAUNCHES["flash_attention"] == (impl == "kernel")
        assert int(cache["pos"]) == start + c
        outs.append(y)
        pools.append(cache)
    _close(outs[0], outs[1], rtol)
    for key in ("k_pages", "v_pages"):
        _close(pools[0][key], pools[1][key], rtol)


def test_captured_paged_step_replays_across_page_boundaries(dev):
    """Paged serving on the card at page 8: each slot captures its step
    once and replays it while decodes cross page edges (new pages mapped
    into the slot's table tensor, which keeps its address) and while a
    third request reuses a slot; the tokens are the unpaged engine's and
    the pool drains balanced."""
    cfg = configs.get_smoke("qwen2-1.5b")
    params = api.init_params(cfg, 0, device="cuda")
    prompts = [np.arange(3, 3 + n) % cfg.vocab_size for n in (6, 13, 22)]

    def serve(**kw):
        eng = ServeEngine(cfg, params, max_len=64, slots=2, device="cuda",
                          **kw)
        captures = []
        real = eng._capture
        eng._capture = lambda slot: (captures.append(slot), real(slot))
        for p in prompts:
            eng.add_request(p, max_new_tokens=20)
        done = sorted(eng.run_until_done(), key=lambda r: r.rid)
        return eng, [r.out_tokens for r in done], captures

    build.reset_launches()
    eng, got, captures = serve(paged=True, page_size=8)
    assert build.LAUNCHES["flash_decode"] > 0
    assert build.LAUNCHES["flash_attention"] > 0
    assert len(captures) == 2                   # once per slot, no recapture
    ptrs = [s.table.data_ptr() for s in eng._slots]
    _, want, base_captures = serve()
    assert got == want
    assert len(base_captures) == 2
    assert [s.table.data_ptr() for s in eng._slots] == ptrs
    eng.pool.check_balanced()
    pool = eng.metrics.as_dict()["pool"]
    assert pool["page_allocs"] == pool["page_frees"] >= 3 * 3


# -- Shadow measurement on the card (serve/refine.py) -----------------------

QWEN_CELLS = {
    "matmul": dict(m=4, k=1536, n=8960),
    "flash_attention": dict(sq=128, skv=128, d=128, hq=12, hkv=2, window=0),
    "flash_decode": dict(b=4, skv=1024, d=128, hq=12, hkv=2, window=0),
}


def _launchable(kernel, problem):
    if kernel == "matmul":
        return mm_ops.REGIME_TILES[mm_ops.regime(
            problem["m"], problem["n"], problem["k"], torch.float32)][0]
    if kernel == "flash_attention":
        return fa.regime_tiles(torch.float32, problem["d"])[0]
    return (64,)


@pytest.mark.parametrize("kernel", sorted(QWEN_CELLS))
def test_shadow_measure_times_a_launchable_tile_on_the_card(dev, kernel):
    """``make_shadow_measure(h100_sxm)`` times a tile the wrapper launches
    on the card (finite seconds, the kernel launched), and gives ``inf``
    for one it would not launch as given, without timing it."""
    from repro_torch.core import H100_SXM
    from repro_torch.serve.refine import make_shadow_measure

    measure = make_shadow_measure(H100_SXM)
    problem = QWEN_CELLS[kernel]
    before = build.LAUNCHES[kernel]
    dt = measure(kernel, problem, "float32", _launchable(kernel, problem))
    assert 0.0 < dt < 1.0
    assert build.LAUNCHES[kernel] > before
    bad = {"matmul": (32, 32, 32), "flash_attention": (48, 48),
           "flash_decode": (2048,)}[kernel]
    before = build.LAUNCHES[kernel]
    assert measure(kernel, problem, "float32", bad) == float("inf")
    assert build.LAUNCHES[kernel] == before
    assert len(measure.timers) == 1


def test_shadow_measure_leaves_memory_flat(dev):
    """Fifty measurements of a cached cell's timer: each captures, replays
    and drops its own graph, so the allocated bytes end where the first
    measurement left them."""
    from repro_torch.core import H100_SXM
    from repro_torch.serve.refine import make_shadow_measure

    measure = make_shadow_measure(H100_SXM)
    tiles = {k: _launchable(k, p) for k, p in QWEN_CELLS.items()}
    for kernel, problem in QWEN_CELLS.items():
        measure(kernel, problem, "float32", tiles[kernel])
    torch.cuda.synchronize()
    first = torch.cuda.memory_allocated()
    for i in range(50):
        kernel = sorted(QWEN_CELLS)[i % 3]
        measure(kernel, QWEN_CELLS[kernel], "float32", tiles[kernel])
    torch.cuda.synchronize()
    assert abs(torch.cuda.memory_allocated() - first) <= 1 << 20
    assert len(measure.timers) == 3


# ---------------------------------------------------------------------------
# The MoE, encoder-decoder and vision models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_captured_moe_decode_replays_the_eager_step(dev, arch):
    """An MoE decode step (router, top-k, the stable sort, the gather
    dispatch and combine) captured in a CUDA graph replays the eager
    step's logits exactly: nothing in it reads back to the host."""
    cfg = configs.get_smoke(arch)
    params = api.init_params(cfg, 0, device="cuda")
    prompt = (np.arange(3, 14) * 7) % cfg.vocab_size
    _, eager = api.prefill(params, cfg, {"tokens": prompt[None]}, max_len=32)
    _, graphed = api.prefill(params, cfg, {"tokens": prompt[None]}, max_len=32)
    tok = torch.full((1, 1), 5, dtype=torch.long, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up: what capture needs
        scratch = [{k: t.clone() for k, t in c.items()} for c in graphed]
        api.decode_step(params, cfg, tok, scratch)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out, _ = api.decode_step(params, cfg, tok, graphed)
    for step in range(3):
        tok.fill_(11 + step)
        want, _ = api.decode_step(params, cfg, tok, eager)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want), step
    assert all(int(c["pos"]) == len(prompt) + 3 for c in graphed)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("hq,hkv,sq,skv,d,causal", [
    (16, 16, 600, 600, 128, True),       # deepseek-moe-16b: MHA
    (64, 4, 600, 600, 128, True),        # qwen3-moe: ratio 16
    (32, 32, 1500, 1500, 64, False),     # whisper's encoder
    (32, 32, 64, 1500, 64, False),       # whisper's cross-attention
    (32, 32, 1, 1500, 64, False),        # a decode step's cross-attention
])
def test_flash_attention_at_the_moe_and_whisper_shapes(dev, dtype, rtol, hq,
                                                       hkv, sq, skv, d,
                                                       causal):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(sq + skv)
    q = torch.randn((1, hq, sq, d), generator=g, device="cuda").to(dt)
    k = torch.randn((1, hkv, skv, d), generator=g, device="cuda").to(dt)
    v = torch.randn((1, hkv, skv, d), generator=g, device="cuda").to(dt)
    _close(flash_attention(q, k, v, causal=causal),
           flash_attention_ref(q, k, v, causal=causal), rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("hq,hkv,d,pos", [(16, 16, 128, 611),
                                          (32, 32, 64, 79),
                                          (64, 4, 128, 607),
                                          (32, 32, 64, 1499)])
def test_flash_decode_at_the_moe_and_whisper_ratios(dev, dtype, rtol, hq, hkv,
                                                    d, pos):
    dt = getattr(torch, dtype)
    s = 1500 if pos == 1499 else 1024
    g = torch.Generator(device="cuda").manual_seed(pos)
    q = torch.randn((1, hq, d), generator=g, device="cuda").to(dt)
    k = torch.randn((1, hkv, s, d), generator=g, device="cuda").to(dt)
    v = torch.randn((1, hkv, s, d), generator=g, device="cuda").to(dt)
    pos_t = torch.full((), pos, dtype=torch.int32, device="cuda")
    _close(flash_decode(q, k, v, pos=pos_t), flash_decode_ref(q, k, v, pos=pos),
           rtol)


def test_whisper_cross_attention_through_the_kernel(dev):
    """whisper's smoke model on the card: the encoder, the decoder prefill
    (cross-attention Sq != Skv, non-causal) and decode steps through the
    kernels against the plain versions, and the launches they made."""
    from repro_torch.models import encdec

    cfg = configs.get_smoke("whisper-large-v3")
    params = api.init_params(cfg, 0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.randn((2, cfg.encoder.seq_len, cfg.d_model), generator=g,
                         device="cuda")
    toks = torch.randint(2, cfg.vocab_size, (2, 7), generator=g, device="cuda")
    batch = {"tokens": toks, "frames": frames}
    build.reset_launches()
    with torch.inference_mode():
        _close(encdec.encode(params, cfg, frames),
               encdec.encode(params, cfg, frames, impl="reference"), 2e-5)
        lk, sk = api.prefill(params, cfg, batch, max_len=16)
        lr, sr = api.prefill(params, cfg, batch, max_len=16, impl="reference")
        _close(lk, lr, 2e-5)
        for _ in range(3):
            tok = torch.argmax(lr[:, :cfg.vocab_size], -1, keepdim=True)
            lk, sk = api.decode_step(params, cfg, tok, sk)
            lr, sr = api.decode_step(params, cfg, tok, sr, impl="reference")
            _close(lk, lr, 2e-5)
    n_enc, n_dec = cfg.encoder.n_layers, cfg.n_layers
    assert build.LAUNCHES["flash_attention"] == 2 * n_enc + 2 * n_dec
    assert build.LAUNCHES["flash_decode"] == 3 * 2 * n_dec


def test_moe_engine_serves_the_plain_tokens_through_the_kernels(dev):
    """deepseek-moe-16b smoke through the captured engine: matmul (dense
    layer, shared experts), flash_attention and flash_decode launch, and
    the tokens are the plain path's or differ at a near tie."""
    cfg = configs.get_smoke("deepseek-moe-16b")
    params = api.init_params(cfg, 0, device="cuda")
    prompts = [(np.arange(2, 2 + n) * 5) % cfg.vocab_size for n in (7, 19, 4)]
    build.reset_launches()
    eng = ServeEngine(cfg, params, max_len=48, slots=2, device="cuda")
    rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
    done = {r.rid: r.out_tokens for r in eng.run_until_done()}
    for name in ("matmul", "flash_attention", "flash_decode"):
        assert build.LAUNCHES[name] > 0, name
    for rid, p in zip(rids, prompts):
        with torch.inference_mode():
            logits, st = api.prefill(params, cfg, {"tokens": p[None]},
                                     max_len=48, impl="reference")
            want = [int(torch.argmax(logits[0, :cfg.vocab_size]))]
            while len(want) < 8:
                tok = torch.tensor([[want[-1]]], device="cuda")
                logits, st = api.decode_step(params, cfg, tok, st,
                                             impl="reference")
                want.append(int(torch.argmax(logits[0, :cfg.vocab_size])))
        _same_tokens_or_tie(params, cfg, p, done[rid], want)


# ---------------------------------------------------------------------------
# The fleet: a kill and its recovery under captured graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_fleet_kill_and_recover_serves_the_fault_free_tokens(dev, paged):
    """Two captured engines, "a" and "b"; "b" is killed while it decodes
    and its requests are re-prefilled on "a". Every request finishes once
    with the tokens of a fault-free serve on one engine; no slot of the
    survivor is recaptured and its slot tensors keep their addresses; the
    kernels launch after the kill (the survivor's re-prefills and
    replays)."""
    from repro_torch.serve import (BucketPolicy, FaultEvent, FaultInjector,
                                   FaultScript, FleetRouter,
                                   ShapeBucketScheduler)

    cfg = configs.get_smoke("qwen2-1.5b")
    params = api.init_params(cfg, 0, device="cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab_size, size=n) for n in
               (5, 12, 7, 30, 9, 20)]
    policy = BucketPolicy((8, 16, 32), max_queue=64)

    def engine():
        eng = ServeEngine(cfg, params, max_len=64, slots=2, device="cuda",
                          scheduler=ShapeBucketScheduler(policy),
                          paged=paged, page_size=8 if paged else None)
        eng.captures = []
        real = eng._capture
        eng._capture = lambda slot: (eng.captures.append(slot), real(slot))
        return eng

    solo = engine()
    rids = [solo.add_request(p, max_new_tokens=12) for p in prompts]
    by_rid = {r.rid: r.out_tokens for r in solo.run_until_done()}
    want = [by_rid[r] for r in rids]

    router = FleetRouter({"a": engine(), "b": engine()}, policy,
                         injector=FaultInjector(FaultScript(
                             [FaultEvent(4, "kill", "b")])))
    fids = [router.route(p, max_new_tokens=12).fid for p in prompts]
    survivor = router.engines["a"]
    for _ in range(3):
        router.step_all()
    assert any(r is not None for r in router.engines["b"]._active)
    ptrs = [[t.data_ptr() for c in s.caches for t in c.values()]
            + [s.token.data_ptr(), s.next_token.data_ptr()]
            for s in survivor._slots]
    build.reset_launches()
    router.run_until_done(max_steps=500)
    assert router.status["b"] == "dead" and router.recoveries >= 1
    assert router.lost == 0
    got = router.results()
    assert sorted(got) == sorted(fids)
    assert [got[f] for f in fids] == want
    for name in ("matmul", "flash_attention", "flash_decode"):
        assert build.LAUNCHES[name] > 0, name
    assert len(survivor.captures) == survivor.slots
    assert [[t.data_ptr() for c in s.caches for t in c.values()]
            + [s.token.data_ptr(), s.next_token.data_ptr()]
            for s in survivor._slots] == ptrs
    if paged:
        for eng in router.engines.values():
            eng.pool.check_balanced()
