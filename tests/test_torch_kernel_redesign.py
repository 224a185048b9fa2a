"""The redesigned matmul, flash_decode and flash_attention: what runs
before the card does.

The kernels run only on the card; what surrounds them runs here and is
pinned here:

* ``mm``'s choice of kernel (skinny, simt, wgmma, or the plain path for row
  strides TMA and 16-byte loads cannot take) from M, N, K and the dtype;
* every compiled tile's shared memory against a block's 232,448 bytes;
* the K split of the matmul and the KV split of the decode: at B = 1 they
  give the card at least one wave of 132 blocks, at B = 128 one split;
* the split decode's arithmetic (per-split online softmax, then the
  log-sum-exp combine in split order, ``flash_decode_split_ref``) against
  the JAX Pallas ``flash_decode`` in interpret mode, on inputs from a numpy
  seed. Tolerance 1e-5 in float32: the combine reorders the sums;
* flash_attention's regime (mma for float32, wgmma for bf16) and the tiles
  each launches, the sweep and default tiles at qwen2-1.5b's, gemma2-9b's
  and recurrentgemma-9b's widths against a block's shared memory, and each
  regime's arithmetic emulated in PyTorch (3xTF32 products; bf16 P) against
  the plain version and the JAX Pallas kernel in interpret mode: 3xTF32
  meets the float32 check (2e-5), one TF32 product does not.
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
from repro_torch.configs.shapes import DECODE_32K, LONG_500K  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.core.tiling import cdiv  # noqa: E402
from repro_torch.core.tiling import enumerate_tiles  # noqa: E402
from repro_torch.kernels.flash_attention import decode as fd  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.launch.specs import cell_problems, kernel_problems  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
F32, BF16 = torch.float32, torch.bfloat16
SMS = H100_SXM.num_sm


# ---------------------------------------------------------------------------
# matmul: regimes, tiles, splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k,dtype,want", [
    (1, 8960, 1536, F32, "skinny"),
    (4, 1536, 8960, BF16, "skinny"),
    (16, 8960, 1536, F32, "skinny"),
    (17, 8960, 1536, F32, "simt"),
    (600, 1536, 8960, F32, "simt"),
    (600, 8960, 1536, BF16, "wgmma"),
    (601, 1000, 1000, BF16, "wgmma"),      # 2000-byte rows: 16-byte multiples
    (600, 1000, 1000, F32, "simt"),
    (600, 1001, 1536, BF16, "plain"),      # 2002-byte rows of B
    (600, 1536, 1001, F32, "plain"),       # 4004-byte rows of A
    (1, 1001, 1536, F32, "plain"),
    (4, 1004, 1536, BF16, "plain"),        # 2008 bytes: a multiple of 8 only
    (4, 1004, 1536, F32, "skinny"),        # 4016 bytes
])
def test_mm_regime_from_shape_and_dtype(m, n, k, dtype, want):
    assert mm_ops.regime(m, n, k, dtype) == want
    tile = mm_ops.default_tile(m, k, n, dtype)
    assert tuple(tile) in mm_ops.REGIME_TILES[want]
    # A tile of another regime is refused, never run in place of this one.
    for other, tiles in mm_ops.REGIME_TILES.items():
        for t in tiles:
            if t not in mm_ops.REGIME_TILES[want]:
                with pytest.raises(ValueError):
                    mm_ops.launch_tile(t, m, n, k, dtype)
                assert mm_ops.SPEC.vmem_bytes(
                    t, dict(m=m, k=k, n=n), str(dtype)) == float("inf")


@pytest.mark.parametrize("arch", configs.list_archs())
def test_no_model_config_takes_the_plain_path(arch):
    cfg = configs.get_arch(arch)
    for width in (cfg.d_model, cfg.d_ff):
        if width:
            assert width % 8 == 0, (arch, width)
    for k, n in ((cfg.d_model, cfg.d_ff or cfg.d_model),
                 (cfg.d_ff or cfg.d_model, cfg.d_model)):
        for m in (1, 4, 600):
            for dtype in (F32, BF16):
                assert mm_ops.regime(m, n, k, dtype) != "plain"


def test_every_compiled_tile_fits_a_block():
    limit = H100_SXM.vmem_bytes
    assert limit == 232_448
    for regime, tiles in mm_ops.REGIME_TILES.items():
        for tile in tiles:
            for dtype in ("float32", "bfloat16"):
                assert 0 < mm_ops.smem_bytes(tile, dtype) <= limit, (tile, dtype)
    # The wgmma ring is four stages of a bf16 A and B tile (plus alignment).
    assert mm_ops.smem_bytes((128, 64, 128), "bfloat16") == \
        4 * (128 * 64 + 64 * 128) * 2 + 1024 + 64
    assert mm_ops.threads((128, 64, 128)) == 256
    assert mm_ops.threads((64, 64, 128)) == 128
    assert mm_ops.threads((16, 64, 256)) == 256


@pytest.mark.parametrize("m,k,n", [(1, 1536, 8960), (1, 8960, 1536),
                                   (4, 4096, 12288), (600, 8960, 1536),
                                   (37, 1000, 1001), (2, 100, 8)])
def test_split_plan_covers_k_in_whole_steps(m, k, n):
    for dtype in (F32, BF16):
        tile = mm_ops.default_tile(m, k, n, dtype)
        splits, k_split = mm_ops.split_plan(m, n, k, tile)
        assert k_split % tile[1] == 0
        assert (splits - 1) * k_split < k <= splits * k_split
        if splits > 1:
            assert k_split >= 4 * tile[1]
        assert mm_ops.split_k(m, n, k, tile) == splits


def _blocks(m, k, n, dtype):
    tile = mm_ops.default_tile(m, k, n, dtype)
    return (cdiv(m, tile[0]) * cdiv(n, tile[2])
            * mm_ops.split_k(m, n, k, tile))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-9b"])
def test_splits_fill_the_card_at_b1_and_stay_whole_at_b128(arch):
    cfg = configs.get_arch(arch)
    b1 = kernel_problems(cfg, 1, 32768, "decode")
    if arch == "recurrentgemma-9b":
        b1 = cell_problems(cfg, LONG_500K)
    b128 = cell_problems(cfg, DECODE_32K)
    mm1, mm128 = b1["matmul"], b128["matmul"]
    assert mm1["m"] == 1 and mm128["m"] == 128
    for dtype in (F32, BF16):
        assert _blocks(mm1["m"], mm1["k"], mm1["n"], dtype) >= SMS
        t = mm_ops.default_tile(mm128["m"], mm128["k"], mm128["n"], dtype)
        assert mm_ops.split_k(mm128["m"], mm128["n"], mm128["k"], t) == 1
    for problem, want_one in ((b1["flash_decode"], False),
                              (b128["flash_decode"], True)):
        prob = dict(problem, hq=cfg.padded_heads, hkv=cfg.padded_kv_heads)
        tile = fa_ops.DECODE_SPEC.default_tile(prob, "float32")
        bkv = fd.launch_bkv(tile[0], prob["skv"], prob["d"],
                            prob["hq"] // prob["hkv"])
        sp = fd.decode_splits(prob["b"], prob["hkv"], prob["skv"], bkv,
                              prob["skv"] - 1, True, prob["window"] or None)
        blocks = prob["b"] * prob["hkv"] * sp.splits
        assert blocks == fa_ops.DECODE_SPEC.n_tiles(tile, prob)
        # The split count is fixed by the cache length, not the position.
        assert sp.splits == fd.split_count(prob["b"] * prob["hkv"],
                                           cdiv(prob["skv"], bkv))
        if want_one:
            assert sp.splits == 1
        else:
            assert blocks >= SMS and sp.splits <= cdiv(prob["skv"], bkv)


# ---------------------------------------------------------------------------
# flash_decode: the split layout and the split-and-combine arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,bkv,pos,window,linear,want", [
    (1024, 8, 511, None, True, (0, 64)),
    (1024, 64, 1023, 100, True, (14, 2)),
    (4096, 8, 4095, 2048, True, (256, 256)),
    (1000, 7, 900, None, True, (0, 129)),
    (1000, 7, 900, 57, True, (120, 9)),
    (1000, 128, 10, None, False, (0, 8)),    # kv_pos: every block
])
def test_decode_visits_only_blocks_with_visible_keys(s, bkv, pos, window,
                                                     linear, want):
    sp = fd.decode_splits(1, 2, s, bkv, pos, linear, window)
    assert (sp.ib_lo, sp.n_blk) == want
    if linear:
        first, last = sp.ib_lo * bkv, (sp.ib_lo + sp.n_blk) * bkv - 1
        lo_key = max(0, pos - window + 1) if window else 0
        assert first <= lo_key < first + bkv and last - bkv < pos <= last
    # The split count is fixed by S (a captured grid cannot follow pos);
    # the first min(splits, blocks) splits share the blocks, the rest none.
    # The used splits partition the blocks in order, none empty, each once.
    assert sp.splits == fd.split_count(2, cdiv(s, bkv))
    runs = sp.runs()
    assert len(runs) == sp.used == min(sp.splits, sp.n_blk)
    assert runs[0][0] == sp.ib_lo and runs[-1][1] == sp.ib_lo + sp.n_blk
    assert all(a < b for a, b in runs)
    assert all(r1[1] == r2[0] for r1, r2 in zip(runs, runs[1:]))


def test_split_count_rule():
    assert fd.split_count(1, 10_000) == SMS
    assert fd.split_count(2, 10_000) == SMS // 2
    assert fd.split_count(2, 5) == 5            # at least one block a split
    assert fd.split_count(128, 10_000) == 1
    assert fd.split_count(256, 10_000) == 1
    assert fd.split_count(1, 0) == 1


def _dec(seed, b=2, hq=8, hkv=2, s=128, d=32):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, hq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


def _ring(s, pos, unwritten):
    written = np.arange(max(0, pos - s + 1), pos + 1)
    kv_pos = np.full(s, -1, np.int32)
    kv_pos[written % s] = written
    kv_pos[:unwritten] = -1
    return kv_pos


SPLIT_CASES = [
    ("splits=1", dict(pos=127), None, 1),
    ("splits=2", dict(pos=127), None, 2),
    ("splits=7", dict(pos=100), None, 7),
    ("empty splits", dict(pos=127), None, 12),          # 8 blocks, 12 splits
    ("derived splits", dict(pos=90), None, None),
    ("window+softcap", dict(pos=120, window=40, softcap=8.0), None, 3),
    ("window, 1 block", dict(pos=100, window=5), None, 4),
    ("ring -1 slots", dict(pos=300, window=70), ("ring", 300, 9), 7),
    ("holes", dict(pos=90), ("holes", 90, 0), 5),
    ("all masked: unwritten", dict(pos=50), ("none", 50, 0), 3),
    ("all masked: future", dict(pos=5), ("future", 5, 0), 6),
]


@pytest.mark.parametrize("name,kw,kv,splits", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_split_decode_matches_the_jax_kernel(name, kw, kv, splits):
    s = 128
    q, k, v = _dec(31, s=s)
    kv_pos = None
    if kv is not None:
        kind, pos, unwritten = kv
        if kind == "ring":
            kv_pos = _ring(s, pos, unwritten)
        elif kind == "holes":
            kv_pos = np.arange(s, dtype=np.int32)
            kv_pos[np.random.default_rng(3).random(s) < 0.3] = -1
        elif kind == "none":
            kv_pos = np.full(s, -1, np.int32)
        else:
            kv_pos = np.arange(10, 10 + s, dtype=np.int32)   # all after pos
    want = np.asarray(pallas_decode(
        *map(jnp.asarray, (q, k, v)), bkv=32, interpret=True,
        kv_pos=None if kv_pos is None else jnp.asarray(kv_pos), **kw))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tkv = None if kv_pos is None else torch.from_numpy(kv_pos)
    out = fd.flash_decode_split_ref(tq, tk, tv, kv_pos=tkv, bkv=16,
                                    splits=splits, **kw)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    if "all masked" in name:
        # NEG_INF is finite: the reference averages every cache row.
        mean = v.mean(axis=2).repeat(q.shape[1] // v.shape[1], axis=1)
        np.testing.assert_allclose(out.numpy(), mean, **TOL)


@pytest.mark.parametrize("bkv", [7, 16, 50])
def test_split_decode_with_a_ragged_last_block(bkv):
    """S = 100 is no multiple of bkv: the kernel's last block is cut at the
    cache end, and the slots past it are no keys at all."""
    q, k, v = _dec(32, b=1, hq=4, hkv=1, s=100, d=16)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for kw in (dict(pos=99), dict(pos=99, window=30)):
        want = fd.flash_decode_ref(tq, tk, tv, **kw)
        for splits in (1, 3, None):
            out = fd.flash_decode_split_ref(tq, tk, tv, bkv=bkv,
                                            splits=splits, **kw)
            np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
    kp = torch.full((100,), -1, dtype=torch.int32)
    out = fd.flash_decode_split_ref(tq, tk, tv, pos=4, kv_pos=kp, bkv=bkv,
                                    splits=3)
    np.testing.assert_allclose(out.numpy(),
                               v.mean(axis=2).repeat(4, axis=1), **TOL)


def test_decode_default_tile_fits_and_fills():
    cfg = configs.get_arch("qwen2-1.5b")
    for b in (1, 4):
        prob = dict(kernel_problems(cfg, b, 1024, "decode")["flash_decode"],
                    hq=cfg.padded_heads, hkv=cfg.padded_kv_heads)
        tile = fa_ops.DECODE_SPEC.default_tile(prob, "float32")
        assert fa_ops.DECODE_SPEC.vmem_bytes(tile, prob, "float32") <= \
            H100_SXM.vmem_bytes
        assert fa_ops.DECODE_SPEC.n_tiles(tile, prob) >= 128


# ---------------------------------------------------------------------------
# flash_attention: regimes, tiles, and each regime's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype,want", [(F32, "mma"), ("float32", "mma"),
                                        (BF16, "wgmma"), ("bfloat16", "wgmma")])
def test_fa_regime_from_dtype_and_head_dim(d, dtype, want):
    assert fa.regime(dtype, d) == want
    tiles = fa.regime_tiles(dtype, d)
    assert tiles
    for t in tiles:
        assert fa.launch_tile(t, d, dtype) == t
        assert fa.smem_bytes(*t, d, dtype) <= H100_SXM.vmem_bytes


def test_fa_regime_refuses_other_head_dims_and_dtypes():
    for d in (0, 8, 48, 96, 512):
        with pytest.raises(ValueError):
            fa.regime(F32, d)
        with pytest.raises(ValueError):
            fa.launch_tile((64, 64), d, BF16)
    for dtype in (torch.float16, "float64"):
        with pytest.raises(TypeError):
            fa.regime(dtype, 128)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_fa_launch_tile_per_regime(d):
    mma = set(fa.regime_tiles("float32", d))
    wg = set(fa.regime_tiles("bfloat16", d))
    assert {bq for bq, _ in mma | wg} <= set(fa.BQS) == {64, 128}
    assert {bkv for _, bkv in mma} <= {32, 64}
    assert {bkv for _, bkv in wg} <= {64, 128}
    prob = dict(sq=600, skv=600, d=d, hq=16, hkv=2, window=0)
    others = {(4, 4), (32, 32), (16, 64), (64, 256), (256, 64), (600, 600)}
    for t in mma | wg | others:
        for dtype, legal in (("float32", mma), ("bfloat16", wg)):
            if t in legal:
                assert fa.launch_tile(t, d, dtype) == t
                assert fa_ops.FLASH_SPEC.vmem_bytes(t, prob, dtype) == \
                    fa.smem_bytes(*t, d, dtype)
            else:                  # refused, never clamped to a legal tile
                with pytest.raises(ValueError):
                    fa.launch_tile(t, d, dtype)
                assert fa_ops.FLASH_SPEC.vmem_bytes(t, prob, dtype) == \
                    float("inf")


def test_fa_smem_and_threads_of_each_regime():
    limit = H100_SXM.vmem_bytes
    # mma: float32 q block and two K, V stages, rows padded by 4 floats.
    assert fa.smem_bytes(128, 64, 128, F32) == 4 * 132 * (128 + 4 * 64)
    assert fa.smem_bytes(64, 32, 256, F32) == 4 * 260 * (64 + 4 * 32)
    assert fa.smem_bytes(128, 32, 256, F32) > limit     # so D = 256: (64, 32)
    # wgmma: bf16 in 64-column panels, 1024 B of alignment, 7 mbarriers.
    assert fa.smem_bytes(128, 128, 128, BF16) == \
        2 * 128 * (128 + 4 * 128) + 1024 + 56
    assert fa.smem_bytes(64, 64, 16, BF16) == fa.smem_bytes(64, 64, 64, BF16)
    assert fa.threads(64, F32) == 128 and fa.threads(128, F32) == 256
    assert fa.threads(64, BF16) == 256 and fa.threads(128, BF16) == 384


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-9b",
                                  "recurrentgemma-9b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fa_swept_and_default_tiles_fit_at_model_widths(arch, dtype):
    cfg = configs.get_arch(arch)
    spec = fa_ops.FLASH_SPEC
    for seq in (16, 600, 4096, 32768):
        prob = kernel_problems(cfg, 1, seq, "prefill")["flash_attention"]
        d = prob["d"]
        tiles = enumerate_tiles(spec.constraints(prob), H100_SXM, dtype,
                                lambda t: spec.vmem_bytes(t, prob, dtype),
                                max_candidates=256)
        # The sweep yields exactly the tiles the regime launches.
        assert {tuple(t) for t in tiles} == set(fa.regime_tiles(dtype, d))
        for t in list(tiles) + [spec.default_tile(prob, dtype)]:
            assert fa.launch_tile(t, d, dtype) == tuple(t)
            assert spec.vmem_bytes(t, prob, dtype) <= H100_SXM.vmem_bytes
            assert spec.workload(t, prob, dtype).threads == \
                fa.threads(t[0], dtype)


@pytest.mark.parametrize("dtype,s,d,want", [
    ("float32", 600, 128, (64, 64)), ("float32", 4096, 128, (128, 64)),
    ("float32", 4096, 256, (64, 32)), ("bfloat16", 600, 128, (64, 64)),
    ("bfloat16", 4096, 128, (128, 128)), ("bfloat16", 4096, 256, (128, 64)),
    ("bfloat16", 600, 256, (64, 64)), ("float32", 16, 16, (64, 64)),
    ("bfloat16", 16, 32, (64, 64))])
def test_fa_default_tiles_are_the_measured_best(dtype, s, d, want):
    # qwen2-1.5b's heads (PERF.md): 128 query rows and the regime's
    # largest bkv once 128-row blocks alone fill the card's 132 SMs.
    prob = dict(sq=s, skv=s, d=d, hq=16, hkv=2, window=0)
    assert tuple(fa_ops.FLASH_SPEC.default_tile(prob, dtype)) == want


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, split):
    """a @ b from TF32 products summed in float32: three (3xTF32, the mma
    regime: hi*hi + hi*lo + lo*hi) or one (plain TF32)."""
    ahi, bhi = _tf32(a), _tf32(b)
    if not split:
        return ahi @ bhi
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _attention_emulated(q, k, v, *, causal, split=True, p_bf16=False):
    """Dense attention with each regime's arithmetic: q.k and p.v as TF32
    products (mma), or bf16 operands with P rounded to bf16 before p.v and
    the denominator from the unrounded P (wgmma)."""
    n_rep = q.shape[1] // k.shape[1]
    k = k.float().repeat_interleave(n_rep, dim=1)
    v = v.float().repeat_interleave(n_rep, dim=1)
    scale = q.shape[-1] ** -0.5
    if p_bf16:
        s = (q.float() @ k.transpose(-1, -2)) * scale
    else:
        s = _mm_tf32(q.float() * scale, k.transpose(-1, -2), split)
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1), -2e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    if p_bf16:
        o = p.to(BF16).float() @ v
    else:
        o = _mm_tf32(p, v, split)
    return (o / den).to(q.dtype)


def _fa_inputs(seed, dtype=F32, b=1, hq=4, hkv=2, s=128, d=64):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v)]


def _rel_err(out, ref):
    return float((out.float() - ref.float()).abs().max()) / max(
        1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("d", [64, 128])
def test_3xtf32_meets_the_float32_check_and_plain_tf32_does_not(d):
    q, k, v = _fa_inputs(40 + d, d=d)
    ref = flash_attention_ref(q, k, v, causal=True)
    want = torch.from_numpy(np.array(pallas_flash(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True,
        tile=(64, 64), interpret=True)))
    three = _attention_emulated(q, k, v, causal=True, split=True)
    one = _attention_emulated(q, k, v, causal=True, split=False)
    for target in (ref, want):
        assert _rel_err(three, target) <= 2e-5 / 4     # chip_smoke's REL_TOL
        assert _rel_err(one, target) > 2e-5            # why the mma splits


def test_bf16_p_stays_within_the_bf16_check():
    q, k, v = _fa_inputs(44, dtype=BF16, hq=8, hkv=1, s=256, d=128)
    ref = flash_attention_ref(q, k, v, causal=True)
    emu = _attention_emulated(q, k, v, causal=True, p_bf16=True)
    err = _rel_err(emu, ref)
    assert err <= 1e-2                  # chip_smoke's bf16 REL_TOL
    # of the order of the output's own rounding to bf16 (2^-8 relative)
    assert err <= 4 * 2.0 ** -8


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_attention_plain_vs_pallas_every_head_dim(d):
    q, k, v = _fa_inputs(50 + d, hq=4, hkv=2, s=96, d=d)
    want = np.asarray(pallas_flash(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                   causal=True, window=40, tile=(32, 32),
                                   interpret=True))
    out = fa.flash_attention(q, k, v, causal=True, window=40)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
