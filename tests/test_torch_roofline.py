"""The port's roofline (``repro_torch/roofline``) against the reference's
``repro/roofline/analysis.py``: one counterpart of each of
``tests/test_roofline.py``'s five cases, ``model_flops`` and
``active_param_count`` of every config and shape, and the count's record of
kernel launches, torch ops, collectives and live bytes on ``meta`` tensors.

The reference parses HLO text; the port records its own collective calls
(``distributed/collectives.py`` on ``meta`` tensors, under PyTorch's fake
process group), so where the reference feeds ``parse_collectives`` a line
of HLO the port's case feeds ``collective_stats`` the call it stands for.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.configs.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro.roofline import analysis as jax_RA  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.matmul.ops import mm  # noqa: E402
from repro_torch.launch.dryrun import fake_group  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.roofline.count import counting  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- the reference's five cases ----------------------------------------------

def test_result_bytes():
    """``_shape_bytes``'s cases: bf16[8,4096], f32[16], the tuple
    (bf16[2,4], f32[8]), pred[4], and a type of no bytes (token[])."""
    assert RA.result_bytes([((8, 4096), torch.bfloat16)]) == 8 * 4096 * 2
    assert RA.result_bytes([((16,), torch.float32)]) == 64
    assert RA.result_bytes([((2, 4), torch.bfloat16),
                            ((8,), torch.float32)]) == 16 + 32
    assert RA.result_bytes([((4,), torch.bool)]) == 4
    assert RA.result_bytes([((), "token")]) == 0
    assert RA.dtype_bytes("bf16") == jax_RA._DTYPE_BYTES["bf16"]
    assert RA._DTYPE_BYTES == jax_RA._DTYPE_BYTES
    assert RA._COLLECTIVES == jax_RA._COLLECTIVES


def test_collective_stats_synthetic():
    """The reference's synthetic HLO, as the calls it stands for: its four
    collectives (the ``add`` is no call), each kind's count and bytes."""
    calls = [
        ("all-reduce", RA.result_bytes([((8, 128), torch.bfloat16)])),
        ("all-gather", RA.result_bytes([((64, 32), torch.float32)])),
        ("reduce-scatter", RA.result_bytes([((4, 32), torch.float32)])),
        ("collective-permute", RA.result_bytes([((16,), torch.bfloat16)])),
    ]
    stats = RA.collective_stats(calls)
    hlo = """
  %all-reduce.1 = bf16[8,128]{1,0} all-reduce(bf16[8,128] %x), replica_groups={}
  %all-gather.2 = f32[64,32]{1,0} all-gather(f32[4,32] %y), dimensions={0}
  %reduce-scatter.3 = f32[4,32]{1,0} reduce-scatter(f32[64,32] %z)
  %add.4 = f32[2]{0} add(f32[2] %a, f32[2] %b)
  %collective-permute.5 = bf16[16]{0} collective-permute(bf16[16] %w)
"""
    ref = jax_RA.parse_collectives(hlo)
    assert stats.count_by_kind == ref.count_by_kind == {
        "all-reduce": 1, "all-gather": 1, "reduce-scatter": 1,
        "collective-permute": 1,
    }
    assert stats.bytes_by_kind == ref.bytes_by_kind
    assert stats.bytes_by_kind["all-reduce"] == 8 * 128 * 2 * 2.0
    assert stats.total_bytes == ref.total_bytes > 0
    with pytest.raises(ValueError):
        RA.collective_stats([("add", 8)])


def test_one_record_a_call():
    """The reference counts an async all-gather's start and not its done;
    the port records each call of its collectives once, on meta tensors
    under a fake group of two ranks, and moves nothing."""
    with fake_group(2):
        group = torch.distributed.group.WORLD
        with counting() as c:
            out = collectives.all_gather(meta(4, 8), 0, group)
            collectives.permute(meta(16, dtype=torch.bfloat16),
                                [(0, 1), (1, 0)], group)
            collectives.all_reduce(meta(16), "max", group)
    assert out.shape == (8, 8) and out.is_meta
    stats = RA.collective_stats(c.collectives)
    assert stats.count_by_kind == {"all-gather": 1, "collective-permute": 1,
                                   "all-reduce": 1}
    assert stats.bytes_by_kind == {"all-gather": 8 * 8 * 4,
                                   "collective-permute": 16 * 2,
                                   "all-reduce": 16 * 4 * 2.0}


def test_terms_dominance():
    t = RA.RooflineTerms(flops=1e12, hbm_bytes=1e9, collective_bytes=1e6,
                         compute_s=1e12 / H100_SXM.peak_flops_bf16,
                         memory_s=1e9 / H100_SXM.hbm_bw,
                         collective_s=1e6 / (4 * 50e9))
    assert t.dominant == "compute"
    assert 0 < t.roofline_fraction() <= 1.0
    assert t.total_s == t.compute_s
    # The reference's formulas on the H100: 989e12, 3.35e12, 18 x 50e9.
    u = RA.terms(989e12, 3.35e12, 18 * 50e9, H100_SXM)
    assert (u.compute_s, u.memory_s, u.collective_s) == (1.0, 1.0, 1.0)


_PSUM = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P
from repro.roofline.analysis import parse_collectives
mesh = jax.make_mesh((2,), ("d",), axis_types=(jax.sharding.AxisType.Auto,))
def f(x):
    return jax.lax.psum(x.sum(axis=0), "d")
g = shard_map(f, mesh=mesh, in_specs=P("d", None), out_specs=P(),
              check_vma=False)
x = jax.ShapeDtypeStruct((64, 64), jnp.float32)
c = jax.jit(g).lower(x).compile()
print("TOTAL", parse_collectives(c.as_text()).total_bytes)
"""


def test_compiled_psum_against_the_ports_all_reduce():
    """The reference's compiled psum of a [64, 64] float32 sharded over two
    devices and the port's ``all_reduce`` of the [64] float32 result under
    a two-rank fake group: 512 bytes on both sides."""
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", _PSUM], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300)
    line = [x for x in out.stdout.splitlines() if x.startswith("TOTAL")]
    assert line, out.stderr[-2000:]
    ref = float(line[0].split()[1])
    with fake_group(2):
        with counting() as c:
            collectives.all_reduce(meta(64), "sum",
                                   torch.distributed.group.WORLD)
    assert RA.analyze(c, H100_SXM).collective_bytes == ref == 512.0


# -- model_flops and active_param_count ---------------------------------------

@pytest.mark.parametrize("arch", configs.list_archs())
def test_model_flops_equal_the_references(arch):
    cfg, cfg_j = configs.get_arch(arch), jax_configs.get_arch(arch)
    assert RA.active_param_count(cfg) == jax_RA.active_param_count(cfg_j)
    assert [s.name for s in SHAPES] == [s.name for s in JAX_SHAPES]
    for shape, shape_j in zip(SHAPES, JAX_SHAPES):
        assert RA.model_flops(cfg, shape) == jax_RA.model_flops(cfg_j,
                                                                shape_j)


# -- the count ----------------------------------------------------------------

def test_a_meta_call_is_counted_and_launches_nothing():
    """``mm`` on meta tensors takes its card path up to the launch: its
    regime, tile and split plan, an output on meta, the launch counted in
    the open count (not in ``build.LAUNCHES``), with 2 m n k FLOPs and the
    bytes of its operands, output and split-K workspace."""
    before = dict(build.LAUNCHES)
    a, b = meta(64, 256, dtype=torch.bfloat16), meta(256, 512,
                                                     dtype=torch.bfloat16)
    with counting(live=(a, b)) as c:
        out = mm(a, b)
    assert out.shape == (64, 512) and out.is_meta
    assert build.LAUNCHES == before
    assert c.launches == {"matmul": 1}
    assert c.kernel_flops["matmul"] == 2.0 * 64 * 256 * 512
    from repro_torch.kernels.matmul import ops
    splits, _ = ops.split_plan(64, 512, 256,
                               ops.default_tile(64, 256, 512, torch.bfloat16))
    ws = 4 * splits * 64 * 512 if splits > 1 else 0
    assert c.kernel_bytes["matmul"] == 2 * (64 * 256 + 256 * 512
                                            + 64 * 512) + ws
    assert c.op_flops == 0.0
    # a, b, the output and the workspace (freed inside the call) at once.
    assert c.peak_bytes == 2 * (64 * 256 + 256 * 512 + 64 * 512) + ws


def test_meta_and_real_tensors_do_not_mix():
    with pytest.raises(ValueError):
        mm(meta(4, 8), torch.zeros(8, 4))
    # CPU tensors still take the plain version, uncounted.
    with counting() as c:
        out = mm(torch.ones(4, 8), torch.ones(8, 4))
    assert torch.equal(out, torch.full((4, 4), 8.0))
    assert c.launches == {}


def test_torch_ops_views_and_live_bytes():
    """Products by FlopCounterMode's formulas, elementwise ops one FLOP an
    element (exp none, as XLA counts it apart), views and factories
    nothing; a storage is live until its last view is freed."""
    x = meta(32, 64)
    with counting(live=x) as c:
        y = x @ meta(64, 16)              # 2 * 32 * 64 * 16, a temporary
        z = (y + 1.0).exp()               # 512 + 0
        v = z.view(16, 32).t()            # a view: nothing
        del y
        w = v.sum()                       # 512
    assert c.op_flops == 2 * 32 * 64 * 16 + 512 + 512
    assert c.kernel_flops == {}
    # x (8192 B), the weight (4096) and y (2048) while the product runs;
    # the weight is freed with it, so y, y + 1 and z (6144) stay below.
    assert c.peak_bytes == 8192 + 4096 + 2048
    assert w.shape == ()
    assert c.live_bytes <= c.peak_bytes


def test_counts_do_not_nest():
    with counting():
        with pytest.raises(RuntimeError):
            with counting():
                pass
