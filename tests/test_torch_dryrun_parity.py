"""The dry run's FLOPs against the reference's: the port's count of a step
on ``meta`` tensors (``repro_torch/launch/dryrun.py``) beside XLA's
``cost_analysis`` of the same step compiled by the reference's
``dryrun._terms_of``, on a 1 x 1 mesh, at full width:

* qwen2-1.5b cut to 2 layers: train B 2 x S 256, prefill B 2 x S 256 and
  decode B 2 over a 1024-position cache;
* a probe of every other config (a layer of each distinct layer kind, an
  encoder-decoder's encoder at one layer) at prefill B 2 x S 256, the
  serving path all ten share.

The port's count must lie within 2% of the reference's once each term only
one side counts is added back to the port's side. Each term is a named
formula here (and a line in ROADMAP.md §3):

* ``head_every_position``: the reference's prefill applies the head to
  every position and keeps the last; the port's to the last only
  (``api.prefill``): 2 B (S - 1) d Vpad more for a decoder-only model;
* ``attention_skipped_blocks``: the reference's plain attention computes
  every KV chunk and masks; the port's flash-attention kernel skips the
  blocks its causal or window mask hides (``flash_attention.flops``): the
  same formula with the mask off, less it with the mask on, summed over
  the launches;
* ``ssd_plain_scan``: the reference's plain SSD scan at its analysis chunk
  (min(512, S)) computes C B^T once for the heads and every score of a
  chunk; the kernel's formula (``ssd/ops.py:flops``) counts causal pairs
  per head at its own chunk;
* ``cpu_weight_converts``: compiled for the CPU, the reference's bf16
  dots read their weights through converts to float32, which XLA counts
  one FLOP an element: the embedding twice (the lookup's fusion and the
  head), every other weight four times (the stacked weights and each
  layer's slice, to float32, to bf16 and back). The card reads bf16
  directly; this is 39% of the reference's decode count, where the
  weights are read once.

Bytes are not held: XLA counts fused HLO, the port eager ops.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.configs.shapes import ShapeSpec as JaxShapeSpec  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

RTOL = 0.02
KINDS = {"train": (256, 2), "prefill": (256, 2), "decode": (1024, 2)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_dryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS to 512
    host devices; this process's backend is started first, so the flag
    cannot reach it, and the variable is restored, so it reaches no later
    test's subprocess either."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jax_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jax_dryrun


def _cut(cfg, n_layers):
    return dataclasses.replace(cfg, n_layers=n_layers,
                               layer_pattern=tuple(cfg.layers()[:n_layers]))


def _probe(cfg):
    return dryrun._probe_cfg(cfg, [s for s, _ in dryrun._distinct_specs(cfg)],
                             1)


# -- the terms only one side counts -------------------------------------------

def head_every_position(cfg, shape) -> float:
    if shape.kind != "prefill" or (cfg.encoder is not None
                                   and cfg.encoder.kind == "audio"):
        return 0.0
    return 2.0 * shape.global_batch * (shape.seq_len - 1) * cfg.d_model \
        * cfg.padded_vocab


def ssd_plain_scan(cfg, shape, count) -> float:
    if cfg.ssm is None or shape.kind == "decode":
        return 0.0
    s, b = shape.seq_len, shape.global_batch
    q = min(512, s)
    h, p, n = cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim, cfg.ssm.d_state
    per_row = (s // q) * (2 * q * q * n + 2 * h * q * q * p + 4 * h * q * n * p)
    return count.launches["ssd"] * b * per_row - count.kernel_flops["ssd"]


def cpu_weight_converts(params) -> float:
    embed = params["embed"].numel()
    rest = sum(t.numel() for t in tree_leaves(params)) - embed
    return 2.0 * embed + 4.0 * rest


def port_count(cfg, shape):
    """The port's count on a 1 x 1 mesh, with the attention kernel's
    FLOPs also taken with its mask off (for attention_skipped_blocks)."""
    unmasked = [0.0]
    flops = fa.flops

    def spy(b, hq, sq, skv, d, tile, causal=True, window=None, q_offset=0):
        unmasked[0] += flops(b, hq, sq, skv, d, tile, causal=False)
        return flops(b, hq, sq, skv, d, tile, causal, window, q_offset)

    fa.flops = spy
    try:
        with dryrun.cell_mesh(local=(1, 1)) as mesh:
            count, _ = dryrun._compile_step(cfg, shape, mesh)
    finally:
        fa.flops = flops
    skipped = unmasked[0] - count.kernel_flops.get("flash_attention", 0.0)
    return count, skipped


CELLS = ([("qwen2-1.5b", kind, 2) for kind in KINDS]
         + [(arch, "prefill", None) for arch in configs.list_archs()
            if arch != "qwen2-1.5b"])


@pytest.mark.parametrize("arch,kind,layers", CELLS,
                         ids=[f"{a}-{k}" for a, k, _ in CELLS])
def test_flops_within_2_percent_of_the_reference(arch, kind, layers):
    seq, batch = KINDS[kind]
    cfg = configs.get_arch(arch)
    cfg_j = jax_configs.get_arch(arch)
    if layers is None:
        cfg, cfg_j = _probe(cfg), reference_dryrun()._probe_cfg(
            cfg_j, [s for s, _ in reference_dryrun()._distinct_specs(cfg_j)],
            1)
    else:
        cfg, cfg_j = _cut(cfg, layers), _cut(cfg_j, layers)
    shape = ShapeSpec("parity", seq, batch, kind)
    want, _, _ = reference_dryrun()._terms_of(
        cfg_j, JaxShapeSpec("parity", seq, batch, kind), make_local_mesh(1, 1))

    count, skipped = port_count(cfg, shape)
    terms = {
        "head_every_position": head_every_position(cfg, shape),
        "attention_skipped_blocks": skipped,
        "ssd_plain_scan": ssd_plain_scan(cfg, shape, count),
        "cpu_weight_converts": cpu_weight_converts(
            S.abstract_params(cfg, torch.bfloat16)),
    }
    got = count.flops + sum(terms.values())
    assert abs(got - want) <= RTOL * want, (count.flops, terms, want)
