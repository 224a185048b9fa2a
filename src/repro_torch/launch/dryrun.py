"""Multi-pod dry run: count every (arch x shape x mesh) cell — the port's
``repro/launch/dryrun.py``.

For each cell this module builds abstract parameters, optimizer state and
inputs (``meta`` tensors: shapes and dtypes, nothing allocated), starts a
fake process group of the production mesh's ranks (256 single pod, 512
multi-pod) and builds ``launch/mesh.py``'s mesh over it, then runs rank
0's train or serve step (the port's own ``make_train_step`` /
``make_serve_steps``) on those tensors under a count
(``roofline/count.py``): kernel launches, FLOPs, bytes, collectives and
the peak of live bytes, as the reference reads them from XLA's
``memory_analysis`` and ``cost_analysis`` of the compiled step. Nothing
touches a card. Results go to ``build/dryrun_results/<cell>.json``;
existing results are skipped unless --force.

The reference's probes exist because XLA counts a while-loop body once;
the port counts every layer as it runs, so :func:`exact_cost_terms` counts
the full depth directly (:func:`probe_cost_terms` is the reference's
method, kept to check the count against itself).

Each rank holds its blocks (``api.rank_shardings``: attention heads, FF
columns, experts, RG-LRU features, SSD heads and vocabulary over the model
axis, and with FSDP, on by default as the reference's is, every decoder
leaf's block over the data axis) and computes the layers on them for its
batch rows (``models/context.py``), gathering each layer over the data
group as it runs, so the counts are the port's per rank, the model-axis
sums and the data axis's gathers and reduce-scatters among the
collectives.
``--no-fsdp`` counts the model split alone. ``memory.param_bytes_sharded``
gives what the reference's shardings (``sharding_rules.param_shardings``)
leave a rank, paired with the parameters by key.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, applicable, get_shape
from repro_torch.core.hardware import PRODUCTION_TARGET
from repro_torch.distributed import sharding_rules as rules
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import api, flags
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.count import Count, counting
from repro_torch.train.step import make_serve_steps, make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_results"

OPT_CFG = adamw.AdamWConfig(moment_dtype="bfloat16")  # 235B @256 chips needs it

CARRY_BUDGET = 2 * 2**30  # target bytes for the layer-boundary carries a rank


def choose_microbatches(cfg, shape, mesh) -> int:
    """Split the per-rank batch so layer-boundary carries fit the budget."""
    if shape.kind != "train":
        return 1
    dp = 1
    for ax in rules.batch_axes_for(mesh):
        dp *= mesh.shape[ax]
    per_dev = max(1, shape.global_batch // dp)
    per_seq = shape.seq_len * cfg.d_model * 2 * max(cfg.n_layers, 1)
    if cfg.encoder is not None and cfg.encoder.kind == "audio":
        per_seq += cfg.encoder.seq_len * cfg.d_model * 2 * cfg.encoder.n_layers
    need = (per_dev * per_seq + CARRY_BUDGET - 1) // CARRY_BUDGET
    mb = 1
    while mb < need and mb < per_dev:
        mb *= 2
    return mb


@contextlib.contextmanager
def fake_group(world_size: int):
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (PyTorch's ``fake`` backend: collectives return at once, nothing
    moves); destroyed on exit, so cells can be counted one after another."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised here")
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def cell_mesh(multi_pod: Optional[bool] = None, local: Tuple[int, int] = ()):
    """The mesh a cell is counted on, inside its fake group: the production
    mesh (``multi_pod`` True or False), or a ``local`` (data, model) one."""
    shape = (local if local else
             (2, 16, 16) if multi_pod else (16, 16))
    n = 1
    for s in shape:
        n *= s
    with fake_group(n):
        if local:
            yield make_local_mesh(*local, device="cpu")
        else:
            yield make_production_mesh(multi_pod=bool(multi_pod),
                                       device="cpu")


def _rank_rows(x: torch.Tensor, ctx) -> torch.Tensor:
    """Rank 0's rows of a global batch array: its block over the batch
    axes, or every row of a batch the axes do not split (the reference
    replicates a batch of one)."""
    n = ctx.axis_size("batch")
    if x.shape[0] % n:
        return x
    return rules.local_rows(x, ctx)


def _storage_bytes(tree: Any) -> int:
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total


def _compile_step(cfg, shape, mesh, microbatches: int = 1,
                  dtype=torch.bfloat16, opt_cfg=OPT_CFG, fsdp: bool = True
                  ) -> Tuple[Count, Dict[str, int]]:
    """Build rank 0's step of the cell on its blocks and count it (the
    reference lowers and compiles it). ``dtype`` and ``opt_cfg``: the
    parameters' and AdamW's (the production cells' bf16 by default);
    ``fsdp``: the blocks over the data axis too (``make_context``).
    Returns (count, {"argument_bytes", "output_bytes"})."""
    ctx = rules.make_context(mesh, fsdp=fsdp)
    params = S.abstract_params(cfg, dtype, ctx=ctx)
    if shape.kind == "train":
        opt = S.abstract_opt_state(params, opt_cfg)
        batch = {k: _rank_rows(v, ctx)
                 for k, v in S.input_specs(cfg, shape).items()}
        # Huge models (235B-class) accumulate microbatch grads in bf16 to
        # keep the f32 accumulation buffer off the HBM budget (the
        # reference's rule, on the whole model's bytes).
        params_bytes = _storage_bytes(S.abstract_params(cfg, dtype))
        accum = (torch.bfloat16 if params_bytes / 256 > 2**30
                 else torch.float32)
        step = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                               accum_dtype=accum, ctx=ctx)
        args = (params, opt, batch)
        with counting(live=args) as count:
            out = step(*args)
    elif shape.kind == "prefill":
        batch = {k: _rank_rows(v, ctx)
                 for k, v in S.input_specs(cfg, shape).items()}
        batch.pop("targets", None)
        prefill_step, _ = make_serve_steps(cfg, ctx, max_len=shape.seq_len,
                                           dtype=dtype)
        args = (params, batch)
        with counting(live=args) as count:
            out = prefill_step(*args)
    else:  # decode
        tok = _rank_rows(S.decode_token_spec(cfg, shape), ctx)
        state = S.abstract_serve_state(cfg, shape, dtype, params=params,
                                       batch=tok.shape[0], ctx=ctx)
        _, decode_step = make_serve_steps(cfg, ctx, max_len=shape.seq_len,
                                          dtype=dtype)
        args = (params, tok, state)
        with counting(live=args) as count:
            out = decode_step(*args)
    arg = _storage_bytes(args)
    sizes = {"argument_bytes": arg,
             "output_bytes": max(0, _storage_bytes((args, out)) - arg)}
    return count, sizes


# ---------------------------------------------------------------------------
# Cost terms. The port counts each layer as it runs, so the full depth is
# counted directly; the reference's per-layer differencing of probe configs
# is kept (probe_cost_terms) to hold the count against itself.
# ---------------------------------------------------------------------------

def _distinct_specs(cfg) -> List[Tuple[Any, int]]:
    counts: Dict[Any, int] = {}
    order = []
    for spec in cfg.layers():
        if spec not in counts:
            order.append(spec)
        counts[spec] = counts.get(spec, 0) + 1
    return [(s, counts[s]) for s in order]


def _probe_cfg(cfg, pattern, enc_layers: Optional[int] = None):
    kw = dict(n_layers=len(pattern), layer_pattern=tuple(pattern))
    if enc_layers is not None and cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=enc_layers)
    return dataclasses.replace(cfg, **kw)


def _terms_of(cfg, shape, mesh, fsdp: bool = True
              ) -> Tuple[float, float, float]:
    count, _ = _compile_step(cfg, shape, mesh, fsdp=fsdp)
    return count.totals()


def exact_cost_terms(cfg, shape, mesh, fsdp: bool = True
                     ) -> Dict[str, float]:
    """FLOPs, HBM bytes and collective bytes of one rank's step, counted
    at full depth."""
    f, b, c = _terms_of(cfg, shape, mesh, fsdp)
    return {"flops": f, "hbm_bytes": b, "collective_bytes": c}


def probe_cost_terms(cfg, shape, mesh) -> Dict[str, float]:
    """The reference's ``exact_cost_terms``: one probe with a layer of each
    distinct spec, one more with an extra layer of each repeated spec (and
    an extra encoder layer), the differences extrapolated to full depth."""
    distinct = _distinct_specs(cfg)
    base_pattern = [s for s, _ in distinct]
    enc_probe = (cfg.encoder is not None and cfg.encoder.kind == "audio"
                 and shape.kind != "decode")
    base_enc = 1 if enc_probe else None

    base = _terms_of(_probe_cfg(cfg, base_pattern, base_enc), shape, mesh)
    total = list(base)
    for spec, count in distinct:
        if count == 1:
            continue
        plus = _terms_of(
            _probe_cfg(cfg, base_pattern + [spec], base_enc), shape, mesh)
        for j in range(3):
            total[j] += (count - 1) * (plus[j] - base[j])
    if enc_probe and cfg.encoder.n_layers > 1:
        plus = _terms_of(_probe_cfg(cfg, base_pattern, 2), shape, mesh)
        for j in range(3):
            total[j] += (cfg.encoder.n_layers - 1) * (plus[j] - base[j])
    return {"flops": total[0], "hbm_bytes": total[1],
            "collective_bytes": total[2]}


def param_bytes_sharded(cfg, mesh, fsdp: bool = True) -> int:
    """Bytes of bf16 parameters a rank would hold under the reference's
    shardings (``sharding_rules.param_shardings``, FSDP on), each leaf's
    sharding paired with it by key (``init_tree`` sorts a dict's keys,
    the shardings keep the definitions' order)."""
    params = S.abstract_params(cfg, torch.bfloat16)
    shards = rules.param_shardings(api.param_logical_axes(cfg), params, mesh,
                                   fsdp=fsdp)

    def nbytes(t, sh):
        n = 1
        for d in sh.shard_shape(tuple(t.shape)):
            n *= d
        return n * t.element_size()

    return sum(tree_leaves(rules._map2(nbytes, params, shards)))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               fsdp: bool = True, remat: bool = True,
               extra_tag: str = "") -> Dict[str, Any]:
    cfg = configs.get_arch(arch)
    shape = get_shape(shape_name)
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": why}

    with cell_mesh(multi_pod) as mesh:
        n_chips = dist.get_world_size()
        mb = choose_microbatches(cfg, shape, mesh)

        # Phase A: the full-depth step at its microbatches: the memory
        # picture (and, at one microbatch, the terms too).
        t0 = time.time()
        count, sizes = _compile_step(cfg, shape, mesh, microbatches=mb,
                                     fsdp=fsdp)
        t_compile = time.time() - t0
        hw = PRODUCTION_TARGET

        # Phase B: the cost terms of the full depth at one microbatch (the
        # reference's probes compile at one).
        t0 = time.time()
        if mb == 1:
            exact = dict(zip(("flops", "hbm_bytes", "collective_bytes"),
                             count.totals()))
        else:
            exact = exact_cost_terms(cfg, shape, mesh, fsdp)
        t_probe = time.time() - t0
        sharded = param_bytes_sharded(cfg, mesh, fsdp=fsdp)
    terms = RA.terms(exact["flops"], exact["hbm_bytes"],
                     exact["collective_bytes"], hw)
    mf = RA.model_flops(cfg, shape)
    peak = int(count.peak_bytes)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "status": "ok",
        "n_chips": int(n_chips),
        "microbatches": mb,
        "compile_s": round(t_compile, 1),
        "probe_s": round(t_probe, 1),
        "memory": {
            "argument_bytes": int(sizes["argument_bytes"]),
            "output_bytes": int(sizes["output_bytes"]),
            "temp_bytes": peak - int(sizes["argument_bytes"]),
            "peak_bytes": peak,
            "param_bytes_sharded": int(sharded),
            "hbm_per_chip": hw.hbm_bytes,
            "fits": bool(peak < hw.hbm_bytes),
        },
        "roofline": {
            "flops_per_chip": terms.flops,
            "hbm_bytes_per_chip": terms.hbm_bytes,
            "collective_bytes_per_chip": terms.collective_bytes,
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "roofline_fraction": terms.roofline_fraction(),
            "model_flops_global": mf,
            "useful_flops_ratio": (
                mf / (terms.flops * n_chips) if terms.flops else 0.0
            ),
        },
        "launches_by_kernel": dict(sorted(count.launches.items())),
    }
    if extra_tag:
        result["tag"] = extra_tag
    return result


def cell_path(arch, shape_name, multi_pod, tag="") -> str:
    mesh = "multi" if multi_pod else "single"
    suffix = f".{tag}" if tag else ""
    return str(RESULTS_DIR / f"{arch}__{shape_name}__{mesh}{suffix}.json")


OPT_PRESETS = {
    "attn_bf16": dict(attn_bf16=True),
    "remat_dots": dict(remat="dots"),
    "decode_sharded": dict(decode_sharded=True),
    "ssd256": dict(ssd_chunk=256),
    "ssd512": dict(ssd_chunk=512),
    "ssd_bf16": dict(ssd_bf16=True),
    "all": dict(attn_bf16=True, remat="dots", decode_sharded=True),
}


def apply_opts(opts: str) -> None:
    flags.set_perf(attn_bf16=False, remat="nothing", ssd_chunk=0,
                   decode_sharded=False)
    for name in [o for o in opts.split(",") if o]:
        flags.set_perf(**OPT_PRESETS[name])


def run_cell(arch, shape_name, multi_pod, force=False, fsdp=True,
             remat=True, tag="", opts="") -> Dict[str, Any]:
    path = cell_path(arch, shape_name, multi_pod, tag)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    apply_opts(opts)
    try:
        res = lower_cell(arch, shape_name, multi_pod, fsdp=fsdp,
                         remat=remat, extra_tag=tag)
    except Exception as e:  # record failures — they are bugs to fix
        res = {"arch": arch, "shape": shape_name,
               "mesh": "multi" if multi_pod else "single",
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


def plan_hit_report(plans, arch: str, shape_name: str,
                    dtype: str = "bfloat16") -> Dict[str, str]:
    """kernel -> resolution source for one roofline cell against a plan.

    Pure plan lookups (nothing counted): the dry run's (arch x shape) cell
    maps to kernel problems via ``specs.cell_problems`` — the same mapping
    ``compile_plans`` sweeps — so this reports how well the artifact covers
    the roofline table. Sources: exact | nearest_shape | cross_hardware |
    fallback (plan had nothing usable).
    """
    import warnings

    from repro_torch import kernels as kernel_pkg
    from repro_torch.core.plans import PlanTransferWarning

    kernel_pkg.register_all()
    cfg = configs.get_arch(arch)
    shape = get_shape(shape_name)
    ok, _ = applicable(cfg, shape)
    if not ok:
        return {}
    sources = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PlanTransferWarning)
        for kernel, problem in S.cell_problems(cfg, shape).items():
            res = plans.resolve(kernel, problem, dtype, PRODUCTION_TARGET)
            sources[kernel] = res.source if res is not None else "fallback"
    return sources


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", default="",
                    help="comma list of OPT_PRESETS (perf hillclimb runs)")
    ap.add_argument("--tile-plans", default=None,
                    help="compiled TilePlan artifact; reports per-cell plan "
                         "hit-rate alongside the roofline results")
    ap.add_argument("--plan-dtype", default="bfloat16",
                    help="dtype key for the --tile-plans hit-rate lookups "
                         "(the dry run itself counts bfloat16)")
    args = ap.parse_args(argv)
    if args.opt and not args.tag:
        args.tag = args.opt.replace(",", "+")

    from repro_torch.core.plans import TilePlan
    plans = TilePlan.load_or_none(args.tile_plans)

    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod or not args.single_pod:
        meshes.append(True)

    archs = configs.list_archs() if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all or not args.shape \
        else [args.shape]

    plan_sources: List[Tuple[str, str]] = []   # (shape kind, source)
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                res = run_cell(arch, shape_name, mp, force=args.force,
                               fsdp=not args.no_fsdp, tag=args.tag,
                               opts=args.opt)
                status = res["status"]
                line = f"{arch:24s} {shape_name:12s} {res['mesh']:6s} {status}"
                if status == "ok":
                    r = res["roofline"]
                    line += (
                        f"  count={res['compile_s']}s"
                        f"  peak={res['memory']['peak_bytes']/2**30:.2f}GiB"
                        f"  dom={r['dominant']}"
                        f"  frac={r['roofline_fraction']:.2f}"
                    )
                elif status == "error":
                    line += f"  {res['error'][:120]}"
                if plans is not None and not mp:
                    sources = plan_hit_report(plans, arch, shape_name,
                                              args.plan_dtype)
                    if sources:
                        kind = get_shape(shape_name).kind
                        plan_sources.extend(
                            (kind, s) for s in sources.values())
                        line += "  plan=" + ",".join(
                            f"{k}:{s}" for k, s in sorted(sources.items()))
                print(line, flush=True)
    if plans is not None and plan_sources:
        # Decode cells sweep their own kernel (flash_decode) with its own
        # sensitivity curve; report its coverage separately from the
        # full-sequence (train/prefill) cells.
        def _rate(label: str, pool: List[Tuple[str, str]]) -> None:
            if not pool:
                return
            srcs = [s for _, s in pool]
            hits = sum(s == "exact" for s in srcs)
            print(f"tile-plan hit-rate [{label}] ({args.plan_dtype}, "
                  f"{PRODUCTION_TARGET.name}): "
                  f"{hits}/{len(srcs)} exact ({hits / len(srcs):.2f}); "
                  f"sources: { {s: srcs.count(s) for s in sorted(set(srcs))} }",
                  flush=True)

        _rate("all", plan_sources)
        _rate("decode", [p for p in plan_sources if p[0] == "decode"])
        _rate("prefill+train", [p for p in plan_sources if p[0] != "decode"])


if __name__ == "__main__":
    main()
