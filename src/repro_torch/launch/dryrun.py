"""Multi-pod dry-run: every (arch × input shape × production mesh) step
traced on fake tensors over a fake process group, with no allocation and
no card.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each step for 256 or 512 host devices. Here the process
starts a ``"fake"`` process group of 256 ranks (512 with
``--multi-pod``) and builds the production mesh over it; under
``FakeTensorMode`` it places the parameters (and moments, batch and
cache) by the LM specs and runs the real step on them: ``train_step``
with TPGF for ``train_*``, ``prefill_step`` for ``prefill_*``,
``serve_step`` for ``decode_*`` / ``long_*``. The step runs on rank 0's
shards: its DTensor redistributions dispatch their collectives (which the
fake group answers at once), its regions their local operations. Each
record holds:

  - ``n_params``, ``n_active_params``, ``model_flops`` (6·N·D / 2·N·D);
  - ``arg_bytes_per_chip``: the rank's shards of the params, moments,
    batch and cache (the reference's ``argument_size_in_bytes``);
  - ``flops_per_chip`` (``count_flops`` over the rank's local operations,
    backward included), ``flops`` (times the chips) and
    ``useful_flops_ratio`` (``model_flops / flops``);
  - ``collectives``: the rank's wire bytes and calls by kind
    (``roofline.collective_bytes``);
  - ``peak_step_bytes_per_chip``: the most the step holds at once
    beyond its arguments (activations, temporaries, gradients and new
    moments), by ``torch.distributed._tools.mem_tracker.MemTracker``
    over the rank's local tensors (the reference's
    ``temp_size_in_bytes``), by kind;
  - the roofline terms on the H100's ``HW``: compute at the config's
    dtype's peak, memory as ``arg_bytes_per_chip`` read once (a lower
    bound: activations are not counted), collective at NVLink's rate.

Kernels stay off
(``use_pallas=False``), as in the reference's dry-run. Results append
to a JSONL ledger; combos already there are skipped, so a sweep
resumes. Usage:

  python -m repro_torch.launch.dryrun --arch llama3_2_3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--out results/dryrun_torch.jsonl]

``init_process_group("fake")`` changes the default process group of
the process that calls it: run the dry-run in a process of its own.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time
import traceback

import torch


def _nbytes(tree) -> int:
    from repro_torch.launch.sharding import is_dtensor
    from repro_torch.tree import tree_leaves
    return sum(x.to_local().numel() * x.element_size()
               for x in tree_leaves(tree) if is_dtensor(x))


def _start_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process (this is
    rank 0), replacing any group it had."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_one(arch: str, shape_name, *, multi_pod: bool = False,
            config_overrides=None, verbose: bool = True,
            mesh_shape=None, reduced: bool = False):
    """One combo's record (a ``skipped`` record for a skipped combo).
    ``shape_name`` may be an ``InputShape`` of its own; ``mesh_shape``
    (``(data, model)``) and ``reduced`` (the arch's reduced config) size
    a small run, as the tests make one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch import roofline as RA
    from repro_torch.configs import base
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.models.model import torch_dtype

    cfg = (base.get_reduced(arch) if reduced else base.get_config(arch)
           ).replace(use_pallas=False)
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    shape = shape_name if isinstance(shape_name, base.InputShape) \
        else base.INPUT_SHAPES[shape_name]
    shape_name = shape.name
    mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape else
                 "2x16x16" if multi_pod else "16x16")
    reason = base.skip_reason(arch, shape_name) \
        if shape_name in base.INPUT_SHAPES else None
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": reason}
    if mesh_shape:
        _start_group(math.prod(mesh_shape))
        mesh = make_test_mesh(tuple(mesh_shape), device="cpu")
    else:
        _start_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    chips = mesh.size()
    dp = SH.fsdp_axes(mesh)
    eff_batch = shape.global_batch
    if shape.kind == "train":
        eff_batch //= max(cfg.microbatches, 1)
    if "batch_shard_axes" not in (config_overrides or {}) and \
            eff_batch % SH._axis_size(mesh, dp) == 0:
        cfg = cfg.replace(batch_shard_axes=dp)
    t0 = time.time()

    p_shapes = ST.params_specs(cfg)
    n_params = sum(x.numel() for _, x in SH.tree_flatten_with_path(p_shapes))
    place = SH.distribute_tree
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = place(p_shapes, SH.param_pspecs(cfg, p_shapes, mesh), mesh)
        arg = {"params": _nbytes(params)}
        if shape.kind == "train":
            step, opt = ST.make_train_step(cfg)
            opt_state = opt.init(params)
            b_shapes = ST.batch_specs(cfg, shape)
            batch = place(b_shapes, SH.batch_pspecs(cfg, shape, b_shapes,
                                                     mesh), mesh)
            arg.update(moments=_nbytes(opt_state), batch=_nbytes(batch))
            args = (params, opt_state, batch)
        elif shape.kind == "prefill":
            step = ST.make_prefill_step(cfg)
            b_shapes = {k: v for k, v in ST.batch_specs(cfg, shape).items()
                        if k != "labels"}
            batch = place(b_shapes, SH.batch_pspecs(cfg, shape, b_shapes,
                                                     mesh), mesh)
            arg["batch"] = _nbytes(batch)
            args = (params, batch)
        else:
            step = ST.make_serve_step(cfg)
            c_shapes = ST.cache_specs(cfg, shape)
            cache = place(c_shapes, SH.cache_pspecs(cfg, c_shapes, mesh),
                          mesh)
            cache["idx"] = shape.seq_len // 2
            t_shapes = {"token": ST.token_specs(cfg, shape)}
            token = place(t_shapes, SH.batch_pspecs(cfg, shape, t_shapes,
                                                     mesh), mesh)["token"]
            arg.update(cache=_nbytes(cache), batch=_nbytes({"t": token}))
            args = (params, cache, token)
        arg["total"] = sum(arg.values())
        tracker = MemTracker()
        with tracker:
            coll, (flops, _) = RA.collective_bytes(RA.count_flops, step,
                                                   *args)
        peak = {str(kind.value if hasattr(kind, "value") else kind): n
                for dev in tracker.get_tracker_snapshot("peak").values()
                for kind, n in dev.items()}
    n_active = RA.active_params(cfg, n_params)
    mf = RA.model_flops(cfg, shape, n_params, n_active)
    terms = RA.roofline_terms(flops, arg["total"], torch_dtype(cfg),
                              coll["bytes"]["total"])
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "kind": shape.kind, "n_params": n_params,
           "n_active_params": n_active, "model_flops": mf,
           "flops_per_chip": flops, "flops": flops * chips,
           "useful_flops_ratio": mf / (flops * chips) if flops else 0.0,
           "arg_bytes_per_chip": arg,
           "peak_step_bytes_per_chip": peak,
           "collectives": coll,
           "collective_wire_bytes_per_chip": coll["bytes"]["total"],
           "t_compute_s": terms["t_compute_s"],
           "t_memory_s": terms["t_memory_s"],
           "t_collective_s": terms["t_collective_s"],
           "dominant": terms["dominant"],
           "trace_s": round(time.time() - t0, 1)}
    if verbose:
        print(f"[dryrun] {arch:16s} {shape_name:12s} {mesh_name:8s} "
              f"flops/chip={flops:.3e} args/chip={arg['total']:.3e}B "
              f"wire/chip={coll['bytes']['total']:.3e}B "
              f"dom={terms['dominant']} t={rec['trace_s']}s", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    from repro_torch.configs import base

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r.get("mesh", "")))
                except (ValueError, KeyError):
                    pass
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    if args.all:
        combos = [(a, s, mp) for a in base.ARCH_IDS
                  for s in base.INPUT_SHAPES for mp in meshes]
    else:
        combos = [(args.arch, args.shape, mp) for mp in meshes]
    # one mesh size after the other: the fake group is made once for each
    combos.sort(key=lambda c: c[2])
    for a, s, mp in combos:
        mesh_name = "2x16x16" if mp else "16x16"
        if (a, s, mesh_name) in done:
            print(f"[dryrun] skip (done): {a} {s} {mesh_name}")
            continue
        try:
            rec = run_one(a, s, multi_pod=mp)
        except Exception as e:
            rec = {"arch": a, "shape": s, "mesh": mesh_name,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[dryrun] FAIL {a} {s} {mesh_name}: {e}")
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
