"""Child process for tests/test_torch_lm_mesh.py (not collected by
pytest). It imports torch, numpy and the port only.

    python tests/_torch_lm_mesh_child.py <workdir> <ranks>:<case>[,<case>...]...

runs each group of cases, one group after the other. ``4`` spawns four
gloo ranks on the CPU (``torch.multiprocessing``), which meet on a
``file://`` store in ``<workdir>/ranks4/`` and build
``make_test_mesh((2, 2))``, each on one torch thread, each process group
with a 120 s timeout; ``1`` runs in this process, on the one-rank group
that ``make_test_mesh((1, 1))`` makes itself. Rank 0 writes each case's
results to ``<workdir>/ranks<ranks>/<case>.npz``.

The cases read ``<workdir>/spec.json`` (each case's arch, config
overrides, optimizer and step counts) and ``<workdir>/<arch>.npz`` (the
reference's weights, ``w/<path>``, and the inputs, ``b/<name>``), both
written by the parent:

  prefill_<arch>  the prefill of ``b/tokens`` (and ``b/patches`` or
                  ``b/frames``): its logits and every cache entry,
                  gathered
  decode_<arch>   the prefill of ``b/prompt``, then one decode step per
                  column of ``b/next``: each step's logits, the last cache
  train_<arch>    ``steps`` train steps on ``b/train_tokens`` and
                  ``b/train_labels`` (one [B, S] slice a step): each
                  step's metrics, the final parameters gathered
  init            the sharded ``init_params`` of seed 0 against the
                  meshless one, per arch: the largest difference
  refusal         a mesh of CUDA tensors over the gloo group: the error
  mesh11_<arch>   (one rank) prefill, decode and two train steps on a
                  (1, 1) mesh against the meshless run from the same
                  weights: the largest difference of each (0.0: bit for
                  bit)
"""
import datetime
import json
import logging
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

TIMEOUT = datetime.timedelta(seconds=120)
INIT_ARCHS = ("llama3_2_3b", "mixtral_8x7b", "mamba2_2_7b", "whisper_small")


def _spec(workdir):
    with open(os.path.join(workdir, "spec.json")) as f:
        return json.load(f)


def _inputs(workdir, arch):
    data = np.load(os.path.join(workdir, f"{arch}.npz"))
    weights, batch = {}, {}
    for k in data.files:
        kind, path = k.split("/", 1)
        if kind == "w":
            node = weights
            parts = path.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[k]
        else:
            batch[path] = data[k]
    return weights, batch


def _cfg(spec):
    from repro_torch.configs import base
    return base.get_reduced(spec["arch"]).replace(**spec.get("cfg", {}))


def _np(x):
    from repro_torch.launch.sharding import is_dtensor
    if is_dtensor(x):
        x = x.full_tensor()
    return x.detach().float().cpu().numpy().copy()


def _t(batch, keys):
    return {k: torch.as_tensor(batch[k]) for k in keys if k in batch}


def _prefill(cfg, params, batch, budget):
    from repro_torch.models import decode as D
    keys = ("tokens", "patches", "frames")
    with torch.no_grad():
        return D.prefill(cfg, params, _t(batch, keys), decode_budget=budget)


def _serve(cfg, params, batch, budget, decode):
    """{name: array}: the prefill's logits and cache, then with
    ``decode`` each decode step's logits and the last cache."""
    from repro_torch.models import decode as D
    out = {}
    b = dict(batch)
    if decode:
        b = {"tokens": batch["prompt"]}
    logits, cache = _prefill(cfg, params, b, budget)
    out["logits"] = _np(logits)
    for k, v in cache.items():
        if k != "idx":
            out[f"cache/{k}"] = _np(v)
    if decode:
        with torch.no_grad():
            for t in range(batch["next"].shape[1]):
                lg, cache = D.decode_step(cfg, params, cache, torch.as_tensor(
                    batch["next"][:, t:t + 1]))
                out[f"step{t}"] = _np(lg)
        for k, v in cache.items():
            if k != "idx":
                out[f"final/{k}"] = _np(v)
    return out


def _train(cfg, params, batch, spec):
    from repro_torch import optim as TO
    from repro_torch.launch import steps as ST
    from repro_torch.tree import tree_flatten_with_path
    opt = (TO.adamw(1e-3, weight_decay=0.1) if spec["opt"] == "adamw"
           else TO.sgd(0.1))
    step, _ = ST.make_train_step(cfg, opt)
    state = opt.init(params)
    out = {}
    for i in range(spec["steps"]):
        b = {"tokens": torch.as_tensor(batch["train_tokens"][i]),
             "labels": torch.as_tensor(batch["train_labels"][i])}
        params, state, m = step(params, state, b)
        for k, v in m.items():
            out[f"metric{i}/{k}"] = np.float32(float(v))
    for path, x in tree_flatten_with_path(params):
        out["param/" + "/".join(path)] = _np(x)
    return out


def run_case(case, workdir, mesh):
    from repro_torch import bridge
    spec = _spec(workdir)
    if case == "init":
        from repro_torch.configs import base
        from repro_torch.models import model as M
        from repro_torch.tree import tree_flatten_with_path
        out = {}
        for arch in INIT_ARCHS:
            cfg = base.get_reduced(arch)
            want = dict(tree_flatten_with_path(M.init_params(
                cfg, torch.Generator().manual_seed(0), device="cpu")))
            got = M.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu", mesh=mesh)
            out[arch] = np.float32(max(
                float((x.full_tensor() - want[p]).abs().max())
                for p, x in tree_flatten_with_path(got)))
        return out
    if case == "refusal":
        from repro_torch.launch.mesh import make_test_mesh
        try:
            make_test_mesh((2, 2), device="cuda")
        except ValueError as e:
            return {"error": np.array(str(e))}
        return {"error": np.array("")}
    kind, arch = case.split("_", 1)
    s = spec[case if kind != "mesh11" else f"train_{arch}"]
    weights, batch = _inputs(workdir, arch)
    if kind == "mesh11":
        return _mesh11(spec, weights, batch, arch, mesh)
    cfg = _cfg(s)
    params = bridge.to_model_params(cfg, weights, device="cpu", mesh=mesh)
    if kind == "train":
        return _train(cfg, params, batch, s)
    return _serve(cfg, params, batch, s["budget"], kind == "decode")


def _mesh11(spec, weights, batch, arch, mesh):
    """The (1, 1) mesh against the meshless run: the largest difference
    of the prefill, decode and train results."""
    from repro_torch import bridge
    out = {}
    s = spec[f"decode_{arch}"]
    cfg = _cfg(s)
    runs = [_serve(cfg, bridge.to_model_params(cfg, weights, device="cpu",
                                               mesh=m), batch, s["budget"],
                   True) for m in (mesh, None)]
    out["serve"] = np.float32(max(float(np.abs(runs[0][k] - runs[1][k])
                                        .max()) for k in runs[1]))
    s = spec[f"train_{arch}"]
    cfg = _cfg(s)
    runs = [_train(cfg, bridge.to_model_params(cfg, weights, device="cpu",
                                               mesh=m), batch, s)
            for m in (mesh, None)]
    out["train"] = np.float32(max(float(np.abs(runs[0][k] - runs[1][k])
                                        .max()) for k in runs[1]))
    return out


def _save(workdir, ranks, case, res):
    np.savez(os.path.join(workdir, f"ranks{ranks}", f"{case}.npz"), **res)


def _rank(rank, world, workdir, cases):
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/ranks{world}/store",
        world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh((2, 2), device="cpu")
        for case in cases:
            res = run_case(case, workdir, mesh)
            if rank == 0:
                _save(workdir, world, case, res)
    finally:
        dist.destroy_process_group()


def main():
    workdir = sys.argv[1]
    for group in sys.argv[2:]:
        ranks, cases = group.split(":")
        ranks, cases = int(ranks), cases.split(",")
        os.makedirs(os.path.join(workdir, f"ranks{ranks}"), exist_ok=True)
        if ranks == 1:
            torch.set_num_threads(1)
            from repro_torch.launch.mesh import make_test_mesh
            mesh = make_test_mesh((1, 1), device="cpu")
            for case in cases:
                _save(workdir, 1, case, run_case(case, workdir, mesh))
            dist.destroy_process_group()
        else:
            mp.spawn(_rank, args=(ranks, workdir, cases), nprocs=ranks)


if __name__ == "__main__":
    main()
