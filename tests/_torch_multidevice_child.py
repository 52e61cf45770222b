"""Child process for tests/test_torch_multidevice.py (not collected by
pytest). It imports torch, numpy and the port only.

    python tests/_torch_multidevice_child.py <workdir> <ranks>:<case>[,<case>...]...

runs each group of cases, one group after the other, on a fleet mesh of
``<ranks>`` gloo ranks on the CPU: ``torch.multiprocessing`` spawns the
ranks, which meet on a ``file://`` store in ``<workdir>/ranks<ranks>/``
(no TCP port to collide with another test worker), each on one torch
thread, each process group with a 120 s timeout. With ``<ranks>`` 1 the
cases run in this process, on the one-rank group that
``make_fleet_mesh(1)`` makes itself.

The engines start from the weights the parent wrote to
``<workdir>/weights_<n>.npz`` (the reference's, for ``n`` clients) where
they exist, else from the port's own seeded init. Rank 0 writes each
case's results to ``<workdir>/ranks<ranks>/<case>.npz`` (the sanitizer's
trip: every rank to ``trip_rank<r>.npz`` there); the parent compares
them.

Cases:

  parity_<strategy>  two rounds at ``availability=0.7, sample_frac=0.8``,
                     13 clients: losses, ``comm_mb``, params, the heads
                     gathered, ``opt_state``, after every round the
                     largest drift of the replicated state between ranks,
                     and the accuracy of the global head and of the local
                     ensemble
  width              the same for ``ssfl`` on the width ladder (0.5, 1.0),
                     fused
  frozen[_width]     ``ssfl``/``adamw``, 8 clients: one round, then one at
                     availability 0: the global head and ``opt_state``
                     before and after it
  resume[_width]     ``ssfl``/``adamw`` at lr 0.01, 8 clients: two rounds
                     against one + ``save`` + ``restore`` into a fresh mesh
                     engine + one; the checkpoint stays in ``<workdir>``
  storage            the rows of ``client_stack`` and ``local_heads`` each
                     rank holds (13 clients)
  extent1            a mesh of extent 1 against the meshless engine, for
                     ``ssfl`` and ``sfl``, two rounds each
  sanitize           two healthy sanitized rounds on the mesh against the
                     meshless engine, then NaN written into client 3's
                     images: every rank records what it raised and the
                     seconds from the round's start to the raise, and
                     rank 0 the meshless engine's trip
"""
import datetime
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

SMALL = dict(n_layers=3, d_model=24, n_heads=2, n_kv_heads=2, head_dim=12,
             d_ff=48, image_size=16, n_classes=6)
ARGS = dict(seed=0, lr=0.3, local_steps=2, batch_size=4)
PARITY = dict(availability=0.7, sample_frac=0.8)
LADDER = (0.5, 1.0)
N_PARITY, N_INVARIANT = 13, 8
ROUNDS = 2
TIMEOUT = datetime.timedelta(seconds=120)


def cfg():
    from repro_torch.configs import base
    return base.get_reduced("vit16_cifar").replace(**SMALL)


def flat(tree, prefix):
    from repro_torch.tree import tree_flatten_with_path
    out = {}
    for path, x in tree_flatten_with_path(tree):
        x = x.detach().cpu()
        out["/".join([prefix, *map(str, path)])] = x.numpy().copy()
    return out


def weights(workdir, n):
    """The parent's (params, stacked heads) for ``n`` clients, or None."""
    from repro_torch.tree import tree_unflatten
    path = os.path.join(os.path.dirname(workdir), f"weights_{n}.npz")
    if not os.path.exists(path):
        return None
    trees = {"params": ([], []), "heads": ([], [])}
    with np.load(path) as data:
        for key in data.files:
            root, *rest = key.split("/")
            trees[root][0].append(tuple(rest))
            trees[root][1].append(data[key])
    return tuple(tree_unflatten(*trees[k]) for k in ("params", "heads"))


def engine(workdir, strategy, n, mesh=None, **kw):
    from repro_torch import bridge
    from repro_torch.federated import Engine
    eng = Engine(cfg(), n, strategy, device="cpu", mesh=mesh,
                 **dict(ARGS, **kw))
    w = weights(workdir, n)
    if w is not None:
        bridge.install_weights(eng, *w)
    return eng


def replicated(eng):
    return (eng.state.params, eng.state.opt_state)


def state_arrays(eng, mesh):
    from repro_torch.launch import sharding as SH
    heads = SH.fleet_gather(eng.state.local_heads, eng.state.n_clients,
                            mesh)
    return {**flat(eng.state.params, "params"), **flat(heads, "heads"),
            **flat(eng.state.opt_state, "opt")}


def save(workdir, name, rank, **arrays):
    if rank == 0:
        np.savez(os.path.join(workdir, f"{name}.npz"), **arrays)


def rounds(eng, mesh):
    """``ROUNDS`` rounds: their records and, after each, the largest drift
    of the replicated state between the ranks."""
    from repro_torch.launch import sharding as SH
    recs, drift = [], []
    for _ in range(ROUNDS):
        recs.append(eng.run_round())
        drift.append(SH.replicated_drift(replicated(eng), mesh))
    return recs, drift


# ------------------------------------------------------------------- cases

def parity(workdir, mesh, rank, strategy, name=None, **kw):
    eng = engine(workdir, strategy, N_PARITY, mesh, **PARITY, **kw)
    recs, drift = rounds(eng, mesh)
    acc = [eng.evaluate(head=h) for h in ("global", "local")]
    save(workdir, name or f"parity_{strategy}", rank,
         loss=[r["loss"] for r in recs], comm_mb=[r["comm_mb"] for r in recs],
         drift=drift, fleet_shards=eng.fleet_shards, accuracy=acc,
         **state_arrays(eng, mesh))


def frozen(workdir, mesh, rank, **kw):
    from repro_torch.core.fault import AvailabilityModel
    eng = engine(workdir, "ssfl", N_INVARIANT, mesh, optimizer="adamw",
                 lr=0.05, **kw)
    eng.run_round()   # nonzero server moments
    before = {**flat(eng.state.params, "params"),
              **flat(eng.state.opt_state, "opt")}
    eng.avail_model = AvailabilityModel(0.0)
    eng.run_round()
    after = {**flat(eng.state.params, "params"),
             **flat(eng.state.opt_state, "opt")}
    save(workdir, "frozen" + ("_width" if kw else ""), rank,
         **{f"before/{k}": v for k, v in before.items()},
         **{f"after/{k}": v for k, v in after.items()})


def resume(workdir, mesh, rank, **kw):
    name = "resume" + ("_width" if kw else "")
    mk = lambda: engine(workdir, "ssfl", N_INVARIANT, mesh, optimizer="adamw",
                        lr=0.01, **PARITY, **kw)
    a = mk()
    a.run_round()
    a.run_round()
    path = os.path.join(workdir, f"ck_{name}")
    b = mk()
    b.run_round()
    b.save(path)
    saved = state_arrays(b, mesh)
    c = mk()
    c.restore(path)
    round_idx = c.state.round_idx
    c.run_round()
    save(workdir, name, rank, round_idx=round_idx,
         **{f"straight/{k}": v for k, v in state_arrays(a, mesh).items()},
         **{f"resumed/{k}": v for k, v in state_arrays(c, mesh).items()},
         **{f"saved/{k}": v for k, v in saved.items()})


def storage(workdir, mesh, rank):
    """Every rank's leading dims of its workspace and its heads, summed
    into one-hot rows (rank r's counts in column r)."""
    from repro_torch.federated.strategies import base
    from repro_torch.launch import sharding as SH
    from repro_torch.tree import tree_leaves
    eng = engine(workdir, "ssfl", N_PARITY, mesh, **PARITY)
    eng.run_round()
    ws = base.fleet_workspace(eng)
    world = SH.fleet_extent(mesh)
    rows = torch.zeros((3, world), dtype=torch.int64)
    rows[0, rank] = min(x.shape[0] for x in tree_leaves(ws["client_stack"]))
    rows[1, rank] = max(x.shape[0] for x in tree_leaves(ws["client_stack"]))
    rows[2, rank] = {x.shape[0] for x in tree_leaves(eng.state.local_heads)
                     }.pop()
    owner = SH.fleet_owner(N_PARITY, mesh)
    save(workdir, "storage", rank, rows=SH.fleet_sum([rows], mesh)[0].numpy(),
         owner=owner)


def extent1(workdir, mesh, rank):
    arrays = {}
    for strategy in ("ssfl", "sfl"):
        for tag, m in (("mesh", mesh), ("meshless", None)):
            eng = engine(workdir, strategy, N_PARITY, m, **PARITY)
            recs, _ = rounds(eng, m)
            arrays[f"{strategy}/{tag}/loss"] = [r["loss"] for r in recs]
            arrays[f"{strategy}/{tag}/fleet_shards"] = eng.fleet_shards
            for k, v in state_arrays(eng, m).items():
                arrays[f"{strategy}/{tag}/{k}"] = v
    save(workdir, "extent1", rank, **arrays)


def sanitize(workdir, mesh, rank):
    from repro_torch.federated.sanitize import SlotSanitizerError
    shd = engine(workdir, "ssfl", N_INVARIANT, mesh, availability=0.7,
                 sanitize=True)
    rep = engine(workdir, "ssfl", N_INVARIANT, None, availability=0.7)
    loss = [(shd.run_round()["loss"], rep.run_round()["loss"])
            for _ in range(ROUNDS)]
    save(workdir, "sanitize", rank, loss=loss)

    def trip(m):
        eng = engine(workdir, "ssfl", N_INVARIANT, m, local_steps=1,
                     sanitize=True)
        eng.data["clients"][3].images[:] = float("nan")
        cohorts = {d: ids.tolist() for d, ids in
                   eng.state.fleet.cohorts().items()}
        d3 = next(d for d, ids in cohorts.items() if 3 in ids)
        t0 = time.perf_counter()
        try:
            eng.run_round()
        except SlotSanitizerError as e:
            return {"raised": 1, "slots": list(e.slots), "message": str(e),
                    "position": cohorts[d3].index(3),
                    "seconds": time.perf_counter() - t0}
        return {"raised": 0, "slots": [], "message": "", "position": -1,
                "seconds": time.perf_counter() - t0}

    got = trip(mesh)
    np.savez(os.path.join(workdir, f"trip_rank{rank}.npz"), **got)
    if rank == 0:
        want = trip(None)
        np.savez(os.path.join(workdir, "trip_meshless.npz"), **want)


CASES = {"width": lambda w, m, r: parity(w, m, r, "ssfl", "width",
                                         width_tiers=LADDER),
         "frozen": frozen,
         "frozen_width": lambda w, m, r: frozen(w, m, r, width_tiers=LADDER),
         "resume": resume,
         "resume_width": lambda w, m, r: resume(w, m, r, width_tiers=LADDER),
         "storage": storage, "extent1": extent1, "sanitize": sanitize}


def run_case(workdir, mesh, rank, case):
    if case.startswith("parity_"):
        parity(workdir, mesh, rank, case[len("parity_"):])
    else:
        CASES[case](workdir, mesh, rank)


def rank_main(rank, world, workdir, cases):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_fleet_mesh
    store = os.path.join(workdir, f"store_{world}")
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        mesh = make_fleet_mesh(world, device="cpu")
        for case in cases:
            run_case(workdir, mesh, rank, case)
    finally:
        dist.destroy_process_group()


def main():
    root = sys.argv[1]
    for group in sys.argv[2:]:
        world, cases = group.split(":")
        world, cases = int(world), cases.split(",")
        workdir = os.path.join(root, f"ranks{world}")
        os.makedirs(workdir, exist_ok=True)
        t0 = time.perf_counter()
        if world == 1:
            torch.set_num_threads(1)
            from repro_torch.launch.mesh import make_fleet_mesh
            mesh = make_fleet_mesh(1, device="cpu")   # makes its own group
            for case in cases:
                run_case(workdir, mesh, 0, case)
            dist.destroy_process_group()
        else:
            mp.spawn(rank_main, args=(world, workdir, cases), nprocs=world)
        print(f"CHILD_OK {world} {time.perf_counter() - t0:.1f}s",
              flush=True)


if __name__ == "__main__":
    main()
