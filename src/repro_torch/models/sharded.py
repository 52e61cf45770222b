"""Sharded execution of the LM families over a ``("data", "model")`` mesh
(``("pod", "data", "model")`` for multi-pod): the counterpart of the
reference running its steps under GSPMD with ``launch/sharding.py``'s
specs.

The parameters are DTensors placed by ``param_pspecs`` (FSDP over the
data axes, tensor parallel over ``"model"``); the batch is placed by
``batch_pspecs`` (its rows over the data axes where they divide). The
activations between layers are DTensors whose rows follow the batch's
and which every ``"model"`` rank holds whole. Each layer runs as a few
*regions*: ``torch.distributed.tensor.experimental.local_map`` calls of
the meshless model's own functions on each rank's local shards, with the
placements each input arrives in and those its gradient leaves in
declared. Everything the mesh communicates is DTensor's redistribution
of a region's inputs and outputs:

* a weight's FSDP dims are all-gathered before its region (its gradient
  reduce-scattered back by the redistribution's backward);
* a tensor-parallel region (whole heads, a d_ff slice, an SSM head
  slice) returns a partial sum, all-reduced over ``"model"`` after it
  (Megatron's row-parallel output); its replicated inputs' gradients
  are partial over ``"model"`` and all-reduced on their way back;
* a region over split rows leaves partial gradients on the data axes
  for every weight it read.

What runs tensor parallel: attention when ``"model"`` divides both the
query and the kv heads (else each ``"model"`` rank runs every head: the
reference's spec may split a head, the activations then reshard); the
MLP and the experts over d_ff; the Mamba-2 mixer over its heads, with
the gated norm's mean square all-reduced between two regions. The
embeddings, the final norm, the heads and the losses run on every
``"model"`` rank over the whole (gathered) weight; a mixture of experts
routes every data rank's tokens (gathered) on every rank, as one
routing over the global batch, so the gather dispatch's capacity and
the router loss are the meshless ones.

The kernels run per rank inside those regions, on local tensors only:
``flash_attention`` on each rank's query and kv heads, ``ssd_scan`` on
its SSM heads (departure (i) in ROADMAP.md: the reference's dry-run never
partitions a Pallas call). Decode writes its caches in place on each
rank's local shards, inside the regions (departures (c) and (d)).

On a one-rank mesh every region is the meshless code on whole tensors:
the same operations, in the same order, bit for bit.
"""
from __future__ import annotations

import functools
import logging
import math
from typing import Any, Dict, List, Sequence

import torch

from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import TENSOR_AXIS, fsdp_axes
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.tree import tree_flatten_with_path, tree_unflatten


# ------------------------------------------------------------ mesh facts

class Mesh:
    """The facts of a ``DeviceMesh`` the regions read: which mesh dims
    are data dims and which is ``"model"``, and their extents."""

    def __init__(self, mesh):
        # DTensor warns at every (Partial, Partial) -> Replicate
        # redistribution (a replicated weight's gradient on a 2-D mesh)
        # that it runs one all-reduce per mesh dim: expected here
        logging.getLogger("torch.distributed.tensor._redistribute"
                          ).setLevel(logging.ERROR)
        names = tuple(mesh.mesh_dim_names)
        self.mesh = mesh
        self.ndim = len(names)
        self.data_dims = tuple(i for i, n in enumerate(names)
                               if n in fsdp_axes(mesh))
        self.model_dim = names.index(TENSOR_AXIS) \
            if TENSOR_AXIS in names else None
        self.D = math.prod(mesh.size(i) for i in self.data_dims)
        self.M = 1 if self.model_dim is None else mesh.size(self.model_dim)

    def pls(self, data, model=None):
        """The placements with ``data`` on every data dim and ``model``
        (default: replicated) on ``"model"``; a mesh dim of size 1 is
        replicated (as ``launch.sharding.placements`` places it)."""
        from torch.distributed.tensor import Replicate
        model = Replicate() if model is None else model
        return tuple(Replicate() if self.mesh.size(i) == 1 else
                     data if i in self.data_dims else
                     model if i == self.model_dim else Replicate()
                     for i in range(self.ndim))

    def act(self, B: int, dim: int = 0, model=None):
        """An activation's placements: its rows (dim ``dim``) over the data
        axes where ``B`` divides them, as ``batch_pspecs`` places the
        batch; ``model`` (default replicated) on ``"model"``."""
        from torch.distributed.tensor import Replicate, Shard
        return self.pls(Shard(dim) if B % self.D == 0 else Replicate(),
                        model)

    def rows(self, B: int) -> bool:
        """Whether the data ranks hold different rows of a batch of B."""
        return self.D > 1 and B % self.D == 0

    def model_rank(self) -> int:
        return 0 if self.M == 1 else self.mesh.get_local_rank(TENSOR_AXIS)

    def grad_pls(self, pls, rows: bool, tp: bool):
        """The placements of the gradient a region leaves for an input it
        read in ``pls``: a shard's is that shard; a replicated input's is
        partial over the data axes when the region ran split rows
        (``rows``) and partial over ``"model"`` when it ran tensor
        parallel (``tp``), else replicated."""
        from torch.distributed.tensor import Partial, Replicate
        out = []
        for i, p in enumerate(pls):
            if self.mesh.size(i) == 1:
                out.append(Replicate())
            elif p.is_shard():
                out.append(p)
            elif i in self.data_dims and rows:
                out.append(Partial())
            elif i == self.model_dim and tp:
                out.append(Partial())
            else:
                out.append(Replicate())
        return tuple(out)


@functools.lru_cache(maxsize=8)
def _info(mesh) -> Mesh:
    return Mesh(mesh)


def mesh_info(tree):
    """The :class:`Mesh` of ``tree``'s DTensors, or None for a plain
    tree."""
    mesh = SH.mesh_of(tree)
    return None if mesh is None else _info(mesh)


# --------------------------------------------------------------- regions

def region(mi: Mesh, fn, args: Sequence, outs: Sequence, *, rows: bool,
           tp: bool):
    """``fn`` on each rank's local tensors through ``local_map``. ``args``
    are DTensors (read in the placements they have) and plain values;
    ``outs`` the placements of each of ``fn``'s outputs (``fn`` returns a
    tuple; None for an output that is not a tensor). The inputs' gradients leave as ``Mesh.grad_pls``
    says for ``rows`` and ``tp``."""
    from torch.distributed.tensor.experimental import local_map
    in_pls = tuple(tuple(a.placements) if SH.is_dtensor(a) else None
                   for a in args)
    grads = tuple(None if p is None else mi.grad_pls(p, rows, tp)
                  for p in in_pls)
    return local_map(fn, out_placements=tuple(None if o is None else list(o)
                                              for o in outs),
                     in_placements=in_pls, in_grad_placements=grads,
                     device_mesh=mi.mesh)(*args)


def view(mi: Mesh, p, tp_dim: int = None):
    """A weight as its region reads it: whole over the data axes (the
    FSDP all-gather) and, on ``"model"``, its shard on ``tp_dim`` or
    whole."""
    from torch.distributed.tensor import Replicate, Shard
    want = mi.pls(Replicate(), None if tp_dim is None else Shard(tp_dim))
    return p if tuple(p.placements) == want else p.redistribute(mi.mesh,
                                                                want)


def reduce_to(mi: Mesh, x, pls):
    """``x`` redistributed to ``pls`` (a partial sum all-reduced, a
    replicated dim sliced)."""
    return x if tuple(x.placements) == tuple(pls) else x.redistribute(
        mi.mesh, pls)


def rows_of(mi: Mesh, x, dim: int = 0):
    """A batch tensor as a DTensor: a plain one (the same on every rank)
    placed with its rows over the data axes where they divide, by slicing
    (no communication); a DTensor as it is."""
    if x is None or SH.is_dtensor(x):
        return x
    pls = mi.act(x.shape[dim], dim)
    return SH.as_dtensor(SH.local_slice(x, mi.mesh, pls).contiguous(),
                         mi.mesh, pls, tuple(x.shape))


def _flat(tree):
    flat = tree_flatten_with_path(tree)
    return [p for p, _ in flat], [x for _, x in flat]


def _model_shard(mi: Mesh, p) -> bool:
    return mi.model_dim is not None and \
        p.placements[mi.model_dim].is_shard()


def _partial_if(mi: Mesh, B: int, tp: bool, dim: int = 0):
    from torch.distributed.tensor import Partial
    return mi.act(B, dim, Partial() if tp else None)


def _heads(mi: Mesh, B: int, tp: bool, head_dim: int):
    """[B, ..., heads, ...] outputs: rows as the batch, heads sharded
    over ``"model"`` under tensor parallelism."""
    from torch.distributed.tensor import Shard
    return mi.act(B, 0, Shard(head_dim) if tp else None)


def rows_call(cfg, fn, params: Dict[str, Any], *acts):
    """``fn(cfg, params, *acts)`` -> one [B, ...] tensor, on every
    ``"model"`` rank over the whole (gathered) ``params``: the
    embeddings', norms' and heads' region."""
    mi = _info(SH.mesh_of({"a": acts, "p": params}))
    acts = [rows_of(mi, a) for a in acts]
    paths, leaves = _flat({k: view(mi, v) if SH.is_dtensor(v) else v
                           for k, v in params.items()})
    n = len(acts)
    B = acts[0].shape[0]

    def body(*args):
        return (fn(cfg, tree_unflatten(paths, args[n:]), *args[:n]),)

    return region(mi, body, [*acts, *leaves], [mi.act(B)],
                  rows=mi.rows(B), tp=False)[0]


# ------------------------------------------------------------ the blocks

def _local_cfg(cfg, mi: Mesh):
    """The config of one rank's heads under tensor parallelism."""
    return cfg.replace(n_heads=cfg.n_heads // mi.M,
                       n_kv_heads=cfg.n_kv_heads // mi.M,
                       head_dim=cfg.resolved_head_dim)


def _heads_tp(cfg, mi: Mesh, attn) -> bool:
    """Attention runs tensor parallel when ``"model"`` divides the query
    and the kv heads and the specs shard the projections over it."""
    return (mi.M > 1 and cfg.n_heads % mi.M == 0
            and cfg.n_kv_heads % mi.M == 0
            and all(_model_shard(mi, attn[k]) for k in ("wq", "wk", "wv",
                                                         "wo")))


_ATTN_DIM = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0}


def _norm_views(mi: Mesh, p, prefix: str):
    return {k: view(mi, v) for k, v in p.items() if k.startswith(prefix)}


def _attn_views(mi: Mesh, attn, tp: bool):
    return {k: view(mi, v, _ATTN_DIM[k] if tp else None)
            for k, v in attn.items()}


def attn_block(cfg, mi: Mesh, p, h, *, causal, window, use_rope):
    """``model._attn_block`` on the mesh: (the projected output, the
    replicated-over-``"model"`` activation; (k, v), heads sharded under
    tensor parallelism)."""
    tp = _heads_tp(cfg, mi, p["attn"])
    lcfg = _local_cfg(cfg, mi) if tp else cfg
    sub = _norm_views(mi, p, "attn_norm_")
    sub["attn"] = _attn_views(mi, p["attn"], tp)
    paths, leaves = _flat(sub)
    B = h.shape[0]

    def body(hl, *ls):
        pos = torch.arange(hl.shape[1], device=hl.device).expand(
            hl.shape[:2])
        out, (k, v) = M._attn_block(lcfg, tree_unflatten(paths, ls), hl,
                                    positions=pos, causal=causal,
                                    window=window, use_rope=use_rope)
        return out, k, v

    heads = _heads(mi, B, tp, 2)
    out, k, v = region(mi, body, [h, *leaves],
                       [_partial_if(mi, B, tp), heads, heads],
                       rows=mi.rows(B), tp=tp)
    return reduce_to(mi, out, mi.act(B)), (k, v)


def cross_block(cfg, mi: Mesh, p, h, enc_out):
    """``model._cross_block`` on the mesh (the audio decoder)."""
    tp = _heads_tp(cfg, mi, p["cross"])
    lcfg = _local_cfg(cfg, mi) if tp else cfg
    sub = _norm_views(mi, p, "cross_norm_")
    sub["cross"] = _attn_views(mi, p["cross"], tp)
    paths, leaves = _flat(sub)
    B = h.shape[0]

    def body(hl, el, *ls):
        out, (k, v) = M._cross_block(lcfg, tree_unflatten(paths, ls), hl,
                                     el)
        return out, k, v

    heads = _heads(mi, B, tp, 2)
    out, k, v = region(mi, body, [h, enc_out, *leaves],
                       [_partial_if(mi, B, tp), heads, heads],
                       rows=mi.rows(B), tp=tp)
    return reduce_to(mi, out, mi.act(B)), (k, v)


def mlp_block(cfg, mi: Mesh, p, h):
    """``h`` + the layer's MLP of its normed input, tensor parallel over
    d_ff where the specs shard it (``b_down`` added after the
    all-reduce)."""
    mp = p["mlp"]
    tp = mi.M > 1 and _model_shard(mi, mp["w_up"]) and \
        _model_shard(mi, mp["w_down"])
    dims = {"w_gate": 1, "w_up": 1, "b_up": 0, "w_down": 0}
    sub = _norm_views(mi, p, "mlp_norm_")
    sub["mlp"] = {k: view(mi, v, dims[k] if tp else None)
                  for k, v in mp.items() if k != "b_down"}
    paths, leaves = _flat(sub)
    B = h.shape[0]

    def body(hl, *ls):
        pl = tree_unflatten(paths, ls)
        x = L.apply_norm(cfg, hl, pl, "mlp_norm")
        if cfg.mlp in ("swiglu", "geglu"):
            return (L.mlp_apply(cfg, pl["mlp"], x),)
        q = pl["mlp"]
        return (L.gelu(x @ q["w_up"] + q["b_up"]) @ q["w_down"],)

    y = region(mi, body, [h, *leaves], [_partial_if(mi, B, tp)],
               rows=mi.rows(B), tp=tp)[0]
    y = reduce_to(mi, y, mi.act(B))
    if "b_down" in mp:
        y = y + view(mi, mp["b_down"])
    return h + y


def moe_block(cfg, mi: Mesh, p, h):
    """``h`` + the layer's mixture of experts, and its router loss: the
    router over every data rank's tokens on every rank (one region), then
    the experts tensor parallel over d_ff (a second region, so that the
    router loss's gradient is not summed over ``"model"``)."""
    from torch.distributed.tensor import Partial, Replicate
    mp = p["moe"]
    tp = mi.M > 1 and all(_model_shard(mi, mp[k])
                          for k in ("w_gate", "w_up", "w_down"))
    B, S, dm = h.shape
    whole = mi.pls(Replicate())
    hall = reduce_to(mi, h, whole)
    sub = _norm_views(mi, p, "mlp_norm_")
    sub["router"] = view(mi, mp["router"])
    paths, leaves = _flat(sub)

    def route(hl, *ls):
        pl = tree_unflatten(paths, ls)
        x = L.apply_norm(cfg, hl, pl, "mlp_norm")
        routed, f_e, P_e = MOE.moe_route(cfg, {"router": pl["router"]},
                                         x.reshape(-1, dm))
        return x, routed, MOE.moe_aux(cfg, f_e, P_e)

    x, routed, aux = region(mi, route, [hall, *leaves],
                            [whole, whole, whole], rows=False, tp=False)
    dims = {"w_gate": 2, "w_up": 2, "w_down": 1}
    ex = {k: view(mi, mp[k], dims[k] if tp else None) for k in dims}
    epaths, eleaves = _flat(ex)

    def experts(xl, rl, *ls):
        y = MOE.moe_combine(cfg, tree_unflatten(epaths, ls),
                            xl.reshape(-1, dm), rl)
        return (y.reshape(xl.shape),)

    y = region(mi, experts, [x, routed, *eleaves],
               [mi.pls(Replicate(), Partial() if tp else None)],
               rows=False, tp=tp)[0]
    return h + reduce_to(mi, y, mi.act(B)), aux


def _ssm_tp(cfg, mi: Mesh, sp) -> bool:
    """The mixer runs tensor parallel over its heads when ``"model"``
    divides them and the specs shard d_inner over it."""
    return (mi.M > 1 and cfg.ssm_n_heads % mi.M == 0
            and all(_model_shard(mi, sp[k]) for k in (
                "w_x", "w_z", "conv_w", "conv_b", "gate_norm_scale",
                "w_out")))


_SSM_DIM = {"w_x": 1, "w_z": 1, "conv_w": 1, "conv_b": 0}


def _ssm_local(cfg, mi: Mesh, q):
    """A rank's cut of the per-head leaves it reads whole (``w_dt``'s
    columns, ``dt_bias``, ``A_log``, ``D``): its heads."""
    n = cfg.ssm_n_heads // mi.M
    lo = mi.model_rank() * n
    q = dict(q)
    q["w_dt"] = q["w_dt"][:, lo:lo + n]
    for k in ("dt_bias", "A_log", "D"):
        q[k] = q[k][lo:lo + n]
    return q, n


def _ssm_out_tp(cfg, mi: Mesh, sp, y, z, ss, B: int):
    """The mixer's gated norm and ``w_out`` on a rank's d_inner slice,
    the mean square from every rank's sum of squares (``ss``, all-reduced
    here); a decode step's [B, d_inner] slice comes out [B, 1, dm]."""
    ss = reduce_to(mi, ss, mi.act(B))
    sub = {"gate_norm_scale": view(mi, sp["gate_norm_scale"], 0),
           "w_out": view(mi, sp["w_out"], 0)}
    paths, leaves = _flat(sub)
    din = cfg.ssm_d_inner

    def body(yl, zl, sl, *ls):
        out = SSM.ssm_out(tree_unflatten(paths, ls), yl, zl, var=sl / din)
        return (out[:, None, :] if out.dim() == 2 else out,)

    out = region(mi, body, [y, z, ss, *leaves], [_partial_if(mi, B, True)],
                 rows=mi.rows(B), tp=True)[0]
    return reduce_to(mi, out, mi.act(B))


def ssm_block(cfg, mi: Mesh, p, h, emit: bool):
    """``model._ssm_block`` on the mesh: (out, {"ssm_h", "ssm_conv"} when
    ``emit``)."""
    from torch.distributed.tensor import Partial, Shard
    sp = p["ssm"]
    B = h.shape[0]
    tp = _ssm_tp(cfg, mi, sp)
    sub = _norm_views(mi, p, "attn_norm_")
    sub["ssm"] = {k: view(mi, v, _SSM_DIM.get(k) if tp else None)
                  for k, v in sp.items()
                  if not tp or k not in ("gate_norm_scale", "w_out")}
    paths, leaves = _flat(sub)
    st_pls = [_heads(mi, B, tp, 1), _heads(mi, B, tp, 2)]
    if not tp:
        def body(hl, *ls):
            pl = tree_unflatten(paths, ls)
            x = L.apply_norm(cfg, hl, pl, "attn_norm")
            if emit:
                return SSM.ssm_apply(cfg, pl["ssm"], x, return_state=True)
            return (SSM.ssm_apply(cfg, pl["ssm"], x),)

        outs = region(mi, body, [h, *leaves],
                      [mi.act(B)] + (st_pls if emit else []),
                      rows=mi.rows(B), tp=False)
        return outs[0], ({"ssm_h": outs[1], "ssm_conv": outs[2]}
                         if emit else {})

    def mix(hl, *ls):
        pl = tree_unflatten(paths, ls)
        x = L.apply_norm(cfg, hl, pl, "attn_norm")
        q, n = _ssm_local(cfg, mi, pl["ssm"])
        y, z, hf, xs_raw = SSM.ssm_mix(cfg, q, x, n_heads=n)
        ss = y.float().square().sum(dim=-1, keepdim=True)
        st = (hf, SSM.conv_tail(cfg, xs_raw)) if emit else ()
        return (y, z, ss, *st)

    sharded = mi.act(B, 0, Shard(2))
    outs = region(mi, mix, [h, *leaves],
                  [sharded, sharded, mi.act(B, 0, Partial())]
                  + (st_pls if emit else []), rows=mi.rows(B), tp=True)
    out = _ssm_out_tp(cfg, mi, sp, outs[0], outs[1], outs[2], B)
    return out, ({"ssm_h": outs[3], "ssm_conv": outs[4]} if emit else {})


def ffn(cfg, mi: Mesh, role: str, p, h):
    """``model.ffn`` on the mesh: (h + the MLP or the mixture of experts,
    the moe layer's router loss or None)."""
    if role == "moe":
        return moe_block(cfg, mi, p, h)
    return mlp_block(cfg, mi, p, h), None


def _any_tp(cfg, mi: Mesh, role: str, p) -> bool:
    """Whether any block of a ``role`` layer runs tensor parallel."""
    if mi.M == 1:
        return False
    tp = []
    if role != "ssm":
        tp.append(_heads_tp(cfg, mi, p["attn"]))
        ff = p["moe"] if role == "moe" else p["mlp"]
        tp.append(any(_model_shard(mi, v) for v in ff.values()))
    if role in ("ssm", "hybrid"):
        tp.append(_ssm_tp(cfg, mi, p["ssm"]))
    if role == "dec":
        tp.append(_heads_tp(cfg, mi, p["cross"]))
    return any(tp)


def _cache_keys(role: str, emit: bool):
    if not emit:
        return []
    keys = [] if role == "ssm" else ["k", "v"]
    if role in ("ssm", "hybrid"):
        keys += ["ssm_h", "ssm_conv"]
    if role == "dec":
        keys += ["cross_k", "cross_v"]
    return keys


def _whole_layer(cfg, mi: Mesh, role: str, p, h, *, causal, window,
                 use_rope, emit, enc_out):
    """A layer with no tensor-parallel block: ``model._layer`` itself in
    one region over the rank's rows and the whole (gathered) weights. On
    a one-rank mesh this is the meshless layer, its backward too: the
    residual stays inside, so the gradients accumulate in the meshless
    order."""
    from torch.distributed.tensor import Replicate
    paths, leaves = _flat({path: view(mi, x) for path, x in
                           tree_flatten_with_path(p)})
    paths = [path[0] for path in paths]
    keys = _cache_keys(role, emit)
    B = h.shape[0]
    extra = [] if enc_out is None else [enc_out]

    def body(hl, *rest):
        el = rest[0] if extra else None
        pl = tree_unflatten(paths, rest[len(extra):])
        pos = torch.arange(hl.shape[1], device=hl.device).expand(
            hl.shape[:2])
        h2, aux, ys = M._layer(cfg, role, pl, hl, positions=pos,
                               causal=causal, window=window,
                               use_rope=use_rope, emit=emit, enc_out=el)
        return (h2, aux, *[ys[k] for k in keys])

    outs = region(mi, body, [h, *extra, *leaves],
                  [mi.act(B), mi.pls(Replicate()) if role == "moe" else
                   None] + [mi.act(B)] * len(keys),
                  rows=mi.rows(B), tp=False)
    return outs[0], outs[1], dict(zip(keys, outs[2:]))


def layer(cfg, mi: Mesh, role: str, p, h, *, causal, window, use_rope,
          emit: bool = False, enc_out=None):
    """``model._layer`` on the mesh: (h, aux, the layer's cache
    entries). A layer with no tensor-parallel block runs whole in one
    region, except a mixture of experts over split rows, which routes
    the global batch block by block."""
    if not _any_tp(cfg, mi, role, p) and not (role == "moe"
                                              and mi.rows(h.shape[0])):
        return _whole_layer(cfg, mi, role, p, h, causal=causal,
                            window=window, use_rope=use_rope, emit=emit,
                            enc_out=enc_out)
    if role == "ssm":
        s, ys = ssm_block(cfg, mi, p, h, emit)
        return h + s, None, ys
    out, (k, v) = attn_block(cfg, mi, p, h, causal=causal, window=window,
                             use_rope=use_rope)
    ys = {"k": k, "v": v}
    if role == "hybrid":
        s, st = ssm_block(cfg, mi, p, h, emit)
        ys.update(st)
        h = h + p["branch_scale_attn"] * out + p["branch_scale_ssm"] * s
    else:
        h = h + out
    if role == "dec":
        out, (ck, cv) = cross_block(cfg, mi, p, h, enc_out)
        h = h + out
        ys.update(cross_k=ck, cross_v=cv)
    return (*ffn(cfg, mi, role, p, h), ys)


def _stack_ys(mi: Mesh, per: List[Dict[str, Any]]):
    """Each cache entry of the layers stacked on a leading L axis, from
    the local tensors (the placements shift by one dim)."""
    from torch.distributed.tensor import Shard
    out = {}
    for k in (per[0] if per else {}):
        first = per[0][k]
        pls = tuple(Shard(p.dim + 1) if p.is_shard() else p
                    for p in first.placements)
        local = torch.stack([ys[k].to_local() for ys in per])
        out[k] = SH.as_dtensor(local, mi.mesh, pls,
                               (len(per),) + tuple(first.shape))
    return out


def run_stack(cfg, stack, h, *, causal: bool = False, window: int = 0,
              emit: bool = False, role: str = None, enc_out=None):
    """``model.run_stack`` on the mesh (``h`` a DTensor; positions are
    each region's own ``arange``)."""
    from torch.utils.checkpoint import checkpoint
    mi = _info(h.device_mesh)
    role = role or M.layer_role(cfg)
    use_rope = role in ("dense", "moe", "hybrid")
    remat = cfg.remat and not emit and torch.is_grad_enabled()
    kw = dict(causal=causal, window=window, use_rope=use_rope)

    def one(p, x, e=None):
        return layer(cfg, mi, role, p, x, enc_out=e, **kw)[:2]

    extra = () if enc_out is None else (enc_out,)
    per, aux = [], 0.0
    for row in M._rows(stack, M.stack_len(stack)):
        if remat:
            h, a = checkpoint(one, row, h, *extra, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, a, ys = layer(cfg, mi, role, row, h, emit=emit,
                             enc_out=enc_out, **kw)
            if emit:
                per.append(ys)
        if a is not None:
            aux = aux + a
    if emit:
        return h, aux, _stack_ys(mi, per)
    return h, aux


# ---------------------------------------------------- embeddings, heads

_EMBED_KEYS = ("embed", "vision_proj", "frame_proj", "patch_embed",
               "patch_bias", "pos_embed")


def embed_inputs(cfg, params, batch):
    """``model.embed_inputs`` on the mesh: (h, None); the batch's rows
    over the data axes."""
    mi = mesh_info(params)
    keys = sorted(k for k in batch if batch[k] is not None)
    sub = {k: params[k] for k in _EMBED_KEYS if k in params}

    def fn(cfg_, pl, *bl):
        return M.embed_inputs(cfg_, pl, dict(zip(keys, bl)))[0]

    return rows_call(cfg, fn, sub, *[rows_of(mi, batch[k])
                                     for k in keys]), None


def embed_decoder(cfg, params, tokens, start: int = 0):
    """The audio decoder's input over ``tokens`` (rows as the batch): the
    token embedding plus ``dec_pos[start:start + S]``."""
    mi = mesh_info(params)

    def fn(cfg_, pl, tl):
        h = M.embed_tokens(cfg_, pl, tl)
        if "dec_pos" not in pl:
            return h
        if start == 0:
            return h + pl["dec_pos"][:tl.shape[1]][None]
        return h + pl["dec_pos"][start]

    sub = {k: params[k] for k in ("embed", "dec_pos") if k in params}
    return rows_call(cfg, fn, sub, rows_of(mi, tokens))


def xent(cfg, logits, batch, *, unigram: bool = False):
    """``model._xent`` on the mesh: a replicated fp32 scalar. Rows split
    over the data ranks each give their share of the global mean (their
    sum over the global count), summed; otherwise every rank takes the
    meshless mean of the whole batch. ``unigram``: the audio local head's
    [B, V] logits predict every label position."""
    from torch.distributed.tensor import Partial, Replicate
    mi = _info(logits.device_mesh)
    labels, valid = M._label_fields(cfg, batch)
    labels, valid = rows_of(mi, labels), rows_of(mi, valid)
    B = logits.shape[0]
    whole = mi.pls(Replicate())

    def expand(lg, lb):
        return lg[:, None].expand(lb.shape + lg.shape[-1:]) if unigram \
            else lg

    if not mi.rows(B):
        def body(lg, lb, *vl):
            b = {"labels": lb, "label": lb}
            if vl:
                b["valid"] = vl[0]
            return (M._xent(cfg, expand(lg, lb), b),)
        args = [logits, labels] + ([valid] if valid is not None else [])
        return region(mi, body, args, [whole], rows=False, tp=False)[0]
    if valid is None:
        den = float(math.prod(labels.shape))
        args = [logits, labels]
    else:
        den = torch.clamp(reduce_to(mi, valid.float().sum(), whole),
                          min=1.0)
        args = [logits, labels, valid, den]

    def body(lg, lb, *rest):
        lg = expand(lg, lb)
        if cfg.family == "vlm":
            lg = lg[:, cfg.n_patches:]
        nll = L.softmax_nll(lg, lb, vocab=cfg.vocab)
        if not rest:
            return (nll.sum() / den,)
        return (torch.sum(nll * rest[0].float()) / rest[1],)

    out = region(mi, body, args, [mi.pls(Partial())], rows=True,
                 tp=False)[0]
    return reduce_to(mi, out, whole)


# ----------------------------------------------------------------- serve

def cache_placements(cfg, cache, mesh):
    """The cache's placements by ``cache_pspecs``."""
    specs = SH.cache_pspecs(cfg, {k: v for k, v in cache.items()
                                  if SH.is_dtensor(v)}, mesh)
    return {k: SH.placements(s, mesh) for k, s in specs.items()}


def prefill(cfg, params, batch, decode_budget: int = 0):
    """``decode.prefill`` on the mesh: (logits, the cache placed by
    ``cache_pspecs``; ``idx`` a host int)."""
    from repro_torch.models import decode as D
    mi = mesh_info(params)
    h, _ = M.embed_inputs(cfg, params, batch)
    if cfg.is_encdec:
        enc_out, _ = M.encode(cfg, params, h)
        h, _, ys = M.decode_tokens(cfg, params, batch["tokens"], enc_out,
                                   emit=True)
    else:
        h, _, ys = run_stack(cfg, params["layers"], h, causal=M._causal(cfg),
                             window=cfg.sliding_window, emit=True)
    logits = M._head_logits(cfg, params, M.final_norm(cfg, params, h))
    B, S = h.shape[:2]
    local = D._build_cache(cfg, {k: v.to_local() for k, v in ys.items()},
                           h.to_local().shape[0], S, decode_budget,
                           h.to_local().device)
    cache: Dict[str, Any] = {"idx": local.pop("idx")}
    for k, x in local.items():
        pls = ys[k].placements if k in ys else mi.act(B)
        shape = list(x.shape)
        for m, pl in enumerate(pls):
            if pl.is_shard():
                shape[pl.dim] *= mi.mesh.size(m)
        cache[k] = SH.as_dtensor(x.contiguous(), mi.mesh, pls, tuple(shape))
    want = cache_placements(cfg, cache, mi.mesh)
    for k, pls in want.items():
        cache[k] = reduce_to(mi, cache[k], pls)
    return logits, cache


def _decode_pls(cfg, mi: Mesh, p, key: str, B: int):
    """Where decode reads and writes a cache entry: rows as the batch,
    heads as the layer's tensor parallelism shards them."""
    from torch.distributed.tensor import Shard
    if key == "pos":
        return mi.act(B)
    if key in ("k", "v", "cross_k", "cross_v"):
        tp = _heads_tp(cfg, mi, p["cross" if key.startswith("cross")
                                  else "attn"])
        return mi.act(B, 1, Shard(3) if tp else None)
    tp = _ssm_tp(cfg, mi, p["ssm"])
    return mi.act(B, 1, Shard(2 if key == "ssm_h" else 3) if tp else None)


@torch.no_grad()
def decode_step(cfg, params, cache, token):
    """``decode.decode_step`` on the mesh. Each layer's regions write the
    new k, v, ssm_h and ssm_conv into the rank's local shards of the cache
    in place; an entry stored in other placements than decode's (the
    reference's spec may split a head, or shard the window) is
    redistributed for the step and stored back."""
    mi = mesh_info(params)
    role = "dec" if cfg.is_encdec else M.layer_role(cfg)
    B = token.shape[0]
    idx = int(cache["idx"])
    stack = params["dec_layers" if cfg.is_encdec else "layers"]
    p0 = M._row(stack, 0)
    work = {}
    for k, v in cache.items():
        if SH.is_dtensor(v):
            work[k] = reduce_to(mi, v, _decode_pls(cfg, mi, p0, k, B))
    if cfg.is_encdec:
        h = embed_decoder(cfg, params, token, start=idx)
    else:
        h = rows_call(cfg, lambda c, pl, tl: M.embed_tokens(c, pl, tl),
                      {"embed": params["embed"]}, rows_of(mi, token))
    slot = idx % work["k"].shape[2] if "k" in work else 0
    for i in range(M.stack_len(stack)):
        p = M._row(stack, i)
        if role in ("dense", "moe", "hybrid", "dec"):
            out = _decode_attn(cfg, mi, role, p, h, work, i, idx, slot)
        if role in ("ssm", "hybrid"):
            s = _decode_ssm(cfg, mi, p, h, work, i)
        if role in ("dense", "moe", "dec"):
            h = h + out
        elif role == "ssm":
            h = h + s
        else:
            h = h + p["branch_scale_attn"] * out + \
                p["branch_scale_ssm"] * s
        if role == "dec":
            h = h + _decode_cross(cfg, mi, p, h, work, i)
        if role != "ssm":
            h = ffn(cfg, mi, role, p, h)[0]
    logits = M._head_logits(cfg, params, M.final_norm(cfg, params, h))
    for k, v in work.items():
        if v is not cache[k]:
            cache[k] = reduce_to(mi, v, cache[k].placements)
    cache["idx"] = idx + 1
    return logits, cache


def _decode_attn(cfg, mi: Mesh, role, p, h, work, i, idx, slot):
    """One layer's self-attention over its cache for the new token: k and
    v (and, in the first layer, the position) written into the rank's
    shard of the cache at ``slot``."""
    tp = _heads_tp(cfg, mi, p["attn"])
    lcfg = _local_cfg(cfg, mi) if tp else cfg
    sub = _norm_views(mi, p, "attn_norm_")
    sub["attn"] = _attn_views(mi, p["attn"], tp)
    paths, leaves = _flat(sub)
    B = h.shape[0]

    def body(hl, kc, vc, pos, *ls):
        pl = tree_unflatten(paths, ls)
        if i == 0:
            pos[:, slot] = idx
        x = L.apply_norm(lcfg, hl, pl, "attn_norm")
        q, k, v = L.project_qkv(lcfg, pl["attn"], x, x)
        if role != "dec":
            pos_q = torch.full((hl.shape[0], 1), idx, dtype=torch.int32,
                               device=hl.device)
            q = L.apply_rope(q, pos_q, lcfg.rope_theta)
            k = L.apply_rope(k, pos_q, lcfg.rope_theta)
        kc[i, :, slot] = k[:, 0]
        vc[i, :, slot] = v[:, 0]
        out = L.attention(q, kc[i], vc[i],
                          mask=(pos >= 0)[:, None, None, :])
        return (out.reshape(hl.shape[0], 1, -1) @ pl["attn"]["wo"],)

    out = region(mi, body, [h, work["k"], work["v"], work["pos"], *leaves],
                 [_partial_if(mi, B, tp)], rows=mi.rows(B), tp=tp)[0]
    return reduce_to(mi, out, mi.act(B))


def _decode_cross(cfg, mi: Mesh, p, h, work, i):
    """One audio decoder layer's cross-attention to its (unwritten)
    cross cache."""
    tp = _heads_tp(cfg, mi, p["cross"])
    lcfg = _local_cfg(cfg, mi) if tp else cfg
    sub = _norm_views(mi, p, "cross_norm_")
    sub["cross"] = {"wq": view(mi, p["cross"]["wq"], 1 if tp else None),
                    "wo": view(mi, p["cross"]["wo"], 0 if tp else None)}
    paths, leaves = _flat(sub)
    B = h.shape[0]

    def body(hl, ck, cv, *ls):
        pl = tree_unflatten(paths, ls)
        x = L.apply_norm(lcfg, hl, pl, "cross_norm")
        q = (x @ pl["cross"]["wq"]).reshape(
            hl.shape[0], 1, lcfg.n_heads, lcfg.resolved_head_dim)
        out = L.attention(q, ck[i], cv[i])
        return (out.reshape(hl.shape[0], 1, -1) @ pl["cross"]["wo"],)

    out = region(mi, body, [h, work["cross_k"], work["cross_v"], *leaves],
                 [_partial_if(mi, B, tp)], rows=mi.rows(B), tp=tp)[0]
    return reduce_to(mi, out, mi.act(B))


def _decode_ssm(cfg, mi: Mesh, p, h, work, i):
    """One layer's mixer for the new token: its state written into the
    rank's shard of the cache."""
    from torch.distributed.tensor import Partial, Shard
    sp = p["ssm"]
    B = h.shape[0]
    tp = _ssm_tp(cfg, mi, sp)
    sub = _norm_views(mi, p, "attn_norm_")
    sub["ssm"] = {k: view(mi, v, _SSM_DIM.get(k) if tp else None)
                  for k, v in sp.items()
                  if not tp or k not in ("gate_norm_scale", "w_out")}
    paths, leaves = _flat(sub)

    def state(hl, sh, sc, pl):
        x = L.apply_norm(cfg, hl, pl, "attn_norm")
        return x, {"h": sh[i], "conv": sc[i]}

    if not tp:
        def body(hl, sh, sc, *ls):
            pl = tree_unflatten(paths, ls)
            x, st = state(hl, sh, sc, pl)
            s, new = SSM.ssm_decode_step(cfg, pl["ssm"], x, st)
            sh[i] = new["h"]
            sc[i] = new["conv"]
            return (s,)

        return region(mi, body, [h, work["ssm_h"], work["ssm_conv"],
                                 *leaves], [mi.act(B)], rows=mi.rows(B),
                      tp=False)[0]

    def mix(hl, sh, sc, *ls):
        pl = tree_unflatten(paths, ls)
        x, st = state(hl, sh, sc, pl)
        q, n = _ssm_local(cfg, mi, pl["ssm"])
        y, z, new = SSM.ssm_decode_mix(cfg, q, x, st, n_heads=n)
        sh[i] = new["h"]
        sc[i] = new["conv"]
        return y, z, y.float().square().sum(dim=-1, keepdim=True)

    sharded = mi.act(B, 0, Shard(1))
    y, z, ss = region(mi, mix, [h, work["ssm_h"], work["ssm_conv"],
                                *leaves],
                      [sharded, sharded, mi.act(B, 0, Partial())],
                      rows=mi.rows(B), tp=True)
    return _ssm_out_tp(cfg, mi, sp, y, z, ss, B)
