"""Plain fp32 reference of the ssm_moe family (Granite-4.0-H) and its
SuperSFL train step, for the port's CPU tests. It imports nothing of
``repro_torch`` and no JAX; the configuration is a dict of the port's
field names, the parameters a nested dict with the port's keys.

The model (ibm-granite/granite-4.0-h-small config.json, the source's
GraniteMoeHybrid modelling): tokens embedded times
``embedding_multiplier``; per layer, in ``layer_kinds``' order,
h ← h + r·mixer(RMSNorm(h)), then h ← h + r·(MoE(x) + shared(x)) with
x = RMSNorm(h) and r the ``residual_multiplier``; the last RMSNorm, the
head, and the logits divided by ``logits_scaling``. RMS norms store
scale − 1, with eps ``rms_norm_eps``.

* Mamba-2 (arXiv:2405.21060, one group): [z, xBC, dt] = x W_in;
  xBC ← silu(depthwise causal conv(xBC) + b) over x, B and C together;
  dt ← softplus(dt + dt_bias); A = −exp(A_log); per head the recurrence
  h_t = exp(dt_t·A)·h_{t−1} + dt_t·x_t ⊗ B_t, y_t = h_t·C_t + D·x_t,
  step by step over time (not the chunked form the port runs);
  y ← RMSNorm(y ⊙ silu(z)) over d_inner; out = y W_out.
* Attention: causal GQA, no position embedding, scores times
  ``attention_multiplier``.
* MoE: the router's logits over all ``router_experts``; the top k logits;
  gates their softmax; each expert held here (``[expert_offset,
  expert_offset + n_experts)``) runs its SwiGLU on its tokens, weighted
  by the gate; the shared SwiGLU on every token.

Departures from the source, each the port's too: untied client (local)
and server heads, both divided by ``logits_scaling`` (SuperSFL puts the
embedding on the client; the source ties its head to it); the balance
term, the port's E·Σ_e f_e·P_e / k per layer over the router's E
outputs (f_e the share of picks, P_e the mean probability), summed over
the server's layers, where the source's takes all layers' router outputs
at once and does not divide by k; the held share of experts.

The train step: the client holds the embedding and layers [:d], its
local head maps z to the vocabulary (Phase 1); the server holds layers
[d:], the last norm and the head, and its loss adds ``router_aux_coef``
times its layers' balance terms (Phase 2); the client's two gradients
(the local one clipped to global L2 norm ``tpgf_clip``) fused by Eq. 3-4
with w = d/L · (1/l_c) / (1/l_c + 1/l_s); the microbatches' gradients
averaged; AdamW with bias correction and decoupled weight decay.
"""
import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _rms(x, s, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + s)


def _silu(x):
    return x * torch.sigmoid(x)


def mamba(c, p, x):
    din = c["ssm_expand"] * c["d_model"]
    st, hd = c["ssm_state"], c["ssm_head_dim"]
    nh = din // hd
    Bt, S, _ = x.shape
    z, xbc, dt = (x @ p["w_in"]).split([din, din + 2 * st, nh], -1)
    k = p["conv_w"].shape[0]
    xbc = F.conv1d(xbc.transpose(1, 2), p["conv_w"].t()[:, None, :],
                   p["conv_b"], padding=k - 1,
                   groups=xbc.shape[-1])[..., :S].transpose(1, 2)
    xs, B, C = _silu(xbc).split([din, st, st], -1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(Bt, S, nh, hd)
    h = x.new_zeros(Bt, nh, hd, st)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] \
            + (dt[:, t, :, None] * xh[:, t])[..., None] * B[:, t, None, None]
        ys.append((h * C[:, t, None, None]).sum(-1))
    y = torch.stack(ys, 1) + xh * p["D"][:, None]
    y = _rms(y.reshape(Bt, S, din) * _silu(z), p["gate_norm_scale"],
             c["rms_norm_eps"])
    return y @ p["w_out"]


def attention(c, p, x):
    Bt, S, _ = x.shape
    hd = c["head_dim"]
    q = (x @ p["wq"]).reshape(Bt, S, -1, hd).transpose(1, 2)
    k = (x @ p["wk"]).reshape(Bt, S, -1, hd).transpose(1, 2)
    v = (x @ p["wv"]).reshape(Bt, S, -1, hd).transpose(1, 2)
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = (q @ k.transpose(-1, -2)) * c["attention_multiplier"]
    later = torch.ones(S, S, dtype=torch.bool).triu(1)
    o = torch.softmax(s.masked_fill(later, -math.inf), -1) @ v
    return o.transpose(1, 2).reshape(Bt, S, -1) @ p["wo"]


def _swiglu(wg, wu, wd, x):
    return (_silu(x @ wg) * (x @ wu)) @ wd


def moe(c, p, x):
    """-> (the held experts' part plus the shared expert, balance term)."""
    B, S, dm = x.shape
    xt = x.reshape(-1, dm)
    R, k, off = c["router_experts"], c["top_k"], c["expert_offset"]
    logits = xt @ p["router"]
    top, topi = torch.topk(logits, k, -1)
    gates = torch.softmax(top, -1)
    y = _swiglu(p["shared"]["w_gate"], p["shared"]["w_up"],
                p["shared"]["w_down"], xt)
    for e in range(c["n_experts"]):
        rows, slot = torch.nonzero(topi == off + e, as_tuple=True)
        y = y.index_add(0, rows, _swiglu(
            p["w_gate"][e], p["w_up"][e], p["w_down"][e], xt[rows])
            * gates[rows, slot, None])
    f = F.one_hot(topi, R).float().sum(1).mean(0)
    P = torch.softmax(logits, -1).mean(0)
    return y.reshape(B, S, dm), R * torch.sum(f * P) / k


def layer(c, kind, p, mixer, h):
    eps, r = c["rms_norm_eps"], c["residual_multiplier"]
    mix = mamba if kind == "mamba" else attention
    h = h + r * mix(c, mixer, _rms(h, p["mixer_norm_scale"], eps))
    y, aux = moe(c, p["moe"], _rms(h, p["ffn_norm_scale"], eps))
    return h + r * y, aux


def _row(tree, i):
    return {k: (_row(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def stack(c, layers, h, lo, hi):
    """Layers [lo:hi] of the stacked tree ``layers`` (whole, all L rows)
    over h: (h, the sum of their balance terms)."""
    kinds = c["layer_kinds"]
    shared = {k: v for k, v in layers.items() if k not in ("mamba",
                                                           "attention")}
    aux = 0.0
    for l in range(lo, hi):
        kind = kinds[l]
        j = list(kinds[:l]).count(kind)
        h, a = layer(c, kind, _row(shared, l), _row(layers[kind], j), h)
        aux = aux + a
    return h, aux


def embed(c, p, tokens):
    return p["embed"][tokens.long()] * c["embedding_multiplier"]


def local_logits(c, p, z):
    return (z @ p["local_head"]) / c["logits_scaling"]


def server_logits(c, p, h):
    return (_rms(h, p["final_norm"]["scale"], c["rms_norm_eps"])
            @ p["unembed"]) / c["logits_scaling"]


def xent(logits, labels, vocab):
    logits = logits[..., :vocab]
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[..., None].long())[..., 0]).mean()


def split_depth(c):
    L = c["n_layers"]
    return min(max(c["split_depth"] or max(L // 4, 1), 1), L - 1)


def losses(c, p, batch):
    """(z, l_c, l_s): the client's smashed data, the local head's loss and
    the server's (with its layers' balance terms)."""
    d, L = split_depth(c), c["n_layers"]
    z, _ = stack(c, p["layers"], embed(c, p, batch["tokens"]), 0, d)
    l_c = xent(local_logits(c, p, z), batch["labels"], c["vocab"])
    h, aux = stack(c, p["layers"], z, d, L)
    l_s = xent(server_logits(c, p, h), batch["labels"], c["vocab"]) \
        + c["router_aux_coef"] * aux
    return z, l_c, l_s


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _client_rows(c, path, x):
    """The rows of a leaf the client holds: the embedding whole, a
    per-layer leaf's [:d], a kind stack's rows of that kind below d; the
    rest (None) is the server's or the local head's."""
    d = split_depth(c)
    if path == ("embed",):
        return slice(None)
    if path[0] != "layers":
        return None
    if path[1] in ("mamba", "attention"):
        return slice(0, list(c["layer_kinds"][:d]).count(path[1]))
    return slice(0, d)


def tpgf_grads(c, params, batch):
    """One microbatch's gradients of every leaf ({path: tensor}) by
    Eq. 3-4, and (l_c, l_s, w_c)."""
    flat = dict(_flat(params))
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in flat.items()}
    tree = {}
    for path, x in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    d, L = split_depth(c), c["n_layers"]
    z, l_c, l_s = losses(c, tree, batch)
    keys = list(leaves)
    g_c = dict(zip(keys, torch.autograd.grad(l_c, list(leaves.values()),
                                             retain_graph=True,
                                             allow_unused=True)))
    g_s = dict(zip(keys, torch.autograd.grad(l_s, list(leaves.values()),
                                             allow_unused=True)))
    zero = lambda k: torch.zeros_like(flat[k])
    g_c = {k: zero(k) if g is None else g for k, g in g_c.items()}
    g_s = {k: zero(k) if g is None else g for k, g in g_s.items()}
    # the client's rows: Eq. 3-4; the local head its own loss's; the
    # server's rows its own loss's
    rows = {k: _client_rows(c, k, flat[k]) for k in keys}
    norm = torch.sqrt(sum(torch.sum(g_c[k][r] ** 2) for k, r in rows.items()
                          if r is not None))
    scale = torch.clamp(c["tpgf_clip"] / (norm + 1e-12), max=1.0)
    ic, is_ = 1 / (l_c.detach() + c["tpgf_eps"]), 1 / (l_s.detach()
                                                       + c["tpgf_eps"])
    wc = d / L * ic / (ic + is_)
    out = {}
    for k in keys:
        g = g_c[k].clone() if k == ("local_head",) else g_s[k].clone()
        r = rows[k]
        if r is not None:
            g[r] = wc * scale * g_c[k][r] + (1 - wc) * g_s[k][r]
        out[k] = g
    return out, (l_c.detach(), l_s.detach(), wc)


def train_step(c, params, batch, opt, state):
    """The microbatches' mean gradient, then AdamW: (new params (flat),
    new state, the gradient, the mean metrics)."""
    mb = c["microbatches"]
    acc, mets = None, []
    for i in range(mb):
        part = {k: v.chunk(mb)[i] for k, v in batch.items()}
        g, m = tpgf_grads(c, params, part)
        acc = g if acc is None else {k: acc[k] + g[k] for k in acc}
        mets.append(m)
    acc = {k: v / mb for k, v in acc.items()}
    t = state["t"] + 1
    c1, c2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
    new, m_, v_ = {}, {}, {}
    for k, p in _flat(params):
        g = acc[k]
        m_[k] = opt["b1"] * state["m"][k] + (1 - opt["b1"]) * g
        v_[k] = opt["b2"] * state["v"][k] + (1 - opt["b2"]) * g * g
        upd = (m_[k] / c1) / (torch.sqrt(v_[k] / c2) + opt["eps"]) \
            + opt["weight_decay"] * p
        new[k] = p - opt["lr"] * upd
    metrics = [torch.stack([m[i] for m in mets]).mean() for i in range(3)]
    return new, {"m": m_, "v": v_, "t": t}, acc, metrics


def adamw_init(params):
    z = {k: torch.zeros_like(v) for k, v in _flat(params)}
    return {"m": z, "v": dict(z), "t": 0}
