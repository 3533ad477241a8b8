"""Plain reference of the MoE family with latent attention
(DeepSeek-V2-Lite, arXiv:2405.04434), float32, for training.

Layers: the first ``first_k_dense_replace`` take a dense gated MLP, the
rest a routed MoE FFN (softmax router, each token's ``num_experts_per_tok``
most probable experts, their weights renormalised to sum to one, plus
``n_shared_experts`` experts' worth of shared MLP) and the Switch
balance loss E * sum_e f_e p_e. Attention is MLA without a query
latent: q = x Wq split into (nope, rope); the latent x Wkv_a normed,
then expanded by Wkv_b to per-head k_nope and v; one roped k_rope
shared by the heads. RoPE is the plain one at ``rope_theta``. Each
departure from the published config is listed under ``departures`` in
the configuration's file.

The experts run sparsely: each expert on the tokens routed to it.
"""

from __future__ import annotations

import torch

try:
    from . import layers as L
except ImportError:                 # loaded by path, beside layers.py
    import layers as L


def _bf16(cfg) -> bool:
    """Whether the state stores the norm scales in bf16."""
    return cfg["dtype"] == "bfloat16"


def _dims(cfg):
    return dict(d=cfg["hidden_size"], h=cfg["num_attention_heads"],
                lat=cfg["kv_lora_rank"], nope=cfg["qk_nope_head_dim"],
                rope=cfg["qk_rope_head_dim"], dv=cfg["v_head_dim"],
                e=cfg["n_routed_experts"], fe=cfg["moe_intermediate_size"],
                ns=cfg["n_shared_experts"], f=cfg["intermediate_size"],
                v=cfg["vocab_size"])


def param_spec(cfg) -> list:
    """The parameter layout, in the order the benchmark draws it."""
    k = _dims(cfg)
    d, h, bf = k["d"], k["h"], cfg["dtype"]
    spec = [L.Leaf("embed", (k["v"], d), bf, fan_in=d),
            L.Leaf("final_norm", (d,), bf, "norm"),
            L.Leaf("head", (d, k["v"]), bf, fan_in=d)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        spec += [L.Leaf(p + "ln1", (d,), bf, "norm"),
                 L.Leaf(p + "ln2", (d,), bf, "norm"),
                 L.Leaf(p + "attn.wq", (d, h, k["nope"] + k["rope"]), bf,
                        fan_in=d),
                 L.Leaf(p + "attn.wkv_a", (d, k["lat"] + k["rope"]), bf,
                        fan_in=d),
                 L.Leaf(p + "attn.kv_norm", (k["lat"],), bf, "norm"),
                 L.Leaf(p + "attn.wkv_b", (k["lat"], h, k["nope"] + k["dv"]),
                        bf, fan_in=k["lat"]),
                 L.Leaf(p + "attn.wo", (h, k["dv"], d), bf,
                        fan_in=h * k["dv"])]
        if i < cfg["first_k_dense_replace"]:
            spec += [L.Leaf(p + "mlp.wi", (d, 2, k["f"]), bf, fan_in=d),
                     L.Leaf(p + "mlp.wo", (k["f"], d), bf, fan_in=k["f"])]
            continue
        fs = k["fe"] * k["ns"]
        spec += [L.Leaf(p + "moe.router", (d, k["e"]), "float32", fan_in=d),
                 L.Leaf(p + "moe.wi", (k["e"], d, 2, k["fe"]), bf, fan_in=d),
                 L.Leaf(p + "moe.wo", (k["e"], k["fe"], d), bf,
                        fan_in=k["fe"]),
                 L.Leaf(p + "shared_mlp.wi", (d, 2, fs), bf, fan_in=d),
                 L.Leaf(p + "shared_mlp.wo", (fs, d), bf, fan_in=fs)]
    return spec


def _mla(p, x, cfg, prec):
    k = _dims(cfg)
    eps, theta = cfg["reference"]["norm_eps"], cfg["rope_theta"]
    q = L.mm("bsd,dhk->bshk", x, p["attn.wq"], prec)
    q = torch.cat([q[..., :k["nope"]], L.rope(q[..., k["nope"]:], theta)],
                  dim=-1)
    kv_a = L.mm("bsd,dk->bsk", x, p["attn.wkv_a"], prec)
    latent = L.rms_norm(kv_a[..., :k["lat"]], p["attn.kv_norm"], eps, _bf16(cfg))
    k_rope = L.rope(kv_a[..., None, k["lat"]:], theta)
    kv = L.mm("bsl,lhk->bshk", latent, p["attn.wkv_b"], prec)
    b, s = x.shape[:2]
    keys = torch.cat([kv[..., :k["nope"]],
                      k_rope.expand(b, s, k["h"], k["rope"])], dim=-1)
    out = L.causal_attention(q, keys, kv[..., k["nope"]:], prec)
    return L.mm("bshv,hvd->bsd", out, p["attn.wo"], prec)


def route_gap(logits, ids, top_k: int) -> torch.Tensor:
    """The widest gap, in router logits, by which an expert that ``ids``
    (T, k) sends a token to lies below the token's k-th best: 0 where
    every token takes its top-k; inf where a token takes an expert
    twice or ``ids`` does not cover the tokens."""
    if ids.shape != (logits.shape[0], top_k) or bool(
            (ids.sort(-1).values.diff(dim=-1) == 0).any()):
        return torch.tensor(float("inf"))
    kth = torch.topk(logits, top_k, dim=-1).values[:, -1]
    return (kth - logits.gather(1, ids).min(-1).values).max().clamp_min(0)


def _moe(p, x, cfg, prec, forced=None, record=None):
    """(routed experts' output + shared experts', balance loss). With
    ``forced`` (T, k) ids, the tokens take those experts (the program's
    routes, which this reference then judges: ``record["gaps"]``); the
    experts chosen go to ``record["ids"]``."""
    k = _dims(cfg)
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    logits = L.mm("td,de->te", xt, p["moe.router"], prec)
    probs = torch.softmax(logits, dim=-1)
    ids = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1).indices
    if forced is not None:
        gap = route_gap(logits.detach(), forced, cfg["num_experts_per_tok"])
        if record is not None:
            record["gaps"].append(float(gap))
        if torch.isfinite(gap):
            ids = forced
    if record is not None:
        record["ids"].append(ids.detach())
    w = probs.gather(1, ids)
    if cfg["reference"]["topk_renormalize"]:
        w = w / w.sum(-1, keepdim=True)
    share = torch.bincount(ids.reshape(-1), minlength=k["e"]).float() \
        / ids.numel()
    aux = k["e"] * torch.sum(probs.mean(0) * share)
    y = torch.zeros_like(xt)
    for e in range(k["e"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = L.glu(xt[tok][None], p["moe.wi"][e], p["moe.wo"][e], "silu",
                  prec)[0]
        y = y.index_add(0, tok, h * w[tok, slot][:, None])
    y = y + L.glu(xt[None], p["shared_mlp.wi"], p["shared_mlp.wo"], "silu",
                  prec)[0]
    return y.reshape(shape), aux


def _layer(params, i, x, cfg, prec, forced=None, record=None):
    p = {n[len(f"layers.{i}."):]: t for n, t in params.items()
         if n.startswith(f"layers.{i}.")}
    eps = cfg["reference"]["norm_eps"]
    x = x + _mla(p, L.rms_norm(x, p["ln1"], eps, _bf16(cfg)), cfg, prec)
    h = L.rms_norm(x, p["ln2"], eps, _bf16(cfg))
    if i < cfg["first_k_dense_replace"]:
        return x + L.glu(h, p["mlp.wi"], p["mlp.wo"], "silu", prec), \
            torch.zeros((), device=x.device)
    y, aux = _moe(p, h, cfg, prec, forced, record)
    return x + y, aux


def loss(params: dict, batch: dict, cfg, prec: str = "fp32", routes=None,
         record=None):
    """(mean next-token cross-entropy, summed balance loss) of
    ``batch`` ({"tokens", "labels"}, (B, S) int64). ``routes``: the
    program's expert ids of this step, one (T, k) a MoE layer in order,
    which the MoE layers take and judge (see :func:`_moe`)."""
    x = params["embed"][batch["tokens"]]
    aux = torch.zeros((), device=x.device)
    dense = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        forced = routes[i - dense] if routes is not None and i >= dense \
            else None
        x, a = L.remat(lambda x_, i_=i, f_=forced: _layer(
            params, i_, x_, cfg, prec, f_, record), x)
        aux = aux + a
    h = L.rms_norm(x, params["final_norm"], cfg["reference"]["norm_eps"],
                   _bf16(cfg))
    logits = L.mm("bsd,dv->bsv", h, params["head"], prec)
    return L.cross_entropy(logits, batch["labels"]), aux


def attention_calls(cfg, traffic) -> list[dict]:
    """The attention calls of one step's forward: one a layer."""
    b, s = traffic["batch"], traffic["seq_len"]
    call = dict(b=b, s=s, h=cfg["num_attention_heads"],
                hkv=cfg["num_attention_heads"],
                dqk=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
                dv=cfg["v_head_dim"])
    return [call] * cfg["num_hidden_layers"]


def ssd_calls(cfg, traffic) -> list[dict]:
    return []


def active_matmul_params(cfg) -> int:
    """Parameters a token multiplies by: the head, each layer's attention
    projections and its dense MLP, or its router, its routed experts
    (``num_experts_per_tok`` of them) and its shared experts."""
    k = _dims(cfg)
    d, h = k["d"], k["h"]
    attn = d * h * (k["nope"] + k["rope"]) + d * (k["lat"] + k["rope"]) \
        + k["lat"] * h * (k["nope"] + k["dv"]) + h * k["dv"] * d
    n = d * k["v"]
    for i in range(cfg["num_hidden_layers"]):
        if i < cfg["first_k_dense_replace"]:
            n += attn + 3 * d * k["f"]
        else:
            n += attn + d * k["e"] + 3 * d * k["fe"] * (
                cfg["num_experts_per_tok"] + k["ns"])
    return n


def flops_per_token(cfg, traffic) -> float:
    """Useful training FLOPs a token (forward and backward, no
    recomputation): 6 times the active matmul parameters, plus the
    attention score and value products over the causally visible keys."""
    attn = sum(3 * 2 * c["h"] * (c["dqk"] + c["dv"]) * (c["s"] + 1) / 2
               for c in attention_calls(cfg, traffic))
    return 6 * active_matmul_params(cfg) + attn
