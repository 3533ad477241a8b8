"""Plain reference of the hybrid family (Zamba2, arXiv:2411.15242),
float32, for training.

Mamba-2 layers (arXiv:2405.21060) in groups of ``shared_every``; each
group is headed by the one shared transformer block, run on the
concatenation of the residual stream and the first embedding (2 d
wide), with a LoRA of rank ``adapter_rank`` on q, k and v of its own a
group, a gated-GELU MLP of ``ffn_hidden_size``, and a projection back
to d. Layers past the last whole group form a tail with no shared
block. The head is the tied embedding. Each departure from the
published config is listed under ``departures`` in the configuration's
file.

The SSD scan is written from its chunked equations: within a chunk the
masked products C B^T (per group) times the decays, across chunks the
states B^T (w x) carried by the chunk's total decay.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

try:
    from . import layers as L
except ImportError:                 # loaded by path, beside layers.py
    import layers as L


def _bf16(cfg) -> bool:
    """Whether the state stores the norm scales in bf16."""
    return cfg["dtype"] == "bfloat16"


def _dims(cfg):
    d = cfg["hidden_size"]
    di = cfg["mamba_expand"] * d
    return dict(d=d, di=di, n=cfg["mamba_d_state"], g=cfg["mamba_ngroups"],
                p=cfg["mamba_headdim"], hs=di // cfg["mamba_headdim"],
                kc=cfg["mamba_d_conv"], h=cfg["num_attention_heads"],
                dh=cfg["attention_head_dim"], r=cfg["adapter_rank"],
                f=cfg["ffn_hidden_size"], v=cfg["vocab_size"])


def groups(cfg) -> tuple[int, int]:
    """(whole groups, tail layers) of the cut depth."""
    every = cfg["reference"]["shared_every"]
    n = cfg["num_hidden_layers"]
    return n // every, n % every


def param_spec(cfg) -> list:
    """The parameter layout, in the order the benchmark draws it."""
    k = _dims(cfg)
    d, d2, bf = k["d"], 2 * k["d"], cfg["dtype"]
    gn = k["g"] * k["n"]
    spec = [L.Leaf("embed", (k["v"], d), bf, fan_in=d),
            L.Leaf("final_norm", (d,), bf, "norm")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        spec += [L.Leaf(p + "ln", (d,), bf, "norm"),
                 L.Leaf(p + "wz", (d, k["di"]), bf, fan_in=d),
                 L.Leaf(p + "wx", (d, k["di"]), bf, fan_in=d),
                 L.Leaf(p + "wB", (d, gn), bf, fan_in=d),
                 L.Leaf(p + "wC", (d, gn), bf, fan_in=d),
                 L.Leaf(p + "wdt", (d, k["hs"]), bf, fan_in=d),
                 L.Leaf(p + "dt_bias", (k["hs"],), "float32", "dt_bias"),
                 L.Leaf(p + "conv_x", (k["kc"], k["di"]), bf,
                        fan_in=k["kc"]),
                 L.Leaf(p + "conv_B", (k["kc"], gn), bf, fan_in=k["kc"]),
                 L.Leaf(p + "conv_C", (k["kc"], gn), bf, fan_in=k["kc"]),
                 L.Leaf(p + "A_log", (k["hs"],), "float32", "A_log"),
                 L.Leaf(p + "D", (k["hs"],), "float32", "one"),
                 L.Leaf(p + "gate_norm", (k["di"],), bf, "norm"),
                 L.Leaf(p + "wout", (k["di"], d), bf, fan_in=k["di"])]
    spec += [L.Leaf("shared.ln1", (d2,), bf, "norm"),
             L.Leaf("shared.ln2", (d2,), bf, "norm"),
             L.Leaf("shared.down", (d2, d), bf, fan_in=d2),
             L.Leaf("shared.attn.wq", (d2, k["h"], k["dh"]), bf, fan_in=d2),
             L.Leaf("shared.attn.wk", (d2, k["h"], k["dh"]), bf, fan_in=d2),
             L.Leaf("shared.attn.wv", (d2, k["h"], k["dh"]), bf, fan_in=d2),
             L.Leaf("shared.attn.wo", (k["h"], k["dh"], d2), bf,
                    fan_in=k["h"] * k["dh"]),
             L.Leaf("shared.mlp.wi", (d2, 2, k["f"]), bf, fan_in=d2),
             L.Leaf("shared.mlp.wo", (k["f"], d2), bf, fan_in=k["f"])]
    for r in range(groups(cfg)[0]):
        p = f"shared.lora.{r}."
        spec += [L.Leaf(p + "a", (3, d2, k["r"]), bf, fan_in=d2)]
        spec += [L.Leaf(p + b, (k["r"], k["h"], k["dh"]), bf, fan_in=k["r"])
                 for b in ("b_q", "b_k", "b_v")]
    return spec


def ssd(x, dt, A, B, C, chunk: int, prec: str):
    """The SSD scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t
    h_t from h_0 = 0, chunked. x (b, S, H, P), dt (b, S, H), A (H,),
    B and C (b, S, G, N), head h reading group h // (H / G); S a
    multiple of ``chunk``. Returns y (b, S, H, P)."""
    b, s, h, pd = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, q = s // chunk, chunk
    x = x.reshape(b, nc, q, h, pd)
    dt = dt.reshape(b, nc, q, h)
    grp = torch.arange(h, device=x.device) // (h // g)
    Bh = B.reshape(b, nc, q, g, n)[:, :, :, grp]           # (b,c,q,H,N)
    Ch = C.reshape(b, nc, q, g, n)[:, :, :, grp]
    cs = torch.cumsum(dt * A, dim=2)                        # (b,c,q,H)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # (b,c,l,s,H)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal[None, None, :, :, None], torch.exp(
        seg.masked_fill(~causal[None, None, :, :, None], 0.0)), 0.0)
    cb = L.mm("bclgn,bcsgn->bclsg", C.reshape(b, nc, q, g, n),
              B.reshape(b, nc, q, g, n), prec)[..., grp]   # (b,c,l,s,H)
    m = cb * decay * dt[:, :, None, :, :]
    y = L.mm("bclsh,bcshp->bclhp", m, x, prec)
    w = torch.exp(cs[:, :, -1:] - cs) * dt                  # (b,c,q,H)
    states = L.mm("bcshn,bcshp->bchpn", Bh, x * w[..., None], prec)
    carried = [torch.zeros_like(states[:, 0])]
    for c in range(nc - 1):
        carried.append(carried[-1] * torch.exp(cs[:, c, -1])[..., None, None]
                       + states[:, c])
    h_in = torch.stack(carried, dim=1)                      # (b,c,H,P,N)
    y = y + L.mm("bclhn,bchpn->bclhp", Ch, h_in, prec) \
        * torch.exp(cs)[..., None]
    return y.reshape(b, s, h, pd)


def _conv(x, w):
    """Depthwise causal convolution of x (b, S, C) by w (K, C)."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + s] * w[i] for i in range(k))


def _mamba(params, i, x, cfg, prec):
    p = {n[len(f"layers.{i}."):]: t for n, t in params.items()
         if n.startswith(f"layers.{i}.")}
    k = _dims(cfg)
    b, s, _ = x.shape
    eps = cfg["reference"]["norm_eps"]
    hid = L.rms_norm(x, p["ln"], eps, _bf16(cfg))
    z = L.mm("bsd,de->bse", hid, p["wz"], prec)
    xs = F.silu(_conv(L.mm("bsd,de->bse", hid, p["wx"], prec), p["conv_x"]))
    Bs = F.silu(_conv(L.mm("bsd,de->bse", hid, p["wB"], prec), p["conv_B"]))
    Cs = F.silu(_conv(L.mm("bsd,de->bse", hid, p["wC"], prec), p["conv_C"]))
    dt = F.softplus(L.mm("bsd,dh->bsh", hid, p["wdt"], prec) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, s, k["hs"], k["p"])
    y = ssd(xh, dt, A, Bs.reshape(b, s, k["g"], k["n"]),
            Cs.reshape(b, s, k["g"], k["n"]), cfg["chunk_size"], prec)
    y = (y + xh * p["D"][:, None]).reshape(b, s, k["di"]) * F.silu(z)
    y = L.rms_norm(y, p["gate_norm"], eps, _bf16(cfg))
    return x + L.mm("bse,ed->bsd", y, p["wout"], prec)


def _shared(params, r, x, emb0, cfg, prec):
    p = {n[len("shared."):]: t for n, t in params.items()
         if n.startswith("shared.") and ".lora." not in n}
    lora = {n[len(f"shared.lora.{r}."):]: t for n, t in params.items()
            if n.startswith(f"shared.lora.{r}.")}
    eps, theta = cfg["reference"]["norm_eps"], cfg["rope_theta"]
    h0 = torch.cat([x, emb0], dim=-1)
    h = L.rms_norm(h0, p["ln1"], eps, _bf16(cfg))

    def proj(i, w, b):
        return L.mm("bsd,dhk->bshk", h, p[w], prec) + L.mm(
            "bsr,rhk->bshk", L.mm("bsd,dr->bsr", h, lora["a"][i], prec),
            lora[b], prec)
    q = L.rope(proj(0, "attn.wq", "b_q"), theta)
    kk = L.rope(proj(1, "attn.wk", "b_k"), theta)
    out = L.causal_attention(q, kk, proj(2, "attn.wv", "b_v"), prec)
    h1 = h0 + L.mm("bshk,hkd->bsd", out, p["attn.wo"], prec)
    h1 = h1 + L.glu(L.rms_norm(h1, p["ln2"], eps, _bf16(cfg)), p["mlp.wi"],
                    p["mlp.wo"], cfg["reference"]["mlp_activation"], prec)
    return x + L.mm("bse,ed->bsd", h1, p["down"], prec)


def loss(params: dict, batch: dict, cfg, prec: str = "fp32", routes=None,
         record=None):
    """(mean next-token cross-entropy, 0: no balance loss) of ``batch``
    ({"tokens", "labels"}, (B, S) int64)."""
    x = params["embed"][batch["tokens"]]
    emb0 = x
    every = cfg["reference"]["shared_every"]
    n_rep, tail = groups(cfg)
    for r in range(n_rep):
        x = L.remat(lambda x_, r_=r: _shared(params, r_, x_, emb0, cfg,
                                             prec), x)
        for j in range(every):
            x = L.remat(lambda x_, i_=r * every + j: _mamba(
                params, i_, x_, cfg, prec), x)
    for j in range(tail):
        x = L.remat(lambda x_, i_=n_rep * every + j: _mamba(
            params, i_, x_, cfg, prec), x)
    h = L.rms_norm(x, params["final_norm"], cfg["reference"]["norm_eps"],
                   _bf16(cfg))
    logits = L.mm("bsd,vd->bsv", h, params["embed"], prec)
    return L.cross_entropy(logits, batch["labels"]), \
        torch.zeros((), device=x.device)


def attention_calls(cfg, traffic) -> list[dict]:
    """The attention calls of one step's forward: one a use of the
    shared block."""
    k = _dims(cfg)
    call = dict(b=traffic["batch"], s=traffic["seq_len"], h=k["h"],
                hkv=k["h"], dqk=k["dh"], dv=k["dh"])
    return [call] * groups(cfg)[0]


def ssd_calls(cfg, traffic) -> list[dict]:
    """The SSD scans of one step's forward: one a Mamba-2 layer."""
    k = _dims(cfg)
    call = dict(b=traffic["batch"], s=traffic["seq_len"], h=k["hs"],
                p=k["p"], g=k["g"], n=k["n"], chunk=cfg["chunk_size"])
    return [call] * cfg["num_hidden_layers"]


def active_matmul_params(cfg) -> int:
    """Parameters a token multiplies by: every Mamba-2 layer's
    projections, the shared block's (attention, LoRA, MLP, down) at each
    use, and the tied head."""
    k = _dims(cfg)
    d, d2 = k["d"], 2 * k["d"]
    mamba = d * (2 * k["di"] + 2 * k["g"] * k["n"] + k["hs"]) + k["di"] * d
    shared = 4 * d2 * k["h"] * k["dh"] \
        + 3 * (d2 * k["r"] + k["r"] * k["h"] * k["dh"]) \
        + 3 * d2 * k["f"] + d2 * d
    return cfg["num_hidden_layers"] * mamba + groups(cfg)[0] * shared \
        + d * k["v"]


def ssd_products_per_token(c) -> float:
    """Forward FLOPs a token of one SSD scan's products: within its chunk
    C B^T (a group) and the masked product with x (a head) over the
    causally visible positions, and the chunk state's two products (a
    head)."""
    vis = (c["chunk"] + 1) / 2
    return 2 * c["h"] * (c["p"] * vis + 2 * c["n"] * c["p"]) \
        + 2 * c["g"] * c["n"] * vis


def flops_per_token(cfg, traffic) -> float:
    """Useful training FLOPs a token (forward and backward, no
    recomputation): 6 times the active matmul parameters, plus the
    shared attention's score and value products over the causally
    visible keys, plus the SSD scans' products."""
    attn = sum(3 * 2 * c["h"] * (c["dqk"] + c["dv"]) * (c["s"] + 1) / 2
               for c in attention_calls(cfg, traffic))
    ssd = sum(3 * ssd_products_per_token(c) for c in ssd_calls(cfg, traffic))
    return 6 * active_matmul_params(cfg) + attn + ssd
