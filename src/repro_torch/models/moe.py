"""Mixture-of-Experts FFN on one device: top-k routing with
softmax-renormalised weights, every expert on every token, a masked
combine.

The reference has three dispatches computing the same math: ``dense``
(this one), and the expert-parallel ``a2a`` (all-to-all over the model
axis, with a capacity model that drops over-capacity tokens) and
``local`` (decode: local experts on replicated tokens, a psum over the
model axis). The last two need a mesh; they and their sort-based
capacity dispatch (``_dispatch_indices``) come with the sharding work of
ROADMAP A13. The port's ``ShardCtx`` holds no mesh, so :func:`moe_ffn`
always takes the dense dispatch, as the reference does when its
``ctx.mesh`` is None; the dense dispatch drops no token.

The expert products are plain large matrix products, which the
reference computes outside any Pallas kernel: here they are
``torch.einsum`` (cuBLAS on the card). Routing runs in float32 whatever
the model's type; the combine sums the experts' outputs in float32 and
casts back to x's type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """x (T, D); w_router (D, E) -> the routing softmax (T, E) float32."""
    return torch.softmax(torch.einsum("td,de->te", x.float(),
                                      w_router.float()), dim=-1)


def route_weights(probs: torch.Tensor, ids: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """probs (T, E) the routing softmax; ids (T, k) int64 the experts each
    token goes to -> (weights (T, k) float32, aux_loss () float32). The
    weights are the chosen experts' probabilities renormalised to sum to
    one; ``aux_loss`` is the Switch load-balancing loss E · sum_e f_e ·
    p_e (f_e the share of the T·k routed copies sent to expert e, p_e
    its mean probability)."""
    weights = probs.gather(1, ids)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    e = probs.shape[1]
    ce = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    ce = ce.index_add_(0, ids.reshape(-1),
                       torch.ones(ids.numel(), dtype=torch.float32,
                                  device=probs.device)) / ids.numel()
    return weights, e * torch.sum(probs.mean(0) * ce)


def router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, D); w_router (D, E) -> (weights (T, k) float32, ids (T, k)
    int64, aux_loss () float32): each token's ``top_k`` most probable
    experts, weighted by :func:`route_weights`."""
    probs = router_probs(x, w_router)
    ids = torch.topk(probs, top_k, dim=-1).indices
    weights, aux = route_weights(probs, ids)
    return weights, ids, aux


def expert_ffn(xe: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
               activation: str) -> torch.Tensor:
    """xe (E, C, D) tokens grouped per expert; wi (E, D, 2, F) fused
    gate+up; wo (E, F, D) -> (E, C, D). ``geglu`` gates with tanh-GELU,
    anything else with SiLU."""
    h = torch.einsum("ecd,edxf->ecxf", xe, wi)
    gate, up = h[:, :, 0], h[:, :, 1]
    act = F.gelu(gate, approximate="tanh") if activation == "geglu" \
        else F.silu(gate)
    return torch.einsum("ecf,efd->ecd", act * up, wo)


def moe_dense(x: torch.Tensor, router: torch.Tensor, wi: torch.Tensor,
              wo: torch.Tensor, top_k: int, activation: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) -> (y (..., D) in x's type, aux_loss). Every expert
    runs on every token; each token's output is its top-k experts'
    outputs weighted by the router, summed in float32."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    weights, ids, aux = router_topk(xt, router, top_k)
    e = router.shape[1]
    # combine weight per (token, expert); the top-k ids of a row differ
    w_te = torch.zeros((xt.shape[0], e), dtype=torch.float32,
                       device=x.device).scatter_add_(1, ids, weights)
    ys = expert_ffn(xt.expand(e, *xt.shape), wi, wo, activation)  # (E,T,D)
    y = torch.einsum("etd,te->td", ys.float(), w_te)
    return y.reshape(shape).to(x.dtype), aux


def moe_ffn(x: torch.Tensor, p, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of a layer's ``moe`` module ``p`` (``router`` (D, E)
    float32, ``wi`` (E, D, 2, F), ``wo`` (E, F, D)): the dense dispatch,
    the only one without a mesh."""
    return moe_dense(x, p.router, p.wi, p.wo, cfg.top_k, cfg.activation)
