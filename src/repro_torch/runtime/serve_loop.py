"""Serving: prefill + batched greedy decode with a persistent KV cache.

``make_prefill`` / ``make_serve_step`` build the two entry points (one
new token against the cache per step); ``generate`` drives them. The
model runs eagerly on the device its parameters lie on; decode updates
the cache in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.model import ShardCtx, forward, init_cache


def make_prefill(cfg, ctx: ShardCtx):
    def prefill(params, batch):
        logits, _, cache = forward(params, batch, cfg,
                                   ctx.with_mode("prefill"))
        return logits, cache
    return prefill


def make_serve_step(cfg, ctx: ShardCtx):
    """serve_step(params, cache, token (B,1), pos int) ->
    (next_token (B,1), logits (B,V), cache)."""
    def serve_step(params, cache, token, pos):
        batch = {"tokens": token, "pos": pos, "cache": cache}
        logits, _, cache = forward(params, batch, cfg,
                                   ctx.with_mode("decode"))
        next_token = torch.argmax(logits, dim=-1)[:, None].to(token.dtype)
        return next_token, logits, cache
    return serve_step


def pad_cache_to(cfg, cache, batch: int, max_seq: int):
    """Grow a prefill cache to the serving window (zeros past the filled
    prefix) so decode can run to ``max_seq``: every tensor shorter than
    its shape in :func:`init_cache` is padded at the end of each axis, as
    the reference pads, which grows the sequence axis of the K/V caches
    (B, T, Hkv, D) and of MLA's ``latent`` and ``k_rope`` (B, T, ·);
    Mamba layers' conv tails and states have their shapes already and
    are kept as they are."""
    target = init_cache(cfg, batch, max_seq, device="meta")   # shapes only

    def fit(src, dst):
        if src.shape == dst.shape:
            return src
        pad = []
        for have, want in zip(reversed(src.shape), reversed(dst.shape)):
            pad += [0, want - have]
        return F.pad(src, pad)

    return [{k: fit(src[k], dst[k]) for k in dst}
            for src, dst in zip(cache, target)]


def generate(cfg, ctx, params, prompt_batch, n_tokens: int,
             max_seq: int | None = None) -> torch.Tensor:
    """Greedy generation: prefill the prompt then step the decoder.
    Returns (B, n_tokens) token ids on the prompt's device."""
    prefill = make_prefill(cfg, ctx)
    step = make_serve_step(cfg, ctx)
    prompt = prompt_batch["tokens"]
    b, s = prompt.shape
    max_seq = max_seq or s + n_tokens
    logits, cache = prefill(params, prompt_batch)
    cache = pad_cache_to(cfg, cache, b, max_seq)
    token = torch.argmax(logits, dim=-1)[:, None].to(prompt.dtype)
    out = [token]
    pos = s
    for _ in range(n_tokens - 1):
        token, logits, cache = step(params, cache, token, pos)
        out.append(token)
        pos += 1
    return torch.cat(out, dim=1)
