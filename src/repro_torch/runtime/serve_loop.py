"""Serving: prefill + batched greedy decode with a persistent KV cache.

``make_prefill`` / ``make_serve_step`` build the two entry points (one
new token against the cache per step); ``generate`` drives them under
``torch.inference_mode()``. The model runs eagerly on the device its
parameters lie on; decode updates the cache in place. A VLM's prompt
carries ``patches`` beside its ``tokens``: the prefill puts the image
prefix first, so decode starts at position ``S + n_patches``.

A model kept by :func:`repro_torch.sharding.shard_params` serves under a
``ShardCtx`` on its mesh, each rank on its data-parallel rows of the
prompt: the caches lie at :meth:`~repro_torch.sharding.Partitioner.
cache_spec`'s layout (:func:`pad_cache_to` with ``part`` cuts the
prefill's cache to this rank's slice), and ``generate`` rounds the
serving window up to a multiple of the model axis so a cache cut over
its slots divides.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.model import ShardCtx, forward, init_cache
from ..sharding.partition import SLOTTED, cache_slices


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


def pad_cache_to(cfg, cache, batch: int, max_seq: int, part=None):
    """Grow a prefill cache to the serving window (zeros past the filled
    prefix) so decode can run to ``max_seq``: every tensor shorter than
    its shape in :func:`init_cache` is padded at the end of each axis, as
    the reference pads, which grows the sequence axis of the K/V caches
    (B, T, Hkv, D) and of MLA's ``latent`` and ``k_rope`` (B, T, ·);
    Mamba layers' conv tails and states have their shapes already and
    are kept as they are. With ``part`` (a tensor-parallel model's
    ``partitioner``), each tensor ends at this rank's slice of its
    :meth:`~repro_torch.sharding.Partitioner.cache_spec`: one cut over
    its T slots (the prefill gives it whole over the prompt) is padded
    whole and cut, one cut over heads (the prefill gives this rank's) is
    padded as it is."""
    target = init_cache(cfg, batch, max_seq, device="meta")   # shapes only

    def fit(src, shape):
        if src.shape == shape:
            return src
        pad = []
        for have, want in zip(reversed(src.shape), reversed(shape)):
            pad += [0, want - have]
        return F.pad(src, pad)

    def place(name, src, whole):
        if part is None:
            return fit(src, whole)
        sl = cache_slices(part, name, tuple(whole))
        if name in SLOTTED and sl[1] != slice(0, whole[1]):
            return fit(src, whole)[:, sl[1]].contiguous()   # over its slots
        return fit(src, torch.Size([s.stop - s.start for s in sl]))

    return [{k: place(k, src[k], dst[k].shape) for k in dst}
            for src, dst in zip(cache, target)]


@torch.inference_mode()
def generate(cfg, ctx, params, prompt_batch, n_tokens: int,
             max_seq: int | None = None) -> torch.Tensor:
    """Greedy generation: prefill the prompt (``tokens``, and
    ``patches`` for a VLM) then step the decoder. Returns (B, n_tokens)
    token ids on the prompt's device."""
    prefill = make_prefill(cfg, ctx)
    step = make_serve_step(cfg, ctx)
    prompt = prompt_batch["tokens"]
    b, s = prompt.shape
    if cfg.frontend == "patch_stub" and "patches" in prompt_batch:
        s += cfg.n_patches                  # the image prefix comes first
    max_seq = max_seq or s + n_tokens
    part = getattr(params, "partitioner", None)
    if part is not None:                    # slots that split evenly
        max_seq = -(-max_seq // part.model_n) * part.model_n
    logits, cache = prefill(params, prompt_batch)
    cache = pad_cache_to(cfg, cache, b, max_seq, part)
    token = torch.argmax(logits, dim=-1)[:, None].to(prompt.dtype)
    out = [token]
    pos = s
    for _ in range(n_tokens - 1):
        token, logits, cache = step(params, cache, token, pos)
        out.append(token)
        pos += 1
    return torch.cat(out, dim=1)
