"""Continuous batching for the serving path.

A fixed pool of decode slots; requests join as slots free up (their
prompt is prefilled into the slot's cache) and leave when finished (EOS
or length budget). Each slot holds a batch of 1 with its own cache and
position, and every tick steps each active slot once — the reference's
discipline, whose model decode takes a scalar position.

A request emits exactly ``max_new`` tokens, fewer when one of them is
``eos_id``: the prefill's token counts, so a request whose prefill token
is its last (``max_new == 1``, or the token is EOS) leaves at its join
and is never decoded. ``generate(n_tokens=max_new)`` gives the same
tokens for the same prompt. (The reference's batcher decodes once more
after such a join and emits two tokens for ``max_new == 1``.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.model import ShardCtx, init_cache
from .serve_loop import make_prefill, make_serve_step, pad_cache_to


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S_p,) int
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False


@dataclass
class Slot:
    active: bool = False
    rid: int = -1
    pos: int = 0
    remaining: int = 0


class ContinuousBatcher:
    """Single-device scheduler over a fixed slot pool, on the device the
    model's parameters lie on."""

    def __init__(self, cfg, params, n_slots: int, max_seq: int,
                 eos_id: int | None = None):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.device = params.embed.device
        ctx = ShardCtx()
        self._prefill = make_prefill(cfg, ctx)
        self._step = make_serve_step(cfg, ctx)
        self.slots = [Slot() for _ in range(n_slots)]
        # one cache per slot (batch dim 1 each keeps joins O(slot))
        self.caches = [init_cache(cfg, 1, max_seq, device=self.device)
                       for _ in range(n_slots)]
        self.tokens = [torch.zeros((1, 1), dtype=torch.long,
                                   device=self.device)
                       for _ in range(n_slots)]
        self.queue: list[Request] = []
        self.by_rid: dict[int, Request] = {}

    # ---- request lifecycle ------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)
        self.by_rid[req.rid] = req

    def _join(self, slot_idx: int, req: Request):
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                                 device=self.device)[None]
        logits, cache = self._prefill(self.params, {"tokens": prompt})
        self.caches[slot_idx] = pad_cache_to(self.cfg, cache, 1,
                                             self.max_seq)
        tok = torch.argmax(logits, dim=-1)[:, None]
        req.out.append(int(tok[0, 0]))
        s = self.slots[slot_idx]
        s.active, s.rid = True, req.rid
        s.pos = int(prompt.shape[1])
        s.remaining = req.max_new - 1
        self.tokens[slot_idx] = tok
        if s.remaining <= 0 or self._is_eos(req.out[-1]):
            self._retire(slot_idx)          # the prefill's token was its last

    def _is_eos(self, t: int) -> bool:
        return self.eos_id is not None and t == self.eos_id

    def _retire(self, slot_idx: int):
        s = self.slots[slot_idx]
        if s.rid >= 0:
            self.by_rid[s.rid].done = True
        s.active, s.rid, s.remaining = False, -1, 0

    # ---- one scheduler tick -------------------------------------------------
    @torch.inference_mode()
    def step(self):
        # fill free slots
        for i, s in enumerate(self.slots):
            if not s.active and self.queue:
                self._join(i, self.queue.pop(0))
        # decode every active slot (per-slot position)
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            tok, logits, cache = self._step(
                self.params, self.caches[i], self.tokens[i], s.pos)
            self.caches[i] = cache
            self.tokens[i] = tok
            s.pos += 1
            s.remaining -= 1
            t = int(tok[0, 0])
            req = self.by_rid[s.rid]
            req.out.append(t)
            if s.remaining <= 0 or self._is_eos(t) or \
                    s.pos >= self.max_seq - 1:
                self._retire(i)

    def run(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(s.active for s in self.slots)) and \
                ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks
