"""Data pipeline: seeded synthetic token/patch/frame streams, placement
on an explicit device, and background prefetch.

A copy of the reference's ``data/pipeline.py``. The stream is a
deterministic function of (seed, step), drawn with NumPy exactly as the
reference draws it, so the two packages' batches are equal array for
array and a restart resumes mid-epoch by construction (the checkpoint
stores the step). Tokens follow a rank-based Zipf unigram so the
cross-entropy trajectory is non-degenerate.

Batches are dicts of tensors on ``device``: token ids and labels as
int64 (the reference's int32 values), patches and frames as float32.
For a CUDA device each array goes through pinned host memory and is
copied without blocking.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PipelineConfig:
    batch: int
    seq_len: int
    seed: int = 0
    prefetch: int = 2
    zipf_a: float = 1.2


class TokenPipeline:
    """Iterator of {"tokens", "labels"} (+ "patches" for the VLM; the
    encoder's {"frames", "labels"}) on ``device``."""

    def __init__(self, cfg, pcfg: PipelineConfig, device="cpu",
                 start_step: int = 0):
        self.cfg = cfg
        self.pcfg = pcfg
        self.device = torch.device(device)
        self.step = start_step
        # fixed rank-based Zipf unigram over the vocab: p_i ∝ (i+1)^-a with
        # a seeded random rank permutation (as the reference)
        if cfg.vocab:
            rng = np.random.default_rng(pcfg.seed)
            n = min(cfg.vocab, 65536)
            w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** pcfg.zipf_a
            w = w[rng.permutation(n)]
            self.unigram = w / w.sum()

    def _tokens(self, rng, shape):
        idx = rng.choice(len(self.unigram), size=shape, p=self.unigram)
        return idx.astype(np.int32) % max(1, self.cfg.vocab)

    def make_batch(self, step: int) -> dict:
        """The batch of ``step``: the reference's NumPy arrays, on the
        device."""
        cfg, p = self.cfg, self.pcfg
        rng = np.random.default_rng((p.seed, step))
        b, s = p.batch, p.seq_len
        if cfg.frontend == "frame_stub":
            frames = rng.standard_normal((b, s, cfg.d_model)).astype(
                np.float32)
            labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
            arrays = {"frames": frames, "labels": labels}
        elif cfg.frontend == "patch_stub":
            st = s - cfg.n_patches
            toks = self._tokens(rng, (b, st + 1))
            patches = rng.standard_normal((b, cfg.n_patches, cfg.d_model)
                                          ).astype(np.float32)
            arrays = {"patches": patches, "tokens": toks[:, :-1],
                      "labels": toks[:, 1:]}
        else:
            toks = self._tokens(rng, (b, s + 1))
            arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        out = {}
        for k, a in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            if t.dtype == torch.int32:
                t = t.long()
            if self.device.type == "cuda":
                out[k] = t.pin_memory().to(self.device, non_blocking=True)
            else:
                out[k] = t.to(self.device)
        return out

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self.make_batch(self.step)
        self.step += 1
        return batch


class Prefetcher:
    """A background thread that synthesises the next ``depth`` batches
    while the device runs the step (the single-host stand-in for a
    per-host input service)."""

    def __init__(self, pipeline: TokenPipeline, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.pipeline = pipeline
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self.thread.start()

    def _fill(self):
        while not self._stop.is_set():
            batch = next(self.pipeline)
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        """Stop the thread and wait for it."""
        self._stop.set()
        self.thread.join()
