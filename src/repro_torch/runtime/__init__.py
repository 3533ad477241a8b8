"""The port's serving runtime: prefill + greedy decode
(``serve_loop``) and continuous batching over a slot pool
(``batching``)."""

from .batching import ContinuousBatcher, Request, Slot
from .serve_loop import generate, make_prefill, make_serve_step, pad_cache_to

__all__ = ["ContinuousBatcher", "Request", "Slot", "generate",
           "make_prefill", "make_serve_step", "pad_cache_to"]
