"""The work of one SSD scan backward call, counted from the chunked
scan's own equations at the call's chunk L, whatever computes it.

Per batch row and chunk: each group recomputes C B^T over the L(L+1)/2
causal pairs and forms dC and dB from it (3 products); each head forms
the gradients of the masked product with x (2 products over the causal
pairs), recomputes its chunk state B^T (w x) and forms its two
gradients (3 products of L N P), and forms both gradients of the
carried state's output C h (2 products of L N P). Bytes: x, dt, A, B,
C and dy read once; dx, ddt, dA, dB and dC written once; dt, ddt, A
and dA in float32. ``call``: ``b``, ``s``, ``h``, ``p``, ``g``, ``n``,
``chunk``."""

BYTES = {"bfloat16": 2, "float32": 4}


def work(call: dict, dtype: str) -> tuple[float, float]:
    """(FLOPs, bytes) of one call."""
    b, s, h, p = call["b"], call["s"], call["h"], call["p"]
    g, n, q = call["g"], call["n"], call["chunk"]
    chunks = -(-s // q)
    pairs = q * (q + 1) / 2
    per_chunk = g * 3 * 2 * pairs * n \
        + h * (2 * 2 * pairs * p + 5 * 2 * q * n * p)
    flops = b * chunks * per_chunk
    e = BYTES[dtype]
    xs, dts, bcs = b * s * h * p, b * s * h, b * s * g * n
    reads = e * (2 * xs + 2 * bcs) + 4 * (dts + h)     # x, dy, B, C; dt, A
    writes = e * (xs + 2 * bcs) + 4 * (dts + h)        # dx, dB, dC; ddt, dA
    return flops, reads + writes


def seconds(call: dict, dtype: str, peaks: dict) -> float:
    flops, bytes_ = work(call, dtype)
    return max(flops / peaks[f"{dtype}_flops_per_s"],
               bytes_ / peaks["hbm_bytes_per_s"])
