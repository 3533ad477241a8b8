"""The work of one attention backward call, whatever computes it: 2.5
times the forward's two products (Q K^T and P V) over the causally
unmasked pairs, and Q, K, V, O, dO and the log-sum-exp read once, dQ,
dK and dV written once. ``call``: ``b``, ``s``, ``h`` (query heads),
``hkv``, ``dqk``, ``dv``."""

BYTES = {"bfloat16": 2, "float32": 4}


def work(call: dict, dtype: str) -> tuple[float, float]:
    """(FLOPs, bytes) of one call."""
    b, s, h, hkv = call["b"], call["s"], call["h"], call["hkv"]
    dqk, dv = call["dqk"], call["dv"]
    pairs = s * (s + 1) / 2
    flops = 2.5 * 2 * b * h * pairs * (dqk + dv)
    e = BYTES[dtype]
    q, k, v, o = b * s * h * dqk, b * s * hkv * dqk, b * s * hkv * dv, \
        b * s * h * dv
    bytes_ = e * (q + k + v + o + o) + 4 * b * h * s + e * (q + k + v)
    return flops, bytes_


def seconds(call: dict, dtype: str, peaks: dict) -> float:
    """The least time: the larger of FLOPs over the dense peak and bytes
    over the memory bandwidth."""
    flops, bytes_ = work(call, dtype)
    return max(flops / peaks[f"{dtype}_flops_per_s"],
               bytes_ / peaks["hbm_bytes_per_s"])
