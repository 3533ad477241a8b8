"""``moe_expert_ms_per_step`` (ms): device time a profiled step of the
batched matrix products with an operand of the routed experts' count in
front, (E, ., .), forward and backward: the expert products of the MoE
layers, picked by their launching ``aten::bmm``'s input shapes (read in
the profiled window that records them)."""

NEEDS_SHAPES = True
OPS = ("aten::bmm",)


def read(run):
    e = run.config.get("n_routed_experts")
    t = run.shapes_trace
    if not e or t is None:
        return None

    def expert_product(op):
        return op.name in OPS and any(len(s) == 3 and s[0] == e
                                      for s in op.shapes)
    s = t.device_s_under(expert_product)
    return 1e3 * s / t.steps if s > 0 else None
