"""``train_mfu`` (%): the model's useful FLOPs a token (the reference
family's ``flops_per_token``: no recomputation, the routed experts a
token takes and no others) times the window's tokens/s, over the
device's dense peak in the configuration's type."""


def read(run):
    peak = run.peak_flops()
    if not peak:
        return None
    flops = run.family.flops_per_token(run.config, run.traffic)
    return 100.0 * flops * run.tokens_per_s / peak
