"""The yardstick's counts against hand counts at small shapes, the
configuration files' stated model FLOPs against the counts, and the
trace's interval arithmetic."""

import pytest

import tiny
from harness import registry
from harness import trace as tr

PEAKS = {"bfloat16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}


def test_flash_attention_bwd_work_by_hand():
    fa = registry.module("roofline", "flash_attention_bwd")
    # b 1, s 2 (3 causal pairs), h 1, dqk 4, dv 2: forward products
    # 2 * 3 * (4 + 2) = 36 FLOPs, backward 2.5 x = 90
    flops, bytes_ = fa.work(dict(b=1, s=2, h=1, hkv=1, dqk=4, dv=2),
                            "bfloat16")
    assert flops == 90
    # q 8, k 8, v 4, o 4, do 4 values read, dq 8, dk 8, dv 4 written, at 2
    # bytes; lse 2 values at 4 bytes
    assert bytes_ == 2 * (8 + 8 + 4 + 4 + 4) + 4 * 2 + 2 * (8 + 8 + 4)
    assert fa.seconds(dict(b=1, s=2, h=1, hkv=1, dqk=4, dv=2), "bfloat16",
                      PEAKS) == max(90 / 1e12, bytes_ / 1e9)


def test_ssd_scan_bwd_work_by_hand():
    ssd = registry.module("roofline", "ssd_scan_bwd")
    c = dict(b=1, s=4, h=2, p=3, g=1, n=2, chunk=2)
    flops, bytes_ = ssd.work(c, "bfloat16")
    # 2 chunks of 2 (3 causal pairs): a group 3 products of 2 * 3 * n = 12
    # FLOPs; a head 2 products of 2 * 3 * p = 18 and 5 of 2 * 2 * n * p
    # = 24
    per_chunk = 1 * 3 * 12 + 2 * (2 * 18 + 5 * 24)
    assert flops == 2 * per_chunk
    xs, dts, bcs = 4 * 2 * 3, 4 * 2, 4 * 1 * 2
    assert bytes_ == 2 * (3 * xs + 4 * bcs) + 4 * (2 * dts + 2 * 2)


def test_model_flops_by_hand():
    moe = registry.module("reference", "moe")
    hybrid = registry.module("reference", "hybrid")
    traffic = {"batch": 1, "seq_len": 3}
    cfg = tiny.config(tiny.MOE)
    d, h, v = 64, 4, 256
    attn = d * h * 24 + d * 40 + 32 * h * 32 + h * 16 * d
    dense = attn + 3 * d * 128
    moe_layer = attn + d * 8 + 3 * d * 32 * (2 + 1)
    active = d * v + dense + 2 * moe_layer
    assert moe.active_matmul_params(cfg) == active
    # 3 layers of attention, each token seeing (3 + 1) / 2 keys on average
    assert moe.flops_per_token(cfg, traffic) == \
        6 * active + 3 * 3 * 2 * h * (24 + 16) * 2
    cfg = tiny.config(tiny.HYBRID)
    d2, di, hs, gn = 128, 128, 8, 2 * 16
    mamba = d * (2 * di + 2 * gn + hs) + di * d
    shared = 4 * d2 * 4 * 32 + 3 * (d2 * 4 + 4 * 4 * 32) + 3 * d2 * 128 \
        + d2 * d
    active = 5 * mamba + 2 * shared + d * v
    assert hybrid.active_matmul_params(cfg) == active
    ssd = 2 * hs * (16 * 4.5 + 2 * 16 * 16) + 2 * 2 * 16 * 4.5
    assert hybrid.flops_per_token(cfg, traffic) == pytest.approx(
        6 * active + 2 * 3 * 2 * 4 * 64 * 2 + 5 * 3 * ssd)


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_stated_model_flops_match_the_count(workload):
    bench = registry.benchmark(registry.BENCH.parent)
    cell = registry.cell(bench, workload)
    cfg = registry.config_of(bench, registry.BENCH.parent, cell["config"])
    traffic = registry.data("traffic", cell["traffic"])
    family = registry.module("reference", cfg["family"])
    assert cfg["model_flops_per_token"] == family.flops_per_token(cfg,
                                                                  traffic)


def test_trace_busy_gaps_and_launchers():
    t = tr.Trace(window=(0.0, 10.0), steps=2,
                 device=[tr.Op("k1", 1, 3, corr=5), tr.Op("k2", 2, 4, corr=6),
                         tr.Op("bwd_tc_kernel<64>", 6, 7, corr=6),
                         tr.Op("late", 9.5, 12)],
                 host=[tr.Op("aten::bmm", 0, 5, corr=5,
                             shapes=((8, 2, 2), (8, 2, 2))),
                       tr.Op("aten::mm", 0, 5, corr=6),
                       tr.Op("cudaLaunchKernel", 4.5, 4.6),
                       tr.Op("aten::add", 3.9, 6.5)])
    assert t.busy_s() == pytest.approx(3 + 1 + 0.5)
    assert t.gaps() == [(0.0, 1), (4, 6), (7, 9.5)]
    assert t.device_s(lambda n: n.startswith("k")) == 4
    assert t.device_s_under(lambda op: op.name == "aten::bmm") == 2
    idle = dict(t.idle_by_host())
    assert idle["aten::add"] == pytest.approx(2)
    assert sum(idle.values()) == pytest.approx(10 - 4.5)
    assert t.top_device_ops(1) == [["k1", 2]] or \
        t.top_device_ops(1) == [["k2", 2]]
