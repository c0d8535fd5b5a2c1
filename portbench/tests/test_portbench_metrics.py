"""The arithmetic of the metrics on synthetic inputs: interval unions and
idle gaps, tails over every sample, FLOP and byte counts against hand
sums, and each reader on a made-up run record."""
import numpy as np
import pytest

from harness import common, costs, serve, trace, trafficgen
from harness.common import metric_reader


def test_union_merges_overlaps_once():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (10, 11)]
    assert trace.union(iv) == [(0, 3), (5, 7), (10, 11)]
    busy = sum(e - s for s, e in trace.union(iv))
    assert busy == 3 + 2 + 1          # overlapping kernels count once


def test_gaps_inside_window():
    busy = [(1, 3), (5, 7)]
    assert trace.gaps(busy, 0, 10) == [(0, 1), (3, 5), (7, 10)]
    assert trace.gaps(busy, 2, 6) == [(3, 5)]
    assert trace.gaps([], 0, 4) == [(0, 4)]


def test_label_gaps_innermost_open_op():
    host = [(0, 100, "outer"), (10, 20, "inner"), (50, 60, "late")]
    gs = [(12, 14), (30, 32), (55, 57), (200, 210)]
    assert trace.label_gaps(gs, host) == ["inner", "outer", "late",
                                          trace.NO_OP]


def _trace_events(span=True):
    ev = [{"ph": "X", "name": "k1", "cat": "kernel", "ts": 100, "dur": 200},
          {"ph": "X", "name": "k2", "cat": "kernel", "ts": 250, "dur": 100},
          {"ph": "X", "name": "k1", "cat": "kernel", "ts": 900, "dur": 200},
          {"ph": "X", "name": "aten::mm", "cat": "cpu_op", "ts": 0,
           "dur": 90},
          {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
           "ts": 400, "dur": 400}]
    if span:
        ev.append({"ph": "X", "name": trace.WINDOW_SPAN,
                   "cat": "user_annotation", "ts": 0, "dur": 1000})
    return {"traceEvents": ev}


def test_device_window_busy_and_top():
    s = trace.device_window(_trace_events(span=False))
    # first device op 100, last ends 1100; union 100-350 and 900-1100
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx(450e-6)
    assert dict(s["device_ops"]) == pytest.approx({"k1": 400e-6,
                                                   "k2": 100e-6})
    assert trace.device_window({"traceEvents": []}) is None


def test_idle_by_host_op_inside_the_span():
    idle = dict(trace.idle_by_host_op(_trace_events()))
    # busy 100-350 and 900-1000 in the span 0-1000; a gap is labelled
    # whole by the host op open at its midpoint
    assert idle == pytest.approx({"aten::mm": 100e-6,
                                  "cudaLaunchKernel": 550e-6})


def test_percentile_is_numpy_linear_over_all_samples():
    rng = np.random.default_rng(0)
    xs = rng.lognormal(size=1001).tolist()
    for q in (50, 95, 99):
        assert common.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))
    assert common.percentile([], 95) is None


def test_paged_decode_bytes_and_flops_by_hand():
    # two rows of 3 and 5 keys, 4 query heads over 2 KV heads of 8, bf16
    b = costs.paged_decode_bytes([3, 5], 4, 2, 8, 2, page_table_row=16)
    kv = 2 * (3 + 5) * 2 * 8 * 2
    qo = 2 * (2 * 4 * 8 * 2)
    assert b == kv + qo + 2 * 16
    assert costs.paged_decode_flops([3, 5], 4, 8) == 4 * 4 * 8 * 8


def test_serve_flops_by_hand():
    assert costs.serve_flops(10, 3, 7, 2, 4, 8) == 2 * 10 * 3 + \
        4 * 2 * 4 * 8 * 7


def _run():
    conf = {"num_hidden_layers": 2, "num_attention_heads": 4,
            "hidden_size": 32}
    return {"conf": conf, "setup_s": 12.5, "window_s": 2.0, "ticks": 4,
            "tick_s": [0.1, 0.2, 0.3, 0.4], "tokens": 50,
            "ttft_s": [1.0, 2.0], "itl_s": [0.1] * 19 + [0.5],
            "processed": 40, "slots": 10, "max_len": 20, "len_sum": 200,
            "context_sum": 240, "matmul_params": 1000, "peak_bytes": 40,
            "device_total_bytes": 80,
            "trace": {"busy_s": 0.3, "window_s": 0.4,
                      "device_seconds_by_name": {
                          "void decode_fused_mma<1>(x)": 2e-6,
                          "gemm": 1.0}},
            "decode_attn": {"bytes": 3.35e6, "flops": 0.0}}


def test_readers_on_a_made_up_run():
    r = _run()
    assert metric_reader("setup_s")(r) == 12.5
    assert metric_reader("serve_tok_s")(r) == 25.0
    assert metric_reader("ttft_p95_ms")(r) == pytest.approx(1950.0)
    assert metric_reader("itl_p95_ms")(r) == pytest.approx(
        float(np.percentile(r["itl_s"], 95)) * 1e3)
    assert metric_reader("tick_ms_p50.serve")(r) == pytest.approx(250.0)
    assert metric_reader("kv_used_share.serve")(r) == pytest.approx(
        100 * 200 / (4 * 10 * 20))
    flops = 2 * 1000 * 40 + 4 * 2 * 4 * 8 * 240
    assert metric_reader("mfu.serve")(r) == pytest.approx(
        100 * flops / (2.0 * 989e12))
    # 3.35 MB at 3.35 TB/s is 1 us, over 2 us of the decode kernel
    assert metric_reader("decode_attn_roofline.serve")(r) == \
        pytest.approx(50.0)
    assert metric_reader("device_idle_share.serve")(r) == pytest.approx(25.0)
    assert metric_reader("peak_mem_share.serve")(r) == pytest.approx(50.0)


def test_readers_find_nothing_return_nothing():
    r = _run()
    r.update(trace=None, peak_bytes=None)
    del r["len_sum"], r["context_sum"]
    for name in ("kv_used_share.serve", "mfu.serve",
                 "decode_attn_roofline.serve", "device_idle_share.serve",
                 "peak_mem_share.serve"):
        assert metric_reader(name)(r) is None, name
    r["trace"] = {"busy_s": 0.0, "window_s": 1.0,
                  "device_seconds_by_name": {}}
    r["decode_attn"] = {"bytes": 1.0, "flops": 1.0}
    assert metric_reader("decode_attn_roofline.serve")(r) is None
    assert metric_reader("device_idle_share.serve")(r) is None


def test_a_split_quantity_shares_its_reader():
    r = _run()
    assert metric_reader("tick_ms_p50.open")(r) == \
        metric_reader("tick_ms_p50.serve")(r) == \
        metric_reader("tick_ms_p50")(r)


@pytest.mark.parametrize("spec", [
    {"mean": 19.31, "sigma": 0.8, "min": 4, "max": 128},
    {"mean": 58.45, "sigma": 0.8, "min": 4, "max": 256},
    {"mean": 8, "sigma": 0.6, "min": 2, "max": 24}])
def test_length_pool_has_the_published_mean(spec):
    pool = trafficgen.length_pool(spec, 4096)
    assert abs(pool.mean() - spec["mean"]) < 0.01
    assert pool.min() >= spec["min"] and pool.max() <= spec["max"]
    assert (np.diff(pool) >= 0).all()


def test_every_seed_offers_the_same_sizes_and_gaps():
    mix = serve.settings({"rate_rps": 50.0, "first_wave": 0,
                          "prompt_len": {"mean": 19.31, "sigma": 0.8,
                                         "min": 4, "max": 128},
                          "output_len": {"mean": 58.45, "sigma": 0.8,
                                         "min": 4, "max": 256}})
    assert mix["max_len"] == 384 and mix["batch_slots"] == 512
    a, b = (trafficgen.Traffic(mix, s, 1000) for s in (1, 2**31 + 5))
    assert sorted(a.pairs) == sorted(b.pairs) and a.pairs != b.pairs
    assert sorted(a.gaps) == sorted(b.gaps)
    assert abs(np.mean(a.gaps) - 1 / 50.0) < 1e-3
