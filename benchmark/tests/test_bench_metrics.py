"""The benchmark's arithmetic on canned records: percentiles and spreads,
interval unions and idle shares, the walk's and the post kernel's bytes,
and each metric reader."""

import numpy as np
import pytest

from benchmark.harness import cells, report, stats

WALK = "(anonymous namespace)::wide_traverse_closest(walk::Unified, walk::Args)"
POST = "(anonymous namespace)::post_rgba8_kernel(float4 const*, float const*)"
GLUE = "void at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>"


def reader(name):
    return cells._load_py(f"{cells.BENCH_DIR}/metrics/{name}.py",
                          name.replace(".", "_"))


def canned():
    """Two traced frames over [0, 100) us: walks, glue, a post kernel and
    a copy, two overlapping."""
    device = [(WALK, "kernel", 0.0, 10.0), (GLUE, "kernel", 5.0, 10.0),
              (GLUE, "kernel", 20.0, 10.0), (WALK, "kernel", 50.0, 20.0),
              (POST, "kernel", 80.0, 4.0),
              ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 90.0, 2.0)]
    walks = [dict(kernel="wide_traverse", rays=1000, live=600,
                  table_bytes=4096),
             dict(kernel="wide_traverse", rays=1000, live=100,
                  table_bytes=4096)]
    host = [("aten::mul", "cpu_op", 30.0, 25.0),
            ("cudaLaunchKernel", "cuda_runtime", 40.0, 5.0)]
    return dict(frame_s=[0.001 * (i + 1) for i in range(200)],
                display_s=[0.002, 0.001, 0.003], setup_s=12.5, pack_s=1.5,
                window_s=4.0, passes=100, pixels_per_pass=1920 * 1080,
                image_hw=(1080, 1920),
                trace=dict(frames=2, span=(0.0, 100.0), device=device,
                           host=host, walks=walks))


def test_percentile_is_over_every_frame():
    rec = canned()
    assert reader("frame_ms_p95").read(rec) == pytest.approx(
        float(np.percentile(rec["frame_s"], 95)) * 1e3)
    assert reader("frame_ms_p95").read(rec) == pytest.approx(190.05)


def test_rate_is_all_work_over_all_time():
    assert reader("msamples_per_s").read(canned()) == pytest.approx(
        1920 * 1080 * 100 / 4.0 / 1e6)


def test_union_and_gaps_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert stats.union(iv) == [(0, 15), (20, 30)]
    assert stats.covered(iv) == 25
    assert stats.gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    assert stats.covered(stats.clip(iv, 8, 22)) == 9


def test_idle_share_from_one_timeline():
    # busy: [0, 15) + [20, 30) + [50, 70) + [80, 84) + [90, 92) = 51 of 100
    assert reader("device_idle_pct.final").read(canned()) == pytest.approx(49.0)


def test_launches_and_glue_leave_out_nothing_and_own_kernels():
    rec = canned()
    for v in ("final", "preview"):
        assert reader("launches_per_frame." + v).read(rec) == 3.0
        # glue: two elementwise kernels and the copy, 22 us over 2 frames
        assert reader("glue_device_ms." + v).read(rec) == pytest.approx(
            0.011)
    assert reader("device_idle_pct.preview").read(rec) == pytest.approx(49.0)


def test_walk_bytes_and_roofline():
    assert stats.walk_bytes(1000, 600, 4096) == \
        600 * 52 + 400 * 24 + 4096 + 16
    rec = canned()
    least = (stats.walk_bytes(1000, 600, 4096)
             + stats.walk_bytes(1000, 100, 4096)) / 3.35e12
    assert reader("walk_roofline").read(rec) == pytest.approx(
        100 * least / 30e-6)
    # a walk call without its kernel in the trace: no reading
    rec["trace"]["walks"].append(rec["trace"]["walks"][0])
    assert reader("walk_roofline").read(rec) is None


def test_post_bytes_and_roofline():
    assert stats.post_bytes(1080, 1920) == 1080 * 1920 * 20
    assert reader("post_rgba8_roofline").read(canned()) == pytest.approx(
        100 * 1080 * 1920 * 20 / 3.35e12 / 4e-6)


def test_host_clock_readers():
    rec = canned()
    assert reader("display_ms").read(rec) == pytest.approx(2.0)
    assert reader("frame_ms_median").read(rec) == pytest.approx(100.5)
    assert reader("pack_s").read(rec) == 1.5
    assert reader("setup_s").read(rec) == 12.5


def test_readers_find_nothing_without_a_trace():
    rec = canned()
    rec["trace"] = None
    for m in ("launches_per_frame.final", "glue_device_ms.final",
              "walk_roofline", "post_rgba8_roofline", "device_idle_pct.final",
              "launches_per_frame.preview", "glue_device_ms.preview",
              "device_idle_pct.preview"):
        assert reader(m).read(rec) is None


def test_breakdown_labels_gaps_by_the_innermost_host_event():
    tr = canned()["trace"]
    b = report.breakdown(tr, tr)
    gaps = dict(b["idle_gaps"])
    # gap [15, 20): no host event; [30, 50): at its middle (40) the
    # launch runs inside aten::mul, and the launch is the innermost;
    # [70, 80), [84, 90), [92, 100): none
    assert "aten::mul" not in gaps
    assert gaps["cudaLaunchKernel"] == pytest.approx(20e-6)
    assert gaps["no host event (Python between calls)"] == pytest.approx(29e-6)
    ops = dict(b["device_ops"])
    assert ops[WALK] == pytest.approx(30e-6)
