"""The trace reader and the per-layer readers on a hand-made trace, and
the byte arithmetic of the rooflines."""
import types

import pytest

from sortbench import devtrace, harness, roofline

NAMES = {"fused_pass_kernel", "hist_kernel", "rows_kernel"}


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
    """Two calls of 100 us.  Call 0: a histogram, a torch fill, the first
    fused pass (20 us), a second one; call 1: the fused pass (40 us)."""
    return [
        _ev("user_annotation", devtrace.CALL_SPAN, 0.0, 100.0),
        _ev("user_annotation", devtrace.CALL_SPAN, 100.0, 100.0),
        _ev("cpu_op", "aten::nonzero", 5.0, 30.0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 20.0, 10.0),
        _ev("kernel", "void hist_kernel<int, true>(int const*)", 1.0, 4.0),
        _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
            10.0, 5.0),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 12.0, 1.0),
        _ev("kernel", "void (anonymous namespace)::fused_pass_kernel<unsigned"
            " int, 1>(PassArgs)", 40.0, 20.0),
        _ev("kernel", "_ZN12_GLOBAL__N_117fused_pass_kernelIjLi1EEEvv",
            70.0, 10.0),
        _ev("kernel", "void fused_pass_kernel<int>(PassArgs)", 120.0, 40.0),
        _ev("kernel", "void outside_the_window()", 300.0, 5.0),
    ]


def _trace():
    return devtrace.DeviceTrace(_events(), NAMES)


def test_calls_window_and_busy():
    tr = _trace()
    assert tr.n_calls == 2
    assert tr.window_s == pytest.approx(200e-6)
    assert len(tr.device) == 6            # the last kernel is outside
    # union: [1,5] [10,15] (the copy inside it) [40,60] [70,80] [120,160]
    assert tr.busy_s == pytest.approx(79e-6)
    assert tr.port_kernel_launches() == 4
    assert [d["call"] for d in tr.device] == [0, 0, 0, 0, 0, 1]


def test_idle_gaps_and_breakdown():
    tr = _trace()
    gaps = tr.idle_gaps()
    assert gaps[0] == (0.0, 1.0) and gaps[-1] == (160.0, 200.0)
    assert sum(b - a for a, b in gaps) * 1e-6 == pytest.approx(
        tr.window_s - tr.busy_s)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].endswith("fused_pass_kernel<int>")
    names = dict(bd["idle_gaps"])
    # the gap [15, 40) is named by the op running at its middle, the
    # innermost one: the copy's runtime call inside aten::nonzero
    assert names["cudaMemcpyAsync"] == pytest.approx(25e-6)
    assert "host between operators" in names
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def _run(trace=None, walls=None, records=1000, record_bytes=8,
         bandwidth=1e9):
    run = types.SimpleNamespace(records=records, record_bytes=record_bytes,
                                bandwidth=bandwidth)
    if trace is not None:
        run.traced = harness.Traced(trace, {"host_reads": 8,
                                            "kernel_launches": 5})
    if walls is not None:
        run.window = harness.Window()
        run.window.walls = walls
    return run


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_per_layer_readers():
    run = _run(_trace())
    assert _read("host_reads_per_sort", run) == 4
    assert _read("launches_per_sort", run) == 3.0
    assert _read("kernel_device_ms", run) == pytest.approx(74e-3 / 2)
    assert devtrace.short_name("void (anonymous namespace)::k<int, 1>("
                               "PassArgs<int, 1>)") == \
        "(anonymous namespace)::k<int, 1>"
    assert _read("plan_device_ms", run) == pytest.approx(6e-3 / 2)
    assert _read("host_gap_ms", run) == pytest.approx(121e-3 / 2)
    assert _read("device_idle_pct", run) == pytest.approx(60.5)
    # first fused pass of each call: 20 us and 40 us; 16 000 bytes each
    assert _read("fused_pass0_roofline", run) == pytest.approx(
        100 * 32000 / 1e9 / 60e-6)


def test_readers_stay_silent_without_device_events():
    events = [e for e in _events() if e["cat"] not in devtrace.DEVICE_CATS]
    run = _run(devtrace.DeviceTrace(events, NAMES))
    for name in ("host_gap_ms", "plan_device_ms", "kernel_device_ms",
                 "launches_per_sort", "device_idle_pct",
                 "fused_pass0_roofline"):
        assert _read(name, run) is None, name


def test_sort_roofline_and_bytes():
    assert roofline.sort_bytes(2**28, 8) == 2**32
    assert roofline.sort_bytes(2**27, 16) == 2**32
    run = _run(_trace(), records=1000, record_bytes=8)
    # 16 000 bytes a call, two calls, over the 79 us in which the device
    # was busy, at 1 GB/s
    assert _read("sort_roofline", run) == pytest.approx(100 * 32000 / 1e9 /
                                                        79e-6)
    events = [e for e in _events() if e["cat"] not in devtrace.DEVICE_CATS]
    assert _read("sort_roofline", _run(devtrace.DeviceTrace(
        events, NAMES))) is None
    assert roofline.share_pct(1.0, 1.0, None) is None
    assert roofline.share_pct(1.0, 0.0, 1e9) is None
    assert roofline.peak_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak_bandwidth("cpu") is None


def test_end_to_end_readers():
    w = harness.Window()
    w.walls = [0.01] * 19 + [0.05]
    w.start, w.end = 0.0, 0.25
    w.peaks = [10, 30, 20]
    run = types.SimpleNamespace(window=w, records=1000, input_bytes=10,
                                setup_s=4.5)
    assert _read("records_per_s", run) == pytest.approx(20 * 1000 / 0.25 /
                                                        1e6)
    assert 10.0 <= _read("call_p95_ms", run) <= 50.0
    assert _read("peak_mem_x", run) == 3.0
    assert _read("setup_s", run) == 4.5


def test_kernel_names_of_the_program():
    names = harness.load_module("entries", "hybrid_sort").kernel_names()
    assert {"fused_pass_kernel", "hist_kernel", "segments_kernel",
            "merge_rows_kernel"} <= names
    match = devtrace.name_matcher(names)
    assert match("void (anonymous namespace)::segments_kernel<unsigned "
                 "int, 256>(unsigned int*, SegArgs)")
    assert not match("void at::native::merge_rows_kernelx()")
    assert not match("void cub::DeviceRadixSortOnesweepKernel<>()")


def test_triton_kernels_are_the_programs_too(tmp_path):
    """A Triton kernel the program adds counts as the program's: its name
    is found in the package's Python sources, and its launches are the
    port's in the trace (and so held to the program's own count)."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "a.cu").write_text(
        "__global__ void hist_kernel(int* a) {}\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "plan.py").write_text(
        "import triton\nimport triton.language as tl\n"
        "from triton import jit\n\n"
        "@triton.jit\ndef _scan_kernel(x_ptr, n: tl.constexpr):\n"
        "    pass\n\n"
        "@triton.autotune(configs=[], key=[])\n@triton.jit()\n"
        "def tuned_kernel(x):\n    pass\n\n"
        "@jit\ndef bare(x):\n    pass\n\n"
        "def not_a_kernel(x):\n    pass\n")
    names = devtrace.port_kernel_names(tmp_path)
    assert names == {"hist_kernel", "_scan_kernel", "tuned_kernel", "bare"}
    events = _events() + [_ev("kernel", "_scan_kernel", 130.0, 5.0),
                          _ev("kernel", "tuned_kernel", 170.0, 5.0)]
    tr = devtrace.DeviceTrace(events, names | NAMES)
    assert tr.port_kernel_launches() == 6
    assert _read("kernel_device_ms", _run(tr)) == pytest.approx(84e-3 / 2)


def test_global_names_skip_launch_bounds():
    src = """
    template <typename K> __global__ void __launch_bounds__(T, (f<K, T>()))
    first_kernel(K* a) {}
    __global__ void second(int* b) {}
    __global__ void __launch_bounds__(256)
    third_kernel(const int* c) {}
    """
    assert devtrace.global_names(src) == {"first_kernel", "second",
                                          "third_kernel"}
