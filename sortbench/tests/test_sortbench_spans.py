"""The readers of the program's span log on a hand-made trace and log: the
five metrics' arithmetic, their silence where there is nothing to read,
and their refusal of a log that does not cover the traced window."""
import sys
import types

import pytest

from repro_torch.core import spans
from sortbench import devtrace, harness, spanlog

NAMES = {"fused_pass_kernel", "fused_wide_kernel", "segments_kernel",
         "rows_kernel", "hist_kernel"}
READERS = ["plan_stream_ms", "read_wait_ms", "pass_active_pct",
           "fused_passes_roofline", "local_sort_roofline"]
#: the run's own start and the start of its timed window, host seconds
RUN_START, WINDOW_START = 100.0, 160.0


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(calls=2):
    """``calls`` calls of 100 us.  Call 0: two fused passes (10 + 30 us), a
    histogram and the local sort's two kernels (4 + 6 us); call 1: a wide
    fused pass (20 us) and one local-sort kernel (10 us)."""
    events = [_ev("user_annotation", devtrace.CALL_SPAN, 100.0 * i, 100.0)
              for i in range(calls)]
    events += [
        _ev("kernel", "void hist_kernel<int>()", 1.0, 2.0),
        _ev("kernel", "void (anonymous namespace)::fused_pass_kernel<unsigned"
            " int, 1>(PassArgs)", 10.0, 10.0),
        _ev("kernel", "void fused_pass_kernel<int>(PassArgs)", 30.0, 30.0),
        _ev("kernel", "void segments_kernel<unsigned int, 256>()", 70.0, 4.0),
        _ev("kernel", "void rows_kernel<unsigned int>()", 80.0, 6.0),
        _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
            90.0, 5.0),
        _ev("kernel", "void fused_wide_kernel<int>(WideArgs)", 110.0, 20.0),
        _ev("kernel", "void segments_kernel<int, 512>()", 140.0, 10.0),
    ]
    return devtrace.DeviceTrace(events, NAMES)


def _span(name, parent, host_ms=0.0, stream_ms=0.0, start_s=120.0, **attrs):
    return {"name": name, "parent": parent, "start_ns": start_s * 1e9,
            "host_ms": host_ms, "stream_ms": stream_ms, "attrs": attrs}


def _sort(passes, reads, plans, records, n=1000, start_s=120.0,
          stream=True):
    """One sort's spans: ``passes`` as (active, executed), the host ms of
    each read, the stream ms of each plan span, the local sort's records
    (None: no local sort)."""
    top = _span("hybrid_sort", None, 50.0, 40.0 if stream else None,
                start_s, n=n, key_bits=32, value_bytes=4, engine="kernel")
    rows = [top]
    for p, (active, executed) in enumerate(passes):
        rows.append(_span("hybrid_sort.pass", 0, start_s=start_s, p=p,
                          executed=executed, active_records=active))
    rows += [_span("hybrid_sort.read", 0, ms, start_s=start_s)
             for ms in reads]
    rows += [_span("hybrid_sort.plan", 0, 1.0, ms if stream else None,
                   start_s) for ms in plans]
    if records is not None:
        rows.append(_span("hybrid_sort.local_sort", 0, start_s=start_s,
                          records=records))
    return rows


class _Log:
    def __init__(self, sorts):
        self._sorts = sorts

    def sorts(self):
        return self._sorts


def _run(sorts, calls=2, record_bytes=8, bandwidth=1e9, monkeypatch=None):
    monkeypatch.setattr(spans, "LOG", _Log(sorts))
    run = types.SimpleNamespace(records=1000, record_bytes=record_bytes,
                                bandwidth=bandwidth, setup_s=WINDOW_START -
                                RUN_START)
    run.window = harness.Window()
    run.window.start = WINDOW_START
    run.traced = harness.Traced(_trace(calls), {"host_reads": 0,
                                                "kernel_launches": 0})
    return run


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _two_sorts():
    return [_sort([(1000, True), (600, True), (600, False)],
                  reads=[1.0, 0.5, 0.25], plans=[2.0, 3.0], records=900),
            _sort([(1000, True)], reads=[2.0], plans=[1.0], records=1000)]


def test_readers_on_a_hand_made_log(monkeypatch):
    run = _run(_two_sorts(), monkeypatch=monkeypatch)
    assert _read("plan_stream_ms", run) == pytest.approx((2 + 3 + 1) / 2)
    assert _read("read_wait_ms", run) == pytest.approx((1.75 + 2.0) / 2)
    # the elided pass moves nothing: 2 600 active of 3 000 moved
    assert _read("pass_active_pct", run) == pytest.approx(100 * 2600 / 3000)
    # 2 * 2 600 records * 8 bytes over the three fused kernels' 60 us
    assert _read("fused_passes_roofline", run) == pytest.approx(
        100 * 2 * 2600 * 8 / 1e9 / 60e-6)
    # 2 * 1 900 records * 8 bytes over the local sort's 20 us
    assert _read("local_sort_roofline", run) == pytest.approx(
        100 * 2 * 1900 * 8 / 1e9 / 20e-6)


def test_rooflines_count_the_record_bytes(monkeypatch):
    run = _run(_two_sorts(), record_bytes=16, bandwidth=2e9,
               monkeypatch=monkeypatch)
    assert _read("fused_passes_roofline", run) == pytest.approx(
        100 * 2 * 2600 * 16 / 2e9 / 60e-6)
    assert _read("local_sort_roofline", run) == pytest.approx(
        100 * 2 * 1900 * 16 / 2e9 / 20e-6)
    run.bandwidth = None            # a card without a peak: no share
    assert _read("fused_passes_roofline", run) is None
    assert _read("local_sort_roofline", run) is None


def test_the_local_sort_kernels_are_named_by_the_program():
    names = devtrace.global_names(spanlog.local_sort_source().read_text())
    assert "segments_kernel" in names
    assert not {"fused_pass_kernel", "hist_kernel"} & names


def test_no_local_sort_leaves_its_roofline_out(monkeypatch):
    sorts = [_sort([(1000, True)], [1.0], [1.0], None),
             _sort([(1000, True)], [1.0], [1.0], 0)]
    run = _run(sorts, monkeypatch=monkeypatch)
    assert _read("local_sort_roofline", run) is None
    assert _read("pass_active_pct", run) == 100.0


@pytest.mark.parametrize("sorts", [[], "cpu", "before"])
def test_readers_stay_silent_with_nothing_to_read(sorts, monkeypatch):
    """An empty log (a control never calls the program), sorts that ran
    on no device, and sorts logged before this run began."""
    if sorts == "cpu":
        sorts = [_sort([(1000, True)], [1.0], [1.0], 900, stream=False)] * 2
    elif sorts == "before":
        sorts = [_sort([(1000, True)], [1.0], [1.0], 900, start_s=50.0)] * 2
    run = _run(sorts, monkeypatch=monkeypatch)
    for name in READERS:
        assert _read(name, run) is None, name


def test_readers_stay_silent_without_the_log(monkeypatch):
    """A program that keeps no span log (an older commit)."""
    run = _run([], monkeypatch=monkeypatch)
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    for name in READERS:
        assert _read(name, run) is None, name


def test_a_log_that_does_not_cover_the_window_is_refused(monkeypatch):
    sorts = _two_sorts() + [_sort([(1000, True)], [1.0], [1.0], 1000)]
    run = _run(sorts, monkeypatch=monkeypatch)
    for name in READERS:
        with pytest.raises(RuntimeError, match="3 sorts .* 2 calls"):
            _read(name, run)
    # sorts of an earlier run in the same process are left out, not counted
    old = [_sort([(1000, True)], [1.0], [1.0], 1000, start_s=10.0)]
    run = _run(old + _two_sorts(), monkeypatch=monkeypatch)
    assert _read("pass_active_pct", run) == pytest.approx(100 * 2600 / 3000)
