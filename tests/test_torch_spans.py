"""The sort path's spans (``repro_torch.core.spans``): the tree a profiled
``hybrid_sort`` logs, its reads held to the host-read counter, its counts
held to an independent count from the keys and equal across engines, and
the log's gating and bound.  The last test needs a card and skips here."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402,E501

from _torch_threads import one_thread  # noqa: E402,F401
from repro_torch.core import hybrid_sort  # noqa: E402
from repro_torch.core.model import SortConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.core import spans  # noqa: E402

CFG = SortConfig(d=8, kpb=64, local_threshold=48, merge_threshold=32)
N = 30000
ENGINES = ["kernel", "argsort", "scan"]
OUTER = "caller.call"


def _profiled(*args, **kw):
    """``hybrid_sort`` under a CPU profiler, inside an outer span: its
    result, the one sort it logged, the host reads it counted and the
    profiler."""
    spans.LOG.clear()
    reads = _build.COUNTS["host_reads"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(OUTER):
            out = hybrid_sort(*args, **kw)
    (sort,) = spans.LOG.sorts()
    return out, sort, _build.COUNTS["host_reads"] - reads, prof


def _children(sort, i):
    return [j for j, s in enumerate(sort) if s["parent"] == i]


def _names(sort, idx):
    return [sort[j]["name"] for j in idx]


def _keys(kind, rng, n=N):
    if kind == "uniform":
        return rng.integers(0, 2**32, n, dtype=np.uint32)
    if kind == "and3":           # AND of 4 words: heavy equal keys
        w = rng.integers(0, 2**32, (4, n), dtype=np.uint32)
        return w[0] & w[1] & w[2] & w[3]
    if kind == "middle":         # a constant middle byte: an elided pass
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
        return (x & np.uint32(0xFF00FFFF)) | np.uint32(0x00AB0000)
    if kind == "int64":          # signed keys through the sign flip
        return rng.integers(-2**62, 2**62, n, dtype=np.int64)
    raise ValueError(kind)


def _ordered(x):
    """The keys' ordered bits as uint64."""
    if x.dtype == np.int64:
        return x.view(np.uint64) ^ np.uint64(1 << 63)
    return x.astype(np.uint64)


def _independent(x, cfg, max_passes=None):
    """From the keys alone: the records of active buckets before each pass
    the loop enters, and the records of done buckets at its exit.  Before
    pass p a bucket is the keys sharing their top p digits of the live
    window, and it is active when it holds more than ∂̂ records."""
    u = _ordered(x)
    live = int(np.bitwise_or.reduce(u) ^ np.bitwise_and.reduce(u))
    lo, hi = (live & -live).bit_length() - 1, live.bit_length()
    nd = -(-(hi - lo) // cfg.d)
    if max_passes is not None:
        nd = min(nd, max_passes)

    def active(p):
        _, counts = np.unique(u >> np.uint64(max(hi - p * cfg.d, lo)),
                              return_counts=True)
        return int(counts[counts > cfg.local_threshold].sum())
    passes = []
    for p in range(nd):
        a = active(p)
        if a == 0:
            return passes, x.size
        passes.append(a)
    return passes, x.size - active(nd)


def _counts(sort):
    passes = [(s["attrs"]["p"], s["attrs"]["executed"],
               s["attrs"]["active_records"])
              for s in sort if s["name"] == "hybrid_sort.pass"]
    local = [s["attrs"]["records"] for s in sort
             if s["name"] == "hybrid_sort.local_sort"]
    return passes, (local[0] if local else 0)


@pytest.mark.parametrize("engine", ENGINES)
def test_span_tree(engine, rng):
    x = _keys("middle", rng)
    v = np.arange(N, dtype=np.int32)
    (k, _, st), sort, reads, _ = _profiled(
        x, v, cfg=CFG, engine=engine, device="cpu", return_stats=True)
    assert np.array_equal(k.numpy(), np.sort(x))
    top = sort[0]
    assert top["name"] == "hybrid_sort" and top["parent"] is None
    assert top["attrs"] == {"n": N, "key_bits": 32, "value_bytes": 4,
                            "engine": engine}
    assert top["stream_ms"] is None                      # no device
    kids = _children(sort, 0)
    names = _names(sort, kids)
    n_pass = names.count("hybrid_sort.pass")
    # the read before the loop; after the passes, the finishing test's
    assert names == (["hybrid_sort.prologue", "hybrid_sort.read"]
                     + ["hybrid_sort.pass"] * n_pass
                     + ["hybrid_sort.read", "hybrid_sort.local_sort",
                        "hybrid_sort.epilogue"])
    # the live-bit window's read; the stats' read
    assert _names(sort, _children(sort, kids[0])) == ["hybrid_sort.read"]
    assert _names(sort, _children(sort, kids[-1])) == ["hybrid_sort.read"]
    assert _children(sort, kids[-2]) == []
    passes = [sort[i] for i in kids[2:2 + n_pass]]
    assert [s["attrs"]["p"] for s in passes] == list(range(n_pass))
    assert [s["attrs"]["executed"] for s in passes] == [True, False, True]
    assert st.counting_passes == 2 and st.elided_passes == 1
    for i in kids[2:2 + n_pass]:
        inner = _names(sort, _children(sort, i))
        # a pass opens with its plan and ends in the read that tests the
        # next (here, after pass 2, that no bucket is active); the plain
        # engines read their skip test after the plan
        assert inner[0] == "hybrid_sort.plan"
        assert inner[-1] == "hybrid_sort.read"
        assert ("hybrid_sort.scatter" in inner) == \
            sort[i]["attrs"]["executed"]
        assert inner.count("hybrid_sort.read") == (
            1 if engine == "kernel" else 2)
    for s in sort:
        assert s["host_ms"] >= 0
        if s["parent"] is not None:
            assert s["start_ns"] >= sort[s["parent"]]["start_ns"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("opts", [{}, {"return_stats": True},
                                  {"compress": True}, {"adaptive": False},
                                  {"max_passes": 1}])
def test_read_spans_equal_the_host_read_count(engine, opts, rng):
    x = _keys("and3", rng, 5000)
    _, sort, reads, _ = _profiled(x, cfg=CFG, engine=engine, device="cpu",
                                  **opts)
    assert reads >= 2
    assert sum(s["name"] == "hybrid_sort.read" for s in sort) == reads


@pytest.mark.parametrize("kind,opts", [
    ("uniform", {}), ("and3", {}), ("middle", {}), ("int64", {}),
    ("uniform", {"max_passes": 1}), ("and3", {"max_passes": 2})])
def test_counts_equal_across_engines_and_an_independent_count(kind, opts,
                                                               rng):
    x = _keys(kind, rng)
    want_active, want_local = _independent(x, CFG, opts.get("max_passes"))
    got = {}
    for engine in ("kernel", "argsort"):
        _, sort, _, _ = _profiled(x, cfg=CFG, engine=engine, device="cpu",
                                  **opts)
        got[engine] = _counts(sort)
    assert got["kernel"] == got["argsort"]
    passes, local = got["kernel"]
    assert [a for _, _, a in passes] == want_active
    assert local == want_local
    # the first pass moves every record: the keys are one bucket of N > ∂̂
    assert passes[0][2] == N


def test_local_sort_records_when_few_buckets_are_done(rng):
    """Under truncation the local sort gets only the done buckets."""
    x = _keys("and3", rng)
    _, sort, _, _ = _profiled(x, cfg=CFG, engine="kernel", device="cpu",
                              max_passes=2)
    (local,) = [s for s in sort if s["name"] == "hybrid_sort.local_sort"]
    assert 0 < local["attrs"]["records"] < N


def test_nothing_is_logged_outside_a_profiler(rng):
    x = _keys("uniform", rng, 2000)
    spans.LOG.clear()
    for engine in ENGINES:
        hybrid_sort(x, cfg=CFG, engine=engine, device="cpu")
    assert spans.LOG.sorts() == []
    with spans.span("hybrid_sort.read"):          # no sort open
        pass
    spans.note(x=1)
    assert spans.LOG.sorts() == []


def test_the_log_keeps_its_cap_of_whole_sorts():
    x = np.arange(20, dtype=np.uint32)[::-1].copy()
    spans.LOG.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(spans.MAX_SORTS + 3):
            hybrid_sort(x, cfg=CFG, device="cpu")
    got = spans.LOG.sorts()
    assert len(got) == spans.MAX_SORTS
    assert all(s[0]["name"] == "hybrid_sort" and s[-1]["name"] ==
               "hybrid_sort.epilogue" for s in got)
    log = spans.SpanLog(max_sorts=2)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with log.top("s", "cpu", i=i):
                with log.span("a"):
                    pass
    assert [s[0]["attrs"]["i"] for s in log.sorts()] == [3, 4]
    spans.LOG.clear()


def test_note_and_tally():
    log = spans.SpanLog()
    t = torch.tensor([3, 4, 5], dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]):
        with log.top("s", "cpu"):
            with log.span("pass", p=0):
                with log.span("plan"):
                    pass
                log.note(e=True)
                log.tally("a", t)
                log.tally("b", t, where=torch.tensor([True, False, True]))
                log.tally("c", torch.tensor([True, False, True, True]))
    (sort,) = log.sorts()
    assert [(s["name"], s["parent"]) for s in sort] == [
        ("s", None), ("pass", 0), ("plan", 1)]
    assert sort[1]["attrs"] == {"p": 0, "e": True, "a": 12, "b": 8, "c": 3}
    assert sort[1]["host_ms"] >= sort[2]["host_ms"]
    assert log.sorts() == [sort]                   # read once, then numbers
    with log.top("s", "cpu"):                      # no profiler: nothing
        log.tally("a", t)
    assert len(log.sorts()) == 1


def test_a_sort_holds_no_table_of_its_own():
    """A read sort keeps numbers only: no tensor of the sort and no event."""
    x = _keys("and3", np.random.default_rng(7), 5000)
    spans.LOG.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        hybrid_sort(x, cfg=CFG, engine="argsort", device="cpu")
    (held,) = list(spans.LOG._sorts)
    assert all(not isinstance(a, torch.Tensor)
               for s in held.spans for a in s.attrs.values())
    (sort,) = spans.LOG.sorts()
    assert held.spans == [] and held.counts is None
    for s in sort:
        assert all(isinstance(v, (int, bool, str)) for v in
                   s["attrs"].values())
    spans.LOG.clear()


class _Event:
    """A stand-in CUDA event: its time is the order it was recorded in."""
    made = []

    def __init__(self):
        self.t = len(_Event.made)
        _Event.made.append(self)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_adjacent_spans_share_their_events(monkeypatch):
    """A span opened right after its sibling closed starts at that close's
    event; one opened after a tally's sum takes its own: 10 events for 6
    spans."""
    _Event.made = []
    monkeypatch.setattr(spans, "_event", lambda stream: _Event())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: "s")
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda n, dtype, device: empty(n, dtype=dtype))
    log = spans.SpanLog()
    with profile(activities=[ProfilerActivity.CPU]):
        with log.top("sort", torch.device("cuda")):       # 0
            with log.span("read"):                        # 1, 2
                pass
            with log.span("pass"):                        # 2
                with log.span("plan"):                    # 3, 4
                    pass
                log.tally("a", torch.ones(3, dtype=torch.int32))
                with log.span("scatter"):                 # 5, 6
                    pass
                with log.span("read"):                    # 6, 7
                    pass
    (sort,) = log.sorts()                                 # pass: 8, sort: 9
    assert len(_Event.made) == 10
    assert [(s["name"], s["stream_ms"]) for s in sort] == [
        ("sort", 9.0), ("read", 1.0), ("pass", 6.0), ("plan", 1.0),
        ("scatter", 1.0), ("read", 1.0)]
    assert sort[2]["attrs"] == {"a": 3}


def test_chrome_trace_nests_the_spans_in_the_callers(tmp_path, rng):
    x = _keys("uniform", rng, 5000)
    _, sort, _, prof = _profiled(x, cfg=CFG, engine="kernel", device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    (outer,) = [e for e in ann if e["name"] == OUTER]
    ours = [e for e in ann if e["name"].startswith("hybrid_sort")]
    assert {e["name"] for e in ours} == {s["name"] for s in sort}
    assert len(ours) == len(sort)
    for e in ours:
        assert outer["ts"] <= e["ts"] and (
            e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])


def test_the_launch_counters_keep_their_keys():
    """The benchmark sums every key but ``host_reads`` into the kernel
    launches it holds to the profiler's count: counts of spans live in
    ``core.spans``, never here."""
    assert set(_build.COUNTS) == {
        "histogram", "fused_pass", "local_sort", "merge_rows", "merge",
        "bitonic_rows", "bitonic_rows_kv", "multisplit", "multisplit_kv",
        "assigned_hist", "host_reads"}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "and3", "int64"])
def test_spans_on_the_card(kind, rng):
    """On the card: stream times from the span events, the read spans held
    to the host-read count, the counts equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _keys(kind, rng, 1 << 20)
    v = np.arange(x.size, dtype=np.int32)
    cfg = SortConfig()
    (k, _), sort, reads, _ = _profiled(torch.from_numpy(x).cuda(),
                                       torch.from_numpy(v).cuda(), cfg=cfg)
    torch.cuda.synchronize()
    assert np.array_equal(k.cpu().numpy(), np.sort(x))
    assert sort[0]["attrs"]["engine"] == "kernel"
    assert sum(s["name"] == "hybrid_sort.read" for s in sort) == reads
    assert all(s["stream_ms"] is not None and s["stream_ms"] >= 0
               for s in sort)
    assert sort[0]["stream_ms"] >= sum(
        s["stream_ms"] for s in sort if s["parent"] == 0)
    _, cpu, _, _ = _profiled(x, v, cfg=cfg, engine="argsort", device="cpu")
    assert _counts(sort) == _counts(cpu)
    want_active, want_local = _independent(x, cfg)
    assert [a for _, _, a in _counts(sort)[0]] == want_active
    assert _counts(sort)[1] == want_local
