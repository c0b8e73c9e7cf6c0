"""The port's contract layer (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

* The formula evaluator, the ``ANALYSIS_CONTRACT(S)`` declarations, the
  ``*_params`` helpers and ``expected_census`` equal the reference's.
* The descriptor-table checks and the lint rules R1 / R2 give the
  reference's findings on the reference's inputs, good and mutated.
* Every contract run on the CPU (the kernels' plain versions) has the
  census and the sweep bytes of the reference's formulas evaluated at the
  run's executed passes, and the full sweep is green over the reference's
  registry plus ``descriptor_tables``; the distributed contract also on
  two spawned gloo ranks (``ProcessGroupMesh``).
* Each seeded violation (M1–M11, the reference's numbering, M9 being the
  port's write-exactly-once replay) is caught, and its unmutated control
  reports nothing.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro.analysis import contracts as rcontracts  # noqa: E402
from repro.analysis import expr as rexpr  # noqa: E402
from repro.analysis import lint as rlint  # noqa: E402
from repro.analysis import refhazard as rrefhazard  # noqa: E402
from repro.core import model as rmodel  # noqa: E402
from repro_torch.analysis import contracts, expr, lint, refhazard  # noqa
from repro_torch.analysis import transfer  # noqa: E402
from repro_torch.analysis.trace import recording  # noqa: E402
from repro_torch.core import plan  # noqa: E402
from repro_torch.core.interop import config_from_reference  # noqa: E402
from repro_torch.kernels import fused, histogram, ref  # noqa: E402
from repro_torch.utils import census as ucensus  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _port_cfg(cfg):
    return config_from_reference(dataclasses.asdict(cfg))


# --------------------------------------------------------------------------
# the evaluator and the declarations equal the reference's
# --------------------------------------------------------------------------

FORMULAS = [
    ("ceil_div(7, 2) + 1", {}),
    ("[1] * chunks", {"chunks": 3}),
    ("2 + classes", {"classes": 4}),
    ("(2 * passes + 1) * n_pad * kb + 2 * passes * n_pad * vb",
     {"passes": 3, "n_pad": 4160, "kb": 4, "vb": 8}),
    ("((P - 1) / P) * (attempts * chunks * P * (cap * (kb + vb) + 4)"
     " + kb * P * sum(samp) + attempts * 2 * 4)",
     {"P": 8, "attempts": 2, "chunks": 2, "cap": 99, "kb": 4, "vb": 0,
      "samp": [64, 256]}),
    ("max(a, b) - min(a, b) if a > b else abs(a - b)", {"a": 3, "b": 9}),
    ("sqrt(n) // 1 + int(2.9)", {"n": 81}),
    ("not (a == b) and a <= b < c", {"a": 1, "b": 2, "c": 3}),
]
# (a comprehension's target is a Store: the reference refuses those too)
UNSAFE = ["[x * x for x in range(n) if x % 2]", "__import__('os')",
          "(lambda: 1)()", "x.__class__", "open('/etc/passwd')", "x[0]",
          "'text'", "min(a, key=a)", "unknown + 1", "1 +"]


@pytest.mark.parametrize("i", range(len(FORMULAS)))
def test_expr_evaluates_as_the_reference(i):
    formula, params = FORMULAS[i]
    assert expr.evaluate(formula, params) == rexpr.evaluate(formula, params)


@pytest.mark.parametrize("formula", UNSAFE)
def test_expr_refuses_what_the_reference_refuses(formula):
    params = {"x": [1], "a": [1, 2], "n": 7}
    with pytest.raises(rexpr.FormulaError):
        rexpr.evaluate(formula, params)
    with pytest.raises(expr.FormulaError):
        expr.evaluate(formula, params)


def test_expr_refuses_parameters_shadowing_helpers():
    with pytest.raises(expr.FormulaError, match="shadow"):
        expr.evaluate("len + 1", {"len": 2})


DECLS = [("core.hybrid", "ANALYSIS_CONTRACT"),
         ("core.lsd", "ANALYSIS_CONTRACT"),
         ("core.plan", "ANALYSIS_CONTRACT"),
         ("core.distributed", "ANALYSIS_CONTRACT"),
         ("core.outofcore", "ANALYSIS_CONTRACTS"),
         ("data.pipeline", "ANALYSIS_CONTRACT"),
         ("models.moe", "ANALYSIS_CONTRACT")]


def _without_entry(decl):
    return {k: v for k, v in decl.items() if k != "entry"}


@pytest.mark.parametrize("module,attr", DECLS)
def test_contract_declarations_equal_the_reference(module, attr):
    import importlib
    want = getattr(importlib.import_module("repro." + module), attr)
    got = getattr(importlib.import_module("repro_torch." + module), attr)
    pairs = [(got, want)] if attr == "ANALYSIS_CONTRACT" else \
        [(got[k], want[k]) for k in want]
    assert attr == "ANALYSIS_CONTRACT" or set(got) == set(want)
    for g, w in pairs:
        assert _without_entry(g) == _without_entry(w)
        assert g["entry"] == w["entry"].replace("repro.", "repro_torch.", 1)
        mod, _, fn = g["entry"].rpartition(".")
        assert callable(getattr(importlib.import_module(mod), fn))


def test_registry_binds_the_reference_declarations():
    assert [c.name for c in contracts.CONTRACTS] == \
        [c.name for c in rcontracts.CONTRACTS]
    for c in contracts.CONTRACTS:
        assert _without_entry(c.decl) == \
            _without_entry(rcontracts.REGISTRY[c.name].decl)


REF_CFGS = [rcontracts.TCFG, rmodel.default_config(4),
            rmodel.default_config(8, 8),
            rmodel.SortConfig(d=5, kpb=512, local_threshold=600,
                              merge_threshold=400, step_batch=3)]
SIZES = [1, 100, 2048, 5000, 70000]


@pytest.mark.parametrize("c", range(len(REF_CFGS)))
@pytest.mark.parametrize("n", SIZES)
def test_hybrid_params_and_census_equal_the_reference(n, c):
    rcfg = REF_CFGS[c]
    for kw in ({}, dict(key_bits=64, key_bytes=8, vals=2, val_bytes=4)):
        want = rcontracts.hybrid_params(n, rcfg, **kw)
        got = contracts.hybrid_params(n, _port_cfg(rcfg), **kw)
        assert got == want
        for name in ("hybrid_sort", "hybrid_sort_kv", "ooc_chunk_sort"):
            assert contracts.expected_census(name, got) == \
                rcontracts.expected_census(name, want)


@pytest.mark.parametrize("n", SIZES)
def test_lsd_spp_merge_params_equal_the_reference(n):
    for d, kpb, b in ((8, 512, 4), (5, 1024, 8), (11, 64, 1)):
        for kw in ({}, dict(key_bits=16, key_bytes=2, vals=1, val_bytes=8)):
            want = rcontracts.lsd_params(n, d, kpb, b, **kw)
            assert contracts.lsd_params(n, d, kpb, b, **kw) == want
            assert contracts.expected_census("lsd_sort", want) == \
                rcontracts.expected_census("lsd_sort", want)
    for r in (2, 8, 256, 384):
        want = rcontracts.spp_params(n, r)
        assert contracts.spp_params(n, r) == want
        assert contracts.spp_params(n, r, kpb=64, step_batch=2) == \
            rcontracts.spp_params(n, r, kpb=64, step_batch=2)
        for name in ("single_pass_partition", "moe_dispatch",
                     "pipeline_bucketing"):
            assert contracts.expected_census(name, want) == \
                rcontracts.expected_census(name, want)
    lens = (n, n // 2 + 1, 7)
    for kway, tile in ((2, 16), (4, 64), (8, 4096)):
        want = rcontracts.merge_params(lens, kway, tile, 8, 1, 4)
        assert contracts.merge_params(lens, kway, tile, 8, 1, 4) == want
        for name in ("ooc_merge_round", "ooc_slab_sweep"):
            assert contracts.expected_census(name, want) == \
                rcontracts.expected_census(name, want)


@pytest.mark.parametrize("P,n_local,chunks,attempts",
                         [(2, 512, 1, 1), (8, 512, 2, 2), (8, 4096, 4, 3),
                          (16, 1 << 14, 2, 3)])
def test_dist_params_and_census_equal_the_reference(P, n_local, chunks,
                                                    attempts):
    for rcfg in REF_CFGS[:2]:
        for kw in ({}, dict(oversample=8, slack=1.2, refine=2, leaves=2,
                            val_bytes=4)):
            want = rcontracts.dist_params(P, n_local, chunks, attempts, rcfg,
                                          **kw)
            got = contracts.dist_params(P, n_local, chunks, attempts,
                                        _port_cfg(rcfg), **kw)
            assert got == want
            assert contracts.expected_census("distributed_shard", got) == \
                rcontracts.expected_census("distributed_shard", want)


# --------------------------------------------------------------------------
# the table checks and the lint give the reference's findings
# --------------------------------------------------------------------------

def _merge_tables(oo, oc):
    ws = np.zeros((16,), np.int32)
    wt = np.zeros((4, 4), np.int32)
    wt[:, 0] = oc
    return (np.array(oo, np.int32), np.array(oc, np.int32), ws,
            wt.reshape(-1))


MERGE_CASES = {"good": ([0, 16, 32, 48], [16, 16, 16, 16]),
               "M4_overlap": ([0, 8, 32, 48], [16, 16, 16, 16]),
               "M5_gap": ([0, 16, 40, 48], [16, 16, 8, 16])}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_table_findings_equal_the_reference(case):
    tables = _merge_tables(*MERGE_CASES[case])
    kw = dict(kway=4, tpb=16, n=64, buf_len=80)
    want = rrefhazard.check_merge_tables(*tables, **kw)
    assert refhazard.check_merge_tables(*tables, **kw) == want
    assert (want == []) == (case == "good")


def _fused_blocks(offset_at=None):
    """The reference's and the port's packed region blocks of one segment
    of 1000 keys at kpb 128, B 4 — numpy tables, optionally with row
    (0, 0)'s offset moved."""
    import jax.numpy as jnp
    import repro.core.plan as rplan
    m, kpb, b = 1000, 128, 4
    rb = rplan.make_region_blocks(
        jnp.zeros((1,), jnp.int32), jnp.full((1,), m, jnp.int32), m, kpb,
        rplan.max_region_blocks(m, kpb, 1), batch=b)
    pb = plan.make_region_blocks(
        torch.zeros(1, dtype=torch.int32),
        torch.full((1,), m, dtype=torch.int32), m, kpb,
        plan.max_region_blocks(m, kpb, 1), batch=b)
    rnp = rb._replace(**{f: np.array(getattr(rb, f)) for f in rb._fields})
    pnp = plan.RegionBlocks(*[t.numpy() for t in pb])
    for t_r, t_p in zip(rnp, pnp):
        assert np.array_equal(t_r, t_p)
    if offset_at is not None:
        for blocks in (rnp, pnp):
            blocks.offset[0, 0] = offset_at
    return rnp, pnp


@pytest.mark.parametrize("case", ["good", "M10_overrun", "M10_misplaced"])
def test_fused_table_findings_equal_the_reference(case):
    n_pad = fused.pad_length(1000, 128)
    at = {"good": None, "M10_overrun": n_pad - 1, "M10_misplaced": 5}[case]
    rnp, pnp = _fused_blocks(at)
    want = rrefhazard.check_fused_tables(rnp, 1000, 128, n_pad)
    assert refhazard.check_fused_tables(pnp, 1000, 128, n_pad) == want
    assert (want == []) == (case == "good")
    if case == "M10_overrun":
        assert any("outside padded buffer" in f for f in want)


LINT_SOURCES = {
    "M6_sort": ("kernels/evil.py", ["no-comparison-sort"],
                "import jax.numpy as jnp\n"
                "def rank(keys):\n"
                "    return jnp.argsort(keys)\n"),
    "M6_method_sort": ("kernels/evil.py", ["no-comparison-sort"],
                       "def rank(keys):\n"
                       "    a = keys.sort()\n"
                       "    return np.lexsort((a, keys))\n"),
    "M7_prng": ("data/evil.py", ["no-global-prng"],
                "import numpy as np\n"
                "def draw(n):\n"
                "    return np.random.randint(0, 5, n)\n"),
    "M7_import": ("data/evil.py", ["no-global-prng"],
                  "from numpy.random import rand, default_rng\n"
                  "import random\n"
                  "def draw(n):\n"
                  "    return random.random() + rand(n)\n"),
    "M7_good": ("data/fine.py", ["no-global-prng"],
                "import numpy as np\n"
                "def draw(n, seed):\n"
                "    return np.random.default_rng(seed).integers(0, 5, n)\n"),
}


@pytest.mark.parametrize("case", sorted(LINT_SOURCES))
def test_lint_r1_r2_findings_equal_the_reference(case):
    path, rules, src = LINT_SOURCES[case]
    want = [(f.rule, f.line, f.message)
            for f in rlint.lint_source(src, path, rules)]
    got = [(f.rule, f.line, f.message)
           for f in lint.lint_source(src, path, rules)]
    assert got == want
    assert (want == []) == case.endswith("good")


def test_lint_r2_torch_global_generator():
    bad = ("import torch\n"
           "def draw(n):\n"
           "    torch.manual_seed(0)\n"
           "    a = torch.rand(n)\n"
           "    b = torch.randperm(n)\n"
           "    return a, b, torch.normal(0.0, 1.0, (n,))\n")
    good = ("import torch\n"
            "def draw(n, g):\n"
            "    a = torch.rand(n, generator=g)\n"
            "    return a, torch.randperm(n, generator=g)\n")
    found = lint.lint_source(bad, "data/evil.py", ["no-global-prng"])
    assert [f.line for f in found] == [3, 4, 5, 6]
    assert lint.lint_source(good, "data/fine.py", ["no-global-prng"]) == []


def test_repo_lint_is_green():
    assert lint.run_lint(str(ROOT / "src" / "repro_torch")) == []


# --------------------------------------------------------------------------
# the runs: census and sweep bytes equal the reference's formulas
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", [c.name for c in contracts.CONTRACTS])
def test_recorded_run_matches_the_reference_formulas(name):
    c = contracts.REGISTRY[name]
    rdecl = rcontracts.REGISTRY[name].decl
    run, params_of = c.make(CPU)
    with recording() as rec:
        out = run()
    params = params_of(out)
    got = ucensus.launch_census(rec)
    want_total = int(rexpr.evaluate(rdecl["census"]["launch_total"], params))
    want_bodies = rexpr.evaluate(rdecl["census"]["while_body_launches"],
                                 params)
    assert got["total"] == c.shards * want_total
    assert got["while_bodies"] == c.shards * [int(x) for x in want_bodies]
    # the prologue and the local sort run outside the pass loops
    assert not any(r.in_while for r in rec.records
                   if r.name in ("_hist_kernel", "_bitonic_stable_kernel"))
    if "executed" in params:      # 1 + passes + classes launches
        assert got["launches"] == (c.shards * want_total -
                                   sum(want_bodies) + params["executed"])
    if "transfer" in rdecl:
        want = int(rexpr.evaluate(rdecl["transfer"]["bytes"], params))
        assert transfer.derive_hbm_bytes(rec.records, rdecl["transfer"],
                                         params)["total"] == want
        assert want > 0
    if "link" in rdecl:
        bytes_by, counts = transfer.recorded_link(rec)
        for kind, f in rdecl["link"]["collective_counts"].items():
            assert counts[kind] == int(rexpr.evaluate(f, params))
        assert bytes_by["total"] == pytest.approx(
            rexpr.evaluate(rdecl["link"]["link_bytes"], params))


def test_full_cpu_sweep_is_green():
    reports = contracts.run_all("cpu")
    bad = [f for r in reports for f in r.findings]
    assert not bad, "\n".join(bad)
    assert [r.name for r in reports] == \
        [c.name for c in rcontracts.CONTRACTS] + ["descriptor_tables"]
    for r in reports[:-1]:
        assert {"census", "sort_free", "donation", "hazard"} <= set(r.checks)
    assert set(reports[-1].checks) == {
        "hazard.fused_tables", "hazard.merge_tables",
        "hazard.merge_written_once", "hazard.spill_tables"}


def _gloo_rank(rank, store, tmp):
    import torch.distributed as dist
    from repro_torch.core.distributed import ProcessGroupMesh
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    try:
        rep = contracts.run_mesh_contract(ProcessGroupMesh(device="cpu"))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(rep.to_dict(), fh)
    finally:
        dist.destroy_process_group()


def test_distributed_contract_on_gloo_ranks(tmp_path):
    """The distributed contract on two ``ProcessGroupMesh`` ranks: each
    rank's census, and its collectives' sites and wire bytes as
    ``CollectiveMode`` counts them, against the link table."""
    import torch.multiprocessing as mp
    mp.spawn(_gloo_rank, args=(str(tmp_path / "store"), str(tmp_path)),
             nprocs=2, join=True)
    for r in range(2):
        rep = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert rep["ok"], rep
        assert "transfer.link_bytes" in rep["checks"]


def test_cli_on_the_cpu_exits_zero(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
         "--json", str(tmp_path / "r.json")], env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    passes = [ln.split()[1] for ln in out.stdout.splitlines()
              if ln.strip().startswith("PASS")]
    assert passes == [c.name for c in contracts.CONTRACTS] + \
        ["descriptor_tables", "lint"]
    assert json.loads((tmp_path / "r.json").read_text())["ok"]


def test_cli_without_a_gpu_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--only", "lsd_sort"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "PASS" not in out.stdout
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contracts.run_all()


# --------------------------------------------------------------------------
# mutations: each seeded violation is caught, its control is clean
# --------------------------------------------------------------------------

def _check(name, check):
    return contracts.run_contract(contracts.REGISTRY[name], "cpu") \
        .checks[check]


def _twice(module, attr, mp):
    orig = getattr(module, attr)

    def twice(*a, **k):
        orig(*a, **k)
        return orig(*a, **k)
    mp.setattr(module, attr, twice)


def m1_extra_launch_in_pass_loop(mp):
    if mp:
        _twice(fused, "fused_counting_pass", mp)
    return _check("hybrid_sort", "census")


def m2_extra_toplevel_launch(mp):
    if mp:
        _twice(fused, "initial_histogram", mp)
    return _check("lsd_sort", "census")


def m3_clone_instead_of_alternate(mp):
    if mp:
        orig = ref.fused_counting_pass_ref

        def cloned(*a, **k):
            out = orig(*a, **k)
            return (out[0].clone(), *out[1:])
        mp.setattr(ref, "fused_counting_pass_ref", cloned)
    return _check("hybrid_sort", "donation")


def m4_overlapping_tables(mp):
    case = "M4_overlap" if mp else "good"
    return refhazard.check_merge_tables(
        *_merge_tables(*MERGE_CASES[case]), kway=4, tpb=16, n=64, buf_len=80)


def m5_gappy_tables(mp):
    case = "M5_gap" if mp else "good"
    return refhazard.check_merge_tables(
        *_merge_tables(*MERGE_CASES[case]), kway=4, tpb=16, n=64, buf_len=80)


def m6_sort_in_a_kernel_engine_path(mp):
    if mp:
        orig = plan.next_active_table

        def sorting(hist, *a, **k):
            torch.sort(hist.reshape(-1))
            return orig(hist, *a, **k)
        mp.setattr(plan, "next_active_table", sorting)
    return _check("hybrid_sort", "sort_free")


def m7_global_prng_draw(mp):
    src = ("import torch\n"
           "def noise(n, g):\n"
           f"    return torch.randn(n{'' if mp else ', generator=g'})\n")
    return [str(f) for f in lint.lint_source(src, "data/evil.py",
                                             ["no-global-prng"])]


def m8_undeclared_extra_sweep(mp):
    if mp:
        orig = fused.initial_histogram

        def extra(buf_keys, n, lo, width, r, a_max, kpb):
            histogram.radix_histogram(buf_keys.reshape(-1, kpb), lo, width)
            return orig(buf_keys, n, lo, width, r, a_max, kpb)
        mp.setattr(fused, "initial_histogram", extra)
    return _check("single_pass_partition", "transfer.hbm_bytes")


def m9_double_write(mp):
    if mp:
        orig = ref.fused_counting_pass_ref

        def twice_written(*a, **k):
            out = orig(*a, **k)
            if out[1]:
                out[1][0][1] = out[1][0][0]
            return out
        mp.setattr(ref, "fused_counting_pass_ref", twice_written)
    return _check("hybrid_sort", "hazard")


def m10_table_offset_past_the_pad(mp):
    n_pad = fused.pad_length(1000, 128)
    _, pnp = _fused_blocks(n_pad - 1 if mp else None)
    return refhazard.check_fused_tables(pnp, 1000, 128, n_pad)


def m11_alt_wrapper_allocates_a_twin(mp):
    body = ("    out = torch.empty_like(alt_keys)\n"
            "    return launch(src_keys, out)\n" if mp else
            "    return launch(src_keys, alt_keys)\n")
    src = "import torch\ndef sweep(src_keys, alt_keys):\n" + body
    return [str(f) for f in lint.lint_source(src, "kernels/evil.py",
                                             ["undonated-dispatch"])]


MUTATIONS = {
    "M1": (m1_extra_launch_in_pass_loop, "while-body launches"),
    "M2": (m2_extra_toplevel_launch, "launch total"),
    "M3": (m3_clone_instead_of_alternate, "silently copies"),
    "M4": (m4_overlapping_tables, "overlap"),
    "M5": (m5_gappy_tables, "expected exactly [0, 64)"),
    "M6": (m6_sort_in_a_kernel_engine_path, "sort op(s)"),
    "M7": (m7_global_prng_draw, "global generator"),
    "M8": (m8_undeclared_extra_sweep, "sweep bytes"),
    "M9": (m9_double_write, "not a permutation"),
    "M10": (m10_table_offset_past_the_pad, "outside padded buffer"),
    "M11": (m11_alt_wrapper_allocates_a_twin, "allocates a twin"),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS, key=lambda k: int(k[1:])))
def test_mutation_is_caught_and_its_control_is_clean(case, monkeypatch):
    fn, needle = MUTATIONS[case]
    assert fn(None) == []
    found = fn(monkeypatch)
    assert any(needle in f for f in found), found


def test_sort_counter_sees_sorts_outside_the_plain_versions():
    x = torch.arange(10, 0, -1)
    assert ucensus.sort_op_count(torch.sort, x) == 1
    assert ucensus.sort_op_count(torch.argsort, x, stable=True) == 1
    assert ucensus.sort_op_count(lambda: torch.unique(x, sorted=True)) == 1
    assert ucensus.sort_op_count(lambda: x + 1) == 0
    # the plain versions (kernels/ref.py) sort by design
    gen = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 9, (4, 8), generator=gen)
    idx = torch.arange(8, dtype=torch.int32).expand(4, 8).contiguous()
    assert ucensus.sort_op_count(ref.bitonic_sort_rows_stable_ref, keys,
                                 idx) == 0
    assert ucensus.op_counts(torch.sort, x)["sort"] == 1


def test_recorder_is_off_by_default_and_exclusive():
    from repro_torch.kernels import _build
    assert _build.RECORDER is None
    with recording() as rec:
        assert _build.RECORDER is rec
        with pytest.raises(RuntimeError, match="already active"):
            with recording():
                pass
    assert _build.RECORDER is None


def test_argsort_engine_is_not_sort_free():
    """The plain-torch engines sort by design: the counter sees them."""
    from repro_torch import hybrid_sort
    x = contracts._uint32(1, 2048, CPU)
    assert ucensus.sort_op_count(hybrid_sort, x, cfg=contracts.TCFG,
                                 engine="argsort") > 0
    assert ucensus.sort_op_count(hybrid_sort, x, cfg=contracts.TCFG,
                                 engine="kernel") == 0


def test_fault_matrix_is_green_on_the_cpu():
    """``scripts/torch_fault_matrix.py`` (the CI's ``faults`` stage)."""
    import importlib.util
    path = ROOT / "scripts" / "torch_fault_matrix.py"
    spec = importlib.util.spec_from_file_location("torch_fault_matrix", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.run_matrix(device="cpu") == 0
