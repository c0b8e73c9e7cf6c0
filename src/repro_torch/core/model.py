"""The paper's analytical model (§4.5): bucket/block bounds and memory budget.

A copy of ``repro.core.model`` (pure Python, kept here so the port imports
nothing of the JAX package).  The model's upper bounds are the static sizes
of every bookkeeping table, exactly as in the reference, so the port's plan
tables compare with the reference's entry for entry.  I1–I4 and M1–M5 below
use the paper's notation.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Tuning parameters of the hybrid radix sort (paper Table 1/Table 3)."""
    d: int = 8                 # bits per digit
    kpb: int = 3456            # keys per block (tile), per Table 3
    local_threshold: int = 4224   # ∂̂ — buckets <= this are locally sorted
    merge_threshold: int = 3000   # ∂ — merge runs of sub-buckets below this
    rank_engine: str = "auto"  # pass engine default (see core.ranks.resolve_engine)
    step_batch: int = 8        # descriptor rows per super-step of the packed
                               # tables (plan.pack_region_blocks); the CUDA
                               # fused pass reads the flat rows
    adaptive: bool = True      # entropy-adaptive schedule: narrow the digit
                               # window to the live bits of concrete inputs
                               # and elide single-digit passes mid-sort

    def __post_init__(self):
        if not (0 < self.d <= 16):
            raise ValueError("d must be in (0, 16]")
        if self.merge_threshold > self.local_threshold:
            raise ValueError("requires ∂ <= ∂̂ (R3)")
        if self.step_batch < 1:
            raise ValueError("step_batch must be >= 1")

    @property
    def radix(self) -> int:
        return 1 << self.d


# Paper Table 3 defaults, keyed by (key_bytes, value_bytes or 0).
PAPER_TABLE3 = {
    (4, 0): SortConfig(d=8, kpb=6912, local_threshold=9216, merge_threshold=3000),
    (8, 0): SortConfig(d=8, kpb=3456, local_threshold=4224, merge_threshold=3000),
    (4, 4): SortConfig(d=8, kpb=3456, local_threshold=5760, merge_threshold=3000),
    (8, 8): SortConfig(d=8, kpb=2304, local_threshold=3840, merge_threshold=3000),
}


def default_config(key_bytes: int, value_bytes: int = 0) -> SortConfig:
    return PAPER_TABLE3.get((key_bytes, value_bytes),
                            PAPER_TABLE3[(8, 8)] if value_bytes else PAPER_TABLE3[(8, 0)])


def num_digits(key_bits: int, d: int) -> int:
    return math.ceil(key_bits / d)


# ----- the bounds (I1..I4) -------------------------------------------------

def max_active_buckets(n: int, cfg: SortConfig) -> int:
    """I1: at most ⌊n/∂̂⌋ buckets exceed the local-sort threshold."""
    return max(1, n // (cfg.local_threshold + 1) + 1)


def max_total_buckets(n: int, cfg: SortConfig) -> int:
    """I3: min(⌊2n/∂⌋ + ⌊n/∂̂⌋, r·⌊n/∂̂⌋), plus one radix worth of slack."""
    i2 = cfg.radix * max(1, n // cfg.local_threshold)
    i3 = 2 * n // cfg.merge_threshold + n // cfg.local_threshold
    return min(i2, i3) + cfg.radix


def max_blocks(n: int, cfg: SortConfig) -> int:
    """I4: ⌊n/KPB⌋ + ⌊n/∂̂⌋ blocks (full blocks + one remainder per bucket)."""
    return n // cfg.kpb + max_active_buckets(n, cfg) + 1


# ----- the memory budget (M1..M5), in bytes --------------------------------

def memory_budget(n: int, key_bits: int, cfg: SortConfig) -> dict:
    r = cfg.radix
    a = max_active_buckets(n, cfg)
    blocks = max_blocks(n, cfg)
    m1 = 2 * n * key_bits // 8
    m2 = 4 * r * a
    m3 = 4 * r * blocks
    m4 = 2 * 16 * blocks
    m5 = 12 * max_total_buckets(n, cfg)
    aux = m2 + m3 + m4 + m5
    return {
        "M1_input_and_aux": m1,
        "M2_bucket_histograms": m2,
        "M3_block_histograms": m3,
        "M4_block_assignments": m4,
        "M5_local_sort_assignments": m5,
        "aux_total": aux,
        "aux_over_m1": aux / max(m1, 1),
    }


# ----- memory-traffic model (the paper's headline argument) ----------------

def pass_counts(key_bits: int, d_hybrid: int = 8, d_lsd: int = 5) -> dict:
    """Worst-case counting passes: hybrid ⌈k/8⌉ vs LSD ⌈k/5⌉ (CUB)."""
    return {"hybrid": num_digits(key_bits, d_hybrid),
            "lsd": num_digits(key_bits, d_lsd)}


def traffic_bytes(n: int, key_bytes: int, value_bytes: int, passes: int,
                  reads_per_pass: int = 2, writes_per_pass: int = 1) -> int:
    """Device-memory traffic of a radix sort: each pass reads the keys twice
    (histogram + scatter) and writes once; values are read+written once per
    pass (scatter only)."""
    key_traffic = n * key_bytes * (reads_per_pass + writes_per_pass) * passes
    val_traffic = n * value_bytes * 2 * passes
    return key_traffic + val_traffic


def expected_speedup(key_bits: int, value_bytes: int = 0,
                     d_hybrid: int = 8, d_lsd: int = 5) -> float:
    """The paper's anticipated speedup from traffic reduction alone
    (e.g. 64-bit keys: 13 vs 8 passes -> 1.625x; 32-bit: 7 vs 4 -> 1.75x)."""
    kb = key_bits // 8
    n = 1  # ratio — n cancels
    h = traffic_bytes(n, kb, value_bytes, num_digits(key_bits, d_hybrid))
    l = traffic_bytes(n, kb, value_bytes, num_digits(key_bits, d_lsd))
    return l / h
