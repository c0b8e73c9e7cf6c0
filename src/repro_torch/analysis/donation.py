"""In-place audit: every ping-pong / slab buffer is reused, never copied.

The §4.4 in-place replacement is only real if the alternate buffers handed
to a pass or a merge round are the buffers it writes.  The reference checks
``input_output_aliases`` on the traced call; the port's wrappers take the
alternates as arguments and return them, so the audit reads the recorded
launches (``trace.LaunchRecord``):

  * declared check — each kernel listed in the contract's ``donation``
    mapping has exactly the declared number of (alternate, written) pairs
    on every launch, and appears at least once;
  * structural checks on every alternate — it is the buffer the launch
    wrote and returned (same ``data_ptr``, shape and dtype), and the launch
    does not read it (its contents are garbage once the writes begin);
  * the silent-copy sweep — a 1-D write that is neither an alternate nor
    written in place, at least as large as the launch's largest read, with
    an identically-shaped buffer of the launch left unwritten, is a
    ping-pong buffer that was copied into a fresh one (the accumulator
    outputs and the 2-D tables don't trip it).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis import expr


def _desc(b) -> str:
    return f"{b.dtype}{list(b.shape)}"


def audit_record(rec) -> List[str]:
    """Structural findings for one launch (empty = clean)."""
    findings: List[str] = []
    reads = {b.ptr for b in rec.reads}
    written = {b.ptr: b for b in rec.writes}
    for a in rec.alts:
        w = written.get(a.ptr)
        if w is None:
            findings.append(
                f"{rec.name}: alternate buffer {_desc(a)} is not among the "
                f"buffers the launch wrote and returned")
            continue
        if (w.shape, w.dtype) != (a.shape, a.dtype):
            findings.append(f"{rec.name}: alternate {_desc(a)} came back as "
                            f"{_desc(w)}")
        if a.ptr in reads:
            findings.append(f"{rec.name}: alternate buffer {_desc(a)} is "
                            f"also read by the launch")

    if rec.reads:
        buf_max = max(b.nbytes for b in rec.reads)
        handed = {b.ptr for b in rec.alts} | reads
        spare = [b for b in (*rec.alts, *rec.reads) if b.ptr not in written]
        for w in rec.writes:
            if w.ptr in handed or len(w.shape) != 1 or w.nbytes < buf_max:
                continue
            if any((b.shape, b.dtype) == (w.shape, w.dtype) for b in spare):
                findings.append(
                    f"{rec.name}: wrote a fresh full-size buffer "
                    f"{_desc(w)} while an identically-shaped buffer it was "
                    f"handed stayed unwritten — the ping-pong buffer "
                    f"silently copies instead of being reused")
    return findings


def pairs(rec) -> int:
    """(alternate, written) pairs of one launch."""
    written = {b.ptr for b in rec.writes}
    reads = {b.ptr for b in rec.reads}
    return sum(1 for a in rec.alts if a.ptr in written and a.ptr not in reads)


def check_donation(recs, decl: Dict[str, str], params: Dict) -> List[str]:
    """Declared + structural in-place audit over a run's launches."""
    findings: List[str] = []
    expected = {k: int(expr.evaluate(f, params))
                for k, f in (decl or {}).items()}
    seen = {k: 0 for k in expected}
    for rec in recs:
        findings.extend(audit_record(rec))
        want = expected.get(rec.name)
        if want is not None:
            seen[rec.name] += 1
            got = pairs(rec)
            if got != want:
                findings.append(f"{rec.name}: expected {want} in-place "
                                f"alternate pair(s), found {got}")
    for kname, n in seen.items():
        if n == 0:
            findings.append(
                f"declared donation kernel {kname!r} never launched")
    return findings
