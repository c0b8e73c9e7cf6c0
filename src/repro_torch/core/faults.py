"""Fault injection, bounded retry, and checksum verification for oocsort.

Port of ``repro.core.faults``, kept whole and numpy-only so that the same
``FaultPolicy`` seed injects the same faults, at the same op indices, in
both packages.

The §5 out-of-core pipeline is exactly where real deployments fail: PCIe
transfers stall, device allocations OOM mid-round, host buffers rot while a
multi-round merge is in flight.  This module gives the out-of-core sort a
*deterministic* failure story in three layers:

  * :class:`FaultPolicy` — seed-driven injectable faults at every transfer
    and launch site of ``core.outofcore`` (``FAULT_SITES``).  Decisions are
    a pure function of ``(seed, site, per-site op index)``, so the same
    policy object replayed over the same oocsort schedule injects the same
    faults — the property the deterministic-replay tests pin.  Faults come
    in three kinds: ``transient`` (the op failed, retry it), ``fatal`` (the
    process dies mid-run — the kill half of the kill-and-resume test), and
    host-buffer ``corruption`` (a byte of a host-resident run is flipped in
    place, detectable only by checksum).
  * :class:`RetryPolicy` — bounded retries with capped exponential backoff.
    Every retry is ledger-tracked (:class:`FaultLedger`); when a site
    exhausts its retries oocsort raises :class:`RetriesExhausted` and
    walks its degradation ladder instead of crashing.
  * :func:`host_checksum` — an xxhash-style (fast, non-cryptographic)
    per-buffer checksum computed at each host crossing.  oocsort records
    a checksum when a run lands host-side and verifies it before the run is
    consumed, so silent corruption surfaces as :class:`ChecksumError`
    (recoverable from the last round checkpoint) instead of silently wrong
    output.

``guarded`` is the one chokepoint all sites go through: draw a fault
decision, account the attempt, back off, retry, escalate.  It is pure host
code wrapped *around* the transfer/launch callables, so the kernel launch
census of the guarded pipeline is exactly the census of the unguarded one —
a failed attempt never reaches its callable, and a retry calls it once.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np

# every transfer/launch site the out-of-core sort guards, in pipeline
# order: the chunk phase's upload / sort launch / run download, the spill
# merge's strip upload / merge launch / strip download, and the host-buffer
# corruption pseudo-site (drawn once per round of freshly landed runs).
FAULT_SITES = ("chunk_upload", "sort_launch", "run_download",
               "slab_upload", "merge_launch", "slab_download",
               "host_corruption")


class TransientFault(RuntimeError):
    """An injected recoverable failure (stalled transfer, failed launch)."""


class FatalFault(RuntimeError):
    """An injected unrecoverable failure: models the process dying mid-run.

    Carries the :class:`FaultLedger` at the moment of death so tests (and
    post-mortems) can see what the run had survived before it was killed.
    """

    def __init__(self, site: str, ledger: Optional["FaultLedger"] = None):
        super().__init__(f"fatal injected fault at site {site!r}")
        self.site = site
        self.ledger = ledger


class ChecksumError(RuntimeError):
    """A host-resident buffer no longer matches its recorded checksum."""


class RetriesExhausted(RuntimeError):
    """A site kept failing past ``RetryPolicy.max_retries``.

    The out-of-core sort catches this and walks its degradation ladder
    (shrink the device slab, reduce the merge fan-in, re-chunk smaller);
    it only propagates when the ladder itself is exhausted.
    """

    def __init__(self, site: str, attempts: int):
        super().__init__(f"site {site!r} failed {attempts} consecutive "
                         f"attempts (retries exhausted)")
        self.site = site
        self.attempts = attempts


def host_checksum(arr: np.ndarray) -> int:
    """xxhash-style checksum of a host buffer: fast, deterministic, 32-bit.

    crc32 over the raw bytes, mixed with the dtype and shape so a buffer
    reinterpreted under another dtype does not collide.  Computed at each
    host crossing of the out-of-core pipeline (run downloads, checkpoint
    publishes) and verified before the buffer is consumed.
    """
    a = np.ascontiguousarray(arr)
    h = zlib.crc32(a.view(np.uint8).reshape(-1))
    h = zlib.crc32(f"{a.dtype.str}{a.shape}".encode(), h)
    return h & 0xFFFFFFFF


def tree_checksums(arrs: Iterable[np.ndarray]) -> Tuple[int, ...]:
    """Checksum a flat sequence of host buffers (a run's keys + leaves)."""
    return tuple(host_checksum(a) for a in arrs)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with capped exponential backoff.

    ``max_retries`` counts *re*-attempts: an op is tried at most
    ``1 + max_retries`` times before :class:`RetriesExhausted`.  Backoff for
    retry i sleeps ``min(backoff_cap_s, backoff_base_s * 2**i)`` seconds —
    the default base of 0 keeps the test/interpret loop instant while the
    formula (and the ledger accounting) stays the production shape.
    """
    max_retries: int = 3
    backoff_base_s: float = 0.0
    backoff_cap_s: float = 0.05

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    def backoff_s(self, attempt: int) -> float:
        if self.backoff_base_s <= 0.0:
            return 0.0
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** attempt))


@dataclasses.dataclass
class FaultLedger:
    """Mutable per-run account of injected faults and recovery work.

    The out-of-core sort folds these counters into ``OocStats`` at the
    end of the run; the deterministic-replay tests assert two runs under
    the same seed produce identical ledgers.  ``retry_h2d_bytes`` /
    ``retry_d2h_bytes`` are the *extra* host-link bytes paid by failed
    transfer attempts (each failed attempt crossed the link before it was
    declared lost — the worst-case model), kept separate so the clean
    ``2·N·b·(1 + rounds)`` formulas stay exact.
    """
    retries: int = 0
    faults_injected: int = 0
    degradations: int = 0
    checksum_failures: int = 0
    rounds_checkpointed: int = 0
    retry_h2d_bytes: int = 0
    retry_d2h_bytes: int = 0

    @property
    def retry_link_bytes(self) -> int:
        return self.retry_h2d_bytes + self.retry_d2h_bytes


def _normalize_sites(mapping, what: str) -> Dict[str, frozenset]:
    out = {}
    for site, idxs in (mapping or {}).items():
        if site not in FAULT_SITES:
            raise ValueError(f"{what}: unknown fault site {site!r} "
                             f"(sites: {FAULT_SITES})")
        out[site] = frozenset(int(i) for i in idxs)
    return out


class FaultPolicy:
    """Deterministic, seed-driven fault points for the out-of-core sort.

    Three injection mechanisms compose (checked in this order per op):

      * ``fatal_at[site]``   — op indices that raise :class:`FatalFault`
        (the run dies; a checkpointed run resumes with ``resume_from``);
      * ``fail_at[site]``    — op indices that raise one
        :class:`TransientFault` each (bounded-retry fodder; N consecutive
        indices model N consecutive failures of one logical op);
      * ``rates[site]``      — a per-site fault probability; the decision
        for op i is a pure function of ``(seed, site, i)`` via a counter-
        keyed PRNG, so the schedule replays exactly under the same seed.

    Op indices are per-site visit counters that advance on every draw —
    including retries, so a ``fail_at`` entry of ``{0, 1}`` means "the
    first attempt and its first retry both fail".  Counters never reset
    (not across degradation restarts either), which is what lets a
    persistent fault burn through the retry budget and trigger the ladder.
    ``state()``/``load_state()`` expose the counters so a checkpoint
    manifest can persist mid-run fault-schedule position.

    ``host_corruption`` is a pseudo-site: when it fires,
    :meth:`maybe_corrupt` flips one deterministic byte of one host-resident
    run in place — detectable only by oocsort's checksum verification.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Mapping[str, float]] = None,
                 fail_at: Optional[Mapping[str, Sequence[int]]] = None,
                 fatal_at: Optional[Mapping[str, Sequence[int]]] = None):
        self.seed = int(seed)
        self.rates = dict(rates or {})
        for site, rate in self.rates.items():
            if site not in FAULT_SITES:
                raise ValueError(f"rates: unknown fault site {site!r} "
                                 f"(sites: {FAULT_SITES})")
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"rates[{site!r}] must be in [0, 1]")
        self.fail_at = _normalize_sites(fail_at, "fail_at")
        self.fatal_at = _normalize_sites(fatal_at, "fatal_at")
        self._counts: Dict[str, int] = {}

    # -- deterministic decision machinery ----------------------------------

    def _uniform(self, site: str, index: int) -> float:
        seq = np.random.SeedSequence(
            [self.seed, zlib.crc32(site.encode()), index])
        return float(np.random.default_rng(seq).random())

    def draw(self, site: str) -> Optional[str]:
        """Advance ``site``'s op counter and return the injected fault kind
        for this op: ``None`` (clean), ``"transient"`` or ``"fatal"``."""
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}")
        i = self._counts.get(site, 0)
        self._counts[site] = i + 1
        if i in self.fatal_at.get(site, ()):
            return "fatal"
        if i in self.fail_at.get(site, ()):
            return "transient"
        rate = self.rates.get(site, 0.0)
        if rate and self._uniform(site, i) < rate:
            return "transient"
        return None

    @property
    def corrupts(self) -> bool:
        """Whether this policy can ever fire the host_corruption site."""
        return bool(self.rates.get("host_corruption")
                    or self.fail_at.get("host_corruption")
                    or self.fatal_at.get("host_corruption"))

    def maybe_corrupt(self, arrays: Sequence[np.ndarray]) -> bool:
        """One host_corruption draw over a round's freshly landed runs.

        When it fires, flips one byte (xor 0xFF) of one non-empty buffer in
        place — buffer and byte chosen by the same counter-keyed PRNG, so
        the corruption replays deterministically.  Returns whether a byte
        was flipped.  Buffers must be writable (oocsort owns its host
        runs).
        """
        i = self._counts.get("host_corruption", 0)
        kind = self.draw("host_corruption")
        if kind is None:
            return False
        live = [a for a in arrays if a.nbytes > 0]
        if not live:
            return False
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, zlib.crc32(b"host_corruption.pick"), i]))
        victim = live[int(rng.integers(len(live)))]
        byte = int(rng.integers(victim.nbytes))
        victim.view(np.uint8).reshape(-1)[byte] ^= 0xFF
        return True

    # -- resume support ----------------------------------------------------

    def state(self) -> Dict[str, int]:
        """Per-site op counters (JSON-serializable, for checkpoint manifests)."""
        return dict(self._counts)

    def load_state(self, state: Mapping[str, int]) -> None:
        """Restore op counters so a resumed run continues the schedule."""
        self._counts = {str(k): int(v) for k, v in state.items()}


def guarded(site: str, fn, *args,
            policy: Optional[FaultPolicy],
            retry: Optional[RetryPolicy],
            ledger: FaultLedger,
            cost_bytes: int = 0,
            direction: Optional[str] = None,
            **kwargs):
    """Run ``fn(*args, **kwargs)`` through one fault point with retries.

    Each attempt first asks ``policy`` for a fault decision at ``site``:

      * fatal     — raise :class:`FatalFault` immediately (no retry);
      * transient — account the lost attempt (``cost_bytes`` in
        ``direction`` — failed transfers still crossed the link) and retry
        after ``retry.backoff_s``; past ``retry.max_retries`` raise
        :class:`RetriesExhausted` for oocsort's degradation ladder;
      * clean     — call ``fn`` and return its result.

    With ``policy=None`` this is a plain call: the guarded pipeline is
    byte- and launch-census-identical to the unguarded one.
    """
    if policy is None:
        return fn(*args, **kwargs)
    retry = retry or RetryPolicy()
    attempt = 0
    while True:
        kind = policy.draw(site)
        if kind == "fatal":
            ledger.faults_injected += 1
            raise FatalFault(site, ledger)
        if kind == "transient":
            ledger.faults_injected += 1
            if direction == "h2d":
                ledger.retry_h2d_bytes += cost_bytes
            elif direction == "d2h":
                ledger.retry_d2h_bytes += cost_bytes
            if attempt >= retry.max_retries:
                raise RetriesExhausted(site, attempt + 1)
            ledger.retries += 1
            backoff = retry.backoff_s(attempt)
            if backoff > 0.0:
                time.sleep(backoff)
            attempt += 1
            continue
        return fn(*args, **kwargs)
