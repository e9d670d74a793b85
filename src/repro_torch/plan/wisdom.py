"""Persistent planner wisdom — FFTW's wisdom lifecycle for this repo.

Counterpart of ``repro.plan.wisdom``, with the same file format: the same
v3 key grammar, served versions and entry schema, so a wisdom file written
by either package loads in the other.  The ``backend=`` field of a key is
the plan's device type, ``cuda`` (or ``cpu`` when the caller planned for
the host).

A wisdom file is a small versioned JSON document mapping a plan key

    n=<N>|dtype=<dtype>|p=<p>|method=<method>|backend=<backend>

to the plan a previous tuning run chose (plus how it was chosen and the
measured time, when there is one).  ``plan_pfft(tune=..., wisdom=path)``
consults it before tuning, so a process that measured once warms every
later process — the serving story the ROADMAP needs: plans for hot sizes
are selected once and then served from disk.

Since schema v2 an entry's value is either a single ``PlanConfig``
(``"config"``, the degenerate case — e.g. microbenchmark sweeps) or a
full heterogeneous ``SegmentSchedule`` (``"schedule"``), so a tuner that
once picked per-segment variants serves the exact mix back.  v1 stores
predate schedules and are treated as whole-file misses.

Schema v3 adds *per-topology* keys for distributed plans: a key may end
in ``|topo=<topology_digest>`` (device count, mesh axis name, platform,
candidate pipeline-panel counts), so a plan measured end-to-end on a
4-device mesh is never served to an 8-device one.  Heterogeneous
*device-group* picks (the reference's ``plan/groups.py``) need no bump of their own:
they are ordinary ``SegmentSchedule`` values under the same topo keys —
the v2 schedule wire format already round-trips them; serving-side
validation (does the stored schedule still lower to *this* mesh?) lives
with the lookup callers, never in the store.  v2 files keep being
served for *single-host* keys (their entry schema is unchanged), but any
``topo=`` lookup against a v2 file is a miss: v2 predates distributed
measurement, so whatever a v2 store claims about a topology key was not
measured on that topology.  v1 stays a whole-file miss.

Writes are atomic (write a sibling ``.tmp``, then ``os.replace`` — the
same idiom as ``save_fpms``) so concurrent readers never observe a torn
file.  A version bump invalidates the whole store: old entries were
chosen under a different cost model / config schema, so a mismatch is
treated as a miss, never an error.
"""

from __future__ import annotations

import json
import os
import time
import zlib

import numpy as np

from repro_torch.plan.config import PlanConfig
from repro_torch.plan.schedule import SegmentSchedule

__all__ = [
    "WISDOM_VERSION",
    "wisdom_key",
    "partition_digest",
    "topology_digest",
    "load_wisdom",
    "lookup_wisdom",
    "record_wisdom",
]

WISDOM_VERSION = 3
# v2 entries are schema-compatible (config/schedule values); serving them
# for single-host keys spares a re-tune.  Distributed (topo=) lookups
# treat a v2 file as a miss — see module docstring and lookup_wisdom.
_SERVED_VERSIONS = (2, WISDOM_VERSION)
_TOPO_FIELD = "|topo="


def wisdom_key(*, n: int, dtype: str, p: int, method: str, backend: str,
               detail: str | None = None, topology: str | None = None) -> str:
    """Canonical store key; every field that changes the best config is in it.

    ``detail`` carries anything beyond (n, dtype, p, method, backend) the
    best config depends on — for the FPM methods, a digest of the
    partition and pad lengths (different FPMSets/eps give different
    partitions, which change the dispatch counts the tuner prices).
    Method 'lb' needs none: its partition is a function of (n, p).
    ``topology`` marks a *distributed* plan: the ``topology_digest`` of
    the mesh the plan was (or is to be) measured on — an end-to-end
    all_to_all time is a property of the topology, so the same problem on
    a different mesh must be a different key.
    """
    base = f"n={int(n)}|dtype={dtype}|p={int(p)}|method={method}|backend={backend}"
    if detail is not None:
        base = f"{base}|part={detail}"
    if topology is not None:
        base = f"{base}{_TOPO_FIELD}{topology}"
    return base


def partition_digest(d, pad_lengths=None) -> str:
    """The ``detail`` digest of an FPM partition (+ pad lengths).

    Shared by ``plan_pfft`` and the microbenchmark's wisdom warmer so
    both sides key FPM-method entries identically — a different
    FPMSet/eps gives a different partition, which must not be served
    another model's plan.
    """
    raw = np.asarray(d, dtype=np.int64).tobytes()
    if pad_lengths is not None:
        raw += np.asarray(pad_lengths, dtype=np.int64).tobytes()
    return format(zlib.crc32(raw), "08x")


def topology_digest(mesh=None, axis_name="fft", *,
                    devices: int | None = None, platform: str | None = None,
                    panels=(1,), hosts: int | None = None) -> str:
    """The ``topology`` field of a distributed wisdom key.

    Everything an end-to-end distributed measurement is conditioned on:
    the device count along the FFT mesh axis, the axis name (it names the
    collective's communicator), the device platform, and the candidate
    pipeline-panel counts the tuner raced (a different panel space is a
    different tuning experiment).  Deliberately human-readable — a store
    should say *which* pod an entry was measured on, not just hash it.

    ``axis_name`` may be a *sequence* of axis names (the pencil-parallel
    3-D pipeline's 2-D mesh): the digest then carries one ``<size>x<name>``
    term per axis, '+'-joined (e.g. ``4xfft_r+2xfft_c.cpu.k1-2``).  The
    form is injective against 1-D digests ('+' never appears there) and
    against the transposed mesh (``4xfft_r+2xfft_c != 2xfft_r+4xfft_c``),
    so a plan measured on one pencil shape is never served to another.

    A mesh spanning more than one host prefixes a host-count component:
    ``2hx4xfft.cpu.k1-2-4`` is two hosts of two devices — comm times on
    it are two-tier quantities that must not be served to the one-host
    ``4xfft.cpu.k1-2-4`` (nor to ``4hx4xfft...``).  The prefix's ``<n>h``
    cannot occur at the head of a single-host digest (those start
    ``<devices>x``), so multi-host digests are injective against every
    pre-multi-host form — and single-host digests are *unchanged*, so
    existing stores keep serving single-host lookups.  ``hosts`` is passed
    explicitly (default 1).

    Only the ``devices=`` form is ported: a digest read off a mesh raises
    ``NotImplementedError`` until the distributed slice brings meshes to the
    port.  ``platform`` defaults to ``cuda``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "topology_digest(mesh=...): meshes are not in repro_torch yet; "
            "they come with the distributed slice — pass devices= and "
            "platform=")
    if not isinstance(axis_name, str):
        raise ValueError("a multi-axis topology_digest needs mesh=")
    if devices is None:
        raise ValueError("topology_digest needs a mesh or devices=")
    if hosts is None:
        hosts = 1
    if platform is None:
        platform = "cuda"
    ks = "-".join(str(int(k)) for k in sorted(set(panels))) or "1"
    prefix = f"{int(hosts)}hx" if int(hosts) > 1 else ""
    return f"{prefix}{int(devices)}x{axis_name}.{platform}.k{ks}"


def _load_doc(path: str) -> tuple[int, dict]:
    """(version, entries) of a wisdom file; (0, {}) on missing, corrupt,
    or unserveable-version files (all are cache misses, never errors)."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return 0, {}
    if not isinstance(doc, dict) or doc.get("version") not in _SERVED_VERSIONS:
        return 0, {}
    entries = doc.get("entries")
    return int(doc["version"]), entries if isinstance(entries, dict) else {}


def load_wisdom(path: str) -> dict:
    """Entries of a wisdom file; {} on missing, corrupt, or version-mismatched
    files (all are cache misses, never errors).  Serves v2 stores as well
    as v3 — per-key version rules live in ``lookup_wisdom``."""
    return _load_doc(path)[1]


def lookup_wisdom(path: str, key: str
                  ) -> tuple[PlanConfig | SegmentSchedule, dict] | None:
    """(plan, full entry) for ``key``, or None on any kind of miss.

    The plan is a ``SegmentSchedule`` when the entry persisted one, else
    the single ``PlanConfig`` — callers (``plan_pfft``) lift a bare
    config into the degenerate schedule for the current partition.
    A distributed (``topo=``) key against a v2 store is always a miss,
    whatever the file contains: v2 predates per-topology measurement.
    """
    version, entries = _load_doc(path)
    if version < WISDOM_VERSION and _TOPO_FIELD in key:
        return None
    entry = entries.get(key)
    if not isinstance(entry, dict):
        return None
    try:
        if "schedule" in entry:
            return SegmentSchedule.from_dict(entry["schedule"]), entry
        return PlanConfig.from_dict(entry["config"]), entry
    except (KeyError, TypeError, ValueError):
        return None  # schema drift inside an entry is also just a miss


def _acquire_lock(path: str, timeout_s: float | None):
    """Exclusive flock on the store's ``.lock`` sibling, or None when the
    platform has no ``fcntl`` (the write is then merely atomic).

    ``timeout_s=None`` blocks, the historical behavior.  A finite timeout
    polls non-blocking acquisitions with backoff and raises
    ``TimeoutError`` when a wedged writer still holds the lock — callers
    for whom the store is advisory (the self-healing re-planner) catch it
    and move on rather than hang recovery behind a stuck process.
    """
    try:
        import fcntl
        lock_fh = open(path + ".lock", "w")
    except (ImportError, OSError):
        return None
    if timeout_s is None:
        try:
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
        except OSError:
            lock_fh.close()
            return None
        return lock_fh
    deadline = time.monotonic() + float(timeout_s)
    delay = 0.01
    while True:
        try:
            fcntl.flock(lock_fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return lock_fh
        except OSError:
            if time.monotonic() >= deadline:
                lock_fh.close()
                raise TimeoutError(
                    f"wisdom lock {path + '.lock'} still held after "
                    f"{timeout_s:g}s")
            time.sleep(delay)
            delay = min(delay * 2.0, 0.25)


def record_wisdom(path: str, key: str, config: PlanConfig | SegmentSchedule,
                  *, mode: str, time_s: float | None = None,
                  extra: dict | None = None, retries: int = 0,
                  backoff_s: float = 0.05,
                  lock_timeout_s: float | None = None) -> None:
    """Insert/overwrite one entry, atomically rewriting the store.

    The load-modify-replace cycle holds an exclusive flock on a ``.lock``
    sibling so concurrent writers (a benchmark warming sizes while a
    serving process records its own measure) don't drop each other's
    entries; on platforms without ``fcntl`` the write is merely atomic.

    ``retries`` re-attempts a failed write (``OSError``) with exponential
    backoff — transient I/O pressure should not cost a measured plan.
    ``lock_timeout_s`` bounds the wait for a contended lock (raises
    ``TimeoutError`` — see ``_acquire_lock``); the default ``None``
    blocks, preserving historical behavior.
    """
    lock_fh = _acquire_lock(path, lock_timeout_s)
    try:
        entries = load_wisdom(path)
        if isinstance(config, SegmentSchedule):
            entry: dict = {"schedule": config.to_dict(), "mode": mode}
        else:
            entry = {"config": config.to_dict(), "mode": mode}
        if time_s is not None:
            entry["time_s"] = float(time_s)
        if extra:
            entry.update(extra)
        entries[key] = entry
        doc = {"version": WISDOM_VERSION, "entries": entries}
        delay = float(backoff_s)
        for attempt in range(int(retries) + 1):
            try:
                tmp = path + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump(doc, fh, indent=2, sort_keys=True)
                os.replace(tmp, path)
                break
            except OSError:
                if attempt >= retries:
                    raise
                time.sleep(delay)
                delay *= 2.0
    finally:
        if lock_fh is not None:
            lock_fh.close()
