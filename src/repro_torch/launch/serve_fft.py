"""Transform-serving: continuous batching of mixed-size request streams.

Counterpart of ``repro.launch.serve_fft``.  The schedule executor already
coalesces *one matrix's* segments into one dispatch per distinct (length,
config) group (``batch_groups``); this service generalises that idea to
*many users' concurrent requests*: an async queue plus a tick loop that
coalesces every same-``(n, dtype, method)`` request waiting at tick time
into a single batch-stacked dispatch (``PfftPlan.execute_many`` — a plan
runs each dispatch group of each phase once over the rows of a whole
batch, so a cohort costs the kernel launches of one request).

    svc = FFTService(wisdom="wisdom.json", tune="estimate")
    async with svc:
        half = await svc.submit(image, method="rfft-lb")

Three layers, each doing one job:

* **Plan resolution** is a cache hierarchy: request -> in-memory
  ``PlanCache`` (bounded LRU of built plans, their index tensors and
  twiddle tables on the device included; a hit is zero-retune *and*
  zero-rebuild) -> wisdom store (a stored schedule skips the tuner) ->
  tuner (estimate/measure).  Freshly tuned
  picks are written back to the wisdom store, so a restarted service —
  or another process sharing the file — starts warm; the cache's
  ``retunes`` counter audits the whole stack (a warm second run must
  report zero).
* **Admission and shedding are cost-priced**, not count-based: the FPM
  cost model (``repro_torch.plan.cost`` with the constants of the
  service's device type, ``batch=`` cohorts) predicts every cohort's
  makespan.  A request whose *single-transform* prediction
  exceeds ``max_request_s`` is rejected at submit with a priced
  ``AdmissionError`` (an oversized outlier must not stall the queue
  behind it); a tick whose predicted makespan would exceed
  ``tick_budget_s`` splits the marginal cohort (the cohort cost is
  affine in the batch, so the largest admissible prefix is solved in
  closed form) and defers lower-priority cohorts to later ticks;
  requests whose deadline lapses before dispatch are shed with a priced
  ``DeadlineExceeded``.
* **The tick loop is the batching window**: while one tick's cohorts
  run on device, new submissions queue up, and the next tick coalesces
  whatever accumulated — continuous batching, no timer to tune.  Batch
  sizes are bucketed (``execute_many(pad_to=_bucket(k))``), as in the
  reference, whose jitted programs specialise on the stacked shape.

The synchronous core (``enqueue``/``tick``) is fully deterministic —
tests and benchmarks drive it tick by tick — and ``submit``/
``serve_forever`` are the thin asyncio surface over it.  The service is
single-loop (one host program driving one device: ``device=None`` is the
card, raising at construction without one; ``device="cpu"`` serves on the
host through the kernels' plain versions).  Results go back to the
tickets as host numpy arrays, so the copy back is where a dispatch waits
for the device.  Cross-process concurrency is the wisdom store's flock
business, not ours.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.plan.cache import PlanCache
from repro_torch.plan.config import PlanConfig
from repro_torch.plan.cost import (CostParams, estimate_cost,
                                   estimate_pfft3_cost,
                                   estimate_schedule_cost)

__all__ = ["AdmissionError", "DeadlineExceeded", "CohortKey",
           "RequestTicket", "FFTService"]

_clock = time.perf_counter   # monotonic: latency math must not see NTP steps

_REAL_PREFIX = "rfft-"
_CTYPES = {"complex64", "complex128"}
_RTYPES = {"float32", "float64"}

# Method families with non-square request shapes: cubic N^3 signals
# (``plan_pfft3``) and huge 1-D lines (``plan_pfft1_large``).  Everything
# else serves the square (N, N) transform through ``plan_pfft``.
_PFFT3_METHODS = frozenset({"pfft3-lb"})
_LARGE1D_METHODS = frozenset({"pfft1-large"})


def _bucket(b: int, quantum: int = 4) -> int:
    """The batch-shape bucket dispatch pads to: powers of two up to
    ``quantum``, then multiples of ``quantum``.

    The reference's jit specialises on the stacked shape, so every
    distinct cohort size would otherwise be its own trace+compile; pure
    pow2 bucketing keeps the program count logarithmic but wastes up to
    half the batch on zero padding — ruinous when the padded transforms
    are the expensive sizes.  Quantised buckets cap the waste at
    ``quantum - 1`` signals — and a lone request still pays no padding
    (1 and 2 are their own buckets).  The port keeps the same buckets, so
    that both services dispatch the same stacks.
    """
    b = max(int(b), 1)
    if b <= quantum:
        return 1 << (b - 1).bit_length()
    return -(-b // quantum) * quantum


class AdmissionError(RuntimeError):
    """Priced rejection: the cost model's prediction and the budget it
    broke ride the exception, so a client (or a load balancer above it)
    can see *why* — and by how much — the request was refused."""

    def __init__(self, reason: str, *, predicted_s: float, budget_s: float):
        super().__init__(
            f"{reason} (predicted {predicted_s * 1e3:.3f} ms vs "
            f"budget {budget_s * 1e3:.3f} ms)")
        self.predicted_s = float(predicted_s)
        self.budget_s = float(budget_s)


class DeadlineExceeded(AdmissionError):
    """Shed: the request's deadline lapsed while it waited for a tick."""


class CohortKey(NamedTuple):
    """The coalescing key: requests agreeing on all three share one
    plan and one stacked dispatch per tick.

    A ``NamedTuple`` rather than a dataclass: the key is hashed on
    every enqueue, price lookup, and cohort grouping — the tuple's
    C-level hash/eq keeps the per-request queue tax in the microseconds.
    """
    n: int
    method: str
    dtype: str


class RequestTicket:
    """A submitted request's handle: resolved by a later tick.

    ``result()`` returns the transform (or re-raises the failure) once
    ``done``; the asyncio surface awaits ``_ensure_event()`` instead of
    polling.  ``latency_s`` is submit-to-resolution on the service's
    monotonic clock — the number the benchmark's percentiles are built
    from.
    """

    __slots__ = ("key", "priority", "t_submit", "deadline", "m", "done",
                 "latency_s", "_value", "_error", "_event")

    def __init__(self, key: CohortKey, m: np.ndarray, priority: int,
                 t_submit: float, deadline: float | None):
        self.key = key
        self.m = m
        self.priority = int(priority)
        self.t_submit = t_submit
        self.deadline = deadline
        self.done = False
        self.latency_s: float | None = None
        self._value: Any = None
        self._error: BaseException | None = None
        self._event: asyncio.Event | None = None

    def result(self):
        if not self.done:
            raise RuntimeError("request not served yet (tick pending)")
        if self._error is not None:
            raise self._error
        return self._value

    def _ensure_event(self) -> asyncio.Event:
        if self._event is None:
            self._event = asyncio.Event()
            if self.done:
                self._event.set()
        return self._event

    def _resolve(self, value: Any, error: BaseException | None,
                 latency_s: float | None) -> None:
        self._value, self._error = value, error
        self.latency_s = latency_s
        self.done = True
        self.m = None   # drop the payload reference once served
        if self._event is not None:
            self._event.set()


class FFTService:
    """Coalescing transform server over ``plan_pfft`` (module docstring).

    Parameters
    ----------
    device:
        Where every plan lives and runs: ``None`` is the CUDA device
        (raising here when there is none), ``"cpu"`` the host.
    p, fpms, tune, wisdom, eps:
        Forwarded to ``plan_pfft`` when a cohort's plan is built:
        ``p`` abstract processors for the ``lb`` methods, ``fpms`` for
        the FPM ones, ``tune`` the planner rigor, ``wisdom`` the
        persistent store the plan cache fronts.
    methods:
        The admissible ``method`` values (defense against a client
        naming an arbitrary plan method); default ``("lb", "rfft-lb")``.
        ``"pfft3-lb"`` (cubic N^3 signals via ``plan_pfft3``) and
        ``"pfft1-large"`` (huge 1-D lines via ``plan_pfft1_large``) are
        also servable when listed here — their requests are validated
        against their own shapes and priced with their own cost terms.
    tick_budget_s:
        Predicted-makespan budget of one tick — the latency the queue
        is allowed to add while coalescing.  Cohorts beyond it are
        split or deferred.
    max_request_s:
        Admission bound on a *single* transform's predicted cost
        (default: ``tick_budget_s``).  Oversized outliers are rejected
        with a priced error rather than wedging every later tick.
    max_queue:
        Queue-depth bound; past it submissions are rejected (priced
        with the predicted backlog of the queue ahead).
    max_cohort:
        Largest single coalesced dispatch.  Batching returns diminish
        well before this, while bucket padding and the stacked batch's
        device memory grow with the cohort — so a huge cohort is served
        as full-cap chunks across consecutive ticks, bounding padding
        waste to the final chunk.
    cache_size:
        The plan LRU bound (``repro_torch.plan.cache.PlanCache``).
    params:
        ``CostParams`` override for pricing (default: the constants of
        the device type, ``CostParams.for_backend(device.type)``).
    write_back:
        Record freshly tuned picks into the wisdom store so restarts
        (and sibling processes) are warm.  Measure-mode picks are
        already recorded by ``plan_pfft`` itself; this covers the
        estimate-mode picks a serving process otherwise re-derives
        every boot.
    """

    def __init__(self, *, p: int = 1, fpms=None, tune: str = "estimate",
                 wisdom: str | None = None, eps: float = 0.05,
                 methods: Sequence[str] = ("lb", "rfft-lb"),
                 tick_budget_s: float = 0.05,
                 max_request_s: float | None = None,
                 max_queue: int = 4096, max_cohort: int = 32,
                 cache_size: int = 64,
                 params: CostParams | None = None,
                 write_back: bool = True,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.p = int(p)
        self.fpms = fpms
        self.tune = tune
        self.wisdom = wisdom
        self.eps = float(eps)
        self.methods = tuple(methods)
        self.tick_budget_s = float(tick_budget_s)
        self.max_request_s = max_request_s
        self.max_queue = int(max_queue)
        self.max_cohort = max(int(max_cohort), 1)
        self.write_back = bool(write_back)
        self._params = params if params is not None \
            else CostParams.for_backend(self.device.type)
        self._cache = PlanCache(maxsize=cache_size)
        self._price_memo: dict[CohortKey, tuple[float, float]] = {}
        self._pending: list[RequestTicket] = []
        self._running = False
        self._wake: asyncio.Event | None = None
        self._stats = self._fresh_stats()

    # ---- pricing -------------------------------------------------------

    def price(self, n: int, method: str = "lb", *, dtype: str | None = None,
              batch: int = 1) -> float:
        """Predicted seconds for ``batch`` coalesced (n, n) transforms.

        Priced with the cached plan's own schedule when one is built
        (its configs carry backend multipliers), else with the method's
        default config — the same numbers every admission and tick
        decision uses, exposed so clients and tests can reason about
        budgets in the model's units.
        """
        real = method.startswith(_REAL_PREFIX)
        if dtype is None:
            dtype = "float32" if real else "complex64"
        p1, var = self._cohort_price(CohortKey(int(n), method, dtype))
        return p1 + (max(int(batch), 1) - 1) * var

    def _cohort_price(self, key: CohortKey) -> tuple[float, float]:
        """(p1, var): the cohort's affine price law — ``batch`` coalesced
        transforms cost ``p1 + (batch - 1) * var`` predicted seconds.

        Memoized per key (invalidated when the key's plan is built, since
        a real schedule reprices its default config): the cost model runs
        twice per cohort *kind*, not once per request — admission and
        tick assembly stay O(1) model evaluations on the hot path.
        """
        cached = self._price_memo.get(key)
        if cached is not None:
            return cached
        plan = self._cache.peek(key)
        if key.method in _PFFT3_METHODS:
            # Cubes: three 2-D-sized passes per signal, priced linearly as
            # the reference prices them, although the batched execute runs
            # one dispatch per group per phase whatever the cohort size
            # (ROADMAP Queue 3).
            cfg = plan.config if plan is not None else PlanConfig()
            p1 = estimate_pfft3_cost(cfg, n=key.n, params=self._params)
            law = (p1, p1)
        elif key.method in _LARGE1D_METHODS:
            # Lines: the four-step estimate at the plan's factorization,
            # linear like the cubes'.
            from repro_torch.plan.tune import tune_pfft1_large
            if plan is not None:
                _, info = tune_pfft1_large(key.n, n1=plan.n1, n2=plan.n2,
                                           params=self._params)
            else:
                _, info = tune_pfft1_large(key.n, params=self._params)
            p1 = float(info["ranked"][0][1])
            law = (p1, p1)
        elif plan is not None:
            p1 = estimate_schedule_cost(plan.schedule, params=self._params)
            p2 = estimate_schedule_cost(plan.schedule, params=self._params,
                                        batch=2)
            law = (p1, max(p2 - p1, 0.0))
        else:
            cfg = PlanConfig(real=key.method.startswith(_REAL_PREFIX))
            p1 = estimate_cost(cfg, n=key.n, params=self._params)
            p2 = estimate_cost(cfg, n=key.n, params=self._params, batch=2)
            law = (p1, max(p2 - p1, 0.0))
        self._price_memo[key] = law
        return law

    def _max_request_s(self) -> float:
        return self.tick_budget_s if self.max_request_s is None \
            else float(self.max_request_s)

    # ---- admission + queue ---------------------------------------------

    @staticmethod
    def _canonical_dtype(kind: np.dtype, method: str) -> str:
        if method.startswith(_REAL_PREFIX):
            return "float64" if kind == np.float64 else "float32"
        return "complex128" if kind in (np.complex128, np.float64) \
            else "complex64"

    def enqueue(self, m, *, method: str = "lb", priority: int = 0,
                deadline_s: float | None = None) -> RequestTicket:
        """Admit one (n, n) request into the queue (synchronous core).

        Raises a priced ``AdmissionError`` when the queue is full or the
        request's own predicted cost exceeds ``max_request_s``; returns
        a ``RequestTicket`` a later ``tick()`` resolves.  ``priority``:
        larger serves earlier; ``deadline_s`` is relative to now — a
        request still queued past it is shed, never served late.
        """
        arr = np.asarray(m)
        if method in _PFFT3_METHODS:
            if arr.ndim != 3 or len(set(arr.shape)) != 1:
                raise ValueError(
                    f"method {method!r} serves cubic (N, N, N) signals, "
                    f"got {arr.shape}")
        elif method in _LARGE1D_METHODS:
            if arr.ndim != 1:
                raise ValueError(
                    f"method {method!r} serves 1-D length-N lines, "
                    f"got {arr.shape}")
        elif arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
            raise ValueError(
                f"serve_fft transforms square (N, N) signals, got "
                f"{arr.shape}; batch by submitting one request per signal")
        if method not in self.methods:
            raise ValueError(f"method {method!r} not served (admissible: "
                             f"{self.methods})")
        n = int(arr.shape[0])
        key = CohortKey(n, method, self._canonical_dtype(arr.dtype, method))
        self._stats["submitted"] += 1
        predicted = self._cohort_price(key)[0]
        cap = self._max_request_s()
        if predicted > cap:
            self._stats["rejected"] += 1
            raise AdmissionError(
                f"oversized transform n={n} method={method}",
                predicted_s=predicted, budget_s=cap)
        if len(self._pending) >= self.max_queue:
            self._stats["rejected"] += 1
            backlog = sum(self._cohort_price(r.key)[0]
                          for r in self._pending[:64])
            raise AdmissionError(
                f"queue full ({len(self._pending)} pending)",
                predicted_s=backlog, budget_s=self.tick_budget_s)
        now = _clock()
        # asarray, not astype: a payload already in the canonical dtype
        # (the common case) is enqueued by reference, no copy.
        ticket = RequestTicket(
            key, np.asarray(arr, dtype=key.dtype), priority, now,
            None if deadline_s is None else now + float(deadline_s))
        self._pending.append(ticket)
        if self._wake is not None:
            self._wake.set()
        return ticket

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    # ---- plans ---------------------------------------------------------

    def _get_plan(self, key: CohortKey):
        def build():
            if key.method in _PFFT3_METHODS:
                from repro_torch.core.api import plan_pfft3
                plan = plan_pfft3(key.n, p=min(self.p, key.n),
                                  tune=self.tune, wisdom=self.wisdom,
                                  dtype=key.dtype, device=self.device)
            elif key.method in _LARGE1D_METHODS:
                from repro_torch.core.api import plan_pfft1_large
                plan = plan_pfft1_large(key.n, tune=self.tune,
                                        wisdom=self.wisdom, dtype=key.dtype,
                                        device=self.device)
            else:
                from repro_torch.core.api import plan_pfft
                plan = plan_pfft(key.n, p=self.p, fpms=self.fpms,
                                 method=key.method, eps=self.eps,
                                 tune=self.tune, wisdom=self.wisdom,
                                 dtype=key.dtype, device=self.device)
            src = plan.tuning.get("source", "?")
            self._stats["sources"][src] = \
                self._stats["sources"].get(src, 0) + 1
            if self.write_back and self.wisdom and src == "estimate":
                # Measure picks were recorded by plan_pfft already; the
                # store is advisory here, so a wedged lock is a counter,
                # not a stalled tick.  The 3-D/1-D families persist their
                # single config (they have no segment schedule).
                from repro_torch.plan.wisdom import record_wisdom
                payload = getattr(plan, "schedule", None)
                if payload is None:
                    payload = plan.config
                try:
                    record_wisdom(self.wisdom, plan.tuning["wisdom_key"],
                                  payload, mode="estimate",
                                  retries=2, lock_timeout_s=5.0)
                except TimeoutError:
                    self._stats["wisdom_write_timeouts"] += 1
            # The built plan's schedule reprices this cohort.
            self._price_memo.pop(key, None)
            return plan

        plan, _hit = self._cache.get(key, build)
        return plan

    # ---- the tick ------------------------------------------------------

    def _shed_expired(self, now: float) -> None:
        kept = []
        for r in self._pending:
            if r.deadline is not None and now > r.deadline:
                err = DeadlineExceeded(
                    f"deadline lapsed before dispatch (n={r.key.n}, "
                    f"method={r.key.method})",
                    predicted_s=self.price(r.key.n, r.key.method,
                                           dtype=r.key.dtype),
                    budget_s=max(r.deadline - r.t_submit, 0.0))
                r._resolve(None, err, None)
                self._stats["shed_deadline"] += 1
            else:
                kept.append(r)
        self._pending = kept

    def _assemble(self, now: float) -> list[tuple[CohortKey, list[RequestTicket]]]:
        """Pick this tick's cohorts under the predicted-makespan budget.

        Cohorts are ordered by (priority desc, oldest submit); each is
        priced as one coalesced dispatch (``price(batch=k)`` is affine
        in k, so the largest prefix fitting the remaining budget is a
        closed-form solve).  A partial fit is a *split* (the suffix
        waits), a nonfit is a *deferral* — and the head cohort always
        gets at least one request, so a nonempty queue always makes
        progress whatever the budget says.
        """
        groups: dict[CohortKey, list[RequestTicket]] = {}
        for r in self._pending:
            groups.setdefault(r.key, []).append(r)
        ordered = sorted(
            groups.items(),
            key=lambda kv: (-max(r.priority for r in kv[1]),
                            min(r.t_submit for r in kv[1])))
        remaining = self.tick_budget_s
        picked: list[tuple[CohortKey, list[RequestTicket]]] = []
        taken: set[int] = set()
        for key, reqs in ordered:
            p1, var = self._cohort_price(key)
            if p1 <= remaining:
                k = len(reqs) if var <= 0.0 else \
                    min(len(reqs), max(int((remaining - (p1 - var)) // var), 1))
            elif not picked:
                k = 1   # progress guarantee: the head never starves
            else:
                self._stats["deferred_cohorts"] += 1
                continue
            k = min(k, self.max_cohort)   # bound padding waste + compiles
            if k < len(reqs):
                self._stats["splits"] += 1
            remaining -= p1 + (k - 1) * var
            picked.append((key, reqs[:k]))
            taken.update(id(r) for r in reqs[:k])
        if taken:
            self._pending = [r for r in self._pending if id(r) not in taken]
        return picked

    def _dispatch(self, key: CohortKey, reqs: list[RequestTicket]) -> int:
        stages: dict[str, float] = {}
        try:
            plan = self._get_plan(key)
            before = launch_counts()
            # execute_many returns host arrays: the copy back waited for
            # the device.
            outs = plan.execute_many([r.m for r in reqs],
                                     pad_to=_bucket(len(reqs)), stages=stages)
            after = launch_counts()
        except Exception as e:   # a bad cohort fails its own requests only
            for r in reqs:
                r._resolve(None, e, None)
            self._stats["failed"] += len(reqs)
            return 0
        t_done = _clock()
        for r, out in zip(reqs, outs):
            lat = t_done - r.t_submit
            r._resolve(out, None, lat)
            self._stats["latencies_s"].append(lat)
        self._stats["cohorts"].append({
            "n": key.n, "method": key.method, "dtype": key.dtype,
            "size": len(reqs), "bucket": _bucket(len(reqs)),
            "config": plan.config.describe(),
            "launches": {k: v - before[k] for k, v in after.items()
                         if v != before[k]}, **stages})
        self._stats["dispatches"] += 1
        self._stats["served"] += len(reqs)
        if len(reqs) >= 2:
            self._stats["coalesced_dispatches"] += 1
        self._stats["max_coalesced"] = max(self._stats["max_coalesced"],
                                           len(reqs))
        return len(reqs)

    def tick(self) -> int:
        """One serving tick: shed expired, assemble cohorts, dispatch.

        Returns the number of requests served.  Deterministic and
        synchronous — the asyncio loop calls it, and so can a test.
        """
        if not self._pending:
            return 0
        self._stats["ticks"] += 1
        now = _clock()
        self._shed_expired(now)
        served = 0
        for key, reqs in self._assemble(now):
            served += self._dispatch(key, reqs)
        return served

    def drain(self) -> int:
        """Tick until the queue is empty (synchronous callers and tests)."""
        total = 0
        while self._pending:
            total += self.tick()
        return total

    # ---- asyncio surface -----------------------------------------------

    async def submit(self, m, *, method: str = "lb", priority: int = 0,
                     deadline_s: float | None = None):
        """Enqueue and await the result (run ``serve_forever`` alongside)."""
        ticket = self.enqueue(m, method=method, priority=priority,
                              deadline_s=deadline_s)
        await ticket._ensure_event().wait()
        return ticket.result()

    async def serve_forever(self) -> None:
        """The tick loop: dispatch whatever queued, yield, repeat.

        Each dispatch *is* the batching window — submissions landing
        while a tick runs on device are coalesced by the next one.
        Exits once ``stop()`` was called and the queue is drained.
        """
        self._running = True
        # Fresh per run: asyncio primitives bind to their first loop, and
        # a service is reused across asyncio.run calls (warm second pass).
        self._wake = asyncio.Event()
        try:
            while self._running or self._pending:
                if not self._pending:
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                self.tick()
                # Let submitters (and their resolved awaits) run between
                # ticks — this yield is what accumulates the next cohort.
                await asyncio.sleep(0)
        finally:
            self._running = False
            self._wake = None

    def stop(self) -> None:
        """Ask ``serve_forever`` to exit after draining the queue."""
        self._running = False
        if self._wake is not None:
            self._wake.set()

    async def __aenter__(self) -> "FFTService":
        self._task = asyncio.ensure_future(self.serve_forever())
        return self

    async def __aexit__(self, *exc) -> None:
        self.stop()
        await self._task

    # ---- stats ---------------------------------------------------------

    @staticmethod
    def _fresh_stats() -> dict[str, Any]:
        return {
            "submitted": 0, "served": 0, "rejected": 0, "failed": 0,
            "shed_deadline": 0, "ticks": 0, "dispatches": 0,
            "coalesced_dispatches": 0, "max_coalesced": 0,
            "splits": 0, "deferred_cohorts": 0,
            "wisdom_write_timeouts": 0,
            "sources": {}, "latencies_s": [], "cohorts": [],
        }

    def reset_stats(self) -> None:
        """Zero every counter but keep the plan cache warm — the 'second
        run' audit starts here (its ``retunes`` must stay zero)."""
        self._stats = self._fresh_stats()
        self._cache.reset_stats()

    def stats(self) -> dict[str, Any]:
        """The reference's counters, plus ``cohorts``: one record per
        dispatch — key, size, bucket, the plan's config, the kernel
        launches of its execute and the seconds of ``execute_many``'s four
        steps (stack, copy to the device, execute, copy back)."""
        s = dict(self._stats)
        s["latencies_s"] = list(s["latencies_s"])
        s["cohorts"] = [dict(c) for c in s["cohorts"]]
        s["sources"] = dict(s["sources"])
        s["batching_efficiency"] = (s["served"] / s["dispatches"]
                                    if s["dispatches"] else 0.0)
        s["plan_cache"] = self._cache.stats_dict()
        return s
