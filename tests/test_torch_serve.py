"""The serving layer of the port: ``repro_torch.launch.serve_fft.FFTService``
over the 2-D, 3-D and huge-1-D plans, and ``repro_torch.plan.cache.PlanCache``.

The reference's ``tests/test_serve.py`` classes, run against the port on
``device="cpu"`` at N <= 32 (the reference's ``benchmarks.stats`` has no
counterpart in the port, so ``TestPercentiles`` is not repeated here), plus
the 3-D and huge-1-D request families and one cross-package case: the same
enqueue sequence goes to the reference's service and to the port's under the
``"cpu"`` cost constants and gives the same cohorts, the same admission
decisions with equal prices, and outputs within tolerance.  No test asserts
on wall-clock time beyond the reference's ``deadline_s=1e-4`` plus
``sleep(0.002)`` pattern.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.api import plan_pfft
from repro_torch.launch.serve_fft import (AdmissionError, CohortKey,
                                          DeadlineExceeded, FFTService,
                                          _bucket)
from repro_torch.plan.cache import PlanCache
from repro_torch.plan.config import PlanConfig
from repro_torch.plan.cost import CostParams
from repro_torch.plan.wisdom import load_wisdom, record_wisdom

CPU = "cpu"
ALL_METHODS = ("lb", "rfft-lb", "pfft3-lb", "pfft1-large")


def service(**kw) -> FFTService:
    return FFTService(device=CPU, **kw)


def _signal(rng, n, dtype="complex64", shape=None):
    shape = (n, n) if shape is None else shape
    if dtype.startswith("float"):
        return rng.standard_normal(shape).astype(dtype)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


class _FakePlan:
    def __init__(self, source="wisdom"):
        self.tuning = {"source": source}


# ---------------------------------------------------------------- PlanCache

class TestPlanCache:
    def test_lru_bound_and_eviction_counters(self):
        cache = PlanCache(maxsize=2)
        for k in "abc":
            cache.get(k, _FakePlan)
        assert len(cache) == 2
        assert cache.stats.evictions == 1
        assert cache.stats.misses == 3
        assert "a" not in cache and "b" in cache and "c" in cache

    def test_hit_refreshes_recency(self):
        cache = PlanCache(maxsize=2)
        cache.get("a", _FakePlan)
        cache.get("b", _FakePlan)
        cache.get("a", _FakePlan)          # refresh a
        cache.get("c", _FakePlan)          # evicts b, not a
        assert "a" in cache and "b" not in cache
        assert cache.stats.hits == 1

    def test_retune_counter_tracks_tuned_sources_only(self):
        cache = PlanCache()
        cache.get("w", lambda: _FakePlan("wisdom"))
        cache.get("e", lambda: _FakePlan("estimate"))
        cache.get("m", lambda: _FakePlan("measure"))
        cache.get("x", lambda: _FakePlan("explicit"))
        assert cache.stats.retunes == 2
        cache.get("e", lambda: _FakePlan("estimate"))   # hit: no retune
        assert cache.stats.retunes == 2

    def test_peek_mutates_nothing(self):
        cache = PlanCache(maxsize=2)
        cache.get("a", _FakePlan)
        assert cache.peek("a") is not None
        assert cache.peek("zzz") is None
        assert cache.stats.hits == 0 and cache.stats.misses == 1

    def test_reset_stats_keeps_entries(self):
        cache = PlanCache()
        cache.get("a", _FakePlan)
        cache.reset_stats()
        assert cache.stats_dict()["misses"] == 0
        assert "a" in cache
        _, hit = cache.get("a", _FakePlan)
        assert hit

    def test_build_failure_not_cached(self):
        cache = PlanCache()
        with pytest.raises(RuntimeError):
            cache.get("a", lambda: (_ for _ in ()).throw(RuntimeError("x")))
        assert "a" not in cache
        cache.get("a", _FakePlan)   # succeeds after the failed build


# ------------------------------------------------------------- execute_many

class TestExecuteMany:
    def test_matches_per_item_execute(self, rng):
        plan = plan_pfft(16, p=1, method="lb", dtype="complex64", device=CPU)
        ms = [_signal(rng, 16) for _ in range(5)]
        outs = plan.execute_many(ms)
        assert len(outs) == 5
        for m, out in zip(ms, outs):
            np.testing.assert_allclose(np.asarray(out), np.fft.fft2(m),
                                       atol=1e-2)

    def test_pad_to_is_invisible_in_results(self, rng):
        plan = plan_pfft(16, p=1, method="lb", dtype="complex64", device=CPU)
        ms = [_signal(rng, 16) for _ in range(3)]
        plain = plan.execute_many(ms)
        padded = plan.execute_many(ms, pad_to=8)
        for a, b in zip(plain, padded):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-5)

    def test_shape_validation(self, rng):
        plan = plan_pfft(16, p=1, method="lb", dtype="complex64", device=CPU)
        with pytest.raises(ValueError, match="stacks"):
            plan.execute_many([_signal(rng, 8)])
        assert plan.execute_many([]) == []


# ------------------------------------------------------- service end to end

class TestServiceCorrectness:
    def test_mixed_cohorts_match_numpy(self, rng, tmp_path):
        svc = service(wisdom=str(tmp_path / "w.json"), tune="estimate")
        cases = []
        for n in (16, 32):
            for method in ("lb", "rfft-lb"):
                dtype = "float32" if method.startswith("rfft") else "complex64"
                for _ in range(3):
                    m = _signal(rng, n, dtype)
                    cases.append((m, method, svc.enqueue(m, method=method)))
        assert svc.drain() == len(cases)
        for m, method, ticket in cases:
            ref = (np.fft.rfft2(m) if method.startswith("rfft")
                   else np.fft.fft2(m))
            np.testing.assert_allclose(np.asarray(ticket.result()), ref,
                                       atol=1e-2)
            assert ticket.done and ticket.latency_s > 0

    def test_cubes_and_lines_match_numpy(self, rng):
        svc = service(tune="estimate", methods=ALL_METHODS, p=3)
        cubes = [_signal(rng, 8, shape=(8, 8, 8)) for _ in range(3)]
        lines = [_signal(rng, 96, shape=(96,)) for _ in range(2)]
        tickets = ([(svc.enqueue(c, method="pfft3-lb"), np.fft.fftn(c))
                    for c in cubes]
                   + [(svc.enqueue(v, method="pfft1-large"), np.fft.fft(v))
                      for v in lines])
        assert svc.drain() == 5
        assert svc.stats()["dispatches"] == 2
        for ticket, ref in tickets:
            assert isinstance(ticket.result(), np.ndarray)
            np.testing.assert_allclose(ticket.result(), ref, atol=2e-2)

    def test_cohort_is_one_dispatch(self, rng):
        svc = service(tune="estimate")
        for _ in range(6):
            svc.enqueue(_signal(rng, 16), method="lb")
        svc.tick()
        s = svc.stats()
        assert s["dispatches"] == 1
        assert s["max_coalesced"] == 6
        assert s["coalesced_dispatches"] == 1
        assert s["batching_efficiency"] == 6.0

    def test_each_dispatch_records_its_cohort_and_stages(self, rng):
        """``stats()["cohorts"]``: one record per dispatch, in dispatch
        order, with the plan's config, no kernel launch on the CPU, and the
        four steps of ``execute_many`` timed; ``reset_stats`` clears it."""
        svc = service(tune="estimate", methods=ALL_METHODS, p=2)
        for _ in range(3):
            svc.enqueue(_signal(rng, 16), method="lb")
        svc.enqueue(_signal(rng, 8, shape=(8, 8, 8)), method="pfft3-lb")
        svc.drain()
        cohorts = svc.stats()["cohorts"]
        assert [(c["n"], c["method"], c["size"], c["bucket"]) for c in cohorts] \
            == [(16, "lb", 3, 4), (8, "pfft3-lb", 1, 1)]
        for c in cohorts:
            assert c["launches"] == {}
            assert isinstance(c["config"], str) and c["config"]
            for stage in ("stack_s", "to_device_s", "execute_s", "to_host_s"):
                assert c[stage] >= 0.0
        svc.reset_stats()
        assert svc.stats()["cohorts"] == []

    def test_non_square_and_unknown_method_rejected(self, rng):
        svc = service(methods=ALL_METHODS)
        with pytest.raises(ValueError, match="square"):
            svc.enqueue(np.zeros((4, 8), np.complex64))
        with pytest.raises(ValueError, match="not served"):
            svc.enqueue(np.zeros((4, 4), np.complex64), method="fpm-czt")
        with pytest.raises(ValueError, match="cubic"):
            svc.enqueue(np.zeros((4, 4, 8), np.complex64), method="pfft3-lb")
        with pytest.raises(ValueError, match="1-D"):
            svc.enqueue(np.zeros((4, 4), np.complex64), method="pfft1-large")

    def test_result_before_tick_raises(self, rng):
        svc = service()
        t = svc.enqueue(_signal(rng, 16))
        with pytest.raises(RuntimeError, match="tick pending"):
            t.result()

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            FFTService()
        assert service().device == torch.device(CPU)


# ------------------------------------------------- priced admission + shed

class TestAdmission:
    def test_oversize_is_priced_rejection(self):
        svc = service(tick_budget_s=0.05)
        big = np.zeros((2048, 2048), np.complex64)
        with pytest.raises(AdmissionError) as ei:
            svc.enqueue(big)
        assert ei.value.predicted_s > ei.value.budget_s
        assert ei.value.budget_s == pytest.approx(0.05)
        assert svc.stats()["rejected"] == 1
        assert svc.pending_count == 0

    def test_queue_full_is_priced_rejection(self, rng):
        svc = service(max_queue=2)
        svc.enqueue(_signal(rng, 16))
        svc.enqueue(_signal(rng, 16))
        with pytest.raises(AdmissionError, match="queue full") as ei:
            svc.enqueue(_signal(rng, 16))
        assert ei.value.predicted_s > 0

    def test_deadline_shed_with_priced_error(self, rng):
        svc = service(tune="estimate")
        doomed = svc.enqueue(_signal(rng, 16), deadline_s=1e-4)
        kept = svc.enqueue(_signal(rng, 16))
        time.sleep(0.002)
        svc.drain()
        with pytest.raises(DeadlineExceeded):
            doomed.result()
        assert kept.done and kept.result() is not None
        s = svc.stats()
        assert s["shed_deadline"] == 1 and s["served"] == 1

    def test_budget_splits_cohort_deterministically(self, rng):
        svc = service(tune="estimate")
        first = svc.enqueue(_signal(rng, 32), method="lb")
        svc.drain()                      # builds the plan: prices settle
        assert first.done
        # Budget admits exactly two 32s per tick by the model's own law.
        svc.tick_budget_s = svc.price(32, "lb", batch=2) * 1.01
        svc.reset_stats()
        tickets = [svc.enqueue(_signal(rng, 32), method="lb")
                   for _ in range(6)]
        svc.drain()
        s = svc.stats()
        assert s["ticks"] == 3
        assert s["splits"] == 2          # final tick takes the remainder
        assert s["max_coalesced"] == 2
        assert all(t.done for t in tickets)

    def test_priority_beats_fifo(self, rng):
        svc = service(tune="estimate")
        svc.enqueue(_signal(rng, 16), method="lb")
        svc.enqueue(_signal(rng, 32), method="lb")
        svc.drain()
        svc.tick_budget_s = 1e-9
        svc.max_request_s = 1.0
        svc.reset_stats()
        low = svc.enqueue(_signal(rng, 16), method="lb", priority=0)
        high = svc.enqueue(_signal(rng, 32), method="lb", priority=5)
        svc.tick()
        assert high.done and not low.done
        assert svc.stats()["deferred_cohorts"] == 1
        svc.drain()
        assert low.done

    def test_progress_guarantee_over_tiny_budget(self, rng):
        svc = service(tune="estimate", tick_budget_s=1e-12, max_request_s=1.0)
        tickets = [svc.enqueue(_signal(rng, 16)) for _ in range(3)]
        assert svc.drain() == 3          # never wedges
        assert all(t.done for t in tickets)

    def test_prices_use_the_device_types_constants(self):
        assert service()._params == CostParams.for_backend(CPU)
        custom = CostParams.for_backend("cuda")
        assert service(params=custom)._params is custom

    @pytest.mark.parametrize("b,bucket", [(1, 1), (2, 2), (3, 4), (4, 4),
                                          (5, 8), (9, 12), (32, 32)])
    def test_bucket(self, b, bucket):
        assert _bucket(b) == bucket


# ------------------------------------------------ cache hierarchy / wisdom

class TestCacheHierarchy:
    def test_plan_cache_hit_zero_retune(self, rng, tmp_path):
        svc = service(wisdom=str(tmp_path / "w.json"), tune="estimate")
        svc.enqueue(_signal(rng, 16))
        svc.drain()
        assert svc.stats()["plan_cache"]["retunes"] == 1
        svc.reset_stats()
        svc.enqueue(_signal(rng, 16))
        svc.drain()
        s = svc.stats()["plan_cache"]
        assert s["hits"] == 1 and s["misses"] == 0 and s["retunes"] == 0

    def test_fresh_service_served_from_warm_wisdom(self, rng, tmp_path):
        wis = str(tmp_path / "w.json")
        requests = [("lb", _signal(rng, 16)),
                    ("rfft-lb", _signal(rng, 16, "float32")),
                    ("pfft3-lb", _signal(rng, 8, shape=(8, 8, 8))),
                    ("pfft1-large", _signal(rng, 64, shape=(64,)))]
        svc1 = service(wisdom=wis, tune="estimate", methods=ALL_METHODS)
        for method, m in requests:
            svc1.enqueue(m, method=method)
        svc1.drain()
        assert svc1.stats()["sources"] == {"estimate": 4}

        svc2 = service(wisdom=wis, tune="estimate", methods=ALL_METHODS)
        for method, m in requests:
            svc2.enqueue(m, method=method)
        svc2.drain()
        s = svc2.stats()
        assert s["sources"] == {"wisdom": 4}
        assert s["plan_cache"]["retunes"] == 0

    def test_lru_eviction_in_service(self, rng):
        svc = service(tune="estimate", cache_size=1)
        svc.enqueue(_signal(rng, 16))
        svc.drain()
        svc.enqueue(_signal(rng, 32))
        svc.drain()
        s = svc.stats()["plan_cache"]
        assert s["evictions"] == 1 and s["size"] == 1

    def test_price_uses_built_schedule_after_first_dispatch(self, rng):
        svc = service(tune="estimate")
        before = svc.price(16, "lb")
        svc.enqueue(_signal(rng, 16))
        svc.drain()
        after = svc.price(16, "lb")
        assert before > 0 and after > 0
        assert CohortKey(16, "lb", "complex64") in svc._cache


# ------------------------------------- wisdom contention under concurrency

class TestWisdomContention:
    def test_threaded_writers_lose_no_entries(self, tmp_path):
        path = str(tmp_path / "w.json")
        errors = []

        def writer(tid):
            try:
                for i in range(8):
                    record_wisdom(path, f"t{tid}-k{i}", PlanConfig(),
                                  mode="estimate", retries=3,
                                  lock_timeout_s=30.0)
            except Exception as e:  # pragma: no cover - failure detail
                errors.append((tid, e))

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors
        store = load_wisdom(path)
        keys = [k for k in store if not k.startswith("_")]
        assert len(keys) == 48

    def test_wedged_lock_times_out(self, tmp_path):
        fcntl = pytest.importorskip("fcntl")
        path = str(tmp_path / "w.json")
        record_wisdom(path, "seed", PlanConfig(), mode="estimate")
        with open(path + ".lock", "w") as holder:
            fcntl.flock(holder, fcntl.LOCK_EX)
            with pytest.raises(TimeoutError, match="still held"):
                record_wisdom(path, "blocked", PlanConfig(),
                              mode="estimate", lock_timeout_s=0.2)
        record_wisdom(path, "blocked", PlanConfig(), mode="estimate")
        assert "blocked" in load_wisdom(path)

    def test_concurrent_services_share_one_store(self, rng, tmp_path):
        wis = str(tmp_path / "w.json")
        svcs = [service(wisdom=wis, tune="estimate") for _ in range(2)]
        payloads = [[_signal(rng, n) for n in (16, 32, 16)]
                    for _ in svcs]
        errors = []

        def serve(svc, ms):
            try:
                for m in ms:
                    svc.enqueue(m, method="lb")
                svc.drain()
            except Exception as e:  # pragma: no cover - failure detail
                errors.append(e)

        threads = [threading.Thread(target=serve, args=(s, p))
                   for s, p in zip(svcs, payloads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors
        assert all(s.stats()["served"] == 3 for s in svcs)
        store = load_wisdom(wis)
        assert sum(1 for k in store if "n=16" in k) >= 1
        assert sum(1 for k in store if "n=32" in k) >= 1


# ------------------------------------------------------------ async surface

class TestAsyncSurface:
    def test_submit_and_serve_forever(self, rng):
        m = _signal(rng, 16)

        async def main():
            svc = service(tune="estimate")
            async with svc:
                out = await svc.submit(m, method="lb")
            return np.asarray(out), svc.stats()

        out, stats = asyncio.run(main())
        np.testing.assert_allclose(out, np.fft.fft2(m), atol=1e-2)
        assert stats["served"] == 1

    def test_service_survives_event_loop_recycling(self, rng):
        svc = service(tune="estimate")
        m = _signal(rng, 16)

        async def one_round():
            async with svc:
                return await asyncio.wait_for(svc.submit(m), timeout=30)

        for _ in range(2):
            out = asyncio.run(one_round())
            np.testing.assert_allclose(np.asarray(out), np.fft.fft2(m),
                                       atol=1e-2)
        assert svc.stats()["served"] == 2

    def test_concurrent_submitters_coalesce(self, rng):
        ms = [_signal(rng, 16) for _ in range(8)]

        async def main():
            svc = service(tune="estimate")
            async with svc:
                outs = await asyncio.gather(
                    *(svc.submit(m, method="lb") for m in ms))
            return outs, svc.stats()

        outs, stats = asyncio.run(main())
        for m, out in zip(ms, outs):
            np.testing.assert_allclose(np.asarray(out), np.fft.fft2(m),
                                       atol=1e-2)
        assert stats["coalesced_dispatches"] >= 1
        assert stats["max_coalesced"] >= 2


# ------------------------------------------------- against the reference

def test_same_stream_same_cohorts_as_the_reference(rng):
    """One enqueue sequence, both services, the ``"cpu"`` constants: the
    same prices, admission decisions, cohorts tick by tick, and outputs."""
    from repro.launch import serve_fft as ref_serve
    import repro.plan as ref_plan

    stream = ([("lb", _signal(rng, 16)) for _ in range(3)]
              + [("rfft-lb", _signal(rng, 16, "float32")) for _ in range(2)]
              + [("lb", _signal(rng, 32)) for _ in range(2)]
              + [("pfft3-lb", _signal(rng, 8, shape=(8, 8, 8))) for _ in range(2)]
              + [("pfft1-large", _signal(rng, 64, shape=(64,))) for _ in range(3)]
              + [("lb", np.zeros((2048, 2048), np.complex64))])
    kw = dict(tune="estimate", methods=ALL_METHODS, p=2, tick_budget_s=3.5e-4,
              max_request_s=0.05)
    services = {
        "ref": ref_serve.FFTService(
            params=ref_plan.CostParams.for_backend("cpu"), **kw),
        "port": service(params=CostParams.for_backend(CPU), **kw)}
    log = {}
    for name, svc in services.items():
        cohorts, events = [], []
        original = svc._dispatch

        def dispatch(key, reqs, _orig=original, _log=cohorts):
            _log.append((tuple(key), len(reqs)))
            return _orig(key, reqs)

        svc._dispatch = dispatch
        tickets = []
        for method, m in stream:
            try:
                tickets.append(svc.enqueue(m, method=method))
                events.append(("admitted", method, svc.price(
                    m.shape[0], method, dtype=tickets[-1].key.dtype)))
            except (AdmissionError, ref_serve.AdmissionError) as err:
                tickets.append(None)
                events.append(("rejected", err.predicted_s, err.budget_s))
        ticks = []
        while svc.pending_count:
            before = len(cohorts)
            svc.tick()
            ticks.append(cohorts[before:])
        log[name] = (ticks, events, tickets, svc.stats())

    ref_ticks, ref_events, ref_tickets, ref_stats = log["ref"]
    ticks, events, tickets, stats = log["port"]
    assert ticks == ref_ticks and len(ticks) > 1
    assert len(events) == len(ref_events)
    for a, b in zip(events, ref_events):
        assert a[:2] == b[:2]
        assert a[2:] == pytest.approx(b[2:], rel=1e-12)
    assert events[-1][0] == "rejected"
    for key in ("served", "dispatches", "coalesced_dispatches", "splits",
                "deferred_cohorts", "max_coalesced", "sources", "rejected"):
        assert stats[key] == ref_stats[key], key
    for a, b in zip(tickets, ref_tickets):
        if a is None:
            assert b is None
            continue
        want = np.asarray(b.result())
        np.testing.assert_allclose(a.result(), want,
                                   atol=2e-4 * want[..., 0].size ** 0.5 * 10)
