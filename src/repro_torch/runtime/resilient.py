"""Self-healing execution: detect -> re-plan -> hot-swap.

Counterpart of ``repro.runtime.resilient``.  ``ResilientPlan`` wraps a
distributed ``PfftPlan`` (``plan_pfft(mesh=)``), times every execute,
probes each rank's local-phase speed, and feeds a ``StragglerMonitor``.  It
runs SPMD over ``torch.distributed`` like the distributed path: one process
per device, every rank calling it alike and deciding alike.

**Drift path.**  When a rank's group drifts past the monitor's threshold
the wrapper synthesises *degraded FPMs* (the observed slowdown folded into
each group's speed function) and re-runs ``tune_dist_schedule`` with them.
The winning ``SegmentSchedule`` — typically a device-group program, so the
slow group genuinely gets different work — is lowered through
``PfftPlan.with_schedule`` and hot-swapped at the *next call boundary*.
Re-planned picks are recorded to wisdom under a degradation-digest key, so
a recurring drift signature is served from disk.

**Loss path.**  A raised ``DeviceLostError`` (injected by
``runtime.faults`` or translated from a real runtime error by the caller)
triggers elastic recovery: registered state is gathered whole over the old
world, the world is rebuilt over the survivors (``rebuild_fft_mesh``: the
axis is capped by N's divisors, and unplaceable survivors are reported),
the plan is made again through ``plan_pfft`` on the new mesh — whose wisdom
key carries the new ``topology_digest``, so a reduced topology measured
once is *served* (serve-or-retune) — the state is re-sharded (``reshard``)
and the failed call is retried.  A rank that was lost, or survived but
does not fit the rebuilt axis, leaves the world and re-raises the error
(its emulated crash).

Every recovery appends a structured event to ``.events``.

What the ranks agree on: every rank probes its own branch on its own
device, the ranks taking turns, and the times are all-gathered, so every
rank feeds the same vector to its monitor; wisdom is read by the first
rank and broadcast, and written by the first rank alone; the tuners agree
on their measurements and retries (``plan.tune``).  Differences from the
reference, by design: ``execute`` takes the whole ``(N, N)`` signal, as the
reference's does, and each rank cuts its ``(N/p, N)`` block under the
current ``p``, but it returns this rank's block of the result (as
``plan_pfft(mesh=).execute`` does); the fault layer is read at call time,
so nothing is re-traced when it changes; survivors of a loss that names no
position are the ranks that check in on the world's store within
``CHECKIN_TIMEOUT_S``.
"""

from __future__ import annotations

import functools
import json
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.api import _PAD_STRATEGY, PfftPlan, plan_pfft
from repro_torch.core.fpm import FPMSet, SpeedFunction
from repro_torch.launch.mesh import (axis_size, first_rank_value,
                                     make_fft_mesh, mesh_host_shape,
                                     world_store)
from repro_torch.plan.cost import CostParams
from repro_torch.plan.groups import device_group_program
from repro_torch.plan.schedule import SegmentSchedule
from repro_torch.plan.tune import dist_panel_space, tune_dist_schedule
from repro_torch.plan.wisdom import (lookup_wisdom, partition_digest,
                                     record_wisdom, topology_digest,
                                     wisdom_key)
from repro_torch.runtime.elastic import gather_whole, rebuild_fft_mesh, reshard
from repro_torch.runtime.faults import (DeviceLostError, get_injector,
                                        repeated, retry_with_backoff)
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = ["ResilientPlan"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ResilientPlan:
    """Self-healing wrapper around a distributed ``PfftPlan``.

    Parameters mirror ``plan_pfft`` (``method``/``fpms``/``tune``/
    ``wisdom``/``config``/``dtype`` build the initial plan on ``mesh``,
    default ``make_fft_mesh(axis_name=axis_name)``) plus the runtime knobs:

    * ``alpha``/``drift_threshold`` — the ``StragglerMonitor``'s EWMA
      factor and trigger multiple.
    * ``probe_every`` — run the per-rank local-phase probe every k-th
      execute (each rank times its *own* schedule branch — the injected
      fault's ``repeated`` wrapper included — on its own device).
    * ``cooldown`` — calls after a recovery during which drift does not
      re-trigger (the new plan needs fresh, settled samples).
    * ``retune_mode``/``retune_params`` — how the drift re-plan tunes
      (defaults to the initial ``tune`` mode, or ``"estimate"`` when the
      initial plan was untuned).
    * ``measure_retries`` / ``wisdom_lock_timeout_s`` — the agreed retry
      budget of measure-mode re-tuning and the bound on waiting for a
      wedged wisdom lock (a stuck store must never stall recovery).
    """

    # Probe blocks carry at least this many rows: a small block is
    # dispatch-dominated, and a compute-side slowdown would hide under the
    # constant overhead.  More rows only scale the per-row work, so
    # relative speeds are unaffected.
    PROBE_MIN_ROWS = 256
    # How long the survivors of a loss that names no position wait for
    # every rank to check in on the store.
    CHECKIN_TIMEOUT_S = 10.0

    def __init__(self, n: int, *, mesh=None, axis_name: str = "fft",
                 method: str = "lb", fpms: FPMSet | None = None,
                 tune: str = "estimate", wisdom: str | None = None,
                 config=None, dtype: str = "complex64", eps: float = 0.05,
                 alpha: float = 0.3, drift_threshold: float = 1.3,
                 probe_every: int = 1, cooldown: int = 4,
                 retune_mode: str | None = None,
                 retune_params: CostParams | None = None,
                 min_probe_rounds: int = 3,
                 measure_retries: int = 2,
                 wisdom_lock_timeout_s: float | None = 5.0):
        if mesh is None:
            mesh = make_fft_mesh(axis_name=axis_name)
        self.n = int(n)
        self.mesh = mesh
        self.axis_name = axis_name
        self.method = method
        self.fpms = fpms
        self.tune = tune
        self.wisdom = wisdom
        self.dtype = dtype
        self.eps = eps
        self.alpha = alpha
        self.drift_threshold = drift_threshold
        self.probe_every = max(int(probe_every), 1)
        self.cooldown = max(int(cooldown), 0)
        self.retune_mode = retune_mode or (tune if tune != "off" else "estimate")
        self.retune_params = retune_params
        self.min_probe_rounds = max(int(min_probe_rounds), 1)
        self.measure_retries = int(measure_retries)
        self.wisdom_lock_timeout_s = wisdom_lock_timeout_s

        self.plan = plan_pfft(self.n, fpms=fpms, method=method, eps=eps,
                              tune=tune, wisdom=wisdom, config=config,
                              dtype=dtype, mesh=mesh, axis_name=axis_name)
        self.monitor = StragglerMonitor(self.p, alpha=alpha,
                                        threshold=drift_threshold)
        self.events: list[dict] = []
        self.step_times: list[float] = []
        self.last_degraded_fpms: FPMSet | None = None
        self._calls = 0
        self._pending: PfftPlan | None = None
        self._cooldown_until = 0
        self._probe_rounds = 0
        self._probe_blocks: dict = {}
        self._probes_warmed: set = set()
        self._state = None
        self._state_specs = None

    # ---- introspection ----

    @property
    def p(self) -> int:
        return axis_size(self.mesh, self.axis_name)

    @property
    def schedule(self) -> SegmentSchedule:
        return self.plan.schedule

    @property
    def calls(self) -> int:
        return self._calls

    @property
    def _pos(self) -> int:
        """This rank's position along the FFT axis."""
        return self.mesh.get_local_rank(self.axis_name)

    # ---- in-flight state (re-sharded across elastic recovery) ----

    def register_state(self, tree: Any, pspecs: Any) -> None:
        """Attach in-flight state to carry across device loss: this rank's
        share of it (its row block for a leaf whose spec names the axis,
        ``("fft", None)``; the whole leaf for a None spec).  On recovery
        it is gathered whole over the old world and re-sharded onto the
        rebuilt mesh via ``reshard`` before the failed call retries."""
        self._state, self._state_specs = tree, pspecs

    @property
    def state(self) -> Any:
        return self._state

    # ---- the hot path ----

    def execute(self, m) -> torch.Tensor:
        """Transform the whole ``(N, N)`` signal ``m`` (a tensor or host
        array, the same on every rank); returns this rank's ``(N/p, N)``
        block of the result."""
        if self.mesh is None:
            raise DeviceLostError(message="this rank left the FFT mesh at a "
                                  "device loss")
        inj = get_injector()
        if self._pending is not None:
            self.plan, self._pending = self._pending, None
            for ev in reversed(self.events):   # stamp the swap boundary
                if ev.get("kind") == "replan" and ev.get("swap_call") is None:
                    ev["swap_call"] = self._calls
                    ev["swap_wall"] = time.perf_counter()
                    break
        call = self._calls
        self._calls += 1
        try:
            inj.check_execute(call)
            out, dt = self._timed_execute(m)
        except DeviceLostError as err:
            self._recover_device_loss(err, call)
            out, dt = self._timed_execute(m)   # retry on the rebuilt plan
        self.step_times.append(dt)
        if call % self.probe_every == 0:
            self._observe(call)
        return out

    def _block(self, m) -> torch.Tensor:
        """This rank's ``(N/p, N)`` row block of the whole signal, on the
        plan's device."""
        rows = self.n // self.p
        whole = torch.as_tensor(m)
        if tuple(whole.shape) != (self.n, self.n):
            raise ValueError(f"ResilientPlan takes the whole ({self.n}, "
                             f"{self.n}) signal, got {tuple(whole.shape)}")
        return whole[self._pos * rows:(self._pos + 1) * rows].to(
            self.plan.device).contiguous()

    def _timed_execute(self, m):
        block = self._block(m)
        _sync(self.plan.device)
        t0 = time.perf_counter()
        out = self.plan.execute(block)
        _sync(self.plan.device)
        return out, time.perf_counter() - t0

    # ---- drift detection ----

    def _device_configs(self):
        """(per-rank config list, uniform pad_len) of the current plan —
        exactly what each rank's branch of the SPMD program runs."""
        sched = self.plan.schedule
        if len(sched.configs) > 1:
            prog = device_group_program(sched, self.p)
            return ([prog.configs[g] for g in prog.group_of_device],
                    prog.pad_len)
        pad_len = max((e.length for e in sched), default=self.n)
        return [sched.anchor_config] * self.p, pad_len

    def _probe_block(self, rows: int) -> torch.Tensor:
        block = self._probe_blocks.get(rows)
        if block is None:
            rng = np.random.default_rng(0)
            block = torch.from_numpy(
                (rng.standard_normal((rows, self.n))
                 + 1j * rng.standard_normal((rows, self.n))
                 ).astype(self.dtype)).to(self.plan.device)
            self._probe_blocks[rows] = block
        return block

    def _probe_group_times(self) -> list[float]:
        """Best-of-3 seconds of each rank's own local-phase program — its
        schedule branch, the fault layer's ``repeated`` wrapper included,
        on its own device — one entry per position of the axis, the same
        list on every rank.  The ranks take turns (a barrier between
        turns), so ranks that share a device do not time each other's
        work; the times are then all-gathered."""
        from repro_torch.core.pfft_dist import _local_fft  # lazy: core imports plan
        cfgs, pad_len = self._device_configs()
        pos = self._pos
        cfg = cfgs[pos]
        reps = get_injector().repeat_for(pos)
        rows = max(self.n // self.p, 1, self.PROBE_MIN_ROWS)
        x = self._probe_block(rows)
        fn = repeated(functools.partial(_local_fft, n=self.n,
                                        padded=cfg.dist_padded,
                                        pad_len=pad_len, config=cfg,
                                        backend=None), reps)
        key = (cfg, pad_len, rows, reps)
        if key not in self._probes_warmed:
            fn(x)                              # first call: build, allocate
            self._probes_warmed.add(key)
        group = self.mesh.get_group(self.axis_name)
        best = float("inf")
        for turn in range(self.p):
            dist.barrier(group=group)
            if turn != pos:
                continue
            for _ in range(3):
                _sync(x.device)
                t0 = time.perf_counter()
                fn(x)
                _sync(x.device)
                best = min(best, time.perf_counter() - t0)
        seen = [None] * self.p
        dist.all_gather_object(seen, (pos, best), group=group)
        return [t for _, t in sorted(seen)]

    def _observe(self, call: int) -> None:
        for g, t in enumerate(self._probe_group_times()):
            self.monitor.record(g, t)
        self._probe_rounds += 1
        if self._probe_rounds < self.min_probe_rounds:
            return   # single noisy rounds must not look like drift
        if self._calls <= self._cooldown_until:
            return
        slow = self.monitor.slow_groups()
        if slow:
            self._replan(call, slow)

    # ---- drift recovery: degraded-FPM re-plan + hot-swap ----

    def _d_even(self) -> np.ndarray:
        return np.full(self.p, self.n // self.p, dtype=np.int64)

    def _baseline_fpms(self) -> FPMSet:
        """The healthy per-rank FPMs the degradation folds into: the
        user's, or a flat nominal-rate synthetic set (drift is relative,
        so a flat baseline still yields correctly-shaped degraded FPMs) at
        the nominal rate of the mesh's device type."""
        if self.fpms is not None and self.fpms.p == self.p:
            return self.fpms
        n_loc = max(self.n // self.p, 1)
        xs = np.array(sorted({1, n_loc, self.n}))
        pow2 = 1 << int(np.ceil(np.log2(max(self.n, 2))))
        ys = np.array(sorted({self.n, pow2, 2 * pow2}))
        params = self.retune_params or CostParams.for_backend(
            self.mesh.device_type)
        speed = np.full((len(xs), len(ys)), params.nominal_flops)
        return FPMSet([SpeedFunction(xs, ys, speed.copy(), name=f"dev{i}")
                       for i in range(self.p)])

    def _pad_lengths(self, fpms: FPMSet):
        d = self._d_even()
        if self.method == "fpm-pad":
            from repro_torch.plan.pads import fpm_pad_lengths
            return fpm_pad_lengths(fpms, d, self.n)
        if self.method == "fpm-czt":
            from repro_torch.plan.pads import czt_fft_lengths
            return czt_fft_lengths(fpms, d, self.n, limit_ratio=2.0)
        return None

    def _degraded_key(self, rel: np.ndarray, pads) -> tuple[str, str]:
        """(wisdom key, topology digest) for a drift re-plan.

        The degradation signature — relative speeds quantised to 1/16 —
        digests into the key's ``part=`` detail, so a recurring drift
        pattern is served from wisdom while the *healthy* plan's entry is
        never overwritten by a degraded pick.  The backend is the mesh's
        device type, as in every distributed plan's key.
        """
        panels = dist_panel_space(self.n, self.p)
        topo = topology_digest(self.mesh, self.axis_name, panels=panels)
        rel_q = np.asarray(np.round(np.asarray(rel) * 16.0), dtype=np.int64)
        detail = partition_digest(np.concatenate([self._d_even(), rel_q]),
                                  pads)
        key = wisdom_key(n=self.n, dtype=np.dtype(self.dtype).name, p=self.p,
                         method=self.method, backend=self.mesh.device_type,
                         detail=f"degraded-{detail}", topology=topo)
        return key, topo

    def _stored_degraded(self, key: str, pads, pad_strategy: str):
        """The schedule stored under ``key`` if it still fits this plan
        (the first rank's lookup, every rank's answer), else None."""
        hit = first_rank_value(self.mesh, self.axis_name,
                               lambda: lookup_wisdom(self.wisdom, key))
        if hit is None or not isinstance(hit[0], SegmentSchedule):
            return None
        cand = hit[0]
        if not (cand.n == self.n and cand.matches(self._d_even(), pads)
                and all(e.config.pad == pad_strategy for e in cand)):
            return None
        try:
            if cand.common_config is None:
                device_group_program(cand, self.p)
        except ValueError:
            return None
        return cand

    def _record_degraded(self, key: str, schedule, info: dict, topo: str):
        """Record a measured re-plan on the first rank; the write's error,
        if any, on every rank (an advisory store must never stall
        recovery)."""
        def write():
            try:
                record_wisdom(self.wisdom, key, schedule, mode="measure",
                              time_s=info["time_s"],
                              extra={"topology": topo,
                                     "origin": "resilient-replan"},
                              retries=2,
                              lock_timeout_s=self.wisdom_lock_timeout_s)
            except (TimeoutError, OSError) as err:
                return repr(err)
            return None
        return first_rank_value(self.mesh, self.axis_name, write)

    def _replan(self, call: int, slow: list[int]) -> None:
        detect_wall = time.perf_counter()
        rel = self.monitor.relative_speeds()
        degraded = self.monitor.degraded_fpms(self._baseline_fpms())
        self.last_degraded_fpms = degraded
        pad_strategy = _PAD_STRATEGY[self.method]
        pads = self._pad_lengths(degraded)
        key, topo = self._degraded_key(rel, pads)
        t0 = time.perf_counter()

        schedule = source = None
        info: dict = {}
        if self.wisdom is not None:
            schedule = self._stored_degraded(key, pads, pad_strategy)
            source = "wisdom" if schedule is not None else None

        if schedule is None:
            def _tune():
                return tune_dist_schedule(
                    self.n, self.mesh, self.axis_name, pad_lengths=pads,
                    mode=self.retune_mode, pad=pad_strategy, fpms=degraded,
                    params=self.retune_params, dtype=np.dtype(self.dtype),
                    measure_retries=self.measure_retries)
            schedule, info = retry_with_backoff(_tune, attempts=2,
                                                base_s=0.1)
            source = self.retune_mode
            if self.wisdom is not None and self.retune_mode == "measure" \
                    and info.get("time_s") is not None:
                error = self._record_degraded(key, schedule, info, topo)
                if error is not None:
                    self.events.append({"kind": "wisdom_error",
                                        "call": call,
                                        "wall": time.perf_counter(),
                                        "error": error})

        replan_s = time.perf_counter() - t0
        event = {
            "kind": "replan", "call": call, "wall": detect_wall,
            "detect_wall": detect_wall,
            "slow_groups": [int(g) for g in slow],
            "relative_speeds": [float(v) for v in rel],
            "replan_s": float(replan_s), "source": source,
            "chosen": info.get("chosen"),
            "schedule": schedule.describe(),
            "wisdom_key": key, "swap_call": None,
        }
        self.events.append(event)
        self.monitor.reset()
        self._probe_rounds = 0
        self._cooldown_until = self._calls + self.cooldown
        if schedule == self.plan.schedule:
            event["kind"] = "replan_noop"   # same plan: nothing to swap
            event["swap_call"] = call
            return
        tuning = {"mode": self.retune_mode, "source": source,
                  "wisdom_key": key, "topology": topo}
        self._pending = self.plan.with_schedule(schedule, tuning=tuning)

    # ---- loss recovery: rebuild the world, serve-or-retune, reshard ----

    def _checked_in(self, call: int) -> list[int]:
        """Positions of the ranks that check in on the world's store within
        ``CHECKIN_TIMEOUT_S`` (all of them, as soon as all have); the first
        rank to decide writes the list, and every rank takes that one."""
        store = dist.PrefixStore(f"repro-checkin-c{call}", world_store())
        store.set(f"pos{self._pos}", "1")
        deadline = time.monotonic() + self.CHECKIN_TIMEOUT_S
        while True:
            seen = [i for i in range(self.p) if store.check([f"pos{i}"])]
            if len(seen) == self.p or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        return json.loads(store.compare_set("survivors", "", json.dumps(seen)))

    def _hosts_hint(self, survivors: list[int]) -> int | None:
        """The surviving host count when the loss is whole-host-granular
        under the old mesh's host-major layout (the rebuilt axis keeps its
        reduced multi-host shape: a distinct topology digest, so the
        re-plan is a correct wisdom miss, never a stale multi-host hit);
        None for a partial host loss, which degrades to flat."""
        h_old, l_old = mesh_host_shape(self.mesh, self.axis_name)
        if h_old <= 1:
            return None
        gone = set(range(self.p)) - set(survivors)
        per_host = [sum(1 for i in gone if i // l_old == h)
                    for h in range(h_old)]
        if all(g in (0, l_old) for g in per_host):
            return sum(1 for g in per_host if g == 0)
        return None

    def _recover_device_loss(self, err: DeviceLostError, call: int) -> None:
        t0 = time.perf_counter()
        old_p = self.p
        lost = sorted({int(i) for i in getattr(err, "lost", ()) or ()
                       if 0 <= int(i) < old_p})
        if lost:
            survivors = [i for i in range(old_p) if i not in lost]
        else:
            survivors = self._checked_in(call)
        if not survivors:
            raise err
        hosts_hint = self._hosts_hint(survivors)
        ranks = [int(r) for r in self.mesh.mesh.tolist()]
        whole = (gather_whole(self._state, self.mesh, self._state_specs)
                 if self._state is not None else None)
        rebuilt = rebuild_fft_mesh(self.n, [ranks[i] for i in survivors],
                                   axis_name=self.axis_name, hosts=hosts_hint,
                                   device_type=self.mesh.device_type)
        if rebuilt.mesh is None:
            # Lost, or dropped by the rebuilt axis: this rank has left.
            self.mesh = self.plan = self._pending = self._state = None
            raise err
        kept = survivors[:rebuilt.used]
        self.mesh = rebuilt.mesh
        if self.fpms is not None and self.fpms.p == old_p:
            self.fpms = FPMSet([self.fpms[i] for i in kept])
        self.monitor = StragglerMonitor(rebuilt.used, alpha=self.alpha,
                                        threshold=self.drift_threshold)
        self._probe_rounds = 0
        self._pending = None
        self._cooldown_until = self._calls + self.cooldown
        # Serve-or-retune: plan_pfft keys wisdom by the *new* mesh's
        # topology_digest — a reduced topology measured once is served
        # with zero re-measurement on the next loss to the same shape.
        self.plan = plan_pfft(self.n, fpms=self.fpms, method=self.method,
                              eps=self.eps, tune=self.tune,
                              wisdom=self.wisdom, dtype=self.dtype,
                              mesh=self.mesh, axis_name=self.axis_name)
        if whole is not None:
            self._state = reshard(whole, self.mesh, self._state_specs)
        self.events.append({
            "kind": "device_loss", "call": call, "wall": time.perf_counter(),
            "lost": lost, "survivors": len(survivors),
            "devices": rebuilt.used, "dropped": rebuilt.dropped,
            "topology": self.plan.tuning.get("topology"),
            "plan_source": self.plan.tuning.get("source"),
            "recover_s": float(time.perf_counter() - t0),
        })
