"""The system under test for the 2-D configurations: one plan a side from
``repro_torch.core.api.plan_pfft`` with the configuration's method, ``p``,
FPMs and ``PlanConfig``, and no tuning, so every run takes one path; a
request is one ``PfftPlan.execute`` on a stack of signals."""

from __future__ import annotations

import sys
import time

from bench.registry import BENCH, ROOT


def open_program(config: dict, sides: list[int], device):
    """``({side: execute}, seconds spent planning, {side: path})``; the
    program is the checkout's ``src/repro_torch``."""
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.api import plan_pfft
    from repro_torch.core.fpm import load_fpms
    from repro_torch.plan.config import PlanConfig

    fpms = load_fpms(str(BENCH / config["fpms"])) if config.get("fpms") else None
    plans, seconds = {}, 0.0
    for n in sides:
        t0 = time.perf_counter()
        plans[n] = plan_pfft(n, p=config.get("p"), fpms=fpms,
                             method=config["method"],
                             eps=config.get("eps", 0.05), tune="off",
                             config=PlanConfig(**config["plan_config"]),
                             dtype=config["dtype"], device=device)
        seconds += time.perf_counter() - t0
    paths = {n: f"{plan.method} {plan.config.describe()} d={[int(v) for v in plan.d]}"
             for n, plan in plans.items()}
    return {n: plan.execute for n, plan in plans.items()}, seconds, paths
