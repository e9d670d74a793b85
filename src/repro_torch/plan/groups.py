"""Device-group programs — heterogeneous schedules lowered to one SPMD program.

Counterpart of ``repro.plan.groups``; it runs on the host only, and its
lowering, validation and messages are the reference's.  The collective
structure of the distributed pipeline (which ``all_to_all`` a phase runs,
and how many) must be identical on every rank, but the *local row-FFT
computation* between collectives may differ: under the port's SPMD form (one
process per device) each rank runs the config of its own device group and
meets the others at the same collectives (``core.pfft_dist``), where the
reference traces one ``lax.switch`` branch per config.

``device_group_program`` performs that lowering: it maps a schedule's
entries onto contiguous mesh-axis device groups (entry ``rows`` must
tile the even ``N/p`` SPMD shards) and dedups the distinct configs.  The
effective FFT length is made *uniform* — every group transforms at the
schedule's max entry length — because the two ``all_to_all`` phases
exchange the transformed blocks, so a device cannot privately change the
global bin semantics mid-pipeline: the program-level analog of
``ragged_row_layout``, where a shorter entry's surplus *length* is the
padding.

What genuinely cannot lower (``spmd_program_config`` raises the named
SPMD error):

* mixed ``pad`` strategies — crop vs czt vs none are different
  *transforms*, not different speeds;
* any ``fused`` entry in a mixed schedule — fused local phases exchange
  *transposed* blocks, so a fused and an unfused device would disagree on
  the collective's layout;
* mixed ``pipeline_panels`` — the panel count is the number of
  collectives a phase runs, which SPMD requires to match everywhere;
* mixed ``exchange`` — flat and hierarchical transposes run different
  collectives.
"""

from __future__ import annotations

import dataclasses

from repro_torch.plan.config import PlanConfig
from repro_torch.plan.schedule import SegmentSchedule

__all__ = ["DeviceGroupProgram", "device_group_program",
           "spmd_program_config"]


def spmd_program_config(schedule: SegmentSchedule) -> PlanConfig:
    """Validate a schedule's program-level knobs; return its program config.

    The program config is the single config of a homogeneous schedule, or
    the ``anchor_config`` (makespan-dominant entry) of a heterogeneous
    one — its ``pad``/``fused``/``pipeline_panels`` are shared by every
    entry (validated here), so callers may read the phase-shaping knobs
    off it.  Raises ``ValueError`` — the named SPMD error, carrying the
    schedule's ``describe()`` — for the mixes the module docstring lists
    as genuinely unloweable.
    """
    configs = schedule.configs
    if len(configs) == 1:
        return configs[0]
    knobs = {(c.pad, c.fused, c.pipeline_panels, c.exchange) for c in configs}
    if len(knobs) > 1 or any(c.fused for c in configs):
        raise ValueError(
            "pfft2_distributed runs one SPMD program per device; the "
            f"heterogeneous schedule [{schedule.describe()}] mixes "
            "program-level knobs (pad / fused / pipeline_panels / exchange "
            "shape the collective structure, which SPMD requires to match "
            "on every device) and cannot be lowered to shard_map — only the "
            "local row-FFT variant (radix/backend) may differ per device "
            "group; use the single-host executor (repro.core.pfft) for the "
            "rest")
    return schedule.anchor_config


@dataclasses.dataclass(frozen=True)
class DeviceGroupProgram:
    """A heterogeneous schedule lowered onto ``p`` mesh-axis devices.

    ``configs`` are the schedule's distinct configs in first-appearance
    order; ``group_of_device[i]`` names the config device ``i`` runs;
    ``pad_len`` is the uniform effective FFT length every group transforms
    at (the max over the schedule's entries unless explicitly overridden —
    see the module docstring's uniform-length rule).
    """

    n: int
    p: int
    configs: tuple[PlanConfig, ...]
    group_of_device: tuple[int, ...]
    pad_len: int

    def describe(self) -> str:
        """Compact human tag: ``branch@devices`` terms, e.g.
        ``radix=xla,batched@[0,1] + radix=2,batched@[2,3]``."""
        terms = []
        for g, cfg in enumerate(self.configs):
            devs = [i for i, gi in enumerate(self.group_of_device) if gi == g]
            terms.append(f"{cfg.describe()}@{devs}")
        return " + ".join(terms)


def device_group_program(schedule: SegmentSchedule, p: int,
                         pad_len: int | None = None) -> DeviceGroupProgram:
    """Map ``schedule``'s entries onto contiguous device groups of a
    ``p``-device mesh axis.

    Each entry must cover a whole number of the even ``N/p`` SPMD row
    shards (an entry spanning ``k·N/p`` rows owns ``k`` contiguous
    devices), and together the entries must cover all ``N`` rows — every
    device needs a branch.  Violations raise the named SPMD error; the
    program-level knob mix is validated first (``spmd_program_config``).
    """
    spmd_program_config(schedule)
    n = schedule.n
    if p <= 0 or n % p:
        raise ValueError(
            f"N={n} must be divisible by the mesh axis size p={p}")
    n_loc = n // p
    if schedule.total_rows != n:
        raise ValueError(
            "pfft2_distributed runs one SPMD program per device; the "
            f"schedule [{schedule.describe()}] covers {schedule.total_rows} "
            f"of N={n} rows, so some device would have no branch — a "
            "device-group program needs the full matrix")
    configs: list[PlanConfig] = []
    groups: list[int] = []
    for e in schedule.entries:
        if e.rows % n_loc:
            raise ValueError(
                "pfft2_distributed runs one SPMD program per device over "
                f"contiguous equal N/p={n_loc} row shards; segment "
                f"{e.index} of [{schedule.describe()}] covers {e.rows} "
                "rows — not a whole number of shards — so it cannot be "
                "assigned a device group (SPMD shards are equal-sized; "
                "express uneven row counts through ragged_row_layout)")
        try:
            g = configs.index(e.config)
        except ValueError:
            g = len(configs)
            configs.append(e.config)
        groups.extend([g] * (e.rows // n_loc))
    length = max(e.length for e in schedule.entries)
    if pad_len is not None:
        length = int(pad_len)
    return DeviceGroupProgram(n=n, p=p, configs=tuple(configs),
                              group_of_device=tuple(groups), pad_len=length)
