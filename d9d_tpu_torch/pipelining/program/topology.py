"""Stage → rank placement maps (a copy of
``d9d_tpu/pipelining/program/topology.py``).

Reference: d9d/pipelining/component/program/topology.py:17 (``ScheduleStyle``
loop|v and the two placement functions; V zig-zag at :36-52).

- ``loop``: stage ``s`` lives on rank ``s % pp`` — rank r holds stages
  ``r, r+pp, r+2pp, ...`` (interleaved/looped schedules).
- ``v``: consecutive rounds of ``pp`` stages snake down then up, so rank r
  holds stages ``r`` and ``2pp-1-r`` (and so on for deeper V folds) — the
  placement used by ZeroBubbleV / DualPipeV, putting the first and last
  stage on the same rank (embedding + head colocation).
"""

import enum


class ScheduleStyle(enum.Enum):
    LOOP = "loop"
    V = "v"


def stage_to_rank(stage: int, pp: int, style: ScheduleStyle) -> int:
    """Rank owning global ``stage`` under the given placement style."""
    if style is ScheduleStyle.LOOP:
        return stage % pp
    round_idx, pos = divmod(stage, pp)
    return pos if round_idx % 2 == 0 else pp - 1 - pos


def ranks_to_stages(
    num_stages: int, pp: int, style: ScheduleStyle
) -> dict[int, list[int]]:
    """Per-rank ordered list of owned global stage ids."""
    if num_stages % pp != 0:
        raise ValueError(f"num_stages {num_stages} must be a multiple of pp {pp}")
    out: dict[int, list[int]] = {r: [] for r in range(pp)}
    for s in range(num_stages):
        out[stage_to_rank(s, pp, style)].append(s)
    return out
