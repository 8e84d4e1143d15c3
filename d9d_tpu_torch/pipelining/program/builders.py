"""Schedule builders: compile (pp, microbatches) → compute-only programs
(a copy of ``d9d_tpu/pipelining/program/builders.py``).

Reference: d9d/pipelining/component/program/{bfs.py:14, interleaved.py:17,
zerobubblev.py:15, dualpipev.py:18} — each builder emits per-rank ordered
compute actions; ``add_communication_ops`` then injects transfers and
``validate_program`` proves executability & completeness. Schedules:

- ``GPipeProgramBuilder``        — all-forward-then-all-backward, v=1.
- ``LoopedBFSProgramBuilder``    — breadth-first over virtual stages
  (reference bfs.py, arXiv 2211.05953 "breadth-first pipeline parallel").
- ``Interleaved1F1BProgramBuilder`` — Megatron interleaved 1F1B; with
  ``zero_bubble=True`` the ZB1P variant (arXiv 2401.10241): backward split
  into input-grad (I) actions on the critical path and deferred
  weight-grad (W) actions filling the cooldown bubble.
- ``ZeroBubbleVProgramBuilder``  — ZBV (arXiv 2401.10241 §V): V-placement
  (rank r owns stages r and 2pp-1-r) + split backward, built by a
  readiness-driven list scheduler with ZBV priorities (I > F > W).
- ``DualPipeVProgramBuilder``    — DualPipeV (DeepSeek-V3 tech report):
  V-placement with joint forward+backward ``Compose`` slots so the
  executor can overlap the two directions of different microbatches.
- ``InferenceProgramBuilder``    — forward-only.

All builders are timing *and* dependency correct; gradient exactness does
not depend on slot timing, which only affects bubble fraction on hardware.
"""

import abc

from d9d_tpu_torch.pipelining.program.actions import (
    Action,
    BackwardFull,
    BackwardInput,
    BackwardWeight,
    Compose,
    ForwardCompute,
    PipelineProgram,
)
from d9d_tpu_torch.pipelining.program.topology import (
    ScheduleStyle,
    ranks_to_stages,
    stage_to_rank,
)

__all__ = [
    "DualPipeVProgramBuilder",
    "GPipeProgramBuilder",
    "Interleaved1F1BProgramBuilder",
    "InferenceProgramBuilder",
    "LoopedBFSProgramBuilder",
    "ProgramBuilder",
]


class ProgramBuilder(abc.ABC):
    """Compiles a compute-only program for a fixed topology."""

    style: ScheduleStyle = ScheduleStyle.LOOP

    def __init__(self, pp: int, stages_per_rank: int = 1):
        if pp < 1 or stages_per_rank < 1:
            raise ValueError("pp and stages_per_rank must be >= 1")
        self.pp = pp
        self.stages_per_rank = stages_per_rank

    @property
    def num_stages(self) -> int:
        return self.pp * self.stages_per_rank

    @property
    def stage_owner(self) -> dict[int, int]:
        return {
            s: stage_to_rank(s, self.pp, self.style)
            for s in range(self.num_stages)
        }

    @abc.abstractmethod
    def compose(self, num_microbatches: int) -> PipelineProgram:
        """Emit the per-rank compute-only action lists."""

    def _check_microbatches(self, m: int) -> None:
        if m < 1:
            raise ValueError("num_microbatches must be >= 1")


class GPipeProgramBuilder(ProgramBuilder):
    """All forwards, then all backwards. stages_per_rank must be 1."""

    def __init__(self, pp: int, stages_per_rank: int = 1):
        if stages_per_rank != 1:
            raise ValueError("GPipe does not interleave virtual stages")
        super().__init__(pp, 1)

    def compose(self, num_microbatches: int) -> PipelineProgram:
        self._check_microbatches(num_microbatches)
        program: PipelineProgram = {}
        for r in range(self.pp):
            acts: list[Action] = [
                ForwardCompute(r, mb) for mb in range(num_microbatches)
            ]
            acts += [BackwardFull(r, mb) for mb in range(num_microbatches)]
            program[r] = acts
        return program


class InferenceProgramBuilder(ProgramBuilder):
    """Forward-only (reference factory/config.py inference schedule)."""

    def compose(self, num_microbatches: int) -> PipelineProgram:
        self._check_microbatches(num_microbatches)
        program: PipelineProgram = {}
        for r, stages in ranks_to_stages(
            self.num_stages, self.pp, self.style
        ).items():
            acts: list[Action] = []
            for s in stages:
                acts += [ForwardCompute(s, mb) for mb in range(num_microbatches)]
            program[r] = acts
        return program


class LoopedBFSProgramBuilder(ProgramBuilder):
    """Breadth-first: all microbatches through virtual stage k, then k+1."""

    def compose(self, num_microbatches: int) -> PipelineProgram:
        self._check_microbatches(num_microbatches)
        program: PipelineProgram = {}
        for r in range(self.pp):
            stages = [k * self.pp + r for k in range(self.stages_per_rank)]
            acts: list[Action] = []
            for s in stages:
                acts += [ForwardCompute(s, mb) for mb in range(num_microbatches)]
            for s in reversed(stages):
                acts += [BackwardFull(s, mb) for mb in range(num_microbatches)]
            program[r] = acts
        return program


class Interleaved1F1BProgramBuilder(ProgramBuilder):
    """Megatron interleaved 1F1B; ``zero_bubble=True`` gives ZB1P.

    With stages_per_rank == 1 this reduces to classic non-interleaved 1F1B.
    Interleaving (v > 1) requires num_microbatches % pp == 0 (the Megatron
    constraint — unit groups of pp microbatches cycle through chunks).
    """

    def __init__(self, pp: int, stages_per_rank: int = 1, zero_bubble: bool = False):
        super().__init__(pp, stages_per_rank)
        self.zero_bubble = zero_bubble

    def _unit(self, i: int, rank: int, forward: bool) -> tuple[int, int]:
        """Map work-unit index → (global stage, microbatch) for ``rank``."""
        p, v = self.pp, self.stages_per_rank
        group = i % (p * v)
        chunk = group // p
        if not forward:
            chunk = v - 1 - chunk
        mb = (i // (p * v)) * p + group % p
        return chunk * p + rank, mb

    def compose(self, num_microbatches: int) -> PipelineProgram:
        self._check_microbatches(num_microbatches)
        m, p, v = num_microbatches, self.pp, self.stages_per_rank
        if v > 1 and m % p != 0:
            raise ValueError(
                f"interleaved 1F1B needs num_microbatches % pp == 0 "
                f"(got m={m}, pp={p})"
            )
        total = m * v
        program: PipelineProgram = {}
        for r in range(p):
            if v == 1:
                warmup = min(m, p - 1 - r)
            else:
                warmup = min(total, (p - 1 - r) * 2 + (v - 1) * p)
            acts: list[Action] = []
            pending_w: list[tuple[int, int]] = []

            def bwd(stage: int, mb: int) -> list[Action]:
                if self.zero_bubble:
                    pending_w.append((stage, mb))
                    return [BackwardInput(stage, mb)]
                return [BackwardFull(stage, mb)]

            for i in range(warmup):
                acts.append(ForwardCompute(*self._unit(i, r, forward=True)))
            for i in range(total - warmup):
                acts.append(
                    ForwardCompute(*self._unit(warmup + i, r, forward=True))
                )
                acts += bwd(*self._unit(i, r, forward=False))
                # ZB1P: one deferred W fills the slot vacated by the split B
                # once the steady state is deep enough to have W work queued.
                if self.zero_bubble and len(pending_w) > p - r:
                    acts.append(BackwardWeight(*pending_w.pop(0)))
            for i in range(total - warmup, total):
                acts += bwd(*self._unit(i, r, forward=False))
                if self.zero_bubble and pending_w:
                    acts.append(BackwardWeight(*pending_w.pop(0)))
            while pending_w:
                acts.append(BackwardWeight(*pending_w.pop(0)))
            program[r] = acts
        return program


class _ReadinessScheduler:
    """Synchronous-round list scheduler over the true dependency rules.

    Builds valid programs for topologies where closed-form slot formulas
    get hairy (ZBV / DualPipeV). Each round, every rank picks its highest-
    priority ready compute action based on state at the end of the previous
    round — exactly the information a real rank would have.
    """

    def __init__(self, builder: ProgramBuilder, num_microbatches: int, split: bool):
        self.b = builder
        self.m = num_microbatches
        self.split = split
        self.owner = builder.stage_owner
        self.num_stages = builder.num_stages
        # work remaining per rank
        self.todo: dict[int, set[tuple[str, int, int]]] = {
            r: set() for r in range(builder.pp)
        }
        for s, r in self.owner.items():
            for mb in range(num_microbatches):
                self.todo[r].add(("F", s, mb))
                self.todo[r].add(("I" if split else "B", s, mb))
                if split:
                    self.todo[r].add(("W", s, mb))
        self.done: set[tuple[str, int, int]] = set()

    def _fwd_done(self, s: int, mb: int) -> bool:
        return ("F", s, mb) in self.done

    def _bwd_done(self, s: int, mb: int) -> bool:
        return ("B", s, mb) in self.done or ("I", s, mb) in self.done

    def ready(self, kind: str, s: int, mb: int) -> bool:
        if kind == "F":
            return s == 0 or self._fwd_done(s - 1, mb)
        if kind in ("B", "I"):
            if not self._fwd_done(s, mb):
                return False
            return s == self.num_stages - 1 or self._bwd_done(s + 1, mb)
        if kind == "W":
            return ("I", s, mb) in self.done
        raise ValueError(kind)

    def run(
        self, priority, compose_overlap: bool = False
    ) -> PipelineProgram:
        program: PipelineProgram = {r: [] for r in range(self.b.pp)}
        mk = {
            "F": ForwardCompute,
            "B": BackwardFull,
            "I": BackwardInput,
            "W": BackwardWeight,
        }
        while any(self.todo.values()):
            picked: dict[int, list[tuple[str, int, int]]] = {}
            for r in range(self.b.pp):
                ready = sorted(
                    (w for w in self.todo[r] if self.ready(*w)), key=priority
                )
                if not ready:
                    continue
                chosen = [ready[0]]
                if compose_overlap:
                    # pair one forward with one input-backward of different
                    # microbatches into a joint slot (DualPipeV overlap)
                    kinds = {w[0] for w in chosen}
                    for w in ready[1:]:
                        if w[0] in kinds or len(chosen) == 2:
                            continue
                        if {chosen[0][0], w[0]} == {"F", "I"}:
                            chosen.append(w)
                            break
                picked[r] = chosen
            if not picked:
                raise RuntimeError("list scheduler stalled — invalid topology")
            for r, works in picked.items():
                acts = [mk[k](s, mb) for k, s, mb in works]
                program[r].append(
                    Compose(tuple(acts)) if len(acts) > 1 else acts[0]
                )
                for w in works:
                    self.todo[r].discard(w)
                    self.done.add(w)
        return program


class ZeroBubbleVProgramBuilder(ProgramBuilder):
    """ZBV: V-shaped placement + split backward (arXiv 2401.10241)."""

    style = ScheduleStyle.V

    def __init__(self, pp: int, stages_per_rank: int = 2):
        if stages_per_rank != 2:
            raise ValueError("ZBV is defined for exactly 2 stages per rank")
        super().__init__(pp, 2)

    def compose(self, num_microbatches: int) -> PipelineProgram:
        self._check_microbatches(num_microbatches)
        sched = _ReadinessScheduler(self, num_microbatches, split=True)

        def priority(work: tuple[str, int, int]):
            kind, stage, mb = work
            # ZBV ordering: input-backwards are critical-path (rank 0 owns
            # both the first and last stage, so cotangents turn around
            # immediately); forwards next, deferred weight grads last.
            rank_order = {"I": 0, "F": 1, "W": 2}[kind]
            return (rank_order, mb, -stage)

        return sched.run(priority)


class DualPipeVProgramBuilder(ProgramBuilder):
    """DualPipeV: V placement + joint F/B overlap slots (DeepSeek-V3)."""

    style = ScheduleStyle.V

    def __init__(self, pp: int, stages_per_rank: int = 2):
        if stages_per_rank != 2:
            raise ValueError("DualPipeV is defined for exactly 2 stages per rank")
        super().__init__(pp, 2)

    def compose(self, num_microbatches: int) -> PipelineProgram:
        self._check_microbatches(num_microbatches)
        sched = _ReadinessScheduler(self, num_microbatches, split=True)

        def priority(work: tuple[str, int, int]):
            kind, stage, mb = work
            rank_order = {"I": 0, "F": 1, "W": 2}[kind]
            return (rank_order, mb, -stage)

        return sched.run(priority, compose_overlap=True)
