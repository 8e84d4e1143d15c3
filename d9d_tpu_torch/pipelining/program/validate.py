"""Program simulator: deadlock/dependency validation + merged linearization.

A copy of ``d9d_tpu/pipelining/program/validate.py`` (which imports no
JAX). Each rank runs its own program in its own process, so a faulty
schedule builder would surface as a hang; instead the per-rank programs
are simulated against the true dependency rules (blocking recvs, eager
sends), which either proves the program executes — returning one global
linearization, the order the one-process executor interprets — or reports
the exact stuck state. This subsumes the reference's deadlock-safety
analysis in d9d/pipelining/component/program/communications.py.
"""

import dataclasses
from collections.abc import Iterable

from d9d_tpu_torch.pipelining.program.actions import (
    Action,
    BackwardFull,
    BackwardInput,
    BackwardRecv,
    BackwardSend,
    BackwardWeight,
    Compose,
    ForwardCompute,
    ForwardRecv,
    ForwardSend,
    PipelineProgram,
    format_program,
)

__all__ = ["SimulatedProgram", "simulate_program", "validate_program"]


@dataclasses.dataclass(frozen=True)
class SimulatedProgram:
    """Proof of executability: a global order consistent with all deps."""

    #: (rank, action) pairs in one dependency-respecting global order.
    order: tuple[tuple[int, Action], ...]


def _primitive(actions: Iterable[Action]):
    for a in actions:
        if isinstance(a, Compose):
            yield from _primitive(a.actions)
        else:
            yield a


class _SimState:
    def __init__(self, num_stages: int, stage_owner: dict[int, int]):
        self.num_stages = num_stages
        self.stage_owner = stage_owner
        self.done: set[tuple[type, int, int, int]] = set()  # (cls, rank, stage, mb)

    def mark(self, rank: int, a: Action) -> None:
        for p in _primitive([a]):
            self.done.add((type(p), rank, p.stage, p.microbatch))

    def has(self, cls: type, rank: int, stage: int, mb: int) -> bool:
        return (cls, rank, stage, mb) in self.done

    def _fwd_done(self, rank: int, stage: int, mb: int) -> bool:
        return self.has(ForwardCompute, rank, stage, mb)

    def _bwd_done(self, rank: int, stage: int, mb: int) -> bool:
        return self.has(BackwardFull, rank, stage, mb) or self.has(
            BackwardInput, rank, stage, mb
        )

    def ready(self, rank: int, a: Action) -> bool:
        """Can ``rank`` execute ``a`` now? (Composes need every member ready.)"""
        if isinstance(a, Compose):
            # Members may feed each other (e.g. F then BS of another mb);
            # approximate by sequential evaluation with provisional marks.
            snapshot = set(self.done)
            ok = True
            for member in a.actions:
                if not self.ready(rank, member):
                    ok = False
                    break
                self.mark(rank, member)
            self.done = snapshot
            return ok
        s, mb = a.stage, a.microbatch
        if isinstance(a, ForwardCompute):
            if s == 0:
                return True
            if self.stage_owner[s - 1] == rank:
                return self._fwd_done(rank, s - 1, mb)
            return self.has(ForwardRecv, rank, s, mb)
        if isinstance(a, (BackwardFull, BackwardInput)):
            if not self._fwd_done(rank, s, mb):
                return False  # residuals: forward must have run here
            if s == self.num_stages - 1:
                return True  # loss-local cotangent
            if self.stage_owner[s + 1] == rank:
                return self._bwd_done(rank, s + 1, mb)
            return self.has(BackwardRecv, rank, s, mb)
        if isinstance(a, BackwardWeight):
            return self.has(BackwardInput, rank, s, mb)
        if isinstance(a, ForwardSend):
            return self._fwd_done(rank, s, mb)
        if isinstance(a, BackwardSend):
            return self._bwd_done(rank, s, mb)
        if isinstance(a, ForwardRecv):
            src = self.stage_owner[s - 1]
            return self.has(ForwardSend, src, s - 1, mb)
        if isinstance(a, BackwardRecv):
            src = self.stage_owner[s + 1]
            return self.has(BackwardSend, src, s + 1, mb)
        raise TypeError(f"unknown action {a!r}")


def simulate_program(
    program: PipelineProgram,
    *,
    num_stages: int,
    stage_owner: dict[int, int],
) -> SimulatedProgram:
    """Run the blocking-recv/eager-send execution model; raise on deadlock."""
    state = _SimState(num_stages, stage_owner)
    pcs = {r: 0 for r in program}
    order: list[tuple[int, Action]] = []
    total = sum(len(p) for p in program.values())
    while len(order) < total:
        progressed = False
        for rank in sorted(program):
            while pcs[rank] < len(program[rank]):
                action = program[rank][pcs[rank]]
                if not state.ready(rank, action):
                    break
                state.mark(rank, action)
                order.append((rank, action))
                pcs[rank] += 1
                progressed = True
        if not progressed:
            stuck = {
                r: str(program[r][pcs[r]])
                for r in sorted(program)
                if pcs[r] < len(program[r])
            }
            raise RuntimeError(
                f"pipeline program deadlocked; blocked heads per rank: {stuck}\n"
                f"{format_program(program)}"
            )
    return SimulatedProgram(order=tuple(order))


def validate_program(
    program: PipelineProgram,
    *,
    num_stages: int,
    num_microbatches: int,
    stage_owner: dict[int, int],
    train: bool = True,
) -> SimulatedProgram:
    """Full check: executable AND complete (every stage×mb computed once)."""
    sim = simulate_program(
        program, num_stages=num_stages, stage_owner=stage_owner
    )
    counts: dict[tuple[type, int, int], int] = {}
    for rank, action in sim.order:
        for p in _primitive([action]):
            owner = stage_owner.get(p.stage)
            if owner != rank and not isinstance(p, (ForwardRecv, BackwardRecv)):
                raise ValueError(
                    f"rank {rank} runs {p} but stage {p.stage} belongs to {owner}"
                )
            counts[(type(p), p.stage, p.microbatch)] = (
                counts.get((type(p), p.stage, p.microbatch), 0) + 1
            )
    for s in range(num_stages):
        for mb in range(num_microbatches):
            f = counts.get((ForwardCompute, s, mb), 0)
            if f != 1:
                raise ValueError(f"stage {s} mb {mb}: {f} forward computes (want 1)")
            if not train:
                continue
            full = counts.get((BackwardFull, s, mb), 0)
            di = counts.get((BackwardInput, s, mb), 0)
            dw = counts.get((BackwardWeight, s, mb), 0)
            if not (full == 1 and di == 0 and dw == 0) and not (
                full == 0 and di == 1 and dw == 1
            ):
                raise ValueError(
                    f"stage {s} mb {mb}: inconsistent backward "
                    f"(full={full}, input={di}, weight={dw})"
                )
    return sim
