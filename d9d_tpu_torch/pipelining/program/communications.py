"""Communication-injection pass: compute-only program → full program (a
copy of ``d9d_tpu/pipelining/program/communications.py``).

Reference: d9d/pipelining/component/program/communications.py
(``add_communication_ops``) — schedule builders emit compute-only per-rank
programs; this pass inserts the Send/Recv actions for every cross-rank
stage edge. The placement discipline (eager sends immediately after the
producing compute, blocking recvs immediately before the consuming
compute) is deadlock-free by construction: sends never block, and every
recv's matching send depends only on computes strictly earlier in the
stage/microbatch DAG. ``validate_program`` proves it per schedule.
"""

from d9d_tpu_torch.pipelining.program.actions import (
    Action,
    BackwardFull,
    BackwardInput,
    BackwardRecv,
    BackwardSend,
    Compose,
    ForwardCompute,
    ForwardRecv,
    ForwardSend,
    PipelineProgram,
)

__all__ = ["add_communication_ops"]


def _edges_for(
    action: Action, num_stages: int, stage_owner: dict[int, int], rank: int
) -> tuple[list[Action], list[Action]]:
    """(recvs-before, sends-after) required by one primitive compute action."""
    before: list[Action] = []
    after: list[Action] = []
    if isinstance(action, ForwardCompute):
        s, mb = action.stage, action.microbatch
        if s > 0 and stage_owner[s - 1] != rank:
            before.append(ForwardRecv(s, mb))
        if s + 1 < num_stages and stage_owner[s + 1] != rank:
            after.append(ForwardSend(s, mb))
    elif isinstance(action, (BackwardFull, BackwardInput)):
        s, mb = action.stage, action.microbatch
        if s + 1 < num_stages and stage_owner[s + 1] != rank:
            before.append(BackwardRecv(s, mb))
        if s > 0 and stage_owner[s - 1] != rank:
            after.append(BackwardSend(s, mb))
    return before, after


def add_communication_ops(
    program: PipelineProgram,
    *,
    num_stages: int,
    stage_owner: dict[int, int],
) -> PipelineProgram:
    """Insert sends/recvs around every cross-rank compute edge."""
    out: PipelineProgram = {}
    for rank, actions in program.items():
        new: list[Action] = []
        for action in actions:
            if isinstance(action, Compose):
                befores: list[Action] = []
                afters: list[Action] = []
                for member in action.actions:
                    b, a = _edges_for(member, num_stages, stage_owner, rank)
                    befores.extend(b)
                    afters.extend(a)
                new.extend(befores)
                new.append(action)
                new.extend(afters)
            else:
                b, a = _edges_for(action, num_stages, stage_owner, rank)
                new.extend(b)
                new.append(action)
                new.extend(a)
        out[rank] = new
    return out
