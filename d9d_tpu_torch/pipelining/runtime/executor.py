"""Pipeline schedule executor: interprets a compiled action program
(counterpart of ``d9d_tpu/pipelining/runtime/executor.py``
``PipelineScheduleExecutor`` and ``PipelineExecutionResult``).

Reference: d9d/pipelining/runtime/executor.py:16 — a VM iterating
``program[rank]`` per process, with P2P at the Send/Recv actions. Two
forms:

- ``transfer=None``: this process owns every stage. It interprets the
  merged program (the dependency-proven global order of
  ``validate_program``), and a carry or cotangent crosses to the next
  stage in memory at its Send (a Recv does nothing): JAX's single-
  controller form, which its ``tests/pipelining/test_e2e.py`` drives.
- with a :class:`~d9d_tpu_torch.pipelining.runtime.transfer.P2PTransfer`:
  this process is one pp rank; it walks its own rank's program, sends at
  each Send action and receives at each Recv.

Either way a carry between two stages of one rank is handed over in
memory (the program has no transfer there). Each action runs under
``torch.profiler.record_function("pp_s{k}/<action>")``, as the reference
wraps them: a profiler trace of a step gives each stage's device time by
those ranges. Buffers: per (stage, microbatch) the
:class:`~d9d_tpu_torch.pipelining.runtime.stage.Flight` from the forward
action to the last backward one, and each carry or cotangent until its
consumer takes it.
"""

import dataclasses
from typing import Any

import torch
from torch.profiler import record_function

from d9d_tpu_torch.pipelining.program.actions import (
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
)
from d9d_tpu_torch.pipelining.program.validate import validate_program
from d9d_tpu_torch.pipelining.runtime.stage import PipelineStageRuntime
from d9d_tpu_torch.pipelining.runtime.transfer import message_key


@dataclasses.dataclass
class PipelineExecutionResult:
    """A step's outcome on this process: the unscaled gradient sums of
    each stage it owns (``stage.params`` order), and the loss statistics
    summed over microbatches where this process owns the last stage
    (``None`` elsewhere)."""

    grads: "dict[int, list[torch.Tensor]] | None"
    loss_sum: Any
    weight_sum: Any
    metrics: dict[str, Any]
    outputs: "list | None" = None  # forward-only: last-stage aux per mb


_LABELS = {
    ForwardCompute: "fwd", ForwardSend: "fwd_send", ForwardRecv: "fwd_recv",
    BackwardFull: "bwd", BackwardInput: "bwd_dI", BackwardWeight: "bwd_dW",
    BackwardSend: "bwd_send", BackwardRecv: "bwd_recv",
}


class _StepState:
    __slots__ = ("carries", "kwargs", "states", "inputs", "cots", "outs",
                 "grads_in", "flights", "aux", "outputs")

    def __init__(self, m: int):
        self.carries: dict = {}  # mb → first-stage carry
        self.kwargs: dict = {}  # mb → per-stage kwargs
        self.states: dict = {}  # mb → last-stage state
        self.inputs: dict = {}  # (s, mb) → carry in
        self.cots: dict = {}  # (s, mb) → cotangent of stage s's output
        self.outs: dict = {}  # (s, mb) → carry out awaiting its send
        self.grads_in: dict = {}  # (s, mb) → dI awaiting its send
        self.flights: dict = {}  # (s, mb) → Flight
        self.aux: list = []  # (loss, weight, metrics) per microbatch
        self.outputs: list = [None] * m


class PipelineScheduleExecutor:
    """Runs one train or eval step per :meth:`step` call. ``stages`` maps
    global stage id → runtime for the stages this process owns (every
    stage when ``transfer`` is ``None``); ``stage_owner`` maps every stage
    to its pp rank. The executor owns no parameters: the stages' modules
    do, so optimizer updates between steps are picked up."""

    def __init__(self, *, stages: dict[int, PipelineStageRuntime],
                 program: PipelineProgram, stage_owner: dict[int, int],
                 num_microbatches: int, train: bool = True,
                 transfer=None):
        self.stages = stages
        self.stage_owner = stage_owner
        self.num_stages = len(stage_owner)
        self.num_microbatches = num_microbatches
        self.train = train
        self.transfer = transfer
        sim = validate_program(
            program, num_stages=self.num_stages,
            num_microbatches=num_microbatches, stage_owner=stage_owner,
            train=train)
        if transfer is None:
            missing = set(range(self.num_stages)) - set(stages)
            if missing:
                raise ValueError(f"an executor without transfers owns every "
                                 f"stage; missing {sorted(missing)}")
            order = [a for _, a in sim.order]
        else:
            me = transfer.rank
            mine = {s for s, r in stage_owner.items() if r == me}
            if set(stages) != mine:
                raise ValueError(f"pp rank {me} owns stages {sorted(mine)}, "
                                 f"got runtimes for {sorted(stages)}")
            order = list(program[me])
        self._plan = self._flatten(order)

    def _flatten(self, order) -> tuple:
        plan = []

        def add(action):
            if isinstance(action, Compose):
                for member in action.actions:
                    add(member)
                return
            handler = getattr(self, "_act_" + _LABELS[type(action)])
            label = f"pp_s{action.stage}/{_LABELS[type(action)]}"
            plan.append((handler, action, label))

        for action in order:
            add(action)
        return tuple(plan)

    def step(self, microbatches: list) -> PipelineExecutionResult:
        """Run the program over ``microbatches`` (this rank's, each as the
        task's ``prepare_batch`` structure on the device)."""
        if len(microbatches) != self.num_microbatches:
            raise ValueError(
                f"program compiled for {self.num_microbatches} microbatches, "
                f"got {len(microbatches)}")
        task = next(iter(self.stages.values())).task
        st = _StepState(self.num_microbatches)
        for mb, micro in enumerate(microbatches):
            st.carries[mb], st.kwargs[mb], st.states[mb] = (
                task.split_microbatch(micro))
        if self.train:
            for stage in self.stages.values():
                stage.reset_grads()
        if self.transfer is not None:
            self.transfer.begin_step()
        for handler, action, label in self._plan:
            with record_function(label):
                handler(st, action)
        if self.transfer is not None:
            self.transfer.finish()
        for stage in self.stages.values():
            stage.finish_step()
        loss_sum = weight_sum = None
        metrics: dict = {}
        for loss, weight, m in st.aux:
            loss_sum = loss if loss_sum is None else loss_sum + loss
            weight_sum = weight if weight_sum is None else weight_sum + weight
            for k, v in m.items():
                metrics[k] = v if k not in metrics else metrics[k] + v
        return PipelineExecutionResult(
            grads=({s: stage.grads() for s, stage in self.stages.items()}
                   if self.train else None),
            loss_sum=loss_sum, weight_sum=weight_sum, metrics=metrics,
            outputs=st.outputs if not self.train else None)

    # ---- handoffs ------------------------------------------------------

    def _carry_in(self, st: _StepState, s: int, mb: int):
        if s == 0:
            return st.carries.pop(mb)
        if (s, mb) not in st.inputs:  # same-rank edge
            st.inputs[(s, mb)] = st.outs.pop((s - 1, mb))
        return st.inputs.pop((s, mb))

    def _hand_back(self, st: _StepState, s: int, mb: int, gc) -> None:
        """Route stage ``s``'s input gradient to stage ``s - 1``."""
        if s == 0 or gc is None:
            return
        if self.stage_owner[s - 1] == self.stage_owner[s]:
            st.cots[(s - 1, mb)] = gc
        else:
            st.grads_in[(s, mb)] = gc

    # ---- actions -------------------------------------------------------

    def _act_fwd(self, st: _StepState, action) -> None:
        s, mb = action.stage, action.microbatch
        stage = self.stages[s]
        carry = self._carry_in(st, s, mb)
        kw = st.kwargs[mb]
        if not self.train:
            if not stage.info.is_last:
                st.outs[(s, mb)] = stage.forward(carry, kw)
            else:
                aux = stage.forward_loss(carry, kw, st.states[mb])
                st.aux.append(aux)
                st.outputs[mb] = aux
            return
        fl, out = stage.begin(carry, kw, st.states[mb])
        st.flights[(s, mb)] = fl
        if out is not None:
            st.outs[(s, mb)] = out

    def _act_fwd_send(self, st: _StepState, action) -> None:
        s, mb = action.stage, action.microbatch
        out = st.outs.pop((s, mb))
        if self.transfer is None:
            st.inputs[(s + 1, mb)] = out
        else:
            self.transfer.send(message_key(action), out,
                               self.stage_owner[s + 1])

    def _act_fwd_recv(self, st: _StepState, action) -> None:
        if self.transfer is not None:
            s, mb = action.stage, action.microbatch
            st.inputs[(s, mb)] = self.transfer.recv(
                message_key(action), self.stage_owner[s - 1])

    def _backward(self, st: _StepState, action, fn) -> None:
        s, mb = action.stage, action.microbatch
        stage = self.stages[s]
        cot = None if stage.info.is_last else st.cots.pop((s, mb))
        fl = st.flights[(s, mb)]
        gc, aux = fn(fl, cot)
        if aux is not None:
            st.aux.append(aux)
        self._hand_back(st, s, mb, gc)

    def _act_bwd(self, st: _StepState, action) -> None:
        self._backward(st, action, self.stages[action.stage].backward_full)
        st.flights.pop((action.stage, action.microbatch))

    def _act_bwd_dI(self, st: _StepState, action) -> None:
        self._backward(st, action, self.stages[action.stage].backward_input)

    def _act_bwd_dW(self, st: _StepState, action) -> None:
        s, mb = action.stage, action.microbatch
        self.stages[s].backward_weight(st.flights.pop((s, mb)))

    def _act_bwd_send(self, st: _StepState, action) -> None:
        s, mb = action.stage, action.microbatch
        gc = st.grads_in.pop((s, mb))
        if self.transfer is None:
            st.cots[(s - 1, mb)] = gc
        else:
            self.transfer.send(message_key(action), gc,
                               self.stage_owner[s - 1])

    def _act_bwd_recv(self, st: _StepState, action) -> None:
        if self.transfer is not None:
            s, mb = action.stage, action.microbatch
            st.cots[(s, mb)] = self.transfer.recv(
                message_key(action), self.stage_owner[s + 1])


__all__ = ["PipelineExecutionResult", "PipelineScheduleExecutor"]
