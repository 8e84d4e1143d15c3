"""One pipeline stage's compute: the forward, a full backward and the
split backward of the zero-bubble schedules (counterpart of
``d9d_tpu/pipelining/runtime/stage.py`` ``PipelineStageRuntime``).

Reference: d9d/pipelining/infra/stage/stage.py:13 (PipelineStage) and
splitgrad.py (``stage_backward_input`` :220, ``stage_backward_weight``
:290). The JAX package derives four pure functions from the stage's
forward with ``jax.vjp``; the port keeps an autograd graph per microbatch
in flight (a :class:`Flight`) and picks the gradients out of it with
the autograd engine. The parameter gradients accumulate as
``loss.backward()`` accumulates them, in each parameter's ``.grad``
(the gathered parameter's under FSDP), summed in ``grad_dtype`` (the JAX
``cast_grads`` / ``accumulate``): a parameter held narrower than
``grad_dtype`` gets its gradient of its own dtype each backward, which is
added into an fp32 accumulator of the stage's and freed, as in the
one-program step (``loop/train_step.py``).

How the backward is paid for is the stage's ``residual_policy``, JAX's
three:

- ``"remat"``: the forward action keeps only the stage's input carry (it
  runs under ``no_grad``; the last stage runs nothing there, its forward
  folded into the backward, as in JAX); every backward runs a fresh
  forward: the full backward one, the I slot one (then the gradient with
  respect to the carry alone) and the W slot another (then the parameters
  alone). Memory-minimal; two extra forwards a microbatch under the split.
- ``"cache_full"``: the forward action keeps its autograd graph; the I slot
  runs one backward for the carry and the parameters together, and the
  deferred W slot is a no-op.
- ``"cache_acts"``: the true split. The forward action keeps its graph;
  the I slot runs only the carry-cotangent chain (``autograd.grad`` with
  respect to the carry, the graph retained) and captures, by pre-hooks,
  the cotangents flowing into the graph's *intermediates*: the nodes of
  the carry chain through which a parameter's gradient enters it (a
  projection's product, a norm's scale). The W slot then replays only the
  weight edges: ``autograd.grad`` from those intermediates, with the
  captured cotangents, to the parameters — no forward and no node of the
  carry chain runs again. Parameters are grouped by the intermediates
  they share and each group is replayed on its own, so a path through the
  carry chain is never walked twice. On the first stage, whose carry is
  token ids, there is no carry chain: the W slot runs the whole backward
  to the parameters from the forward's graph. A W slot before its I slot
  raises, as JAX's does.

Under the split, a custom ``autograd.Function`` that takes a parameter
(the fused MoE expert FFN, ``ops/moe_ffn.py``) is itself an intermediate:
its one backward computes every input's gradient, so it runs in both
slots. Layer remat (``torch.utils.checkpoint``) recomputes a layer's
forward in each backward that unpacks its saved tensors, so in both slots
too.
"""

import dataclasses
from typing import Any, Protocol

import torch
from torch import nn
from torch.autograd.graph import GradientEdge
from torch.utils import _pytree as pytree

from d9d_tpu_torch.parallel.shards import local_tensor
from d9d_tpu_torch.pipelining.stage_info import PipelineStageInfo

POLICIES = ("remat", "cache_full", "cache_acts")


class StageTask(Protocol):
    """How the executor drives one stage of a model for a task (the
    :class:`~d9d_tpu_torch.loop.control.task.PipelineTrainTask` surface).
    Forward-only programs return each microbatch's loss statistics (JAX's
    ``last_stage_outputs`` hook waits for the inference engine, ROADMAP
    A10)."""

    def split_microbatch(self, microbatch: Any) -> tuple[Any, Any, Any]:
        ...

    def stage_forward(self, module: nn.Module, carry: Any, kwargs: Any) -> Any:
        ...

    def last_stage_loss(self, module: nn.Module, carry: Any, kwargs: Any,
                        state: Any):
        ...


def _leaves(tree) -> list:
    return pytree.tree_leaves(tree)


def _differentiable(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def as_carry_input(carry):
    """The stage's input carry as autograd leaves: each floating tensor
    detached and requiring grad (token ids stay as they are)."""
    return pytree.tree_map(
        lambda t: t.detach().requires_grad_(True) if _differentiable(t)
        else t, carry)


def detach_tree(tree):
    return pytree.tree_map(
        lambda t: t.detach() if isinstance(t, torch.Tensor) else t, tree)


def _grad_node(t: torch.Tensor):
    """``t``'s autograd node: its ``grad_fn``, or a leaf's AccumulateGrad."""
    if t.grad_fn is not None:
        return t.grad_fn
    if not t.requires_grad:
        return None
    return t.view_as(t).grad_fn.next_functions[0][0]


def _reverse_edges(roots) -> dict:
    """node → the nodes that send gradients to it, over the graph below
    ``roots``."""
    rev: dict = {}
    seen = set()
    stack = [r for r in roots if r is not None]
    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        for child, _ in node.next_functions:
            if child is None:
                continue
            rev.setdefault(child, []).append(node)
            stack.append(child)
    return rev


def _closure(roots, targets, rev) -> tuple[set, set]:
    """Nodes reachable from ``roots`` towards the outputs, stopping at
    ``targets`` → ``(closure, targets met)``."""
    closure, met = set(), set()
    stack = list(roots)
    while stack:
        node = stack.pop()
        if node in closure:
            continue
        if node in targets:
            met.add(node)
            continue
        closure.add(node)
        stack.extend(rev.get(node, ()))
    return closure, met


@dataclasses.dataclass(eq=False)
class ParamGroup:
    """Parameters whose gradients enter the carry chain at the same
    ``intermediates``, and the cotangents captured there by the I slot."""

    params: list
    intermediates: list
    grads: dict = dataclasses.field(default_factory=dict)


def param_groups(input_nodes, weight_nodes: dict, rev) -> list[ParamGroup]:
    """Group the parameters (``weight_nodes``: AccumulateGrad → index) by
    the nodes where their paths meet the closure of ``input_nodes``: two
    parameters that meet it at a common node share a group. A parameter
    whose path never meets it (unused) is in no group."""
    inputs_closure, _ = _closure(input_nodes, set(), rev)
    met = {i: _closure([acc], inputs_closure, rev)[1]
           for acc, i in weight_nodes.items()}
    root = {i: i for i in met}

    def find(i):
        while root[i] != i:
            root[i] = root[root[i]]
            i = root[i]
        return i

    owner: dict = {}
    for i, nodes in met.items():
        for node in nodes:
            if node in owner:
                root[find(i)] = find(owner[node])
            else:
                owner[node] = i
    groups: dict = {}
    for i in sorted(met):
        if not met[i]:
            continue
        g = groups.setdefault(find(i), ParamGroup(params=[], intermediates=[]))
        g.params.append(i)
        for node in met[i]:
            if node not in g.intermediates:
                g.intermediates.append(node)
    return list(groups.values())


def _owners(groups, rev, out) -> list:
    """What keeps the intermediates' nodes alive between the I and the W
    slot once the graph's output is dropped. A C++ node's Python handle
    owns it; a custom ``autograd.Function``'s node is owned only by the
    nodes that consume it (its Python object holds it weakly), so for it
    the nearest consumers that are C++ nodes are kept — or the graph's
    output, when it is one."""
    from torch.autograd.function import BackwardCFunction

    keep, seen = [], set()
    stack = [n for g in groups for n in g.intermediates]
    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        if not isinstance(node, BackwardCFunction):
            keep.append(node)
        elif rev.get(node):
            stack.extend(rev[node])
        else:
            keep.append(out)
    return keep


def _backward_from_edges(edges: tuple, cots: tuple, params: tuple) -> None:
    """Backward from cotangents ``cots`` entering the graph at ``edges``,
    accumulating into the ``.grad`` of ``params`` only, without graph
    retention. ``torch.autograd`` checks a ``GradientEdge`` output's shape
    through its node's input metadata, which a custom
    ``autograd.Function``'s node does not expose on every torch version
    (2.11 raises); the captured cotangents came out of the engine for
    those very nodes, so the engine takes them as they are."""
    from torch.autograd.graph import _engine_run_backward

    _engine_run_backward(edges, cots, False, False, params, True,
                         accumulate_grad=True)


class _FsdpStage:
    """FSDP2 under the pipeline schedule, for a stage module a plan wrapped
    with ``fully_shard`` (inert otherwise). The split backward runs around
    FSDP's hooks (the I slot stops at the carry, the W slot starts at the
    intermediates), so, as ``torch.distributed.pipelining`` does: the
    units keep their parameters gathered from the first forward of a step
    to its end (the I and W slots of a microbatch read the forward's
    saved, gathered weights), their gradients accumulate in the gathered
    parameters' ``.grad`` with gradient sync off, and after the stage's
    last backward action FSDP's post-backward runs by hand, once, with
    sync on: one reduce-scatter of the step's sums (summed over the shard
    and replicate dims), then every unit reshards. Parameters held
    narrower than fp32 raise here (their gradients would accumulate in
    their own dtype between FSDP's hooks; ROADMAP A8.2)."""

    def __init__(self, module: nn.Module, params: list):
        from torch.distributed.fsdp import FSDPModule, fully_shard

        from d9d_tpu_torch.parallel.plan import fsdp_modules

        self.module = module
        self.units = [m for m in module.modules() if isinstance(m, FSDPModule)]
        by_sharded = {fp.sharded_param: fp for m in fsdp_modules(module)
                      for fp in fully_shard.state(m)._fsdp_param_group
                      .fsdp_params}
        self.fsdp_params = [by_sharded.get(p) for p in params]
        self.managed = [fp is not None for fp in self.fsdp_params]
        self.params = params
        if any(fp is not None and p.dtype != torch.float32
               for fp, p in zip(self.fsdp_params, params)):
            raise NotImplementedError(
                "parameters held narrower than fp32 under FSDP in a "
                "pipeline stage are not ported yet (ROADMAP A8.2)")
        self._training = False
        for m in self.units:
            m.set_reshard_after_forward(False)

    def leaves(self) -> list:
        """The parameters as the autograd graph holds them: the gathered
        parameter of a managed one."""
        return [p if fp is None else fp.unsharded_param
                for p, fp in zip(self.params, self.fsdp_params)]

    def begin_step(self) -> None:
        self._training = True
        for m in self.units:
            m.set_requires_gradient_sync(False)
            m.set_reshard_after_backward(False)
            m.set_is_last_backward(False)

    def finish_step(self) -> None:
        if not self.units:
            return
        if not self._training:  # forward only: nothing to reduce
            for m in self.units:
                m.reshard()
            return
        self._training = False
        from torch.distributed.fsdp import fully_shard

        for m in self.units:
            m.set_is_last_backward(True)
            m.set_reshard_after_backward(True)
            m.set_requires_gradient_sync(True)
        state = fully_shard.state(self.module)
        for st in state._state_ctx.all_states:
            if st._fsdp_param_group is not None:
                st._fsdp_param_group.post_backward()
        state._root_post_backward_final_callback()

    def grads(self) -> dict:
        """Parameter index → this rank's reduced piece, for the managed
        parameters that got one."""
        return {i: local_tensor(p.grad)
                for i, (p, fp) in enumerate(zip(self.params, self.fsdp_params))
                if fp is not None and p.grad is not None}


class Flight:
    """One microbatch in flight on a stage, from its forward action to its
    last backward action: the input carry (autograd leaves), the kwargs and
    task state, the graph's output when it was kept, the loss statistics
    of a last stage, the cotangent and, between the split slots, the
    captured parameter groups."""

    __slots__ = ("carry", "kwargs", "state", "out", "aux", "cot", "groups",
                 "keep", "input_done", "weight_done")

    def __init__(self, carry, kwargs, state):
        self.carry, self.kwargs, self.state = carry, kwargs, state
        self.out = self.aux = self.cot = self.groups = self.keep = None
        self.input_done = self.weight_done = False


class PipelineStageRuntime:
    """One pipeline stage: its module (which holds its parameters), the
    task, and the gradient sums of the step's microbatches
    (:meth:`grads`)."""

    def __init__(self, *, info: PipelineStageInfo, module: nn.Module, task,
                 grad_dtype: "torch.dtype | None" = torch.float32,
                 residual_policy: str = "remat"):
        if residual_policy not in POLICIES:
            raise ValueError(f"unknown residual_policy {residual_policy!r}")
        self.info = info
        self.module = module
        self.task = task
        self.grad_dtype = grad_dtype
        self.residual_policy = residual_policy
        self.params = [p for p in module.parameters() if p.requires_grad]
        wide = [p for p in self.params if grad_dtype is not None
                and p.dtype.itemsize > grad_dtype.itemsize]
        if wide:
            raise NotImplementedError(
                f"parameters held wider than grad_dtype {grad_dtype}")
        # held narrower than grad_dtype: accumulated apart, in fp32
        self._narrow = [i for i, p in enumerate(self.params)
                        if grad_dtype is not None and p.dtype != grad_dtype]
        self._acc: "list[torch.Tensor | None]" = [None] * len(self.params)
        self._fsdp = _FsdpStage(module, self.params)
        self.forward_calls = 0  # stage forwards run

    @property
    def managed(self) -> list[bool]:
        """Which parameters FSDP manages (their gradients come out of its
        reduce-scatter, summed over the stage's data ranks already)."""
        return self._fsdp.managed

    @property
    def keeps_graph(self) -> bool:
        return self.residual_policy in ("cache_full", "cache_acts")

    # ---- forward ---------------------------------------------------------

    def _run(self, fl: Flight):
        """The stage's forward on ``fl`` → the graph's output (the loss on
        the last stage) and the loss statistics (``None`` before it)."""
        self.forward_calls += 1
        if self.info.is_last:
            loss, weight, metrics = self.task.last_stage_loss(
                self.module, fl.carry, fl.kwargs, fl.state)
            aux = (loss.detach().float(), weight.detach().float(),
                   {k: v.detach() for k, v in metrics.items()})
            return loss, aux
        return self.task.stage_forward(self.module, fl.carry, fl.kwargs), None

    def forward(self, carry, kwargs):
        """Forward only (no graph): carry in → carry out."""
        with torch.no_grad():
            self.forward_calls += 1
            return self.task.stage_forward(self.module, carry, kwargs)

    def forward_loss(self, carry, kwargs, state):
        """Last stage, forward only → ``(loss_sum, weight, metrics)``."""
        with torch.no_grad():
            _, aux = self._run(Flight(carry, kwargs, state))
            return aux

    def begin(self, carry, kwargs, state) -> tuple[Flight, Any]:
        """The forward action of a training step → the microbatch's
        :class:`Flight` and the carry to hand to the next stage (``None``
        on the last stage)."""
        fl = Flight(as_carry_input(carry), kwargs, state)
        if self.keeps_graph:
            with torch.enable_grad():
                fl.out, fl.aux = self._run(fl)
            return fl, None if self.info.is_last else detach_tree(fl.out)
        if self.info.is_last:
            return fl, None  # folded into the backward, as in JAX
        return fl, self.forward(fl.carry, kwargs)

    # ---- backward --------------------------------------------------------

    def _carry_leaves(self, fl: Flight) -> list:
        return [t for t in _leaves(fl.carry)
                if isinstance(t, torch.Tensor) and t.requires_grad]

    def _graph(self, fl: Flight):
        """The kept graph, or a fresh forward's (remat); ``fl.out`` is
        dropped: each graph is walked once."""
        if fl.out is None:
            with torch.enable_grad():
                out, aux = self._run(fl)
        else:
            out, aux = fl.out, fl.aux
            fl.out = None
        return out, aux

    def _backward(self, out, cot, inputs: list,
                  retain: bool = False) -> None:
        """Backward from the graph's output (with its cotangent ``cot``;
        the loss's is 1), accumulating into the ``.grad`` of ``inputs``
        only."""
        outs = _leaves(out)
        cots = ([torch.ones_like(o) for o in outs] if cot is None
                else _leaves(cot))
        if inputs:
            torch.autograd.backward(outs, cots, retain_graph=retain,
                                    inputs=inputs)

    def _carry_grad(self, fl: Flight):
        """The carry's gradient (each leaf's ``.grad``), taken off it."""
        def take(t):
            if not (isinstance(t, torch.Tensor) and t.requires_grad):
                return None
            g, t.grad = t.grad, None
            return g if g is not None else torch.zeros_like(t)

        return pytree.tree_map(take, fl.carry)

    def backward_full(self, fl: Flight, cot=None):
        """Carry and parameter gradients in one backward → ``(grad of the
        carry or None, loss statistics or None)``."""
        out, aux = self._graph(fl)
        leaves = self._carry_leaves(fl)
        self._backward(out, cot, leaves + self._fsdp.leaves())
        self._take_narrow()
        fl.input_done = fl.weight_done = True
        return (self._carry_grad(fl) if leaves else None), aux

    def backward_input(self, fl: Flight, cot=None):
        """The I slot → ``(grad of the carry or None, loss statistics or
        None)``; ``fl`` then waits for :meth:`backward_weight`."""
        fl.cot = cot
        if self.residual_policy == "cache_full":
            return self.backward_full(fl, cot)
        leaves = self._carry_leaves(fl)
        if self.residual_policy == "remat":
            fl.input_done = True
            if not leaves:
                # token ids are not differentiable: the I slot has no
                # work, but a stage that is also the last reports its loss
                aux = (self.forward_loss(fl.carry, fl.kwargs, fl.state)
                       if self.info.is_last else None)
                return None, aux
            out, aux = self._graph(fl)
            self._backward(out, cot, leaves)
            return self._carry_grad(fl), aux
        # cache_acts
        if fl.out is None:
            raise RuntimeError("cache_acts input backward without the "
                               "forward action's graph")
        fl.input_done = True
        if not leaves:
            return None, fl.aux  # the W slot runs the whole backward
        out, aux = fl.out, fl.aux
        weights = {}
        for i, p in enumerate(self._fsdp.leaves()):
            node = _grad_node(p)
            if node is not None:
                weights[node] = i
        rev = _reverse_edges([_grad_node(o) for o in _leaves(out)])
        inputs = [_grad_node(t) for t in leaves]
        groups = param_groups(inputs, weights, rev)
        handles = []
        for group in groups:
            for node in group.intermediates:
                def hook(grad_outputs, group=group, node=node):
                    group.grads[node] = grad_outputs
                handles.append(node.register_prehook(hook))
        try:
            self._backward(out, cot, leaves, retain=True)
        finally:
            for h in handles:
                h.remove()
        fl.keep = _owners(groups, rev, out)
        fl.out = None
        fl.groups = groups
        return self._carry_grad(fl), aux

    def backward_weight(self, fl: Flight) -> None:
        """The W slot: the parameter gradients, accumulated."""
        if not fl.input_done:
            raise RuntimeError(
                f"stage {self.info.stage_index}: weight backward before its "
                f"input backward")
        if fl.weight_done:
            return  # cache_full: the I slot did it
        fl.weight_done = True
        params = self._fsdp.leaves()
        if self.residual_policy == "remat" or fl.groups is None:
            # remat: a fresh forward; cache_acts on the first stage: no
            # carry chain, the whole backward from the forward's graph
            out, _ = self._graph(fl)
            self._backward(out, fl.cot, params)
            self._take_narrow()
            return
        for group in fl.groups:
            edges, cots = [], []
            for node in group.intermediates:
                for k, g in enumerate(group.grads.get(node, ())):
                    if g is not None:
                        edges.append(GradientEdge(node, k))
                        cots.append(g)
            if not edges:
                continue
            _backward_from_edges(tuple(edges), tuple(cots),
                                 tuple(params[i] for i in group.params))
        fl.groups = fl.keep = None
        self._take_narrow()

    # ---- gradient sums ---------------------------------------------------

    def _take_narrow(self) -> None:
        """Add the gradients of parameters held narrower than
        ``grad_dtype`` into their fp32 accumulators, and free them."""
        with torch.no_grad():
            for i in self._narrow:
                leaf = self._fsdp.leaves()[i]
                g, leaf.grad = leaf.grad, None
                if g is None:
                    continue
                if self._acc[i] is None:
                    self._acc[i] = g.to(self.grad_dtype)
                else:
                    self._acc[i].add_(g)

    def reset_grads(self) -> None:
        self._acc = [None] * len(self.params)
        for p, managed in zip(self.params, self._fsdp.managed):
            if not managed:  # FSDP frees its gathered gradients itself
                p.grad = None
        self._fsdp.begin_step()

    def finish_step(self) -> None:
        """After the step's last action: FSDP's reduction of the gradients
        it manages after a training step, its units resharded after a
        forward-only one (a no-op for a stage it does not wrap)."""
        self._fsdp.finish_step()

    def grads(self) -> list[torch.Tensor]:
        """The step's gradient sum of each parameter (``self.params``'
        order; this rank's piece, summed over the stage's data ranks, for
        one FSDP manages), zeros for a parameter no microbatch reached."""
        fsdp = self._fsdp.grads()
        out = []
        for i, (a, p) in enumerate(zip(self._acc, self.params)):
            if self._fsdp.managed[i]:
                g = fsdp.get(i)
            elif i in self._narrow:
                g = a
            else:
                g = p.grad
            if g is None:
                g = torch.zeros_like(local_tensor(p),
                                     dtype=self.grad_dtype or p.dtype)
            out.append(g)
        return out


__all__ = ["Flight", "POLICIES", "PipelineStageRuntime", "StageTask",
           "as_carry_input", "detach_tree", "param_groups"]
