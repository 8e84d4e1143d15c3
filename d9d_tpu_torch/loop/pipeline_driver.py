"""Pipeline-parallel training engine: builds this rank's stages over the
``pp`` axis and drives the schedule executor as the ``Trainer``'s step
(counterpart of ``d9d_tpu/loop/pipeline_driver.py``
``build_pipeline_stages`` and ``PipelineTrainEngine``).

Reference: d9d/loop/run/train.py:251, d9d/loop/component/
model_stage_factory.py:187 and d9d/pipelining/factory/factory.py:92. Each
process is one rank of the mesh; its ``pp`` coordinate owns the stages
the schedule's placement gives it (``stage_owner``), and the ranks of one
``pp`` coordinate are a data-parallel group over the other axes
(``dp_r x dp_s``; ``pp`` beside ``cp``, ``tp`` or ``ep_shard`` is ROADMAP
A8.2). Per stage:

- the module comes from ``ModelProvider.build_module(ctx, stage=info)``
  on the meta device and is materialized on the rank's device from a
  generator seeded from ``(module.seed, stage)`` (``stage_seed``), so
  every rank of a ``pp`` coordinate draws the same weights and the stages
  differ from one another; the provider's plan applies to each stage
  unchanged, over the stage's ranks (``fsdp_plan`` / ``hsdp_plan``: FSDP
  units over the ``dp_s`` ranks of the ``pp`` coordinate, HSDP with
  ``dp_r``; the stage runtime runs FSDP's reduction once a step);
- the carry shapes come from the first microbatch's forward chain: the
  rank owning stage ``s`` runs its forward once, without a graph, on a
  zero carry of stage ``s``'s input shape and tells every ``pp`` rank the
  output's (the analogue of JAX's ``eval_shape`` chain);
- one optimizer (the provider's) over the stage's parameters, stepped as
  a unit by :class:`~d9d_tpu_torch.pipelining.training.PipelinedOptimizer`.

A step: the executor runs this rank's program over its microbatches; the
stages' gradient sums that FSDP does not manage and the last stage's
loss statistics are summed over the data axes (one all-reduce); the statistics go from the last
stage's rank to every ``pp`` rank (one broadcast); then the optimizer.
``eval_loss`` runs a forward-only program over the same stages.
"""

import dataclasses
import logging

import numpy as np
import torch
from torch.utils import _pytree as pytree

from d9d_tpu_torch.core.collectives import (
    all_reduce_sum,
    broadcast,
    host_broadcast_object,
)
from d9d_tpu_torch.core.mesh import AXIS_PP, MeshContext
from d9d_tpu_torch.loop.control.task import PipelineTrainTask
from d9d_tpu_torch.loop.model_factory import materialize_
from d9d_tpu_torch.nn.moe import bind_expert_parallel
from d9d_tpu_torch.parallel.plan import apply_plan, fsdp_modules, plan_shards
from d9d_tpu_torch.pipelining.factory import (
    GPipeScheduleConfig,
    build_program_builder,
    schedule_config,
)
from d9d_tpu_torch.pipelining.program import (
    InferenceProgramBuilder,
    add_communication_ops,
)
from d9d_tpu_torch.pipelining.runtime import (
    CarrySpec,
    P2PTransfer,
    PipelineScheduleExecutor,
    PipelineStageRuntime,
)
from d9d_tpu_torch.pipelining.runtime.transfer import (
    build_channels,
    channel_orders,
)
from d9d_tpu_torch.pipelining.stage_info import PipelineStageInfo
from d9d_tpu_torch.pipelining.training import PipelinedOptimizer

logger = logging.getLogger("d9d_tpu_torch.pipeline")


def stage_seed(seed: "int | None", stage: int) -> "int | None":
    """The init seed of pipeline stage ``stage`` of a model seeded with
    ``seed``."""
    if seed is None:
        return None
    return int(np.random.SeedSequence([seed, stage]).generate_state(
        1, np.uint64)[0] >> 1)


def _zeros(spec: CarrySpec, device) -> object:
    leaves = [torch.zeros(s, dtype=d, device=device)
              for s, d in zip(spec.shapes, spec.dtypes)]
    return pytree.tree_unflatten(leaves, pytree.treespec_loads(spec.treedef))


def build_pipeline_stages(*, ctx: MeshContext, builder, model_provider,
                          task, microbatch_size: int, seq_len: int,
                          grad_dtype=torch.float32,
                          residual_policy: str = "remat",
                          pp_group=None) -> tuple[dict, dict]:
    """This rank's stages → ``({stage: PipelineStageRuntime}, {stage:
    CarrySpec of its input carry})`` (the specs of every stage after the
    first, known on every rank)."""
    plan = model_provider.build_plan(ctx)
    sharded = plan_shards(ctx, plan)
    num_stages = builder.num_stages
    owner = builder.stage_owner
    me = ctx.coordinate(AXIS_PP)
    meta = dataclasses.replace(ctx, device=torch.device("meta"))
    sample = {k: v.to(ctx.device) for k, v in
              task.sample_microbatch(microbatch_size, seq_len).items()}
    carry, kwargs, state = task.split_microbatch(sample)
    stages: dict = {}
    spec_in: dict = {}
    for s in range(num_stages):
        info = PipelineStageInfo(stage_index=s, num_stages=num_stages)
        out_spec = None
        if owner[s] == me:
            module = model_provider.build_module(meta, stage=info)
            if sharded:
                apply_plan(module, ctx, plan)
            materialize_(module, ctx.device,
                         stage_seed(getattr(module, "seed", None), s))
            bind_expert_parallel(module, ctx)
            module.train()
            stages[s] = PipelineStageRuntime(
                info=info, module=module, task=task, grad_dtype=grad_dtype,
                residual_policy=residual_policy)
            if not info.is_last:
                c = carry if s == 0 else _zeros(spec_in[s], ctx.device)
                out_spec = CarrySpec.of(stages[s].forward(c, kwargs))
                stages[s].forward_calls = 0
            for m in fsdp_modules(module):
                m.reshard()
        if not info.is_last:
            if pp_group is not None:
                out_spec = host_broadcast_object(out_spec, root=owner[s],
                                                 group=pp_group)
            spec_in[s + 1] = out_spec
    return stages, spec_in


class PipelineTrainEngine:
    """This rank's stages, programs, executors and per-stage optimizers."""

    def __init__(self, *, ctx: MeshContext, schedule, model_provider,
                 task, optimizer_provider, learning_rate, batch_maths,
                 seq_len: int, max_grad_norm: "float | None" = 1.0,
                 grad_dtype=torch.float32, reduce_group=None):
        if not isinstance(task, PipelineTrainTask):
            raise TypeError(
                "pipeline parallelism needs a PipelineTrainTask (the task "
                "defines the stage carry decomposition); got "
                f"{type(task).__name__}")
        self.ctx = ctx
        self.task = task
        self.num_microbatches = batch_maths.num_microbatches
        self.schedule = schedule_config(
            schedule if schedule is not None else GPipeScheduleConfig())
        builder = build_program_builder(self.schedule, pp=ctx.pp_size)
        self.num_stages = builder.num_stages
        self.stage_owner = builder.stage_owner
        self._style = builder.style
        self.pp_rank = ctx.coordinate(AXIS_PP)
        self.pp_group = ctx.group(AXIS_PP)
        self.reduce_group = reduce_group
        self.stages, self.spec_in = build_pipeline_stages(
            ctx=ctx, builder=builder, model_provider=model_provider,
            task=task,
            microbatch_size=batch_maths.microbatch_size
            // batch_maths.dp_size,
            seq_len=seq_len // ctx.cp_size, grad_dtype=grad_dtype,
            residual_policy=getattr(self.schedule, "residual_policy",
                                    "remat"),
            pp_group=self.pp_group)
        program = add_communication_ops(
            builder.compose(self.num_microbatches),
            num_stages=self.num_stages, stage_owner=self.stage_owner)
        orders = channel_orders(program, self.stage_owner)
        n = ctx.world_size // ctx.pp_size
        here = ctx.process_index % n
        self._peers = {i: i * n + here for i in range(ctx.pp_size)}
        self._channels = build_channels(ctx.pp_size, ctx.world_size,
                                        ctx.process_index, set(orders))
        self.transfer = self._transfer(orders)
        self.executor = PipelineScheduleExecutor(
            stages=self.stages, program=program,
            stage_owner=self.stage_owner,
            num_microbatches=self.num_microbatches, train=True,
            transfer=self.transfer)
        self._eval_executor = None
        self.optimizers = {
            s: optimizer_provider.build(rt.params, learning_rate)
            for s, rt in self.stages.items()}
        self.optimizer = PipelinedOptimizer(
            self.optimizers, {s: rt.params for s, rt in self.stages.items()},
            max_grad_norm=max_grad_norm, pp_group=self.pp_group)
        self._metric_keys: "list[str] | None" = None
        self._last_owner = self.stage_owner[self.num_stages - 1]
        logger.info("pipeline engine: %d stages over pp=%d (%s), %d "
                    "microbatches; this rank owns %s", self.num_stages,
                    ctx.pp_size, type(builder).__name__,
                    self.num_microbatches, sorted(self.stages))

    def _transfer(self, orders) -> P2PTransfer:
        return P2PTransfer(pp_rank=self.pp_rank, peers=self._peers,
                           groups=self._channels, orders=orders,
                           spec_in=self.spec_in, device=self.ctx.device)

    @property
    def owns_last(self) -> bool:
        return self.pp_rank == self._last_owner

    def _share_stats(self, result) -> tuple:
        """The last stage's loss statistics, summed over the data axes, on
        every rank: ``(loss_sum, weight_sum, metrics)``."""
        if self._metric_keys is None:
            keys = sorted(result.metrics) if self.owns_last else None
            self._metric_keys = host_broadcast_object(
                keys, root=self._last_owner, group=self.pp_group)
        keys = self._metric_keys
        if self.owns_last:
            vals = torch.stack([result.loss_sum, result.weight_sum]
                               + [result.metrics[k].float() for k in keys])
        else:
            vals = torch.zeros(2 + len(keys), device=self.ctx.device)
        broadcast([vals], group=self.pp_group, src=self._last_owner)
        return vals[0], vals[1], dict(zip(keys, vals[2:]))

    def step(self, microbatches: list) -> dict:
        """One optimizer step over this rank's microbatches → the step's
        metrics as device scalars (the same on every rank)."""
        result = self.executor.step(microbatches)
        grads = result.grads
        with torch.no_grad():
            if self.reduce_group is not None:
                # FSDP's reduce-scatter summed the gradients it manages
                flat = [g for s in sorted(grads)
                        for g, m in zip(grads[s], self.stages[s].managed)
                        if not m]
                stats = []
                if self.owns_last:
                    keys = sorted(result.metrics)
                    stats = [result.loss_sum.clone(),
                             result.weight_sum.clone()] + [
                        result.metrics[k].clone() for k in keys]
                all_reduce_sum(flat + stats, self.reduce_group)
                if self.owns_last:
                    result.loss_sum, result.weight_sum = stats[:2]
                    result.metrics = dict(zip(keys, stats[2:]))
            loss_sum, weight_sum, metrics = self._share_stats(result)
        grad_norm = self.optimizer.step(grads, weight_sum)
        inv_w = 1.0 / torch.clamp(weight_sum, min=1e-8)
        out = {"loss": loss_sum * inv_w, "grad_norm": grad_norm,
               "loss_weight": weight_sum}
        out.update({f"task/{k}": v for k, v in metrics.items()})
        return out

    def eval_loss(self, microbatches: list) -> torch.Tensor:
        """Forward-only program over the same stages → the weighted loss
        (summed over the data axes), on every rank."""
        if self._eval_executor is None:
            builder = InferenceProgramBuilder(
                self.ctx.pp_size,
                stages_per_rank=self.num_stages // self.ctx.pp_size)
            # the training placement (loop or V), so ownership matches
            builder.style = self._style
            program = add_communication_ops(
                builder.compose(self.num_microbatches),
                num_stages=self.num_stages, stage_owner=self.stage_owner)
            self._eval_executor = PipelineScheduleExecutor(
                stages=self.stages, program=program,
                stage_owner=self.stage_owner,
                num_microbatches=self.num_microbatches, train=False,
                transfer=self._transfer(channel_orders(
                    program, self.stage_owner)))
        with torch.no_grad():
            result = self._eval_executor.step(microbatches)
            if self.owns_last and self.reduce_group is not None:
                pair = [result.loss_sum.clone(), result.weight_sum.clone()]
                all_reduce_sum(pair, self.reduce_group)
                result.loss_sum, result.weight_sum = pair
            loss_sum, weight_sum, _ = self._share_stats(result)
        return loss_sum / torch.clamp(weight_sum, min=1e-8)

    # -- state surface for checkpoint and export ----------------------

    def named_parameters(self) -> dict[str, torch.Tensor]:
        """This rank's stages' parameters under their global names."""
        out: dict = {}
        for s in sorted(self.stages):
            for name, p in self.stages[s].module.named_parameters():
                if name in out:
                    raise ValueError(f"stages collide on parameter {name!r}")
                out[name] = p
        return out

    def state_dict(self) -> dict[str, torch.Tensor]:
        out: dict = {}
        for s in sorted(self.stages):
            out.update(self.stages[s].module.state_dict())
        return out

    def optimizer_state(self) -> dict:
        """Every stage's ``checkpoint_state()``, its per-parameter entries
        keyed by global parameter name; the scalars (``count``) are each
        stage's, equal since the stages step together."""
        merged: dict = {}
        for s in sorted(self.stages):
            opt = self.optimizers[s]
            if not hasattr(opt, "checkpoint_state"):
                raise TypeError(f"{type(opt).__name__} has no "
                                f"checkpoint_state(): a checkpointing "
                                f"trainer needs it (see optim/adamw.py)")
            names = self._param_names(s)
            for k, v in opt.checkpoint_state().items():
                if isinstance(v, list):
                    merged.setdefault(k, {}).update(zip(names, v))
                else:
                    merged.setdefault(k, v)
        return merged

    def load_optimizer_state(self, state: dict) -> None:
        for s in sorted(self.stages):
            names = self._param_names(s)
            self.optimizers[s].load_state_dict(
                {k: ([v[n] for n in names] if isinstance(v, dict) else v)
                 for k, v in state.items()})

    def _param_names(self, s: int) -> list[str]:
        names = {id(p): n for n, p in
                 self.stages[s].module.named_parameters()}
        return [names[id(p)] for p in self.optimizers[s].params]


__all__ = ["PipelineTrainEngine", "build_pipeline_stages", "stage_seed"]
