"""Trainer: wires providers into the step and runs the loop (counterpart of
``d9d_tpu/loop/train.py``), on one device or over a mesh of processes
(``dp_r x dp_s x cp_s x cp_r x tp``), without pipeline parallelism or
PEFT.

The model comes from the provider through the model factory
(``loop/model_factory.py``) and the provider's plan
(``ModelProvider.build_plan``). Under a plan that cuts parameters
(``fsdp_plan`` / ``hsdp_plan``, ``tp_plan``, ``with_tp=True``) each rank
initializes and holds only its pieces of them. Under the replicate plan
(the default) every rank builds the whole model and takes rank 0's
parameters by one broadcast at build, so no two ranks can start apart.
Either way the optimizer states stay equal across replicas because the
gradients are summed over the mesh. Every rank reads the same global batch
and stages its rows (its ``(dp_r, dp_s)`` coordinate) and its sequence
chunk (its ``cp_s`` coordinate); ranks along ``cp_r`` and ``tp`` stage
the same ones. The step sums over the data axes (``dp_r x dp_s x cp_s``),
so the history is the same on every rank. Under ``cp_shard > 1`` the
model must attend across ranks (the ring sdpa backend,
``SdpaRingConfig``). MoE models train on any such mesh: with local
experts (``ep_axes=None``; the expert weights whole on every rank), or
with expert parallelism under ``fsdp_ep_plan`` (``ep_axes=
ctx.ep_shard_axes``): each rank holds its ``E / ep_shard`` experts, whose
gradients the step sums over the data axes outside the ep axes. The task's
``moe_tokens_per_expert`` is summed over the data axes like every
statistic: each token counts once, as in JAX's global count.

``__init__`` builds batch maths → model (through the provider, on the
context's device) → optimizer → step. ``train()`` is a host loop around the
step; staging a batch and the metric readback on the ``log_every`` cadence
are its only per-step host work, and metrics stay on the device between
log steps. :meth:`Trainer.export` writes the trained model as sharded
safetensors (the example's last step). Of the JAX trainer's loop
components the port has the stepper, the metric collector, the manual GC
and the null tracker; checkpointing,
profiling, the watchdog, the anomaly guard, preemption, prefetch and
telemetry sinks are not ported yet (their config fields raise).
"""

import logging
import time
from collections.abc import Callable

import numpy as np
import torch

from d9d_tpu_torch.core.collectives import broadcast
from d9d_tpu_torch.core.mesh import MeshContext
from d9d_tpu_torch.loop.components.batch_maths import BatchMaths
from d9d_tpu_torch.loop.components.batch_staging import (
    check_cp_seq_len,
    stage_microbatches,
)
from d9d_tpu_torch.loop.components.garbage_collector import (
    ManualGarbageCollector,
)
from d9d_tpu_torch.loop.components.metric_collector import MetricCollector
from d9d_tpu_torch.loop.components.stepper import Stepper
from d9d_tpu_torch.loop.config import TrainerConfig
from d9d_tpu_torch.loop.control.providers import (
    DatasetProvider,
    ModelProvider,
    OptimizerProvider,
)
from d9d_tpu_torch.loop.control.task import TrainTask
from d9d_tpu_torch.loop.model_factory import build_model
from d9d_tpu_torch.loop.train_step import build_eval_step, build_train_step
from d9d_tpu_torch.parallel.plan import expert_params
from d9d_tpu_torch.parallel.shards import is_sharded
from d9d_tpu_torch.tracker import NullTracker, Tracker

logger = logging.getLogger("d9d_tpu_torch.trainer")


class Trainer:
    def __init__(
        self,
        *,
        ctx: MeshContext,
        config: TrainerConfig,
        model_provider: ModelProvider,
        dataset_provider: DatasetProvider,
        task: TrainTask,
        optimizer_provider: OptimizerProvider,
        learning_rate: "float | Callable[[int], float] | None" = None,
        peft_method=None,
        tracker: Tracker | None = None,
    ):
        if peft_method is not None:
            raise NotImplementedError("PEFT is not ported yet")
        if ctx.pp_size > 1:
            raise NotImplementedError("pipeline parallelism is not ported yet")
        self.ctx = ctx
        self.device = ctx.device
        self.config = config
        self.task = task
        self.tracker = tracker if tracker is not None else NullTracker()
        self.batch_maths = BatchMaths.from_context(
            ctx, config.global_batch_size, config.microbatch_size)
        self.stepper = Stepper(total_steps=config.total_steps)
        check_cp_seq_len(config.seq_len, ctx.cp_size)
        # None where no other rank holds other rows or positions
        self._reduce_group = (ctx.group(*ctx.data_axes)
                              if ctx.axis_size(*ctx.data_axes) > 1 else None)

        plan = model_provider.build_plan(ctx)
        self.module = build_model(model_provider, ctx, plan,
                                  validate=self._validate_module)
        experts = expert_params(self.module, ctx, plan)
        # the ranks holding the same experts and other tokens
        expert_axes = tuple(a for a in ctx.data_axes
                            if a not in ctx.ep_shard_axes)
        expert_group = (ctx.group(*expert_axes)
                        if experts and ctx.axis_size(*expert_axes) > 1
                        else None)
        sum_groups = dict.fromkeys(experts, expert_group)
        sharded = any(is_sharded(p) for p in self.module.parameters())
        if ctx.world_size > 1 and not sharded:
            with torch.no_grad():
                broadcast(list(self.module.parameters()))
        self.optimizer = optimizer_provider.build(
            self.module.parameters(),
            learning_rate if learning_rate is not None else config.learning_rate,
        )
        self.step_fn = build_train_step(
            module=self.module,
            task=self.task,
            optimizer=self.optimizer,
            num_microbatches=self.batch_maths.num_microbatches,
            max_grad_norm=config.max_grad_norm,
            reduce_group=self._reduce_group,
            sum_groups=sum_groups,
        )
        self.dataset_provider = dataset_provider
        self.gc = ManualGarbageCollector(config.gc_every_steps)
        self.metric_collector = MetricCollector(self.task)
        self.run = None
        self._eval_fn = None
        self._tokens_per_step = config.global_batch_size * config.seq_len

    def _validate_module(self, module) -> None:
        if self.ctx.world_size == 1:
            return
        sdpa = getattr(module, "sdpa", None)
        if (self.ctx.cp_size > 1 and sdpa is not None
                and getattr(sdpa, "group", None) is None):
            # a local backend would attend within each rank's chunk only
            raise ValueError(
                "under cp_shard > 1 the model must attend through the "
                "ring backend: build_sdpa_backend(SdpaRingConfig(), "
                "ctx=ctx)")

    # -- the step ------------------------------------------------------

    def _stage_batch(self, raw_batch: dict) -> list[dict]:
        """prepare → microbatch split → this rank's rows and sequence
        chunk → device."""
        ctx = self.ctx
        return stage_microbatches(
            self.task.prepare_batch(raw_batch),
            num_microbatches=self.batch_maths.num_microbatches,
            microbatch_size=self.batch_maths.microbatch_size,
            device=self.device, seq_len=self.config.seq_len,
            cp_size=ctx.cp_size, cp_rank=ctx.cp_rank,
            dp_size=self.batch_maths.dp_size,
            dp_rank=ctx.coordinate(*ctx.batch_axes),
        )

    def run_step(self, raw_batch: dict) -> dict:
        """Public single-step API: stage ``raw_batch``, run one optimizer
        step, advance the step counter. Returns the step's metric dict with
        values still on the device."""
        metrics = self.step_fn(self._stage_batch(raw_batch))
        self.stepper.advance()
        return metrics

    def _fetches_metrics(self, step: int) -> bool:
        return (step % self.config.log_every == 0
                or step >= self.config.total_steps)

    # -- the loop --------------------------------------------------------

    def train(self) -> list[dict]:
        """Run until ``total_steps`` or data exhaustion; returns the metric
        history, one dict per fetched step (``log_every`` cadence and the
        last step)."""
        history: list[dict] = []
        self.run = self.tracker.new_run(self.config.run_name)
        try:
            self.run.track_hparams(self.config.model_dump())
            t0 = time.perf_counter()
            session_steps = 0
            data_iter = iter(self.dataset_provider.build())
            with self.gc:
                while not self.stepper.finished:
                    try:
                        raw = next(data_iter)
                    except StopIteration:
                        break
                    metrics = self.step_fn(self._stage_batch(raw))
                    self.metric_collector.collect(metrics)
                    step = self.stepper.advance()
                    session_steps += 1
                    self.gc.step(step)
                    if not self._fetches_metrics(step):
                        continue
                    host = {k: v.detach().cpu().numpy()
                            for k, v in metrics.items()}
                    host = self.task.metrics_postprocess(
                        {k: float(v) if np.ndim(v) == 0 else v
                         for k, v in host.items()})
                    host = {k: float(v) for k, v in host.items()
                            if np.ndim(v) == 0}
                    host.update(self.metric_collector.flush(self.run, step))
                    host["step"] = step
                    host["wall_s"] = time.perf_counter() - t0
                    host["tokens_per_s"] = (session_steps * self._tokens_per_step
                                            / max(host["wall_s"], 1e-9))
                    history.append(host)
                    for k, v in host.items():
                        if k != "step":
                            self.run.track_scalar(f"train/{k}", v, step=step,
                                                  context={"subset": "train"})
                    logger.info("step %d: %s", step, host)
        finally:
            self.run.close()
        return history

    # -- export -----------------------------------------------------------

    def export(self, out_dir, mapper=None, shard_size_gb: float = 4.0) -> None:
        """Write the model's weights as sharded safetensors through
        ``mapper`` (``None``: the parameters under their own names; e.g.
        ``qwen3_moe_to_hf_mapper(cfg)`` for an HF checkpoint). On a mesh
        it is collective: every rank calls it, each sharded parameter is
        put together whole on rank 0 alone, one at a time, and rank 0
        writes (``model_state/io/module.py`` ``save_params``)."""
        from d9d_tpu_torch.model_state.io.module import save_params

        save_params(out_dir, self.merged_params(), mapper=mapper,
                    shard_size_gb=shard_size_gb)

    def merged_params(self) -> dict[str, torch.Tensor]:
        """The parameters to export: the module's own (each rank's pieces
        of the sharded ones). PEFT and pipeline stages, which the JAX
        trainer merges here, raise where the trainer is built."""
        return dict(self.module.named_parameters())

    def loss_on_batch(self, raw_batch: dict) -> float:
        """Weighted loss of ``raw_batch`` under the current parameters,
        forward only."""
        if self._eval_fn is None:
            self._eval_fn = build_eval_step(module=self.module, task=self.task,
                                            reduce_group=self._reduce_group)
        return float(self._eval_fn(self._stage_batch(raw_batch)))
