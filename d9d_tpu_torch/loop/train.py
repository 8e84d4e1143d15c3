"""Trainer: wires providers into the step and runs the loop (counterpart of
``d9d_tpu/loop/train.py``), on one device, without pipeline parallelism or
PEFT.

``__init__`` builds batch maths → model (through the provider, on the
context's device) → optimizer → step. ``train()`` is a host loop around the
step; staging a batch and the metric readback on the ``log_every`` cadence
are its only per-step host work, and metrics stay on the device between
log steps. Of the JAX trainer's loop components the port has the stepper,
the metric collector, the manual GC and the null tracker; checkpointing,
profiling, the watchdog, the anomaly guard, preemption, prefetch and
telemetry sinks are not ported yet (their config fields raise).
"""

import logging
import time
from collections.abc import Callable

import numpy as np
import torch

from d9d_tpu_torch.core.mesh import MeshContext
from d9d_tpu_torch.loop.components.batch_maths import BatchMaths
from d9d_tpu_torch.loop.components.batch_staging import stage_microbatches
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
from d9d_tpu_torch.loop.train_step import build_eval_step, build_train_step
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

        self.module = model_provider.build_module(ctx)
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
        )
        self.dataset_provider = dataset_provider
        self.gc = ManualGarbageCollector(config.gc_every_steps)
        self.metric_collector = MetricCollector(self.task)
        self.run = None
        self._eval_fn = None
        self._tokens_per_step = config.global_batch_size * config.seq_len

    # -- the step ------------------------------------------------------

    def _stage_batch(self, raw_batch: dict) -> list[dict]:
        """prepare → microbatch split → device."""
        return stage_microbatches(
            self.task.prepare_batch(raw_batch),
            num_microbatches=self.batch_maths.num_microbatches,
            microbatch_size=self.batch_maths.microbatch_size,
            device=self.device,
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

    def loss_on_batch(self, raw_batch: dict) -> float:
        """Weighted loss of ``raw_batch`` under the current parameters,
        forward only."""
        if self._eval_fn is None:
            self._eval_fn = build_eval_step(module=self.module, task=self.task)
        return float(self._eval_fn(self._stage_batch(raw_batch)))
