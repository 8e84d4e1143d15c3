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
context's device) → optimizer → step → checkpointer. ``train()`` builds the
data loader (kept as ``self.data_loader``) and the tracker run, resumes
from the newest intact checkpoint (before the run's hparams are tracked,
so the restored run hash re-points the tracker first), and runs a host
loop around the step; staging a batch and the metric readback on the
``log_every`` cadence are its only per-step host work, and metrics stay on
the device between log steps. With ``prefetch_batches > 0`` a producer
thread fetches, prepares and cuts the next batches on the host while the
card steps (``loop/components/prefetch.py``), and checkpoints record the
loader's position as of the last batch consumed. Checkpoints
(``loop/components/checkpointer.py``, torch DCP) hold the module's
``state_dict()`` and the optimizer's ``checkpoint_state()`` (each moment
laid out as its parameter), with the step, the loader position and the
tracker run hash as JSON meta; they are saved on the
``checkpoint_every_steps`` cadence and after the last step, which
``train()`` waits for. On a mesh rank 0 alone writes the tracker run; the
other ranks carry its hash. :meth:`Trainer.export` writes the trained
model as sharded safetensors (the example's last step), and
:meth:`Trainer.close` releases the checkpointer. Of the JAX trainer's loop
components the port has the stepper, the metric collector, the manual GC,
the data loader and prefetch, the checkpointer and the trackers;
profiling, the watchdog, the anomaly guard, preemption and telemetry
sinks are not ported yet (their config fields raise).
"""

import logging
import time
import warnings
from collections.abc import Callable

import numpy as np
import torch

from d9d_tpu_torch.core.collectives import broadcast, host_broadcast_object
from d9d_tpu_torch.core.mesh import MeshContext
from d9d_tpu_torch.loop.components.batch_maths import BatchMaths
from d9d_tpu_torch.loop.components.batch_staging import (
    check_cp_seq_len,
    host_microbatches,
    to_device,
)
from d9d_tpu_torch.loop.components.checkpointer import StateCheckpointer
from d9d_tpu_torch.loop.components.garbage_collector import (
    ManualGarbageCollector,
)
from d9d_tpu_torch.loop.components.metric_collector import MetricCollector
from d9d_tpu_torch.loop.components.prefetch import BatchPrefetcher
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
from d9d_tpu_torch.resilience.manifest import job_mesh_spec
from d9d_tpu_torch.tracker import MirrorTrackerRun, NullTracker, Tracker

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
        self.data_loader = None  # built fresh per train() call
        self._prefetcher: BatchPrefetcher | None = None
        self.gc = ManualGarbageCollector(config.gc_every_steps)
        self.metric_collector = MetricCollector(self.task)
        self.run = None
        self._eval_fn = None
        self._tokens_per_step = config.global_batch_size * config.seq_len
        self.checkpointer = (
            StateCheckpointer(
                config.checkpoint_dir,
                save_every_steps=config.checkpoint_every_steps,
                num_to_keep=config.checkpoints_to_keep,
                async_save=config.checkpoint_async,
            )
            if config.checkpoint_dir is not None
            else None
        )

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

    def _host_batch(self, raw_batch: dict) -> list[dict]:
        """prepare → microbatch split → this rank's rows and sequence
        chunk, as host tensors (pinned on a card): no device work and no
        collective, so a prefetch thread may run it."""
        ctx = self.ctx
        return host_microbatches(
            self.task.prepare_batch(raw_batch),
            num_microbatches=self.batch_maths.num_microbatches,
            microbatch_size=self.batch_maths.microbatch_size,
            device=self.device, seq_len=self.config.seq_len,
            cp_size=ctx.cp_size, cp_rank=ctx.cp_rank,
            dp_size=self.batch_maths.dp_size,
            dp_rank=ctx.coordinate(*ctx.batch_axes),
        )

    def _to_device(self, microbatches: list[dict]) -> list[dict]:
        return to_device(microbatches, self.device)

    def _stage_batch(self, raw_batch: dict) -> list[dict]:
        """:meth:`_host_batch`, then onto the device."""
        return self._to_device(self._host_batch(raw_batch))

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

    # -- checkpoints -------------------------------------------------------

    def _optimizer_param_names(self) -> list[str]:
        names = {id(p): n for n, p in self.module.named_parameters()}
        return [names[id(p)] for p in self.optimizer.params]

    def _job_arrays(self) -> dict:
        """The live arrays a checkpoint holds, as DCP saves and loads them
        in place: the module's ``state_dict()`` and the optimizer's
        ``checkpoint_state()``, its moments keyed by parameter name."""
        if not hasattr(self.optimizer, "checkpoint_state"):
            raise TypeError(
                f"{type(self.optimizer).__name__} has no checkpoint_state(): "
                f"a checkpointing trainer needs it (see optim/adamw.py)")
        names = self._optimizer_param_names()
        opt = {k: (dict(zip(names, v)) if isinstance(v, list) else v)
               for k, v in self.optimizer.checkpoint_state().items()}
        return {"model": self.module.state_dict(), "optimizer": opt}

    def _load_optimizer_arrays(self, opt: dict) -> None:
        names = self._optimizer_param_names()
        self.optimizer.load_state_dict(
            {k: ([v[n] for n in names] if isinstance(v, dict) else v)
             for k, v in opt.items()})

    def _job_meta(self) -> dict:
        meta = {"step": self.stepper.step}
        if self.data_loader is not None:
            # under prefetch the loader runs ahead of the trainer; the
            # checkpoint must record the position of the last CONSUMED
            # batch, not the producer's run-ahead position
            if (self._prefetcher is not None
                    and self._prefetcher.consumed_position is not None
                    and hasattr(self.data_loader, "state_dict_at")):
                meta["data_loader"] = self.data_loader.state_dict_at(
                    self._prefetcher.consumed_position)
            elif hasattr(self.data_loader, "state_dict"):
                meta["data_loader"] = self.data_loader.state_dict()
        if self.run is not None:
            meta["tracker"] = self.run.state_dict()
        return meta

    def _save_checkpoint(self, *, last: bool = False) -> None:
        if self.checkpointer is None:
            return
        step = self.stepper.step
        if not self.checkpointer.should_checkpoint(step, last=last):
            return
        if self.checkpointer.last_saved_step != step:
            self.checkpointer.save(step, self._job_arrays(), self._job_meta(),
                                   mesh_spec=job_mesh_spec(self.ctx))
        if last:
            # intermediate saves overlap training; the FINAL one must be on
            # disk when train() returns — the process may exit right after
            self.checkpointer.wait_until_finished()

    def _restore_state(self) -> int | None:
        """Restore the newest intact checkpoint into the live job state
        (arrays, stepper, loader position, tracker run); returns the
        restored step or None."""
        if self.checkpointer is None:
            return None
        restored = self.checkpointer.restore(
            self._job_arrays(), mesh_spec=job_mesh_spec(self.ctx))
        if restored is None:
            return None
        step, arrays, meta = restored
        self._load_optimizer_arrays(arrays["optimizer"])
        self.stepper.load_state_dict({"step": meta["step"]})
        if ("data_loader" in meta and self.data_loader is not None
                and hasattr(self.data_loader, "load_state_dict")):
            self.data_loader.load_state_dict(meta["data_loader"])
        if "tracker" in meta and self.run is not None:
            self.run.load_state_dict(meta["tracker"])
        return step

    def _try_resume(self) -> None:
        if self.checkpointer is None or not self.config.resume:
            return
        step = self._restore_state()
        if step is not None:
            logger.info("resumed from checkpoint at step %d", step)

    def _new_run(self):
        """The tracker run: rank 0's own; on the other ranks one that
        writes nothing and carries rank 0's run state."""
        if self.ctx.world_size == 1:
            return self.tracker.new_run(self.config.run_name)
        run = (self.tracker.new_run(self.config.run_name)
               if self.ctx.is_main_process else None)
        state = host_broadcast_object(run.state_dict() if run else None)
        return run if run is not None else MirrorTrackerRun(state)

    def _spawn_prefetcher(self, data_iter) -> None:
        self._prefetcher = BatchPrefetcher(
            data_iter, self._host_batch, depth=self.config.prefetch_batches,
            position_fn=getattr(self.data_loader, "position", None),
            finish_fn=self._to_device)

    # -- the loop --------------------------------------------------------

    def train(self) -> list[dict]:
        """Run until ``total_steps`` or data exhaustion; returns the metric
        history, one dict per fetched step (``log_every`` cadence and the
        last step)."""
        history: list[dict] = []
        try:
            self.data_loader = self.dataset_provider.build()
            self.run = self._new_run()
            # resume BEFORE hparams: restoring the tracker run hash
            # re-points output at the original run
            self._try_resume()
            self.run.track_hparams(self.config.model_dump())
            t0 = time.perf_counter()
            session_steps = 0  # steps run by THIS call (excludes resume)
            data_iter = iter(self.data_loader)
            use_prefetch = self.config.prefetch_batches > 0
            if (use_prefetch and hasattr(self.data_loader, "state_dict")
                    and not hasattr(self.data_loader, "position")):
                # a stateful loader we cannot snapshot per fetch would get
                # checkpointed at the producer's run-ahead position — keep
                # resume exact by staying on the step path instead
                warnings.warn(
                    "data loader has state_dict() but no position(); "
                    "disabling batch prefetch to keep checkpoint resume "
                    "exact (add position()/state_dict_at() to re-enable)",
                    stacklevel=2)
                use_prefetch = False
            if use_prefetch:
                # after the resume, so it iterates from the restored position
                self._spawn_prefetcher(data_iter)
            with self.gc:
                while not self.stepper.finished:
                    try:
                        if self._prefetcher is not None:
                            batch = next(self._prefetcher)
                        else:
                            batch = self._stage_batch(next(data_iter))
                    except StopIteration:
                        break
                    metrics = self.step_fn(batch)
                    self.metric_collector.collect(metrics)
                    step = self.stepper.advance()
                    session_steps += 1
                    self.gc.step(step)
                    if self._fetches_metrics(step):
                        host = {k: v.detach().cpu().numpy()
                                for k, v in metrics.items()}
                        host = self.task.metrics_postprocess(
                            {k: float(v) if np.ndim(v) == 0 else v
                             for k, v in host.items()})
                        host = {k: float(v) for k, v in host.items()
                                if np.ndim(v) == 0}
                        host.update(self.metric_collector.flush(self.run,
                                                                step))
                        host["step"] = step
                        host["wall_s"] = time.perf_counter() - t0
                        host["tokens_per_s"] = (
                            session_steps * self._tokens_per_step
                            / max(host["wall_s"], 1e-9))
                        history.append(host)
                        for k, v in host.items():
                            if k != "step":
                                self.run.track_scalar(
                                    f"train/{k}", v, step=step,
                                    context={"subset": "train"})
                        logger.info("step %d: %s", step, host)
                    self._save_checkpoint()
                self._save_checkpoint(last=True)
        finally:
            if self._prefetcher is not None:
                self._prefetcher.close()
                self._prefetcher = None
            if self.run is not None:
                self.run.close()
            if self.checkpointer is not None:
                # a step raising must not strand an in-flight async save as
                # an unfinalized tmp dir: the crashed job's restart resumes
                # from it
                self.checkpointer.wait_until_finished()
        return history

    def close(self) -> None:
        """Release held resources (the checkpointer's writer thread),
        after its last save is on disk."""
        if self.checkpointer is not None:
            self.checkpointer.close()

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
