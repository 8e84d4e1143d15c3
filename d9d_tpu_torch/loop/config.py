"""Trainer configuration (counterpart of ``d9d_tpu/loop/config.py``).

A dataclass with the JAX ``TrainerConfig``'s field names and defaults.
Unknown fields are refused, as the JAX model's ``extra="forbid"`` refuses
them. ``pipeline`` takes a schedule config (``pipelining/factory.py``) or a
dict with its ``type``, kept as the config; ``None`` means GPipe when the
mesh has ``pp > 1``, as in JAX. Features of the JAX trainer that this port
does not have yet raise ``NotImplementedError`` when a field turns them
on: profiling, the hang watchdog, the anomaly guard, telemetry sinks and the
metrics endpoint, the numerics plane, the pipeline timeline, ZeRO sharding,
the split optimizer update and the HBM budget of a resharding restore.
Checkpointing (``checkpoint_dir``, ``loop/components/checkpointer.py``)
and batch prefetch (``prefetch_batches``, JAX's default of 2) are ported.
Two features are ON by default in the JAX config and are not ported:
preemption handling and the telemetry console. Their fields default to OFF
here, and turning them on raises.
"""

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainerConfig:
    global_batch_size: int
    microbatch_size: int
    seq_len: int
    total_steps: int

    pipeline: Any = None
    learning_rate: float = 3e-4
    max_grad_norm: float | None = 1.0
    seed: int = 0
    log_every: int = 10
    run_name: str | None = None

    checkpoint_dir: str | None = None
    checkpoint_every_steps: int | None = None
    checkpoints_to_keep: int | None = 3
    checkpoint_async: bool = True
    resume: bool = True

    profile_dir: str | None = None
    profile_every_steps: int | None = None
    profile_active_steps: int = 3
    profile_wait_steps: int = 10

    init_timeout_s: float | None = None
    step_timeout_s: float | None = None
    watchdog_exit_code: int = 42

    anomaly_policy: str | None = None
    anomaly_rollback_after: int = 3
    anomaly_spike_factor: float | None = 10.0
    anomaly_spike_window: int = 32
    anomaly_max_rollbacks: int = 3

    # not ported yet: OFF here (the JAX default is True)
    handle_preemption: bool = False
    preemption_exit_code: int = 83

    gc_every_steps: int | None = 100

    prefetch_batches: int = 2

    telemetry_dir: str | None = None
    telemetry_every_steps: int | None = None
    # not ported yet: OFF here (the JAX default is True)
    telemetry_console: bool = False
    telemetry_console_interval_s: float = 30.0
    metrics_port: int | None = None

    numerics_every_steps: int | None = None
    numerics_drift: bool = True
    pp_timeline_every_steps: int | None = None

    zero_sharding: bool = False
    reshard_hbm_budget_mb: float | None = None
    split_optimizer_update: bool = False

    introspect_warmup_steps: int = 2
    flops_divergence_tolerance: float = 0.25

    def __post_init__(self) -> None:
        for name in ("global_batch_size", "microbatch_size", "seq_len",
                     "total_steps", "log_every"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.pipeline is not None:
            from d9d_tpu_torch.pipelining.factory import schedule_config

            self.pipeline = schedule_config(self.pipeline)
        unported = {
            "profile_dir": self.profile_dir is not None,
            "init_timeout_s": self.init_timeout_s is not None,
            "step_timeout_s": self.step_timeout_s is not None,
            "anomaly_policy": self.anomaly_policy is not None,
            "handle_preemption": self.handle_preemption,
            "telemetry_dir": self.telemetry_dir is not None,
            "telemetry_console": self.telemetry_console,
            "metrics_port": self.metrics_port is not None,
            "numerics_every_steps": self.numerics_every_steps is not None,
            "pp_timeline_every_steps": self.pp_timeline_every_steps is not None,
            "zero_sharding": self.zero_sharding,
            "split_optimizer_update": self.split_optimizer_update,
            # the budgeted reshard of a restore onto another mesh
            # (resilience/elastic.py redistribute_tree): ROADMAP A5.3
            "reshard_hbm_budget_mb": self.reshard_hbm_budget_mb is not None,
        }
        on = [name for name, enabled in unported.items() if enabled]
        if on:
            raise NotImplementedError(
                f"TrainerConfig: {', '.join(on)} turn on features of the JAX "
                f"trainer that the port does not have yet")

    def model_dump(self) -> dict:
        return dataclasses.asdict(self)
