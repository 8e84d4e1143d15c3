from d9d_tpu_torch.parallel.plan import (
    ParallelPlan,
    apply_plan,
    fsdp_ep_plan,
    fsdp_plan,
    hsdp_plan,
    replicate_plan,
    tp_plan,
)

__all__ = ["ParallelPlan", "apply_plan", "fsdp_ep_plan", "fsdp_plan",
           "hsdp_plan", "replicate_plan", "tp_plan"]
