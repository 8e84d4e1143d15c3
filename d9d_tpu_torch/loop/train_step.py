"""The training step: microbatch loop, weighted-loss grad accumulation,
global-norm clipping, optimizer update (counterpart of
``d9d_tpu/loop/train_step.py`` ``build_train_step``).

The contract is the JAX step's:

- gradients of each microbatch's ``loss_sum`` accumulate in fp32, in the
  parameters' ``.grad`` (parameters are held in fp32; another dtype
  raises);
- sum-then-scale: the summed gradients are multiplied by
  ``1 / max(Σ weight, 1e-8)`` — not a mean of microbatch means;
- the clip factor is ``min(1, max_norm / max(norm, 1e-12))`` over the
  global L2 norm of all gradients (NOT ``torch.nn.utils.clip_grad_norm_``,
  which divides by ``norm + 1e-6``);
- the update; the metrics ``loss``, ``grad_norm``, ``loss_weight`` and
  ``task/<k>`` (task statistics summed over microbatches), as device
  scalars — nothing is read back here.

The anomaly guard, ZeRO sharding, the split update and the numerics plane
are not ported: asking for them raises ``NotImplementedError``.
"""

from collections.abc import Callable

import torch
from torch import nn

from d9d_tpu_torch.loop.control.task import TrainTask


def global_grad_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ g²)`` in fp32 (optax ``global_norm``)."""
    return torch.stack([g.float().pow(2).sum() for g in grads]).sum().sqrt()


def build_train_step(
    *,
    module: nn.Module,
    task: TrainTask,
    optimizer,
    num_microbatches: int,
    max_grad_norm: float | None = 1.0,
    grad_dtype: torch.dtype | None = torch.float32,
    anomaly_policy: str | None = None,
    zero=None,
    split_update: bool = False,
    numerics: bool = False,
) -> Callable[[list[dict]], dict[str, torch.Tensor]]:
    """Build the step over ``module``'s trainable parameters:
    ``step(microbatches) -> metrics``, taking the ``num_microbatches``
    staged microbatches of one optimizer step."""
    unported = {"anomaly_policy": anomaly_policy is not None,
                "zero": zero is not None, "split_update": split_update,
                "numerics": numerics}
    on = [k for k, v in unported.items() if v]
    if on:
        raise NotImplementedError(
            f"build_train_step: {', '.join(on)} not ported yet")
    params = [p for p in module.parameters() if p.requires_grad]
    odd = {p.dtype for p in params} - {grad_dtype or p.dtype for p in params}
    if odd:
        # autograd accumulates in the parameter's dtype; a separate fp32
        # accumulator for narrower parameters is not ported
        raise NotImplementedError(
            f"parameters held in {sorted(map(str, odd))} with grad_dtype "
            f"{grad_dtype}: hold them in the accumulation dtype (float32, "
            f"the JAX package's param_dtype)")

    def step(microbatches: list[dict]) -> dict[str, torch.Tensor]:
        if len(microbatches) != num_microbatches:
            raise ValueError(f"expected {num_microbatches} microbatches, got "
                             f"{len(microbatches)}")
        for p in params:
            p.grad = None
        loss_sum = weight_sum = None
        metrics_sum: dict[str, torch.Tensor] = {}
        for mb in microbatches:
            # each backward adds this microbatch's gradients into .grad
            loss, weight, metrics = task.loss_fn(module, mb)
            loss.backward()
            loss, weight = loss.detach().float(), weight.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            weight_sum = weight if weight_sum is None else weight_sum + weight
            for k, v in metrics.items():
                v = v.detach()
                metrics_sum[k] = v if k not in metrics_sum else metrics_sum[k] + v

        with torch.no_grad():
            for p in params:
                if p.grad is None:  # unused by the loss: a zero gradient
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            # sum-then-scale by the global weight
            inv_w = 1.0 / torch.clamp(weight_sum, min=1e-8)
            torch._foreach_mul_(grads, inv_w)
            loss = loss_sum * inv_w
            grad_norm = global_grad_norm(grads)
            if max_grad_norm is not None:
                clip = torch.clamp(
                    max_grad_norm / torch.clamp(grad_norm, min=1e-12), max=1.0)
                torch._foreach_mul_(grads, clip)
        optimizer.step()
        out = {"loss": loss, "grad_norm": grad_norm, "loss_weight": weight_sum}
        out.update({f"task/{k}": v for k, v in metrics_sum.items()})
        return out

    return step


def build_eval_step(*, module: nn.Module, task: TrainTask):
    """Forward-only: ``Σ loss_sum / max(Σ weight, 1e-8)`` over the
    microbatches, as a device scalar."""

    @torch.no_grad()
    def step(microbatches: list[dict]) -> torch.Tensor:
        loss_sum = weight_sum = 0.0
        for mb in microbatches:
            loss, weight, _ = task.loss_fn(module, mb)
            loss_sum = loss_sum + loss.float()
            weight_sum = weight_sum + weight.float()
        return loss_sum / torch.clamp(torch.as_tensor(weight_sum), min=1e-8)

    return step
