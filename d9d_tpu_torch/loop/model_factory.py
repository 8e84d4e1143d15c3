"""Sharded model initialization (counterpart of
``d9d_tpu/loop/model_factory.py`` ``init_sharded_params``).

The JAX package infers shapes abstractly, maps the plan's rules to
shardings and runs a jitted init that materializes every parameter into
its shard. The port does the same with PyTorch's meta device:

1. the provider builds the module on the meta device (shapes only, nothing
   drawn, no memory);
2. the plan is applied (``parallel/plan.py``: tensor parallelism and
   ``fully_shard`` turn each parameter they cut into a meta ``DTensor``);
3. ``to_empty`` gives every rank's pieces (and the whole replicated
   parameters) storage on the context's device;
4. every module's ``reset_parameters(generator)`` runs in module order,
   from one generator seeded with the model's ``seed``: each initializer
   draws its parameter's whole value and writes this rank's piece
   (``nn/init.py``).

Step 4 consumes the generator's stream as the one-process constructor
does, so the gathered parameters equal the one-process build's bit for
bit, and no rank holds more than one parameter whole at a time. A plan
that cuts nothing (the replicate plan, or a mesh whose axes it maps are
all 1) builds the module on the device directly, as before. Either way the
MoE layers built with ``ep_axes`` then get their groups on the mesh
(``nn/moe.py`` ``bind_expert_parallel``).
"""

import dataclasses

import torch
from torch import nn

from d9d_tpu_torch.core.mesh import MeshContext
from d9d_tpu_torch.nn.moe import bind_expert_parallel
from d9d_tpu_torch.parallel.plan import ParallelPlan, apply_plan, plan_shards


def materialize_(module: nn.Module, device: torch.device,
                 seed: "int | None") -> None:
    """Steps 3 and 4 above. A module that owns parameters or buffers must
    define ``reset_parameters(generator)``."""
    module.to_empty(device=device)
    gen = None if seed is None else torch.Generator(
        device=device).manual_seed(seed)
    with torch.no_grad():
        for name, m in module.named_modules():
            owns = (next(m.parameters(recurse=False), None) is not None
                    or next(m.buffers(recurse=False), None) is not None)
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
            elif owns:
                raise TypeError(
                    f"module {name or '<root>'} ({type(m).__name__}) owns "
                    f"state but has no reset_parameters(generator)")


def build_model(provider, ctx: MeshContext, plan: ParallelPlan,
                validate=None) -> nn.Module:
    """The provider's module on ``ctx``, sharded as ``plan`` says.
    ``validate(module)``, when given, sees the module as the provider built
    it (on the meta device when the plan shards) and may raise."""
    if not plan_shards(ctx, plan):
        module = provider.build_module(ctx)
        if validate is not None:
            validate(module)
    else:
        module = provider.build_module(
            dataclasses.replace(ctx, device=torch.device("meta")))
        if validate is not None:
            validate(module)
        apply_plan(module, ctx, plan)
        materialize_(module, ctx.device, getattr(module, "seed", None))
    bind_expert_parallel(module, ctx)
    return module


__all__ = ["build_model", "materialize_"]
