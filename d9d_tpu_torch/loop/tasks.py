"""Built-in task implementations (counterpart of ``d9d_tpu/loop/tasks.py``):
``CausalLMTask``, with the pipeline surface of ``PipelineTrainTask``."""

import numpy as np
import torch
from torch import nn

from d9d_tpu_torch.loop.control.task import PipelineTrainTask
from d9d_tpu_torch.nn.moe import collect_tokens_per_expert
from d9d_tpu_torch.ops.linear_ce import LM_IGNORE_INDEX


class CausalLMTask(PipelineTrainTask):
    """Next-token prediction with token-count loss weighting.

    Batches hold ``input_ids [B, T+1]`` (and optionally ``loss_mask
    [B, T+1]``); the task shifts them itself. Labels whose ``loss_mask`` is
    0 become -100 and weigh nothing. The model maps ``(tokens, positions,
    labels)`` to a per-token loss ``[B, T]``.

    For a model with MoE layers the statistics also hold
    ``moe_tokens_per_expert``: the per-expert routed-pair counts of the
    forward, summed over layers, fp32 ``[E]`` (the engine sums them over
    microbatches); :meth:`metrics_postprocess` turns the step's vector into
    ``task/moe_load_max_frac``, the heaviest expert's share of the routed
    pairs (1/E is perfectly balanced). A dense model has no such metric.
    """

    def prepare_batch(self, batch: dict) -> dict:
        input_ids = np.asarray(batch["input_ids"])
        tokens = input_ids[:, :-1]
        labels = input_ids[:, 1:].copy()
        if "loss_mask" in batch:
            labels = np.where(np.asarray(batch["loss_mask"])[:, 1:] != 0,
                              labels, LM_IGNORE_INDEX)
        b, t = tokens.shape
        positions = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
        return {"tokens": tokens.astype(np.int64),
                "labels": labels.astype(np.int64),
                "positions": positions}

    def loss_fn(self, module: nn.Module, mb: dict[str, torch.Tensor]):
        # the window covers this forward only: a remat recomputation in the
        # backward is not counted again
        with collect_tokens_per_expert(module) as counts:
            per_token = module(mb["tokens"], mb["positions"], mb["labels"])
        weight = (mb["labels"] != LM_IGNORE_INDEX).sum().to(torch.float32)
        metrics = {"tokens": weight}
        if counts:
            metrics["moe_tokens_per_expert"] = torch.stack(counts).sum(
                dim=0).to(torch.float32)
        return per_token.sum(), weight, metrics

    def metrics_postprocess(self, metrics):
        counts = metrics.pop("task/moe_tokens_per_expert", None)
        if counts is not None:
            counts = np.asarray(counts, np.float64)
            metrics["task/moe_load_max_frac"] = float(
                counts.max() / max(counts.sum(), 1.0))
        return metrics

    # -- pipeline surface (PipelineTrainTask) --------------------------
    # carry = token ids on stage 0, hidden states after; positions ride
    # kwargs (every stage's RoPE needs them); labels ride last-stage state.
    # As in JAX, the pipeline's statistics are the last stage's: no MoE
    # load vector.

    def sample_microbatch(self, microbatch_size: int, seq_len: int) -> dict:
        z = torch.zeros((microbatch_size, seq_len), dtype=torch.int64)
        return {"tokens": z, "labels": z,
                "positions": z.to(torch.int32)}

    def split_microbatch(self, mb: dict):
        return (mb["tokens"], {"positions": mb["positions"]},
                {"labels": mb["labels"]})

    def stage_forward(self, module: nn.Module, carry, kwargs):
        return module(carry, kwargs["positions"])

    def last_stage_loss(self, module: nn.Module, carry, kwargs, state):
        per_token = module(carry, kwargs["positions"], state["labels"])
        weight = (state["labels"] != LM_IGNORE_INDEX).sum().to(torch.float32)
        return per_token.sum(), weight, {"tokens": weight}
