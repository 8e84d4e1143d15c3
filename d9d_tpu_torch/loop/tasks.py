"""Built-in task implementations (counterpart of ``d9d_tpu/loop/tasks.py``):
``CausalLMTask``."""

import numpy as np
import torch
from torch import nn

from d9d_tpu_torch.loop.control.task import TrainTask
from d9d_tpu_torch.ops.linear_ce import LM_IGNORE_INDEX


class CausalLMTask(TrainTask):
    """Next-token prediction with token-count loss weighting.

    Batches hold ``input_ids [B, T+1]`` (and optionally ``loss_mask
    [B, T+1]``); the task shifts them itself. Labels whose ``loss_mask`` is
    0 become -100 and weigh nothing. The model maps ``(tokens, positions,
    labels)`` to a per-token loss ``[B, T]``.
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
        per_token = module(mb["tokens"], mb["positions"], mb["labels"])
        weight = (mb["labels"] != LM_IGNORE_INDEX).sum().to(torch.float32)
        return per_token.sum(), weight, {"tokens": weight}
