"""Token embeddings with named vocabulary ranges (counterpart of
``d9d_tpu/nn/embedding.py``)."""

import torch
import torch.nn.functional as F
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.nn.vocab_ranges import VocabRanges, vocab_size


class TokenEmbedding(nn.Module):
    """Embedding over named vocab ranges.

    The ranges are held concatenated as one ``weight [vocab, hidden]`` table
    (see ``nn/vocab_ranges.py``); lookup is one gather, output in ``dtype``.
    Initialized ``normal(stddev=1)`` from ``generator`` directly on the
    device.
    """

    def __init__(
        self,
        vocab_ranges: VocabRanges,
        hidden_size: int,
        *,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.vocab_ranges = tuple(vocab_ranges)
        self.hidden_size = hidden_size
        self.dtype = dtype
        dev = resolve_device(device)
        weight = torch.empty(
            (self.vocab_size, hidden_size), dtype=param_dtype or dtype,
            device=dev,
        )
        weight.normal_(0.0, 1.0, generator=generator)
        self.weight = nn.Parameter(weight)

    @property
    def vocab_size(self) -> int:
        return vocab_size(self.vocab_ranges)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(token_ids, self.weight).to(self.dtype)
