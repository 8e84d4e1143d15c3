"""Token embeddings with named vocabulary ranges (counterpart of
``d9d_tpu/nn/embedding.py``), vocab-parallel under tensor parallelism."""

import torch
import torch.nn.functional as F
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.nn.logical_axes import VOCAB, VOCAB_FEATURES
from d9d_tpu_torch.nn.vocab_ranges import VocabRanges, vocab_size
from d9d_tpu_torch.core.collectives import reduce_from_group
from d9d_tpu_torch.parallel.shards import vocab_slice, write_whole_


class TokenEmbedding(nn.Module):
    """Embedding over named vocab ranges.

    The ranges are held concatenated as one ``weight [vocab, hidden]`` table
    (see ``nn/vocab_ranges.py``); lookup is one gather, output in ``dtype``.
    Initialized ``normal(stddev=1)`` from ``generator`` directly on the
    device.

    Under tensor parallelism the table is cut on its vocab dim
    (``parallel/plan.py``): each rank looks up the tokens that fall in its
    rows, writes zeros for the others, and the rows are summed over the tp
    group (``core/collectives.py``), so every rank holds the whole embedding.
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
        self.weight = nn.Parameter(torch.empty(
            (self.vocab_size, hidden_size), dtype=param_dtype or dtype,
            device=resolve_device(device),
        ))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        w = self.weight
        draw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
        write_whole_(w, draw.normal_(0.0, 1.0, generator=generator))

    def logical_axes(self) -> dict:
        return {"weight": (VOCAB, VOCAB_FEATURES)}

    @property
    def vocab_size(self) -> int:
        return vocab_size(self.vocab_ranges)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        rows, lo, group = vocab_slice(self.weight)
        if group is None:
            return F.embedding(token_ids, rows).to(self.dtype)
        local = token_ids - lo
        inside = (local >= 0) & (local < rows.shape[0])
        out = F.embedding(torch.where(inside, local, 0), rows)
        out = torch.where(inside[..., None], out, 0.0)
        return reduce_from_group(out, group).to(self.dtype)
