"""Language-modelling head (counterpart of ``LanguageModellingHead`` in
``d9d_tpu/nn/heads.py``): the fused linear + cross-entropy ``forward`` that
training calls, and raw ``logits`` for inference."""

import torch
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.nn.init import lecun_normal_
from d9d_tpu_torch.nn.vocab_ranges import VocabRanges, vocab_size
from d9d_tpu_torch.ops.linear_ce import linear_cross_entropy

# rows of the table widened to fp32 at a time when it is stored narrower
_LOGITS_VOCAB_CHUNK = 16_384


class LanguageModellingHead(nn.Module):
    """LM head over named vocab ranges, held concatenated as one ``weight
    [vocab, hidden]`` table (see ``nn/vocab_ranges.py``).

    Each range's rows are drawn as the JAX package draws its ``head_<range>``
    table ``[size, hidden]``: lecun-normal with fan_in = that table's first
    axis, i.e. the range's size (flax's ``in_axis=-2``), not ``hidden``.
    """

    def __init__(
        self,
        vocab_ranges: VocabRanges,
        hidden_size: int,
        *,
        ce_chunk_size: "int | str" = "auto",
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device: "torch.device | str | None" = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.vocab_ranges = tuple(vocab_ranges)
        self.hidden_size = hidden_size
        self.ce_chunk_size = ce_chunk_size
        self.dtype = dtype
        weight = torch.empty(
            (vocab_size(self.vocab_ranges), hidden_size),
            dtype=param_dtype or dtype, device=resolve_device(device),
        )
        lo = 0
        for _name, size in self.vocab_ranges:
            lecun_normal_(weight[lo:lo + size], size, generator)
            lo += size
        self.weight = nn.Parameter(weight)

    def forward(self, hidden: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """``hidden [B, T, D]``, ``labels [B, T]`` → per-token loss ``[B, T]``
        (fp32, 0 where the label is -100), never holding the ``[B*T, V]``
        logits at once. The CE matmul policy follows the compute dtype, as
        in the JAX head: bf16 models multiply bf16 operands into fp32
        logits, fp32 models stay exact."""
        b, t, d = hidden.shape
        loss = linear_cross_entropy(
            hidden.reshape(b * t, d).to(self.dtype),
            self.weight,
            labels.reshape(b * t),
            chunk_size=self.ce_chunk_size,
        )
        return loss.reshape(b, t)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """``hidden [..., hidden]`` → float32 logits ``[..., vocab]``.

        The rule is the JAX head's: logits are an fp32 product of the hidden
        state and the table, both widened to fp32. A table stored in fp32 is
        multiplied directly. A narrower table (bf16 at full width) is NOT
        widened whole — that would be a multi-gigabyte temporary every
        decode step — but ``_LOGITS_VOCAB_CHUNK`` rows at a time; widening
        is exact, so the result is the same fp32 product.
        """
        h = hidden.float()
        w = self.weight
        if w.dtype == torch.float32:
            return h @ w.T
        out = torch.empty(
            (*h.shape[:-1], w.shape[0]), dtype=torch.float32, device=h.device
        )
        for lo in range(0, w.shape[0], _LOGITS_VOCAB_CHUNK):
            hi = min(lo + _LOGITS_VOCAB_CHUNK, w.shape[0])
            out[..., lo:hi] = h @ w[lo:hi].float().T
        return out
