"""Language-modelling head: raw logits for inference (counterpart of
``LanguageModellingHead.logits`` in ``d9d_tpu/nn/heads.py``; the fused
cross-entropy ``__call__`` belongs to the training path and is not ported
yet)."""

import torch
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.nn.vocab_ranges import VocabRanges, vocab_size

# rows of the table widened to fp32 at a time when it is stored narrower
_LOGITS_VOCAB_CHUNK = 16_384


class LanguageModellingHead(nn.Module):
    """LM head over named vocab ranges, held concatenated as one ``weight
    [vocab, hidden]`` table (see ``nn/vocab_ranges.py``)."""

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
        weight = torch.empty(
            (vocab_size(self.vocab_ranges), hidden_size),
            dtype=param_dtype or dtype, device=resolve_device(device),
        )
        weight.normal_(0.0, hidden_size**-0.5, generator=generator)
        self.weight = nn.Parameter(weight, requires_grad=False)

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
