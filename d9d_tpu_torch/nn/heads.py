"""Language-modelling head (counterpart of ``LanguageModellingHead`` in
``d9d_tpu/nn/heads.py``): the fused linear + cross-entropy ``forward`` that
training calls, and raw ``logits`` for inference."""

import torch
from torch import nn

from d9d_tpu_torch.core.device import resolve_device
from d9d_tpu_torch.nn.init import lecun_normal_draw_
from d9d_tpu_torch.nn.logical_axes import VOCAB, VOCAB_FEATURES
from d9d_tpu_torch.nn.vocab_ranges import VocabRanges, vocab_size
from d9d_tpu_torch.ops.linear_ce import linear_cross_entropy
from d9d_tpu_torch.core.collectives import reduce_from_group
from d9d_tpu_torch.parallel.shards import vocab_slice, write_whole_

# rows of the table widened to fp32 at a time when it is stored narrower
_LOGITS_VOCAB_CHUNK = 16_384


class LanguageModellingHead(nn.Module):
    """LM head over named vocab ranges, held concatenated as one ``weight
    [vocab, hidden]`` table (see ``nn/vocab_ranges.py``).

    Each range's rows are drawn as the JAX package draws its ``head_<range>``
    table ``[size, hidden]``: lecun-normal with fan_in = that table's first
    axis, i.e. the range's size (flax's ``in_axis=-2``), not ``hidden``.

    Under tensor parallelism the table is cut on its vocab dim: the loss is
    the vocab-parallel cross-entropy over the rank's rows
    (``ops/linear_ce.py``) and ``logits`` gathers the ranks' logits (a sum
    of zero-padded slices: exact, and through the same all-reduce).
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
        self.weight = nn.Parameter(torch.empty(
            (vocab_size(self.vocab_ranges), hidden_size),
            dtype=param_dtype or dtype, device=resolve_device(device),
        ))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        w = self.weight
        draw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        lo = 0
        for _name, size in self.vocab_ranges:
            lecun_normal_draw_(draw[lo:lo + size], size, generator)
            lo += size
        write_whole_(w, draw)

    def logical_axes(self) -> dict:
        return {"weight": (VOCAB, VOCAB_FEATURES)}

    def forward(self, hidden: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """``hidden [B, T, D]``, ``labels [B, T]`` → per-token loss ``[B, T]``
        (fp32, 0 where the label is -100), never holding the ``[B*T, V]``
        logits at once. The CE matmul policy follows the compute dtype, as
        in the JAX head: bf16 models multiply bf16 operands into fp32
        logits, fp32 models stay exact."""
        b, t, d = hidden.shape
        rows, lo, group = vocab_slice(self.weight)
        loss = linear_cross_entropy(
            hidden.reshape(b * t, d).to(self.dtype),
            rows,
            labels.reshape(b * t),
            chunk_size=self.ce_chunk_size,
            vocab_start=lo,
            group=group,
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
        rows, start, group = vocab_slice(self.weight)
        if rows.dtype == torch.float32:
            out = h @ rows.T
        else:
            out = torch.empty((*h.shape[:-1], rows.shape[0]),
                              dtype=torch.float32, device=h.device)
            for lo in range(0, rows.shape[0], _LOGITS_VOCAB_CHUNK):
                hi = min(lo + _LOGITS_VOCAB_CHUNK, rows.shape[0])
                out[..., lo:hi] = h @ rows[lo:hi].float().T
        if group is not None:  # the ranks' vocab slices, gathered
            whole = out.new_zeros((*out.shape[:-1], self.weight.shape[0]))
            whole[..., start:start + out.shape[-1]] = out
            out = reduce_from_group(whole, group)
        return out
