"""Device resolution shared by every entry point of the port."""

import torch


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """``None`` means the card: ``torch.device("cuda")``, raising when no
    CUDA device is present. Anything else is taken as given — callers that
    want the CPU say so explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: d9d_tpu_torch entry points run "
                "on the GPU by default; pass device='cpu' explicitly to run "
                "the plain PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)
