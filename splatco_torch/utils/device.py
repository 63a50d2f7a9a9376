"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card.  Raises when the card is asked for and there
    is none: an entry point never carries on quietly on the CPU.

    On the card, float32 matmuls and cuDNN convolutions are pinned to full
    float32 (cuDNN defaults to TF32, which keeps ~3 decimal digits), and
    cuDNN to deterministic algorithms (the TPA convolution's backward), so
    a training step repeats bit for bit."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return dev
