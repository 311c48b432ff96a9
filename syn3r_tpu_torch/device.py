"""Device resolution for the port's entry points.

Entry points take ``device=`` and default to the card. Without a card they
raise: nothing moves to the CPU unless the caller asks for ``"cpu"`` (the
CPU parity tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a torch.device, raising when it names a card
    that is not there.

    Also sets both TF32 switches off: float32 matrix products and cuDNN
    convolutions (the float32 VAE encode) then run in full float32, as the
    JAX package's float32 reference does. bf16 work is unaffected.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but torch sees no CUDA device; "
                "pass device='cpu' to run the plain torch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
