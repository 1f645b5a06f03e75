"""Device resolution for the port's entry points."""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the card: returns the current CUDA device with its
    index (`cuda:0`, as tensors report their device), or raises when no
    CUDA device is present.  The CPU is used only when the caller asks for
    it (`device="cpu"`), never as a silent fallback.

    Resolving a CUDA device also pins full-fp32 matmuls (no TF32): the
    port's fp32 logits projection and the plain reference versions assume
    fp32 accumulation, as the JAX package's `preferred_element_type`
    einsums do."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:  # as tensors report it: cuda -> cuda:0
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
