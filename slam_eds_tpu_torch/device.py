"""Device selection and float32 numerics policy for the port.

The port's entry points (the pipelines, ``SyntheticSequence``,
``empty_state`` and the ``*from_numpy`` converters) default to ``"cuda"``;
helpers take their device from an input tensor or require it. A caller asks
for the CPU by name (``device="cpu"``), as the CPU tests do.
``resolve_device`` refuses a CUDA device when none is present, so nothing
runs on the CPU by omission.
``set_numerics`` pins full-precision float32: the reduced BA system is about
1e8-conditioned, and cuDNN's default TF32 convolutions would shift the
Sobel/pyramid gradients and with them the pixel selection.
"""
from __future__ import annotations

import torch


def set_numerics():
    """Disable TF32 in matmuls and convolutions; float32 matmuls at the
    highest precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
