"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. Without a
card it raises: the port never carries on silently on the CPU. Tests pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Return the torch device to run on (``None`` → ``"cuda"``).

    Float32 matrix products are pinned to full float32 precision ("highest",
    no TF32) for matmuls and cuDNN alike, so that the exact decode path keeps
    the precision the tests hold it to.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU explicitly")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev
