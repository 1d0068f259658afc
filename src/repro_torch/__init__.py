"""PyTorch + CUDA port of the SparAMX serving and training paths (the
``repro`` package is the JAX reference it is held against).

Layout mirrors ``repro``: ``configs``, ``core`` (sparse format, pruning,
conversion, sparse KV), ``kernels`` (hand-written Hopper kernels, each with
its plain PyTorch version), ``models``, ``optim``, ``train``, ``serving``
and ``launch``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; asking for CUDA on a machine without it raises.  There is
no silent CPU path.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA device.  CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on the CUDA device by default and "
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
