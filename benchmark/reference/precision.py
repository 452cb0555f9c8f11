"""The precision a reference computes in."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def computed_in(dtype=None):
    """Within the block, floating tensors the reference makes take ``dtype``
    (None: float32) and no float32 product runs in TF32."""
    old = torch.get_default_dtype()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.set_default_dtype(torch.float32 if dtype is None else dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_default_dtype(old)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
