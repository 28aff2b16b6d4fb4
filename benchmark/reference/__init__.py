"""The plain reference: PyTorch and numpy, float32 without TF32, nothing
of the program imported."""

import contextlib

import torch


@contextlib.contextmanager
def float32():
    """float32 products without TF32 while the reference runs, whatever a
    control switched on before."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
