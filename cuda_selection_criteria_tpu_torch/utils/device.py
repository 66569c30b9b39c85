"""The device the port runs on unless a caller names another, and the
conversions of 64-bit sketch values between numpy and torch."""

import numpy as np
import torch


def resolve(device):
    """`device` as a torch.device; None means CUDA. There is no silent CPU
    fallback: on a machine without a card the first tensor placed there
    raises. CPU runs (the tests) pass device="cpu" explicitly."""
    return torch.device("cuda") if device is None else torch.device(device)


def as_tensor(x, dtype, device=None):
    """x (numpy array, scalar or tensor) as a `dtype` tensor on
    resolve(device). torch has no unsigned 64-bit arithmetic, so numpy
    uint64 values enter as int64 with the same bit pattern."""
    dev = resolve(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    arr = np.ascontiguousarray(x)
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    if not arr.flags.writeable:  # torch.from_numpy warns on read-only
        arr = arr.copy()
    return torch.from_numpy(arr).to(device=dev, dtype=dtype)


def u64_numpy(t):
    """An int64 tensor of 64-bit values back on the host as numpy uint64
    with the same bits."""
    return t.cpu().numpy().view(np.uint64)
