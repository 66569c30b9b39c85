"""The device the port runs on unless a caller names another."""

import torch


def resolve(device):
    """`device` as a torch.device; None means CUDA. There is no silent CPU
    fallback: on a machine without a card the first tensor placed there
    raises. CPU runs (the tests) pass device="cpu" explicitly."""
    return torch.device("cuda") if device is None else torch.device(device)
