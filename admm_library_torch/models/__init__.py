"""Problem builders of the BASELINE configurations and their dispersions.

Every builder puts its tensors on the CUDA card unless the caller names
another device (`device="cpu"`, as the tests do); with no card, the
first tensor it makes raises.
"""
import torch


def model_device(device=None) -> torch.device:
    """The device a builder builds on: `device`, or the CUDA card."""
    return torch.device("cuda" if device is None else device)
