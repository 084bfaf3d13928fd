"""The device a constructor puts its tensors on.

Every constructor of the port (``default_scene``, ``make_scene``,
``scene_from_numpy``, ``build_pt_scene``, the path-tracer scenes,
``ProgressiveState``) takes ``device=None``, which means the CUDA card. On a
machine without CUDA that raises: the CPU is used only where the caller asks
for it (``device="cpu"``), never as a silent fallback.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a torch.device; None means ``"cuda"``, which must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's constructors default to the card; "
            "pass device='cpu' to build on the CPU")
    return dev


def common(*values, device=None) -> torch.device:
    """The one device of the tensors among ``values`` (numpy arrays and
    numbers have none, and go to it); without a tensor, ``resolve(device)``.
    ValueError for tensors on two devices, or on another device than an
    explicit ``device``."""
    found = {v.device for v in values if isinstance(v, torch.Tensor)}
    if device is not None:
        found.add(resolve(device))
    if len(found) > 1:
        raise ValueError(f"inputs on more than one device: {sorted(map(str, found))}; "
                         "move them to one device first")
    return found.pop() if found else resolve(device)

