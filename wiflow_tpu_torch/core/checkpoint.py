"""Load the best-model artifact the JAX trainer writes.

Counterpart of ``wiflow_tpu/core/checkpoint.py::load_best_model``.  The
trainer saves ``best_pose_model.pth`` as a raw torch ``state_dict`` under
the reference names (``wiflow_tpu/core/checkpoint.py:71-78``), which is
the port's own parameter layout.  ``best_pose_model.msgpack`` needs flax
to decode and is not read here yet.
"""

from __future__ import annotations

from typing import Dict

import torch


def load_best_model(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``.pth`` best-model checkpoint as a CPU ``state_dict``.

    Pass the result to ``models/fast.py::pack_fast`` or to
    ``models/torch_compat.py::load_state_dict``.
    """
    if not path.endswith(".pth"):
        raise ValueError(
            f"{path}: the port loads .pth checkpoints only; the .msgpack "
            f"format needs flax, which wiflow_tpu_torch does not use — load "
            f"the .pth the JAX trainer writes beside it")
    return torch.load(path, map_location="cpu", weights_only=True)
