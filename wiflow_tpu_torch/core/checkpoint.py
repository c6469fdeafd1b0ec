"""Checkpoint files: the best weights and the resume bundle.

Counterpart of ``wiflow_tpu/core/checkpoint.py``, with the same file names:

  * ``save_best_model`` writes ``best_pose_model.pth``, a CPU
    ``state_dict`` under the reference torch names (what the reference's
    tools ``torch.load``), and, given the model's config or a baseline's
    flax tree, ``best_pose_model.msgpack`` in flax's layout, which the JAX
    package's ``load_best_model`` reads.  A model with no reference torch
    names (a baseline, the conv2d ablation) gets the ``.msgpack`` only.
    ``load_best_model`` reads either file back as a ``state_dict``.  The
    ``.msgpack`` goes through ``core/flax_msgpack.py``, so neither flax
    nor the ``msgpack`` package
    is needed.
  * ``save_checkpoint`` / ``load_checkpoint``: the resume bundle
    ``latest_checkpoint.pkl``, the port's own pickle of CPU tensors, numpy
    arrays and Python values (the JAX package does not read it).  The
    write is atomic: a ``.tmp`` file, then ``os.replace``, so a crash
    leaves the previous bundle whole.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import torch

from wiflow_tpu_torch.core import flax_msgpack
from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.models.torch_compat import (
    jax_variables_from_state_dict, state_dict_from_jax,
)


def to_cpu(tree: Any) -> Any:
    """``tree`` (dicts, lists, tuples) with every tensor detached and
    copied to the CPU; other leaves as they are."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Pickle ``payload`` (tensors moved to the CPU) to ``path``
    atomically."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(to_cpu(payload), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """The bundle at ``path``, or None where there is none.  Unpickling
    runs code: read only bundles this program wrote."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def save_best_model(output_dir: str, state_dict: Dict[str, torch.Tensor],
                    model_cfg=None, stem: str = "best_pose_model", *,
                    tree: Optional[Dict[str, Any]] = None) -> None:
    """Write the best weights.

    ``{stem}.msgpack`` in flax's layout where one is known: ``tree`` (the
    ``{'params', 'batch_stats'}`` tree of a baseline, from
    ``models/baselines/convert.py``) or the WiFlow model that ``model_cfg``
    (``ModelConfig`` or ``MMFiModelConfig``) configures.  ``{stem}.pth``,
    the ``state_dict``, where its names are the reference's: a WiFlow model
    with ``encoder_kind == "wiflow"``, or a module with no flax layout
    given.  So a baseline and the conv2d ablation get the ``.msgpack``
    only, as in the JAX package (``wiflow_tpu/train/loop.py:320-325``)."""
    os.makedirs(output_dir, exist_ok=True)
    sd = to_cpu(dict(state_dict))
    if tree is None and model_cfg is not None:
        tree = jax_variables_from_state_dict(sd, model_cfg)
    if tree is not None:
        with open(os.path.join(output_dir, f"{stem}.msgpack"), "wb") as f:
            f.write(flax_msgpack.dumps(_sorted(tree)))
    reference_names = (getattr(model_cfg, "encoder_kind", "wiflow") == "wiflow"
                       if model_cfg is not None else tree is None)
    if reference_names:
        torch.save(sd, os.path.join(output_dir, f"{stem}.pth"))


def _sorted(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Keys in sorted order at every level, as the JAX package's tree maps
    leave them before it serializes."""
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def load_best_model(path: str, cfg=ModelConfig()
                    ) -> Dict[str, torch.Tensor]:
    """A best-model file as a CPU ``state_dict`` under the reference names:
    a ``.pth`` as it is, a ``.msgpack`` (flax's layout, of the model ``cfg``
    configures) through ``models/torch_compat.py::state_dict_from_jax``.
    Pass the result to ``models/fast.py::pack_fast`` or to
    ``models/torch_compat.py::load_state_dict``."""
    if path.endswith(".pth"):
        return torch.load(path, map_location="cpu", weights_only=True)
    if not path.endswith(".msgpack"):
        raise ValueError(f"{path}: a best model is a .pth or a .msgpack")
    with open(path, "rb") as f:
        tree = flax_msgpack.loads(f.read())
    return state_dict_from_jax(tree, cfg)
