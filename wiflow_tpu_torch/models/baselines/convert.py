"""Carry a baseline's weights between the JAX package's flax variables and
the port module's ``state_dict``.

The baseline modules of the port (``models/baselines/``) name every
parameter as its flax path does, joined by dots: flax
``skunit1/sk/conv0_weight`` is ``skunit1.sk.conv0_weight``.  So one set of
rules covers all five files, by leaf:

  4-D conv kernel      HWIO ``[kH, kW, I, O]`` -> OIHW ``[O, I, kH, kW]``
  ``nn.Dense`` kernel  ``[in, out]`` -> ``nn.Linear`` ``weight [out, in]``
  ``nn.LayerNorm``     ``scale`` -> ``weight``; ``bias`` as it is
  ``TorchBatchNorm``   ``weight``/``bias`` (params) and ``running_mean``/
                       ``running_var`` (batch_stats) as they are
  anything else        as it is (a matrix used as ``x @ w`` keeps
                       ``[in, out]``; biases; position embeddings)

``num_batches_tracked`` has no flax counterpart and is left out, as
``models/torch_compat.py`` leaves it out for WiFlow.  The Performer's
random projections are not flax variables in the JAX package (constants
drawn from ``jax.random.key(proj_seed)``); :func:`load_flax_variables`
takes them as numpy arrays, so that a test runs both sides on the same
projections.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from wiflow_tpu_torch.models.torch_compat import load_state_dict

Tree = Dict[str, Any]


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _to_torch_layout(path: Tuple[str, ...], a: np.ndarray):
    """(torch key, array in the port's layout) of one flax leaf."""
    name = path[-1]
    if name == "kernel":                    # nn.Dense
        return ".".join(path[:-1] + ("weight",)), a.T
    if name == "scale":                     # nn.LayerNorm
        return ".".join(path[:-1] + ("weight",)), a
    if a.ndim == 4:                         # HWIO conv kernel
        return ".".join(path), a.transpose(3, 2, 0, 1)
    return ".".join(path), a


def state_dict_from_flax(variables: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """A baseline's flax ``{'params', 'batch_stats'}`` tree (numpy arrays,
    or anything ``np.asarray`` takes) -> the port module's ``state_dict``
    entries, float32 CPU tensors, bit for bit."""
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(coll, {})):
            key, a = _to_torch_layout(path, np.asarray(leaf, np.float32))
            out[key] = torch.from_numpy(np.ascontiguousarray(a).copy())
    return out


def flax_variables_from_state_dict(state_dict: Mapping[str, Any],
                                   module: nn.Module) -> Tree:
    """The inverse of :func:`state_dict_from_flax` for ``module``'s
    ``state_dict``: the flax tree of float32 numpy arrays (the module
    says which leaves are ``nn.Linear`` and ``nn.LayerNorm``)."""
    kinds = {}
    for name, m in module.named_modules():
        if isinstance(m, nn.Linear):
            kinds[f"{name}.weight"] = "kernel"
        elif isinstance(m, nn.LayerNorm):
            kinds[f"{name}.weight"] = "scale"
    out: Tree = {"params": {}, "batch_stats": {}}
    for key, v in state_dict.items():
        path = key.split(".")
        if path[-1] == "num_batches_tracked":
            continue
        a = (v.detach().cpu().numpy() if torch.is_tensor(v)
             else np.asarray(v)).astype(np.float32)
        coll = "batch_stats" if path[-1].startswith("running_") else "params"
        kind = kinds.get(key)
        if kind == "kernel":
            path[-1], a = "kernel", a.T
        elif kind == "scale":
            path[-1] = "scale"
        elif a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return out


def load_flax_variables(module: nn.Module, variables: Mapping[str, Any],
                        projections: Optional[Mapping[str, Any]] = None
                        ) -> nn.Module:
    """Load a baseline's flax variables into ``module`` (strict but for
    ``num_batches_tracked``).  ``projections`` maps the name of a
    ``PerformerAttention`` submodule (``"performer_sc1.att_0"``) to the
    ``[num_features, dim_head]`` projection it should use in place of its
    own draw."""
    load_state_dict(module, state_dict_from_flax(variables))
    subs = dict(module.named_modules())
    for name, proj in (projections or {}).items():
        buf = subs[name].proj
        with torch.no_grad():
            buf.copy_(torch.as_tensor(np.array(proj)))
    return module


class FlaxLayout:
    """Mixin of the baselines' top-level modules: ``flax_variables(sd)``,
    the JAX package's tree of a ``state_dict`` of this module, which
    ``train/loop.py`` writes as ``best_pose_model.msgpack``."""

    def flax_variables(self, state_dict: Mapping[str, Any]) -> Tree:
        return flax_variables_from_state_dict(state_dict, self)
