"""Carry WiFlow weights from the JAX package's variable tree to the port.

The port's modules use the reference torch ``state_dict`` names, so a
``best_pose_model.pth`` loads as it is.  A JAX ``{'params',
'batch_stats'}`` tree (as numpy arrays) maps onto the same names through
this module's own copy of ``wiflow_tpu/models/torch_compat.py::wiflow_spec``
(and ``wiflow_mmfi_spec`` for the MM-Fi model) and its inverse layout
functions — name reshuffling and transposes only:

  grouped Conv1d  (K, G, ci_g, co_g) -> (Co, Ci/G, K)
  pointwise Conv1d (Ci, Co)           -> (Co, Ci, 1)
  (1,3) Conv2d     (3, Ci, Co)        -> (Co, Ci, 1, 3)
  1x1 Conv2d       (Ci, Co)           -> (Co, Ci, 1, 1)
  3x3 Conv2d       (3, 3, Ci, Co)     -> (Co, Ci, 3, 3)

``jax_variables_from_state_dict`` goes the other way, for the
``best_pose_model.msgpack`` the trainer writes in flax's layout.  Both
follow the ablation switches of ``ModelConfig``; the conv2d encoder has no
reference torch names and uses the port's own (``encoder2d.proj``,
``encoder2d.blocks.{j}.conv1`` ...).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.models.wiflow_mmfi import MMFiModelConfig

Path = Tuple[str, ...]
# (torch_key, collection, flax_path, layout function flax -> torch)
Spec = Tuple[str, str, Path, Callable[[np.ndarray], np.ndarray]]


def _grouped_inv(w: np.ndarray) -> np.ndarray:
    k, g, ci_g, co_g = w.shape
    return w.transpose(1, 3, 2, 0).reshape(g * co_g, ci_g, k)


def _pw1d_inv(w: np.ndarray) -> np.ndarray:
    return w.T[:, :, None]


def _conv1x3_inv(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 1, 0)[:, :, None, :]


def _conv1x1_inv(w: np.ndarray) -> np.ndarray:
    return w.T[:, :, None, None]


def _conv3x3_inv(w: np.ndarray) -> np.ndarray:
    return w.transpose(3, 2, 0, 1)


def _ident(w: np.ndarray) -> np.ndarray:
    return w


def _grouped(w: np.ndarray) -> np.ndarray:
    # a TCN k=3 conv maps C channels to C, so its groups are C / (C / G)
    co, ci_g, k = w.shape
    groups = co // ci_g
    return w.reshape(groups, co // groups, ci_g, k).transpose(3, 0, 2, 1)


# torch -> flax, by the spec's flax -> torch function
_FORWARD: Dict[Callable, Callable[[np.ndarray], np.ndarray]] = {
    _grouped_inv: _grouped,
    _pw1d_inv: lambda w: w[:, :, 0].T,
    _conv1x3_inv: lambda w: w[:, :, 0, :].transpose(2, 1, 0),
    _conv1x1_inv: lambda w: w[:, :, 0, 0].T,
    _conv3x3_inv: lambda w: w.transpose(2, 3, 1, 0),
    _ident: lambda w: w,
}


def _bn_specs(torch_prefix: str, flax_path: Path) -> List[Spec]:
    return [
        (f"{torch_prefix}.weight", "params", flax_path + ("weight",), _ident),
        (f"{torch_prefix}.bias", "params", flax_path + ("bias",), _ident),
        (f"{torch_prefix}.running_mean", "batch_stats",
         flax_path + ("running_mean",), _ident),
        (f"{torch_prefix}.running_var", "batch_stats",
         flax_path + ("running_var",), _ident),
    ]


def _tcn_specs(n_in: int, channels) -> List[Spec]:
    specs: List[Spec] = []
    for i, n_out in enumerate(channels):
        tp, fp = f"tcn.network.{i}", ("tcn", f"network_{i}")
        specs += [
            (f"{tp}.conv1_group.weight", "params",
             fp + ("conv1_group_weight",), _grouped_inv),
            (f"{tp}.conv1_pw.weight", "params",
             fp + ("conv1_pw_weight",), _pw1d_inv),
            (f"{tp}.conv2_group.weight", "params",
             fp + ("conv2_group_weight",), _grouped_inv),
            (f"{tp}.conv2_pw.weight", "params",
             fp + ("conv2_pw_weight",), _pw1d_inv),
        ]
        for bn in ("bn1_group", "bn1_pw", "bn2_group", "bn2_pw"):
            specs += _bn_specs(f"{tp}.{bn}", fp + (bn,))
        if n_in != n_out:
            specs.append((f"{tp}.downsample.0.weight", "params",
                          fp + ("downsample_weight",), _pw1d_inv))
            specs += _bn_specs(f"{tp}.downsample.1", fp + ("downsample_bn",))
        n_in = n_out
    return specs


def _conv_stack_specs(n_blocks: int) -> List[Spec]:
    specs: List[Spec] = []

    def conv_block(torch_prefix: str, flax_name: str) -> None:
        fp = (flax_name,)
        for idx, tidx in ((1, 0), (2, 4), (3, 8)):
            specs.append((f"{torch_prefix}.block.{tidx}.weight", "params",
                          fp + (f"conv{idx}_weight",), _conv1x3_inv))
            specs.append((f"{torch_prefix}.block.{tidx}.bias", "params",
                          fp + (f"conv{idx}_bias",), _ident))
            specs.extend(_bn_specs(f"{torch_prefix}.block.{tidx + 1}",
                                   fp + (f"bn{idx}",)))
        specs.append((f"{torch_prefix}.downsample.0.weight", "params",
                      fp + ("downsample_weight",), _conv1x1_inv))
        specs.extend(_bn_specs(f"{torch_prefix}.downsample.1",
                               fp + ("downsample_bn",)))

    conv_block("up", "up")
    for j in range(n_blocks):
        conv_block(f"residual_blocks.{j}", f"residual_blocks_{j}")
    return specs


def _attention_specs(torch_name: str) -> List[Spec]:
    specs: List[Spec] = []
    for axis in ("width_axis", "height_axis"):
        tp, fp = f"{torch_name}.{axis}", ("attention", axis)
        specs.append((f"{tp}.qkv_transform.weight", "params",
                      fp + ("qkv_weight",), _pw1d_inv))
        for bn in ("bn_qkv", "bn_similarity", "bn_output"):
            specs += _bn_specs(f"{tp}.{bn}", fp + (bn,))
    return specs


def _encoder2d_specs(n_blocks: int) -> List[Spec]:
    """The conv2d ablation encoder: flax ``encoder2d/proj_weight``,
    ``block{j}_*`` under the port's own names (the reference has none)."""
    fp = ("encoder2d",)
    specs: List[Spec] = [("encoder2d.proj.weight", "params",
                          fp + ("proj_weight",), _pw1d_inv)]
    specs += _bn_specs("encoder2d.proj_bn", fp + ("proj_bn",))
    for j in range(n_blocks):
        tp, fb = f"encoder2d.blocks.{j}", f"block{j}_"
        for conv in ("conv1", "conv2"):
            specs += [(f"{tp}.{conv}.weight", "params",
                       fp + (f"{fb}{conv}_weight",), _conv3x3_inv),
                      (f"{tp}.{conv}.bias", "params",
                       fp + (f"{fb}{conv}_bias",), _ident)]
        specs.append((f"{tp}.down.weight", "params", fp + (f"{fb}down_weight",),
                      _conv1x1_inv))
        for bn in ("bn1", "bn2", "down_bn"):
            specs += _bn_specs(f"{tp}.{bn}", fp + (f"{fb}{bn}",))
    return specs


def wiflow_spec(cfg: ModelConfig = ModelConfig()) -> List[Spec]:
    """Spec of the flagship model, or of the ablation variant that
    ``cfg``'s ``tcn_conv``, ``encoder_kind`` and ``use_attention`` give."""
    if cfg.encoder_kind == "conv2d":
        specs = _encoder2d_specs(len(cfg.conv_channels) + 1)
    else:
        specs = _tcn_specs(cfg.num_subcarriers, cfg.tcn_channels)
        specs += _conv_stack_specs(len(cfg.conv_channels))
    if cfg.use_attention:
        specs += _attention_specs("attention")
    specs += [
        ("decoder.0.weight", "params", ("decoder_conv1_weight",),
         _conv3x3_inv),
        ("decoder.0.bias", "params", ("decoder_conv1_bias",), _ident),
        ("decoder.3.weight", "params", ("decoder_conv2_weight",),
         _conv1x1_inv),
        ("decoder.3.bias", "params", ("decoder_conv2_bias",), _ident),
    ]
    specs += _bn_specs("decoder.1", ("decoder_bn1",))
    specs += _bn_specs("decoder.4", ("decoder_bn2",))
    return specs


def wiflow_mmfi_spec(cfg: MMFiModelConfig = MMFiModelConfig()) -> List[Spec]:
    """Spec of the MM-Fi model (the port's copy of the JAX package's
    ``wiflow_mmfi_spec``): the 342-channel TCN, ``tcn_proj``, ``att`` (not
    ``attention``) and the ``final_conv`` head."""
    specs = _tcn_specs(cfg.input_channels, cfg.tcn_channels)
    specs.append(("tcn_proj.0.weight", "params", ("tcn_proj_weight",),
                  _pw1d_inv))
    specs += _bn_specs("tcn_proj.1", ("tcn_proj_bn",))
    specs += _conv_stack_specs(len(cfg.conv_channels))
    specs += _attention_specs("att")
    specs += [
        ("final_conv.0.weight", "params", ("final_conv1_weight",),
         _conv1x1_inv),
        ("final_conv.0.bias", "params", ("final_conv1_bias",), _ident),
        ("final_conv.3.weight", "params", ("final_conv2_weight",),
         _conv1x1_inv),
        ("final_conv.3.bias", "params", ("final_conv2_bias",), _ident),
    ]
    specs += _bn_specs("final_conv.1", ("final_bn",))
    return specs


def spec_for(cfg) -> List[Spec]:
    """The spec of the model that ``cfg`` configures."""
    if isinstance(cfg, MMFiModelConfig):
        return wiflow_mmfi_spec(cfg)
    return wiflow_spec(cfg)


def _get_path(tree: Mapping[str, Any], path: Path) -> Any:
    node = tree
    for key in path:
        node = node[key]
    return node


def state_dict_from_jax(variables: Mapping[str, Any],
                        cfg: ModelConfig | MMFiModelConfig = ModelConfig()
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` tree -> the port's ``state_dict``,
    of the flagship model or, given an ``MMFiModelConfig``, the MM-Fi one.

    Leaves are numpy arrays (or anything ``np.asarray`` takes); values are
    copied as float32 CPU tensors, bit for bit.  A leaf missing from the
    tree raises ``KeyError`` naming its path.
    """
    out: Dict[str, torch.Tensor] = {}
    for torch_key, coll, path, inv in spec_for(cfg):
        try:
            leaf = _get_path(variables[coll], path)
        except KeyError:
            raise KeyError(f"JAX variables lack {coll}/{'/'.join(path)} "
                           f"(torch key {torch_key})") from None
        arr = np.ascontiguousarray(inv(np.asarray(leaf, np.float32)))
        out[torch_key] = torch.from_numpy(arr.copy())
    return out


def jax_variables_from_state_dict(
        state_dict: Mapping[str, Any],
        cfg: ModelConfig | MMFiModelConfig = ModelConfig()
) -> Dict[str, Dict[str, Any]]:
    """The port's ``state_dict`` -> the JAX ``{'params', 'batch_stats'}``
    tree of float32 numpy arrays, the inverse of
    :func:`state_dict_from_jax` (bit for bit).  Keys outside the spec
    (``num_batches_tracked``) are left out; a missing key raises
    ``KeyError`` naming it."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for torch_key, coll, path, inv in spec_for(cfg):
        if torch_key not in state_dict:
            raise KeyError(f"state_dict lacks {torch_key} "
                           f"(JAX {coll}/{'/'.join(path)})")
        v = state_dict[torch_key]
        arr = (v.detach().cpu().numpy() if torch.is_tensor(v)
               else np.asarray(v))
        node = out[coll]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(
            _FORWARD[inv](arr.astype(np.float32)))
    return out


def load_state_dict(module: nn.Module,
                    state_dict: Mapping[str, Any]) -> nn.Module:
    """Load ``state_dict`` into ``module``, strict except for exactly the
    ``num_batches_tracked`` counters, which JAX exports do not carry
    (``wiflow_tpu/models/torch_compat.py:79-87``) and eval never reads."""
    sd = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
          for k, v in state_dict.items()}
    result = module.load_state_dict(sd, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith(".num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"state_dict does not match the module: missing "
                       f"{missing[:5]} ({len(missing)}), unexpected "
                       f"{result.unexpected_keys[:5]} "
                       f"({len(result.unexpected_keys)})")
    return module
