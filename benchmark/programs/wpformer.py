"""WPformer in the program: ``WPformer`` built from the configuration,
served by ``pack_wpformer`` / ``wpformer_forward`` (the channel attention's
core on ``ops/kernels/channel_attention.py``'s kernel on the card).

The reference names its weights as the published model does
(``benchmark/reference/wpformer.py``); :func:`to_program` maps them onto
the port's module (its names, and ``[in, out]`` head matrices where the
published ``nn.Linear`` holds ``[out, in]``), :func:`to_reference` back.
``benchmark/program.py::KERNELS`` does not list the channel attention
kernel, so :func:`serve_forward` builds and loads it itself, in set-up,
and holds it to its plain version there (:func:`check_kernel`): the
cell's pose check cannot see the core, whose part in the poses lies under
bf16's rounding (a zeroed core reads as sound, ``PERF.md`` §4), so a
kernel fault fails the run at set-up instead.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from wiflow_tpu_torch.models.baselines.wpformer import (
    WPformer, pack_wpformer, wpformer_forward,
)
from wiflow_tpu_torch.ops.kernels import channel_attention

from benchmark.reference import wpformer as ref

BN = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
WB = ("weight", "bias")
# The kernel against its plain version as shares of max|plain|: max one
# bf16 step of the largest entry (a P entry at a rounding edge rounds the
# other way when the scores sum in another order), RMS 1e-4 (an H100 reads
# 4.6e-5 at most on random inputs; a head left out reads 0.11).
CHECK_WINDOWS = 2
TOL_MAX, TOL_RMS = 2.0 ** -7, 1e-4


def model_config(cfg: Mapping) -> Dict:
    """``WPformer``'s arguments from the configuration file."""
    return dict(num_chunks=cfg["num_chunks"],
                resize_to=tuple(cfg["resize_to"]),
                num_keypoints=cfg["num_keypoints"],
                keypoint_dims=cfg["keypoint_dims"],
                trunk_widths=tuple(cfg["trunk_widths"]),
                trunk_blocks=tuple(cfg["trunk_blocks"]), heads=cfg["heads"],
                compute_dtype=cfg["compute_dtype"])


def names(cfg: Mapping) -> List[Tuple[str, str, bool]]:
    """(reference name, program name, transposed) of every entry."""
    out: List[Tuple[str, str, bool]] = []

    def group(src, dst, leaves):
        out.extend((f"{src}.{k}", f"{dst}.{k}", False) for k in leaves)

    out.append(("conv1.weight", "trunk.stem_weight", False))
    group("bn1", "trunk.stem_bn", BN)
    for p, ci, co, stride in ref.trunk_blocks(cfg):
        layer, block = p.split(".")
        q = f"trunk.{layer}_{block}"
        out += [(f"{p}.conv1.weight", f"{q}.conv1_weight", False),
                (f"{p}.conv2.weight", f"{q}.conv2_weight", False)]
        group(f"{p}.bn1", f"{q}.bn1", BN)
        group(f"{p}.bn2", f"{q}.bn2", BN)
        if stride != 1 or ci != co:
            out.append((f"{p}.downsample.0.weight", f"{q}.down_weight",
                        False))
            group(f"{p}.downsample.1", f"{q}.down_bn", BN)
    group("pre_bn", "pre_tf_bn", BN)
    out.append(("tf.embeddings_1.position_embeddings",
                "tf.position_embeddings", False))
    for i in range(cfg["num_layers"]):
        p = f"tf.encoder.layer.{i}"
        group(f"{p}.attn_norm1", f"tf.attn_norm_{i}", WB)
        for src, dst in (("query1", "wq"), ("key", "wk"), ("value", "wv")):
            out += [(f"{p}.channel_attn.{src}.{h}.weight",
                     f"tf.attn_{i}.{dst}{h}", True)
                    for h in range(cfg["heads"])]
        out.append((f"{p}.channel_attn.out1.weight", f"tf.attn_{i}.wo",
                    True))
        group(f"{p}.ffn_norm1", f"tf.ffn_norm_{i}", WB)
        group(f"{p}.ffn1.fc1", f"tf.mlp_in_{i}", WB)
        group(f"{p}.ffn1.fc2", f"tf.mlp_out_{i}", WB)
    group("tf.encoder.encoder_norm1", "tf.encoder_norm", WB)
    out += [("tf.reconstruct_1.conv.weight", "tf.rec_weight", False),
            ("tf.reconstruct_1.conv.bias", "tf.rec_bias", False)]
    group("tf.reconstruct_1.norm", "tf.rec_bn", BN)
    out.append(("decoder.0.weight", "decode_conv1_weight", False))
    group("decoder.1", "decode_bn1", BN)
    out.append(("decoder.3.weight", "decode_conv2_weight", False))
    group("decoder.4", "decode_bn2", BN)
    group("pool_bn", "final_bn", BN)
    return out


def to_program(sd: Mapping, cfg: Mapping) -> Dict:
    """The reference's ``state_dict`` under the program's names."""
    return {dst: sd[src].t() if tr else sd[src]
            for src, dst, tr in names(cfg)}


def to_reference(sd: Mapping, cfg: Mapping) -> Dict:
    """The program's ``state_dict`` under the reference's names."""
    return {src: sd[dst].t() if tr else sd[dst]
            for src, dst, tr in names(cfg)}


def check_kernel(tokens: int, c: int, heads: int, device) -> None:
    """The channel attention wrapper against its plain version on
    ``CHECK_WINDOWS`` windows of seeded N(0, 1) ``qkv`` in bf16; raises
    ``RuntimeError`` outside ``TOL_MAX`` / ``TOL_RMS``."""
    gen = torch.Generator(device=device).manual_seed(0)
    qkv = torch.randn((CHECK_WINDOWS, tokens, 3 * heads * c), generator=gen,
                      device=device).to(torch.bfloat16)
    got = channel_attention.channel_attention(qkv, heads).float()
    want = channel_attention.channel_attention_plain(qkv, heads).float()
    scale = want.abs().max()
    mx = ((got - want).abs().max() / scale).item()
    rms = ((got - want).pow(2).mean().sqrt() / scale).item()
    if not (mx <= TOL_MAX and rms <= TOL_RMS):
        raise RuntimeError(f"channel attention kernel off its plain version "
                           f"at N = {tokens}, C = {c}, H = {heads}: max "
                           f"{mx:.3e} (limit {TOL_MAX:.3e}), RMS {rms:.3e} "
                           f"(limit {TOL_RMS:.0e}) of max|plain|")


def serve_forward(sd, cfg, device, core: str = "auto"):
    model = WPformer(**model_config(cfg), device=device)
    model.load_state_dict(to_program(sd, cfg))
    packed = pack_wpformer(model)
    dev = model.tf.position_embeddings.device
    if dev.type == "cuda":
        channel_attention.KERNEL.load()
        if core != "stock" and packed.dtype == torch.bfloat16:
            _, tokens, c = packed.pos.shape
            check_kernel(tokens, c, packed.heads, dev)
    return lambda x: wpformer_forward(packed, x, core=core)
