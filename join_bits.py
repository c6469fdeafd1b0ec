"""The ``join`` kernels' outputs on seeded inputs, saved and held bit for
bit against another tree's.

    python3 join_bits.py save FILE      # out, gh, gres, gvec of every case
    python3 join_bits.py compare A B    # two saved files, bit for bit

``save`` runs ``join_forward`` and ``join_backward`` of the package it
imports (the tree it is run from, or the one ``PYTHONPATH`` names) at
every join of the fused train step at batch 256, at the MM-Fi TCN's 342
and 306 channels and at 17 channels with a per-sample mask, in bf16 and
fp32, on inputs made from a fixed seed on the card; it uses only the
wrappers' interfaces, so it runs any tree's.  ``compare`` prints, per
case and output, whether two trees gave the same bits (``out``, ``gh``,
``gres``, saved as sha256 digests) and the largest relative difference
of the per-channel gradients ``gvec`` (the residual branch's only with a
residual norm), which the two may sum in different orders.  Needs a CUDA
card.
"""

import hashlib
import sys

import torch

SEED = 10
KEEP = 0.5
CASES = [
    # the fused step's joins at batch 256 (ModelConfig(): TCN 540 -> 440 ->
    # 340 -> 240, conv stack 8, 8, 16, 32, 64)
    dict(lead=(256, 20), c=540, mask="element", res_norm=False, act_h=True),
    dict(lead=(256, 20), c=440, mask="element", res_norm=True, act_h=True),
    dict(lead=(256, 20), c=340, mask="element", res_norm=True, act_h=True),
    dict(lead=(256, 20), c=240, mask="element", res_norm=True, act_h=True),
    dict(lead=(256, 20, 240), c=8, mask=None, res_norm=True, act_h=False),
    dict(lead=(256, 20, 120), c=8, mask=None, res_norm=True, act_h=False),
    dict(lead=(256, 20, 60), c=16, mask=None, res_norm=True, act_h=False),
    dict(lead=(256, 20, 30), c=32, mask=None, res_norm=True, act_h=False),
    dict(lead=(256, 20, 15), c=64, mask=None, res_norm=True, act_h=False),
    dict(lead=(33, 10), c=342, mask="element", res_norm=False, act_h=True),
    dict(lead=(33, 10), c=306, mask="element", res_norm=True, act_h=True),
    dict(lead=(7, 20), c=17, mask="sample", res_norm=True, act_h=True),
]


def label(c):
    return f"{list(c['lead'])} x {c['c']}"


def inputs(c, index, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + index)
    shape = (*c["lead"], c["c"])

    def vec():
        return (0.3 * torch.randn(c["c"], generator=gen, device=dev),
                torch.empty(c["c"], device=dev).uniform_(0.5, 1.5,
                                                          generator=gen),
                0.3 * torch.randn(c["c"], generator=gen, device=dev))

    h = torch.randn(shape, generator=gen, device=dev)
    res = torch.randn(shape, generator=gen, device=dev)
    vh = vec()
    vr = vec() if c["res_norm"] else (None,) * 3
    mask = None
    if c["mask"]:
        mshape = shape if c["mask"] == "element" else (c["lead"][0], c["c"])
        mask = torch.rand(mshape, generator=gen, device=dev) < KEEP
    go = 0.1 * torch.randn(shape, generator=gen, device=dev)
    return h, vh, mask, res, vr, go


def digest(t):
    """sha256 of a tensor's bytes: bit-equality without keeping it."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def save(path):
    from wiflow_tpu_torch.ops.kernels import stage_fused as sk
    dev = torch.device("cuda")
    saved = {}
    for index, c in enumerate(CASES):
        h, vh, mask, res, vr, go = inputs(c, index, dev)
        for dt in (torch.bfloat16, torch.float32):
            kw = dict(keep=KEEP, act_h=c["act_h"])
            hh, rr, gg = h.to(dt), res.to(dt), go.to(dt)
            out = sk.join_forward(hh, *vh, mask, rr, *vr, **kw)
            gh, gres, gvec = sk.join_backward(hh, *vh, mask, rr, *vr, gg,
                                              **kw)
            key = f"{label(c)} {str(dt)[6:]}"
            saved[key] = dict(
                {n: digest(t) for n, t in (("out", out), ("gh", gh),
                                           ("gres", gres))},
                gvec=gvec[:2 if c["res_norm"] else 1].cpu())
    torch.save(saved, path)
    print(f"saved {len(saved)} cases to {path}")


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    same = True
    for key in a:
        parts = []
        for name in ("out", "gh", "gres"):
            eq = a[key][name] == b[key][name]
            same &= eq
            parts.append(f"{name} {'same bits' if eq else 'DIFFER'}")
        ga, gb = a[key]["gvec"].double(), b[key]["gvec"].double()
        rel = ((ga - gb).abs().max() / ga.abs().max().clamp_min(1e-30)).item()
        parts.append(f"gvec max rel diff {rel:.3e}")
        print(f"{key}: " + ", ".join(parts))
    print(f"out, gh, gres the same bits in every case: {same}")
    return same


if __name__ == "__main__":
    if sys.argv[1:2] == ["save"] and len(sys.argv) == 3:
        save(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        sys.exit(0 if compare(sys.argv[2], sys.argv[3]) else 1)
    else:
        sys.exit(__doc__)
