"""The v1 attention kernel's outputs on seeded inputs, saved and held bit
for bit against another tree's.

    python3 attention_bits.py save FILE      # the output of every case
    python3 attention_bits.py compare A B    # two saved files, bit for bit

``save`` runs ``axial_attention_v1`` of the package it imports (the tree
it is run from, or the one ``PYTHONPATH`` names) along both axes of both
models' attention shapes (``[B, 15, 20, 64]`` and ``[B, 17, 10, 64]``, 8
groups) at batch 4096 and 7, in bf16 and fp32, on a precomputed ``qkv``
and affines made from a fixed seed on the card; it uses only the
wrapper's interface, so it runs any tree's.  ``compare`` prints, per case,
whether two trees gave the same bits (saved as sha256 digests).  Needs a
CUDA card.
"""

import hashlib
import sys

import torch

SEED = 11
C, G = 64, 8
SHAPES = {"flagship": (15, 20), "MM-Fi": (17, 10)}
BATCHES = (4096, 7)


def inputs(h, w, batch, index, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + index)
    qkv = torch.randn((batch, h, w, 3 * C), generator=gen, device=dev)
    sim = torch.stack([
        torch.empty(G, device=dev).uniform_(0.5, 1.5, generator=gen),
        torch.randn(G, generator=gen, device=dev)])
    oaff = torch.stack([
        torch.empty(C, device=dev).uniform_(0.5, 1.5, generator=gen),
        torch.randn(C, generator=gen, device=dev)])
    return qkv, sim, oaff


def digest(t):
    """sha256 of a tensor's bytes: bit-equality without keeping it."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def save(path):
    from wiflow_tpu_torch.ops.kernels import axial_attention as ak
    dev = torch.device("cuda")
    saved, index = {}, 0
    for shape, (h, w) in SHAPES.items():
        for batch in BATCHES:
            qkv, sim, oaff = inputs(h, w, batch, index, dev)
            index += 1
            for dt in (torch.bfloat16, torch.float32):
                for width in (True, False):
                    out = ak.axial_attention_v1(qkv.to(dt), sim, oaff, width)
                    key = (f"{shape} [{batch}, {h}, {w}, {C}] "
                           f"{'width' if width else 'height'} "
                           f"{str(dt)[6:]}")
                    saved[key] = digest(out)
    torch.save(saved, path)
    print(f"saved {len(saved)} cases to {path}")


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    if a.keys() != b.keys():
        print(f"the two files hold different cases: {sorted(a)} vs "
              f"{sorted(b)}")
        return False
    same = True
    for key in a:
        eq = a[key] == b[key]
        same &= eq
        print(f"{key}: {'same bits' if eq else 'DIFFER'}")
    print(f"the same bits in every case: {same}")
    return same


if __name__ == "__main__":
    if sys.argv[1:2] == ["save"] and len(sys.argv) == 3:
        save(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        sys.exit(0 if compare(sys.argv[2], sys.argv[3]) else 1)
    else:
        sys.exit(__doc__)
