"""Performer attention (FAVOR+ linear attention) for the PerUnet baseline.

Counterpart of ``wiflow_tpu/models/baselines/performer.py``: the method of
Choromanski et al. ("Rethinking Attention with Performers", ICLR'21) in
place of the reference's ``performer_pytorch`` (ref baseline/PerUnet/
perunet.py:5, 383-391: dim 600, depth 3, heads 4, dim_head 64).  Each
layer's softmax kernel is approximated by positive random features
``exp(w^T x - |x|^2 / 2) / sqrt(m)``; ``exact=True`` computes softmax
attention instead.

The projection of a layer is a constant, as in the JAX package (there
drawn from ``jax.random.key(proj_seed)`` at trace time, not a flax
variable): here a buffer drawn from ``torch.Generator().manual_seed(
proj_seed)``, outside the ``state_dict``.  The two generators draw other
numbers; ``models/baselines/convert.py::load_flax_variables`` takes the
JAX projections where a test needs both sides on the same ones.  Flax's
defaults are kept: ``nn.LayerNorm`` at eps 1e-6 and ``nn.gelu`` in its
tanh form.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from wiflow_tpu_torch.core.config import resolve_device
from wiflow_tpu_torch.models.baselines.hpeli import flax_param

LN_EPS = 1e-6       # flax nn.LayerNorm's default


def orthogonal_random_features(generator: torch.Generator,
                               num_features: int, dim: int) -> torch.Tensor:
    """Block-orthogonal Gaussian projection ``[num_features, dim]``, rows
    rescaled to chi(dim) norms like iid Gaussians (the JAX function's
    algorithm, drawn from ``generator`` on the CPU)."""
    blocks, n_full = [], num_features // dim
    for i in range(n_full + 1):
        rows = dim if i < n_full else num_features - n_full * dim
        if rows == 0:
            break
        g = torch.randn(dim, dim, generator=generator, dtype=torch.float64)
        q, _ = torch.linalg.qr(g)
        blocks.append(q[:rows])
    w = torch.cat(blocks)
    norms = torch.randn(num_features, dim, generator=generator,
                        dtype=torch.float64).square().sum(dim=1).sqrt()
    return (w * norms[:, None]).float()


def favor_features(x: torch.Tensor, proj: torch.Tensor, *, is_query: bool,
                   eps: float = 1e-4) -> torch.Tensor:
    """Positive softmax-kernel features phi(x) ``[..., N, M]``, stabilised
    by the max over the features of each query, or over all (N, M) of a
    batch and head for the keys."""
    dt = torch.promote_types(x.dtype, proj.dtype)
    x = x.to(dt) / x.shape[-1] ** 0.25
    wx = torch.einsum("...nd,md->...nm", x, proj.to(dt))
    sq = 0.5 * (x * x).sum(dim=-1, keepdim=True)
    if is_query:
        stab = wx.amax(dim=-1, keepdim=True)
    else:
        stab = wx.amax(dim=(-2, -1), keepdim=True)
    return (torch.exp(wx - sq - stab) + eps) / math.sqrt(proj.shape[0])


class PerformerAttention(nn.Module):
    """One multi-head (FAVOR+ or exact) self-attention layer on
    ``[B, N, dim]``; ``wq``, ``wk``, ``wv`` ``[dim, heads * dim_head]`` and
    ``wo`` as in flax."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64,
                 num_features: int = 256, exact: bool = False,
                 proj_seed: int = 0, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.heads, self.dim_head, self.exact = heads, dim_head, exact
        inner = heads * dim_head
        for name, shape in (("wq", (dim, inner)), ("wk", (dim, inner)),
                            ("wv", (dim, inner)), ("wo", (inner, dim))):
            self.register_parameter(name, flax_param(
                shape, "xavier_uniform", generator, device))
        proj = orthogonal_random_features(
            torch.Generator().manual_seed(proj_seed), num_features, dim_head)
        self.register_buffer("proj", proj.to(resolve_device(device)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head

        def split(w):
            return (x @ w.to(x.dtype)).reshape(b, n, h, dh).transpose(1, 2)

        q, k, v = split(self.wq), split(self.wk), split(self.wv)
        if self.exact:
            logits = torch.einsum("bhnd,bhmd->bhnm", q, k) / math.sqrt(dh)
            att = torch.softmax(logits.float(), dim=-1)
            out = torch.einsum("bhnm,bhmd->bhnd", att.to(x.dtype), v)
        else:
            qf = favor_features(q.float(), self.proj, is_query=True)
            kf = favor_features(k.float(), self.proj, is_query=False)
            # linear attention: phi(q) (phi(k)^T v) / (phi(q) sum phi(k))
            kv = torch.einsum("bhnm,bhnd->bhmd", kf,
                              v.float().to(kf.dtype))
            num = torch.einsum("bhnm,bhmd->bhnd", qf, kv)
            den = torch.einsum("bhnm,bhm->bhn", qf, kf.sum(dim=-2))
            out = (num / (den[..., None] + 1e-6)).to(x.dtype)
        out = out.transpose(1, 2).reshape(b, n, h * dh)
        return out @ self.wo.to(x.dtype)


class Performer(nn.Module):
    """Pre-norm transformer stack, FAVOR+ attention and a tanh-GELU MLP
    (performer_pytorch's ``dim, depth, heads, dim_head, causal=False``)."""

    def __init__(self, dim: int, depth: int = 3, heads: int = 4,
                 dim_head: int = 64, mlp_ratio: int = 4, exact: bool = False,
                 *, generator: torch.Generator, device=None):
        super().__init__()
        self.depth = depth
        dev = resolve_device(device)
        for i in range(depth):
            self.add_module(f"ln_att_{i}", nn.LayerNorm(dim, eps=LN_EPS,
                                                        device=dev))
            self.add_module(f"att_{i}", PerformerAttention(
                dim, heads, dim_head, exact=exact, proj_seed=i,
                generator=generator, device=dev))
            self.add_module(f"ln_mlp_{i}", nn.LayerNorm(dim, eps=LN_EPS,
                                                        device=dev))
            self.add_module(f"mlp_in_{i}", dense(dim, dim * mlp_ratio,
                                                 generator, dev))
            self.add_module(f"mlp_out_{i}", dense(dim * mlp_ratio, dim,
                                                  generator, dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = x + getattr(self, f"att_{i}")(layer_norm(
                getattr(self, f"ln_att_{i}"), x))
            y = getattr(self, f"mlp_in_{i}")(layer_norm(
                getattr(self, f"ln_mlp_{i}"), x))
            x = x + getattr(self, f"mlp_out_{i}")(
                F.gelu(y, approximate="tanh"))
        return x


def dense(n_in: int, n_out: int, generator: torch.Generator,
          device) -> nn.Linear:
    """flax ``nn.Dense(n_out)`` as an ``nn.Linear``: LeCun-normal weight,
    zero bias."""
    lin = nn.Linear(n_in, n_out, device=device)
    with torch.no_grad():
        lin.weight.copy_(flax_param((n_in, n_out), "lecun_normal", generator,
                                    device).T)
        lin.bias.zero_()
    return lin


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.LayerNorm``: its parameters' dtype (fp32) promotes a bf16
    input, so the result is fp32."""
    return ln(x.to(ln.weight.dtype))
