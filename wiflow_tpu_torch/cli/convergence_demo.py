"""Synthetic CSI windows made on the device: ``synth_windows``.

Counterpart of ``synth_windows`` in ``wiflow_tpu/cli/convergence_demo.py``
(the windows that ``cli/ablation_demo.py`` and ``cli/baseline_table.py``
train on).  The module's ``main``, the reference-scale convergence run,
is not ported yet (ROADMAP.md queue 1, item 7).

The generative structure is the JAX function's: per-window smooth pose
trajectories (sums of random sinusoids), then a CSI observation model:

* ``"linear"``: one global linear map of [pose, velocity] into subcarrier
  space, plus noise.  Invertible frame by frame, so it cannot reward
  temporal or cross-subcarrier modelling.
* ``"multipath"``: motion-modulated multipath.  Each of P scatter paths
  has a pose-dependent delay ``tau_p(t) = w_p . kp(t)``; subcarrier c sees
  ``sum_p A_p(t) cos(omega_c tau_p(t) + phi_p)`` with a Doppler-style
  amplitude ``A_p(t) = a_p (1 + tanh(u_p . 8 vel(t)))``: a wrapped,
  many-to-one view of the pose per subcarrier.

The radio world (the mixing map, the paths, the phases) depends on
``mix_seed`` only, so it is the same across splits and subjects; the
trajectories are drawn from ``seed``.  Everything is drawn on the device
from ``torch.Generator``s there, a chunk at a time, into preallocated bf16
buffers; ``multipath`` adds its paths one at a time, never holding a
``[m, T, P, C]`` intermediate.  :func:`observe` is the observation model
as a function of the draws, so that a test can feed it the JAX package's.
The torch generators draw other numbers than ``jax.random``: the port's
windows have the JAX windows' distribution, not their values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from wiflow_tpu_torch.core.config import resolve_device


@dataclasses.dataclass(frozen=True)
class SynthWorld:
    """The radio world that every split and subject shares."""

    mix: torch.Tensor        # [2 * 2K, C]: [pose, velocity] -> CSI
    w_path: torch.Tensor     # [2K, P]: path delays from the pose
    u_path: torch.Tensor     # [2K, P]: Doppler from the velocity
    a_path: torch.Tensor     # [P] path amplitudes
    phi: torch.Tensor        # [P, C] path phases
    omega: torch.Tensor      # [C] wavenumbers, 4 .. 16


def synth_world(num_subcarriers: int = 540, keypoints: int = 15,
                mix_seed: int = 7, n_paths: int = 48,
                device=None) -> SynthWorld:
    """The world of ``mix_seed``, drawn on ``device`` (CUDA unless
    ``"cpu"``) with the JAX function's distributions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(mix_seed)
    k2, c, p = 2 * keypoints, num_subcarriers, n_paths

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    return SynthWorld(
        mix=normal(2 * k2, c), w_path=normal(k2, p) / math.sqrt(k2),
        u_path=normal(k2, p) / math.sqrt(k2), a_path=0.7 + 0.6 * uniform(p),
        phi=2 * math.pi * uniform(p, c),
        omega=torch.linspace(4.0, 16.0, c, device=dev))


def subject_style(subject: int) -> Tuple[float, float, float, float]:
    """``(amp_scale, freq_lo, freq_hi, csi_gain)`` of ``subject`` (1..5; 0
    is generic): each subject moves with its own amplitude and frequency
    range and is seen with its own CSI gain."""
    s = subject
    amp_scale = 0.08 * (1.0 + 0.25 * ((s % 3) - 1)) if s else 0.08
    freq_lo = 0.05 + (0.03 * (s - 1) if s else 0.0)
    freq_hi = 0.4 + (0.06 * ((s % 2) * 2 - 1) if s else 0.0)
    csi_gain = 1.0 + (0.06 * (s - 3) if s else 0.0)
    return amp_scale, freq_lo, freq_hi, csi_gain


def observe(world: SynthWorld, base: torch.Tensor, amp: torch.Tensor,
            freq: torch.Tensor, phase: torch.Tensor, noise: torch.Tensor, *,
            mode: str, csi_gain: float, keypoints: int = 15
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The windows of one chunk from its draws: ``base``, ``amp``,
    ``freq``, ``phase`` ``[m, 1, 2K]`` (already scaled: the pose offset,
    the amplitude, the frequency and the phase of each coordinate's
    sinusoid) and ``noise [m, T, C]`` (standard normal).  Returns ``x
    [m, C, T]`` in bf16 and the last frame's pose ``y [m, K, 2]`` + 0.5 in
    fp32."""
    if mode not in ("linear", "multipath"):
        raise ValueError(f"mode={mode!r}: 'linear' or 'multipath'")
    m, window = noise.shape[0], noise.shape[1]
    t = torch.arange(window, dtype=torch.float32,
                     device=noise.device)[None, :, None]
    kp = base + amp * torch.sin(freq * t + phase)            # [m, T, 2K]
    vel = torch.diff(kp, dim=1, prepend=kp[:, :1])
    if mode == "multipath":
        csi = 0.05 * noise + 1.0
        tau = kp @ world.w_path                              # [m, T, P]
        gain = world.a_path * (1.0 + torch.tanh((8.0 * vel) @ world.u_path))
        # the P=8 recipes' CSI spread, kept at any P
        scale = csi_gain / (world.a_path.numel() / 8.0) ** 0.5
        for p in range(world.a_path.numel()):
            ang = tau[..., p, None] * world.omega + world.phi[p]
            csi += scale * gain[..., p, None] * torch.cos(ang)
    else:
        feats = torch.cat([kp, 5.0 * vel], dim=-1)           # [m, T, 4K]
        csi = csi_gain * (feats @ world.mix) + 0.05 * noise + 1.0
    x = csi.transpose(1, 2).to(torch.bfloat16)
    y = kp[:, -1, :].reshape(m, keypoints, 2) + 0.5
    return x, y


def synth_windows(n: int, seed: int, num_subcarriers: int = 540,
                  window: int = 20, keypoints: int = 15,
                  chunk: int = 15_000, mix_seed: int = 7,
                  subject: int = 0, mode: str = "linear",
                  n_paths: int = 48, *, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` CSI windows ``x [n, 540, 20]`` (bf16) and their last-frame
    poses ``y [n, 15, 2]`` (fp32), on ``device`` (CUDA unless ``"cpu"``),
    drawn ``chunk`` windows at a time from a generator seeded with
    ``seed + 1``; the world from ``mix_seed`` (:func:`synth_world`).
    ``n_paths`` must be at least ``2 * keypoints`` for the pose to be
    recoverable from ``"multipath"`` CSI at all."""
    dev = resolve_device(device)
    world = synth_world(num_subcarriers, keypoints, mix_seed, n_paths, dev)
    amp_scale, freq_lo, freq_hi, csi_gain = subject_style(subject)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    k2 = 2 * keypoints
    xbuf = torch.empty(n, num_subcarriers, window, dtype=torch.bfloat16,
                       device=dev)
    ybuf = torch.empty(n, keypoints, 2, dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)

        def draw(*shape, uniform=False):
            f = torch.rand if uniform else torch.randn
            return f(shape, generator=gen, device=dev)

        base = 0.2 * draw(m, 1, k2)
        amp = amp_scale * draw(m, 1, k2)
        freq = freq_lo + (freq_hi - freq_lo) * draw(m, 1, k2, uniform=True)
        phase = 2 * math.pi * draw(m, 1, k2, uniform=True)
        noise = draw(m, window, num_subcarriers)
        xbuf[lo:lo + m], ybuf[lo:lo + m] = observe(
            world, base, amp, freq, phase, noise, mode=mode,
            csi_gain=csi_gain, keypoints=keypoints)
    return xbuf, ybuf
