"""Prediction: constant-velocity advance with process noise (mirrors
``dspmap_tpu/ops/propagate.py``; see its docstring for the reference
semantics, ``dsp_dynamic.h:627-701``, and the static model,
``dsp_static.h:630-646``).

The grid is world-aligned with a moving window, so ego motion moves no
data: prediction only advances valid particles by their own velocity.

Three arms, as in the JAX package:

* static model: every velocity plane becomes zero, positions stay;
* limit-xy: vz is re-pinned to 0 on valid slots, no draw (the reference's
  keep-still quirk makes the noise branch dead there);
* noisy: valid particles with ``|vx*vy*vz| >= 1e-6`` (``dsp_dynamic.h:653``;
  the product taken as ``(vx*vy)*vz`` in float32) get
  ``noise * velocity_noise_std`` added to each velocity; ``noise [3, S, V]``
  (or ``[3, P]`` for the compact layout's rows) is standard normal, drawn
  by the caller.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MapConfig
from .common import frame_float


def jitter_mask(vx, vy, vz, mask):
    """``mask`` and not the reference's keep-still test
    ``|vx*vy*vz| < 1e-6`` (``dsp_dynamic.h:653``)."""
    return mask & ~((vx * vy * vz).abs() < 1e-6)


def propagate(particles, cfg: MapConfig, noise, dt, rt=None):
    """Advance every valid particle one frame; returns the new planes.

    ``noise`` is the standard-normal ``[3, ...]`` draw of the noisy arm
    (``None`` on the other two); ``dt`` the frame block's 0-d tensor or a
    host float; ``rt`` the state's
    :class:`~dspmap_tpu_torch.state.RuntimeParams` (host floats or the
    frame block's tensors; ``None``: the configuration's sigma)."""
    valid = particles.valid
    if cfg.motion_model == "static":
        zeros = torch.zeros_like(particles.vx)
        return dataclasses.replace(particles, vx=zeros, vy=zeros, vz=zeros)

    vx, vy, vz = particles.vx, particles.vy, particles.vz
    if not cfg.limit_motion_to_xy_plane:
        if noise is None:
            raise ValueError("the noisy prediction arm takes a [3, ...] "
                             "standard-normal draw")
        sigma = cfg.velocity_noise_std if rt is None else rt.velocity_noise_std
        n = noise * frame_float(sigma)
        jitter = jitter_mask(vx, vy, vz, valid)
        vx = torch.where(jitter, vx + n[0], vx)
        vy = torch.where(jitter, vy + n[1], vy)
        vz = torch.where(jitter, vz + n[2], vz)
    else:
        vz = torch.where(valid, 0.0, vz)

    dt = frame_float(dt)
    px = torch.where(valid, particles.px + vx * dt, particles.px)
    py = torch.where(valid, particles.py + vy * dt, particles.py)
    pz = torch.where(valid, particles.pz + vz * dt, particles.pz)
    return dataclasses.replace(particles, px=px, py=py, pz=pz, vx=vx, vy=vy,
                               vz=vz)
