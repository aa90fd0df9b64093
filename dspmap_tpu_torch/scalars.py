"""A frame's per-frame values on the device: two small frame blocks.

The step's host prologue (``models/pipeline.py``) decides admission and
computes the frame's values on the host in numpy float32, with the JAX
package's operation order.  They reach the device in two blocks, one
float32 and one int32 (an int never rides as float bits), and with the
frame's points in one copy.  The step's device body reads every per-frame
value from these tensors -- the counterpart of the JAX step's traced
scalars and of the Pallas sweep's ``scal_ref`` / ``iscal_ref`` -- so a
CUDA graph captured over the body (``models/graphed.py``) reads each
replayed frame's values where the frame's copy puts them.

Float block: ``dt``, ``update_time``, ``sensor_pos[3]``, ``quat[4]``, the
world-to-sensor rotation ``R[9]`` (of the conjugate quaternion, row-major)
and the six :class:`~dspmap_tpu_torch.state.RuntimeParams` in their field
order.  Int block: ``origin[3]``, ``origin % (nx, ny, nz)`` and
``n_points``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import geometry
from .state import RuntimeParams

PARAM_NAMES = tuple(f.name for f in dataclasses.fields(RuntimeParams))
#: offsets in the float block
F_DT, F_UPDATE_TIME, F_SENSOR_POS, F_QUAT, F_R, F_PARAMS = 0, 1, 2, 5, 9, 18
N_F = F_PARAMS + len(PARAM_NAMES)
#: offsets in the int block
I_ORIGIN, I_ORIGIN_MOD, I_N_POINTS = 0, 3, 6
N_I = 7


class FrameScalars(NamedTuple):
    """One frame's (one sensor's) blocks on the device; every property is
    a view of them."""

    f: torch.Tensor  # f32 [N_F]
    i: torch.Tensor  # i32 [N_I]

    @property
    def dt(self) -> torch.Tensor:
        return self.f[F_DT]

    @property
    def update_time(self) -> torch.Tensor:
        return self.f[F_UPDATE_TIME]

    @property
    def sensor_pos(self) -> torch.Tensor:
        return self.f[F_SENSOR_POS:F_SENSOR_POS + 3]

    @property
    def quat(self) -> torch.Tensor:
        return self.f[F_QUAT:F_QUAT + 4]

    @property
    def R(self) -> torch.Tensor:
        return self.f[F_R:F_R + 9].view(3, 3)

    @property
    def params(self) -> RuntimeParams:
        """The runtime parameters with 0-d views of the block as fields
        (a setter's new value travels with the next frame)."""
        return RuntimeParams(*self.f[F_PARAMS:N_F].unbind(0))

    @property
    def origin(self) -> torch.Tensor:
        return self.i[I_ORIGIN:I_ORIGIN + 3]

    @property
    def origin_mod(self) -> torch.Tensor:
        return self.i[I_ORIGIN_MOD:I_ORIGIN_MOD + 3]

    @property
    def n_points(self) -> torch.Tensor:
        return self.i[I_N_POINTS]


def host_blocks(cfg, *, dt, update_time, sensor_pos, quat,
                params: RuntimeParams, origin, n_points) -> tuple:
    """``(f [N_F] float32, i [N_I] int32)``: one sensor's blocks on the
    host, from the prologue's host values."""
    f = np.zeros(N_F, np.float32)
    f[F_DT] = np.float32(dt)
    f[F_UPDATE_TIME] = np.float32(update_time)
    f[F_SENSOR_POS:F_SENSOR_POS + 3] = np.asarray(sensor_pos, np.float32)
    f[F_QUAT:F_QUAT + 4] = np.asarray(quat, np.float32)
    f[F_R:F_R + 9] = geometry.frame_rotation(quat).ravel()
    f[F_PARAMS:N_F] = [np.float32(getattr(params, n)) for n in PARAM_NAMES]
    o = [int(x) for x in np.asarray(origin)]
    i = np.asarray([*o, o[0] % cfg.nx, o[1] % cfg.ny, o[2] % cfg.nz,
                    int(n_points)], np.int32)
    return f, i


def frame_scalars(cfg, device, *, dt, sensor_pos, quat, update_time=0.0,
                  params: RuntimeParams | None = None, origin=None,
                  n_points: int = 0) -> FrameScalars:
    """One sensor's blocks on ``device`` from host values, for a caller
    that hands a stage (a kernel) the frame's values as the step does:
    ``origin`` defaults to the window origin of ``sensor_pos``, ``params``
    to the configuration's."""
    if origin is None:
        origin = geometry.window_origin_np(sensor_pos, cfg)
    f, i = host_blocks(
        cfg, dt=dt, update_time=update_time, sensor_pos=sensor_pos,
        quat=quat, params=params or RuntimeParams.from_config(cfg),
        origin=origin, n_points=n_points)
    return FrameScalars(torch.from_numpy(f).to(device),
                        torch.from_numpy(i).to(device))


class FrameLayout(NamedTuple):
    """The bytes of ``n`` sensors' frames in one buffer: the float blocks
    ``[n, N_F]``, the int blocks ``[n, N_I]`` and the points ``[n, P,
    3]`` float32 (``P = cfg.max_input_points``; :func:`layout`), each
    4-byte aligned."""

    n: int
    points: int

    @property
    def nbytes(self) -> int:
        return 4 * self.n * (N_F + N_I + 3 * self.points)

    def _parts(self):
        n, P = self.n, self.points
        a, b = n * N_F, n * (N_F + N_I)
        return ((0, a, (n, N_F)), (a, b, (n, N_I)),
                (b, b + 3 * n * P, (n, P, 3)))

    def pack(self, out: np.ndarray, f, i, points) -> None:
        """Write the blocks and the points (``[n, rows, 3]``, rows up to
        ``P``; the rest zero) into ``out``, a uint8 array of
        :attr:`nbytes`."""
        words = out.view(np.int32)
        (f0, f1, _), (i0, i1, _), (p0, p1, pshape) = self._parts()
        words[f0:f1].view(np.float32)[:] = np.asarray(f, np.float32).ravel()
        words[i0:i1] = np.asarray(i, np.int32).ravel()
        pts = words[p0:p1].view(np.float32).reshape(pshape)
        src = np.asarray(points, np.float32).reshape(self.n, -1, 3)
        rows = src.shape[1]
        if rows > self.points:
            raise ValueError(f"{rows} points a frame, the configuration "
                             f"takes at most {self.points}")
        pts[:, :rows] = src
        pts[:, rows:] = 0.0

    def views(self, buf: torch.Tensor) -> tuple:
        """``(f [n, N_F], i [n, N_I], points [n, P, 3])``: views of a uint8
        tensor of :attr:`nbytes` laid out by :meth:`pack`."""
        words = buf.view(torch.int32)
        (f0, f1, fs), (i0, i1, ishape), (p0, p1, ps) = self._parts()
        return (words[f0:f1].view(torch.float32).view(fs),
                words[i0:i1].view(ishape),
                words[p0:p1].view(torch.float32).view(ps))


def layout(cfg, n_sensors: int = 1) -> FrameLayout:
    """The byte layout of a step's frame of ``n_sensors`` cameras."""
    return FrameLayout(n_sensors, cfg.max_input_points)


def stage(layout: FrameLayout, f, i, points, device) -> tuple:
    """The frame on ``device``: the blocks and points packed on the host
    and moved by one copy (from pinned memory, without blocking, to a
    card).  Returns :meth:`FrameLayout.views` of the device buffer."""
    device = torch.device(device)
    host = torch.empty(layout.nbytes, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    layout.pack(host.numpy(), f, i, points)
    buf = host if device.type == "cpu" else host.to(device, non_blocking=True)
    return layout.views(buf)
