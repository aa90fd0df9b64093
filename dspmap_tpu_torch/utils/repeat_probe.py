"""Does the step repeat its bits, and which of its ops warn under PyTorch's
deterministic mode?

Run on a machine with a CUDA card, from the root of a checkout::

    python3 -m dspmap_tpu_torch.utils.repeat_probe [flagship large_urban ...]

For each named path (default: the eight single-device paths of
``chip_smoke.py`` that give each camera the sequence's frame -- all but
``multisensor_4cam`` --, at full width, on the synthetic street sequence,
seed 0)
it runs three frames, then

* three frames under ``torch.use_deterministic_algorithms(True,
  warn_only=True)``, recording every warning by source line, and the same
  three frames from the same state with the mode off: the leaves in which
  the two states differ (none: no stage reads memory that the mode fills);
* four frames twice from one state with the same draws: the leaves and the
  outputs in which the two runs differ (none: the step repeats its bits),
  and ``repeat_digest``, a SHA-256 of the first run's last state and
  outputs (two checkouts whose steps give the same bits on these frames
  and draws print the same digest),

and prints one JSON line.  The mode is global, so the probe sets it only
around those three frames.  The probe reads only the package's public
surface, so the same file measures an older checkout when copied into its
``utils/`` and run from its root.  The first line is the card's name and
power limit.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import torch

from .. import (Frame, dsp_dynamic, dsp_dynamic_multi_neighbors, dsp_static,
                example_node_settings, init_multisensor_state, init_state,
                large_urban, make_draws, make_multisensor_draws,
                make_multisensor_step, make_step, stack_frames,
                state_to_numpy)
from . import sim

#: the sensors of each two-camera path
SENSORS = 2


def configs() -> dict:
    """chip_smoke.py's single-device paths: ``name -> (cfg, sensors)``
    (``None``: the single-sensor step)."""
    flagship = example_node_settings(dsp_dynamic())
    return {
        "flagship": (flagship, None),
        "large_urban": (large_urban(), None),
        "static": (example_node_settings(dsp_static()), None),
        "multi": (example_node_settings(dsp_dynamic_multi_neighbors()), None),
        "noisy": (example_node_settings(
            dsp_dynamic(limit_motion_to_xy_plane=False)), None),
        "noisy_compact": (large_urban(limit_motion_to_xy_plane=False), None),
        "multisensor_2cam": (flagship, SENSORS),
        "multisensor_compact": (large_urban(), SENSORS),
    }


def _leaves(state) -> dict:
    out = {}
    for key, value in state_to_numpy(state).items():
        items = value.items() if isinstance(value, dict) else [("", value)]
        for k, v in items:
            out[f"{key}.{k}" if k else key] = np.asarray(v)
    return out


def _differing(a, b) -> list:
    x, y = _leaves(a), _leaves(b)
    return sorted(k for k in x.keys() | y.keys()
                  if k not in x or k not in y or x[k].dtype != y[k].dtype
                  or x[k].shape != y[k].shape
                  or x[k].tobytes() != y[k].tobytes())


def _output_bytes(out) -> dict:
    got = {"weight_sum": out.weight_sum.cpu().numpy().tobytes()}
    got.update({k: torch.as_tensor(v).cpu().numpy().tobytes()
                for k, v in out.metrics.items()})
    return got


def _digest(state, outs) -> str:
    h = hashlib.sha256()
    for k, v in sorted(_leaves(state).items()):
        h.update(k.encode() + str(v.dtype).encode() + v.tobytes())
    for out in outs:
        for k in sorted(out):
            h.update(k.encode() + out[k])
    return h.hexdigest()


def probe(cfg, n_sensors=None, device="cuda", warm=3, watched=3,
          repeated=4) -> dict:
    """One path: ``warm`` frames, ``watched`` frames with deterministic
    mode on and off, ``repeated`` frames twice (the module docstring)."""
    device = torch.device(device)
    frames = [Frame(*f) for f in sim.generate_sequence(
        warm + watched + repeated, cfg, seed=0)]
    gen = torch.Generator(device=device).manual_seed(5)
    if n_sensors is None:
        step = make_step(cfg)
        state = init_state(cfg, seed=0, device=device)

        def draws():
            return make_draws(cfg, gen, device)
    else:
        step = make_multisensor_step(cfg, n_sensors)
        state = init_multisensor_state(cfg, n_sensors, seed=0, device=device)
        frames = [stack_frames([f] * n_sensors) for f in frames]

        def draws():
            return make_multisensor_draws(cfg, n_sensors, gen, device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    for f in frames[:warm]:
        state, _ = step(state, f)
    watch = frames[warm:warm + watched]
    watch_draws = [draws() for _ in watch]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            det = state
            for f, d in zip(watch, watch_draws):
                det, _ = step(det, f, d)
            sync()
    finally:
        torch.use_deterministic_algorithms(False)
    plain = state
    for f, d in zip(watch, watch_draws):
        plain, _ = step(plain, f, d)
    warned = {}
    for w in seen:
        key = (f"{os.path.relpath(w.filename)}:{w.lineno}: "
               f"{str(w.message).splitlines()[0][:160]}")
        warned[key] = warned.get(key, 0) + 1
    rest = frames[warm + watched:]
    rest_draws = [draws() for _ in rest]
    runs = []
    for _ in range(2):
        s, outs = state, []
        for f, d in zip(rest, rest_draws):
            s, o = step(s, f, d)
            outs.append(_output_bytes(o))
        runs.append((s, outs))
    sync()
    (a, outs_a), (b, outs_b) = runs
    return {"det_warnings": warned,
            "det_mode_vs_plain_differing": _differing(det, plain),
            "repeat_leaves_differing": _differing(a, b),
            "repeat_outputs_differing": sorted(
                {k for x, y in zip(outs_a, outs_b) for k in x
                 if x[k] != y[k]}),
            "repeat_digest": _digest(a, outs_a)}


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(configs())
    if not torch.cuda.is_available():
        print("repeat_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    table = configs()
    for name in names:
        cfg, n_sensors = table[name]
        print(json.dumps({"path": name, **probe(cfg, n_sensors)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
