"""The port's profiling helpers (``dspmap_tpu_torch/utils/profiling.py``) on
the CPU: ``force_sync`` and ``timed_steps`` around a CPU step, ``trace``
writing a gzipped Chrome trace, and ``summarize_device_trace`` on a small
hand-written trace whose sums are known."""

import dataclasses
import gzip
import json
import os

import numpy as np
import pytest
import torch

import dspmap_tpu_torch as T
from dspmap_tpu_torch.io.replay import TINY
from dspmap_tpu_torch.utils import profiling, sim

torch.set_num_threads(2)


@dataclasses.dataclass
class _Box:
    label: str
    value: torch.Tensor


def test_force_sync_reads_the_first_tensor():
    x = torch.tensor([[2.5, 1.0], [3.0, 4.0]])
    assert profiling.force_sync(x) == 2.5
    assert profiling.force_sync((None, x.T + 1)) == 3.5
    assert profiling.force_sync({"a": "text", "b": [x * 2]}) == 5.0
    assert profiling.force_sync(_Box("b", x - 1)) == 1.5
    with pytest.raises(TypeError):
        profiling.force_sync({"a": np.zeros(3)})


def test_timed_steps_on_a_cpu_step():
    """One wall time a frame with ``sync_every=1``; one a pair of frames
    with ``sync_every=2``; the state is the step's after every frame."""
    cfg = T.example_node_settings(T.dsp_dynamic(**TINY))
    frames = [T.Frame(*f) for f in sim.generate_sequence(4, cfg, seed=0)]
    step = T.make_step(cfg)
    out_a = profiling.force_sync(step(T.init_state(cfg, device="cpu"),
                                      frames[0])[1])
    assert out_a >= 0.0
    state, walls = profiling.timed_steps(step, T.init_state(cfg, device="cpu"),
                                         frames)
    assert len(walls) == 4 and all(w > 0 for w in walls)
    assert state.update_counter == 4
    state2, walls2 = profiling.timed_steps(
        step, T.init_state(cfg, device="cpu"), frames, sync_every=2)
    assert len(walls2) == 2
    assert torch.equal(state.particles.weight, state2.particles.weight)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "logs")):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = list((tmp_path / "logs").glob("*" + profiling.TRACE_SUFFIX))
    assert len(files) == 1
    with gzip.open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert not list((tmp_path / "logs").glob("*.json"))
    # no device event on the CPU: an empty summary
    assert profiling.summarize_device_trace(str(tmp_path / "logs")) == []


def _event(cat, name, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": 0, "dur": dur,
            "args": args}


def _write(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_summarize_device_trace_sums_by_op_and_kernel(tmp_path):
    """Device events (kernels, copies, sets) joined to their ops through
    the runtime call's correlation id, or the event's own external id;
    host events ignored; longest first; ``top`` cuts; the newest file
    wins."""
    events = [
        _event("cpu_op", "aten::add", 30.0, **{"External id": 1}),
        _event("cpu_op", "aten::copy_", 12.0, **{"External id": 2}),
        _event("cuda_runtime", "cudaLaunchKernel", 5.0, correlation=10,
               **{"External id": 1}),
        _event("cuda_runtime", "cudaLaunchKernel", 5.0, correlation=11,
               **{"External id": 1}),
        _event("cuda_runtime", "cudaMemcpyAsync", 5.0, correlation=12,
               **{"External id": 2}),
        _event("kernel", "add_kernel", 250.0, correlation=10),
        _event("kernel", "add_kernel", 150.0, correlation=11),
        _event("gpu_memcpy", "Memcpy HtoD", 40.0, correlation=12),
        _event("kernel", "occupancy_tile_kernel<18, 4>", 70.0,
               correlation=99),
        _event("gpu_memset", "Memset", 1.5, correlation=13,
               **{"External id": 2}),
        _event("python_function", "step", 900.0),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0,
         "args": {}},
    ]
    old = tmp_path / f"1{profiling.TRACE_SUFFIX}"
    _write(old, [_event("kernel", "stale", 1.0)])
    os.utime(old, ns=(10**9, 10**9))
    _write(tmp_path / f"2{profiling.TRACE_SUFFIX}", events)
    rows = profiling.summarize_device_trace(str(tmp_path))
    assert rows == [(0.4, "aten::add", "add_kernel"),
                    (0.07, "?", "occupancy_tile_kernel<18, 4>"),
                    (0.04, "aten::copy_", "Memcpy HtoD"),
                    (0.0015, "aten::copy_", "Memset")]
    assert profiling.summarize_device_trace(str(tmp_path), top=2) == rows[:2]
    with pytest.raises(FileNotFoundError):
        profiling.summarize_device_trace(str(tmp_path / "none"))
