"""Profiling and memory observability (port of
``kvpress_tpu/utils/profiling.py``): ``torch.profiler`` traces in place of
``jax.profiler``, the caching allocator's counters in place of a JAX
device's ``memory_stats``, and the kernel libraries' build directory in
place of XLA's persistent compilation cache."""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

import torch

from ..device import DeviceLike


def _device(device: Optional[DeviceLike]) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None, device: Optional[DeviceLike] = None):
    """Record a ``torch.profiler`` trace of the block, viewable in
    TensorBoard or Perfetto (Chrome trace JSON, ``*.pt.trace.json``, written
    under ``log_dir``; by default ``kvpress_tpu_torch_trace`` in the
    temporary directory). CPU activity is recorded, and CUDA activity when
    ``device`` (by default the card if there is one) is CUDA. Yields
    ``log_dir``::

        with profile_trace("trace"):
            runner.prefill(params, ids)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "kvpress_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if _device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def memory_stats(device: Optional[DeviceLike] = None) -> dict:
    """The device's memory counters under the JAX names callers read:
    ``bytes_in_use`` (``torch.cuda.memory_allocated``), ``peak_bytes_in_use``
    (``max_memory_allocated``) and ``bytes_limit`` (the card's memory). On
    the CPU, ``{}``, as JAX's CPU backend gives."""
    d = _device(device)
    if d.type != "cuda":
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(d),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(d),
            "bytes_limit": torch.cuda.get_device_properties(d).total_memory}


def enable_compile_cache(path: Optional[str] = None, min_compile_secs: float = 0.5) -> None:
    """Keep the hand-written kernels' libraries (``ops._build``) under
    ``path`` (by default ``kvpress_tpu_torch_kernels`` in the temporary
    directory), so that processes that share it build each kernel once: a
    library is named by a hash of its sources and flags, and an unchanged one
    is loaded as it is. Call before the first kernel launch.

    ``min_compile_secs`` is kept for the JAX signature and has no
    counterpart: every build is cached, whatever it took."""
    from ..ops import _build

    path = path or os.path.join(tempfile.gettempdir(), "kvpress_tpu_torch_kernels")
    os.makedirs(path, exist_ok=True)
    _build.set_build_dir(path)
