"""Tracing / profiling subsystem.

The reference has **no** observability — no timers, no profiler markers
(SURVEY §5: grep over Assets/_Scripts finds none); its only instrument is
``Debug.Log`` array dumps.  This module adds wall-time measurement over an
asynchronous device, JAX profiler trace capture, and roofline accounting
for the three hot operators (sort, build, traverse) against the published
peaks of the device the run is on (`device_peaks`).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import jax
import numpy as np

# Published peaks per ``jax.devices()[0].device_kind``: NVIDIA H100 SXM5
# data sheet (dense rates, at the 700 W power limit): 3.35 TB/s HBM3,
# 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s bf16 tensor.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbytes_s": 3350.0, "f32_gflops": 67_000.0, "bf16_gflops": 989_000.0,
    },
}


def device_peaks(device_kind: str | None = None) -> dict:
    """Published peaks of ``device_kind`` (default: the first JAX device).
    A device missing from `PEAKS` is an error, not a default."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def _timed_reps(fn, reps: int) -> float:
    t0 = time.perf_counter()
    r = None
    for _ in range(reps):
        r = fn()
    jax.block_until_ready(r)
    return time.perf_counter() - t0


def measure(fn, iters: int = 5, warmup: int = 2, reps: int = 8) -> float:
    """Median steady-state seconds per call of ``fn``, slope-timed:
    ``(time(reps) - time(1)) / (reps - 1)`` cancels the per-call fixed
    overhead of dispatch and synchronisation."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    slopes = []
    for _ in range(iters):
        t1 = _timed_reps(fn, 1)
        tn = _timed_reps(fn, reps)
        slopes.append((tn - t1) / (reps - 1))
    return max(float(np.median(slopes)), 1e-9)


def measure_interleaved(
    fns: dict, iters: int = 5, warmup: int = 1, reps: int = 4
) -> dict:
    """Compare variants in round-robin rounds (one amortized sample per
    variant per round), so a slow stretch of the machine hits every variant
    alike.  Returns ``{name: (median_s, min_s, samples)}``."""
    for fn in fns.values():
        for _ in range(warmup):
            jax.block_until_ready(fn())
    samples: dict = {k: [] for k in fns}
    for _ in range(iters):
        for k, fn in fns.items():
            samples[k].append(_timed_reps(fn, reps) / reps)
    return {
        k: (max(float(np.median(v)), 1e-9), max(min(v), 1e-9), v)
        for k, v in samples.items()
    }


@dataclass
class OpStats:
    name: str
    seconds: float
    bytes_accessed: int = 0
    flops: int = 0

    def gbytes_per_s(self) -> float:
        return self.bytes_accessed / self.seconds / 1e9

    def gflops_per_s(self) -> float:
        return self.flops / self.seconds / 1e9

    def roofline_fraction(self, peak_gbytes_s: float, peak_gflops: float) -> float:
        """Achieved fraction of the roofline bound for the given peaks
        (`device_peaks` has the published ones)."""
        t_mem = self.bytes_accessed / (peak_gbytes_s * 1e9)
        t_flop = self.flops / (peak_gflops * 1e9)
        bound = max(t_mem, t_flop)
        return bound / self.seconds if self.seconds > 0 else 0.0


class Profiler:
    """Collects named operator timings; optionally wraps a JAX profiler trace.

    >>> prof = Profiler()
    >>> with prof.op("build", bytes_accessed=scene_bytes):
    ...     bvh = build_bvh(scene); prof.sync(bvh)
    >>> print(prof.report())
    """

    def __init__(self):
        self.stats: list[OpStats] = []

    @contextlib.contextmanager
    def op(self, name: str, bytes_accessed: int = 0, flops: int = 0):
        t0 = time.perf_counter()
        yield
        self.stats.append(
            OpStats(name, time.perf_counter() - t0, bytes_accessed, flops)
        )

    def sync(self, x) -> None:
        jax.block_until_ready(x)

    def report(self) -> str:
        lines = [f"{'op':<24}{'ms':>10}{'GB/s':>10}{'GFLOP/s':>10}"]
        for s in self.stats:
            lines.append(
                f"{s.name:<24}{s.seconds*1e3:>10.3f}"
                f"{s.gbytes_per_s():>10.2f}{s.gflops_per_s():>10.2f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a JAX/XLA profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# Roofline byte/FLOP models for the three hot operators --------------------

def sort_bytes(n: int, passes: int = 4) -> int:
    """LSD radix sort traffic: each pass reads+writes keys and values (4 B
    each) plus histogram traffic (negligible)."""
    return passes * (2 * 4 + 2 * 4) * n


def build_bytes(n: int) -> int:
    """LBVH build: sort + topology reads (codes) + refit (node AABBs, ~levels
    passes over 32 B/node) — a coarse lower bound."""
    depth = max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1)
    return sort_bytes(n) + n * 4 * 3 + depth * (n * 32)


def traverse_bytes(n_rays: int, mean_records: float, record_bytes: int = 256) -> int:
    """Per-ray traversal traffic upper bound: rays in + hits out, plus one
    record fetch per visited record per ray (caches absorb the shared top
    of the tree, so this over-counts device-memory bytes)."""
    return n_rays * (8 * 4 + 4 * 4) + int(n_rays * mean_records) * record_bytes
