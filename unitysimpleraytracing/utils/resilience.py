"""Failure detection / recovery helpers (SURVEY §5: the reference has none).

The reference's closest analog is null-sentinel init + a post-build
corruption scan (MeshBufferContainer.cs:114-115,181-195) — detection with no
recovery.  A device deployment has real transient failure modes the host
must survive: preempted devices, a flaky interconnect, and transient XLA
runtime errors.  This module provides

- :func:`device_healthcheck` — a bounded-latency end-to-end device probe
  (compile-free after the first call) that distinguishes "device answering"
  from "device wedged",
- :func:`with_retry` — re-run a step across transient runtime errors with
  exponential backoff (the host-side half of elastic recovery; state lives
  in host/HBM checkpoints — see io/checkpoint for the persistence half).
"""
from __future__ import annotations

import time
from typing import Callable, TypeVar

T = TypeVar("T")

_TRANSIENT_MARKERS = (
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "ABORTED",
    "INTERNAL",
    "RESOURCE_EXHAUSTED",
)


def is_transient(err: Exception) -> bool:
    """Heuristic: does this runtime error look retryable?"""
    s = str(err)
    return any(m in s for m in _TRANSIENT_MARKERS)


def device_healthcheck(timeout_s: float = 30.0) -> bool:
    """True if the default device completes a trivial computation within
    ``timeout_s`` (runs it on a worker thread so a wedged transport cannot
    hang the caller)."""
    import concurrent.futures

    def probe() -> bool:
        import jax
        import jax.numpy as jnp

        x = jnp.ones((8, 128), jnp.float32)
        y = jax.jit(lambda a: (a * 2.0).sum())(x)
        return float(y) == 2048.0

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(probe)
        try:
            return bool(fut.result(timeout=timeout_s))
        except Exception:
            return False


def with_retry(
    fn: Callable[[], T],
    retries: int = 2,
    backoff_s: float = 2.0,
    on_retry: Callable[[int, Exception], None] | None = None,
) -> T:
    """Run ``fn``; on a transient runtime error, back off and retry.

    Non-transient exceptions propagate immediately.  Raises the last error
    after ``retries`` failed retries."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - filtered by is_transient
            if attempt >= retries or not is_transient(e):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_s * (2**attempt))
            attempt += 1
