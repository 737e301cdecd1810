"""Failure-detection/recovery helpers (utils/resilience)."""
import pytest

from unitysimpleraytracing.utils import resilience


def test_healthcheck_on_cpu():
    assert resilience.device_healthcheck(timeout_s=60.0)


def test_with_retry_recovers_from_transient():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("UNAVAILABLE: transport wedged")
        return 42

    seen = []
    out = resilience.with_retry(
        flaky, retries=3, backoff_s=0.01,
        on_retry=lambda i, e: seen.append(i),
    )
    assert out == 42 and calls["n"] == 3 and seen == [0, 1]


def test_with_retry_propagates_non_transient():
    def broken():
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError):
        resilience.with_retry(broken, retries=5, backoff_s=0.01)


def test_with_retry_exhausts():
    def always():
        raise RuntimeError("DEADLINE_EXCEEDED: device stall")

    with pytest.raises(RuntimeError):
        resilience.with_retry(always, retries=1, backoff_s=0.01)
