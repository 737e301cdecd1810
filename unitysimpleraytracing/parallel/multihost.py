"""Multi-host distributed setup (jax.distributed over ICI + DCN).

The reference is single-GPU/single-process (SURVEY §2: no communication
backend at all); this module is the cross-host half of the new parallel layer:
process-group initialization and host-aware mesh construction, so the same
``parallel/dist.py`` shard_map programs run unchanged across a multi-host pod
slice — intra-slice collectives ride ICI, cross-host legs ride DCN.

Layout policy: the ``tp`` (Morton-range) axis is placed along devices WITHIN
a host first, and ``dp`` spans hosts — the ring ray-exchange's ppermute then
rides ICI while only the embarrassingly-parallel ray-batch split crosses DCN
(the axis ordering rule of the scaling playbook: put the chatty axis on the
fast interconnect).

Single-process environments (tests, one card) skip initialization
and degrade to the local device set, so all code paths stay exercisable.
"""
from __future__ import annotations

import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed if a multi-process environment is configured.

    With no arguments, relies on the cluster environment (standard env
    vars) as ``jax.distributed.initialize`` does.  Returns True
    if a multi-process group was initialized, False for single-process.
    """
    import jax

    if num_processes is not None and num_processes <= 1:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return jax.process_count() > 1
    except (RuntimeError, ValueError):
        # Already initialized, or single-process environment without cluster
        # metadata — both mean "proceed single-process".
        return False


def make_host_mesh(tp_per_host: int | None = None, devices=None) -> Mesh:
    """(dp, tp) mesh with tp packed inside each host and dp spanning hosts.

    ``tp_per_host=None`` uses all local devices per host for tp (dp = number
    of hosts); otherwise tp = tp_per_host and dp absorbs the rest.
    """
    import jax

    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    local = jax.local_device_count()
    tp = local if tp_per_host is None else tp_per_host
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    # jax.devices() orders by process then local id, so a (dp, tp) reshape
    # with tp minor keeps each tp group within one host.
    grid = np.asarray(devices).reshape(n // tp, tp)
    return Mesh(grid, ("dp", "tp"))


def host_shard_bounds(n_items: int, num_hosts: int, host_id: int) -> tuple[int, int]:
    """Contiguous [lo, hi) range of items owned by ``host_id`` (per-host
    scene ingest: each host loads only its Morton range of triangles)."""
    per = -(-n_items // num_hosts)
    lo = min(host_id * per, n_items)
    return lo, min(lo + per, n_items)
