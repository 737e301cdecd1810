"""Host/device mirrored buffer — the L0 memory substrate.

Analog of the reference's ``DataBuffer<T>``
(``Assets/_Scripts/DataBuffer.cs:5-76``): a device array paired with a host
numpy mirror and a dirty flag.  ``sync()`` uploads pending host writes
(DataBuffer.cs:56-60), ``get_data()`` downloads (:50-54), and reading an index
lazily downloads first (:32-48).  The constructor's fill-with-initial-value
mode reproduces the sentinel pre-fill the pipeline relies on (keys =
0xFFFFFFFF so padding sorts last, node links = null sentinels;
MeshBufferContainer.cs:108-115).

Here the "upload" is ``jax.device_put`` (optionally with a
``NamedSharding`` so one logical buffer spans a device mesh) and the
"download" is ``np.asarray`` — the SetData/GetData analog pinned down in
SURVEY §5.  The jitted pipeline itself never uses this class (pure functional
arrays are the fast path); it exists for host-driven orchestration, debugging
and incremental scene editing, the same role DataBuffer plays for the C# host.
"""
from __future__ import annotations

from typing import Any

import jax
import numpy as np


class DataBuffer:
    """A device array with a lazily-synchronized host mirror."""

    def __init__(
        self,
        count: int,
        dtype: Any = np.float32,
        shape_suffix: tuple[int, ...] = (),
        initial_value: Any = None,
        sharding: Any = None,
    ):
        self._host = np.zeros((count, *shape_suffix), dtype)
        if initial_value is not None:
            self._host[...] = initial_value
        self._sharding = sharding
        self._device = None
        self._host_dirty = True    # host has writes not yet uploaded
        self._device_dirty = False  # device has results not yet downloaded

    # -- shape/metadata ------------------------------------------------------
    @property
    def count(self) -> int:
        return self._host.shape[0]

    @property
    def dtype(self):
        return self._host.dtype

    @property
    def shape(self) -> tuple[int, ...]:
        return self._host.shape

    # -- transfers (DataBuffer.cs:50-60) --------------------------------------
    def sync(self) -> "DataBuffer":
        """Upload the host mirror to device if it has pending writes."""
        if self._host_dirty or self._device is None:
            self._device = jax.device_put(self._host, self._sharding)
            self._host_dirty = False
            self._device_dirty = False
        return self

    def get_data(self) -> np.ndarray:
        """Download device contents into the host mirror and return it."""
        if self._device_dirty and self._device is not None:
            # np.array (not asarray): device views are read-only; the host
            # mirror must stay writable.
            self._host = np.array(self._device)
            self._device_dirty = False
        return self._host

    @property
    def device_array(self):
        """The device-resident array (uploading first if host is newer)."""
        self.sync()
        return self._device

    def assign_device(self, array) -> "DataBuffer":
        """Point the buffer at a new device result (e.g. a jitted op's output);
        marks the host mirror stale — the lazy-download path of the indexer."""
        if tuple(array.shape) != self._host.shape:
            raise ValueError(f"shape {array.shape} != buffer {self._host.shape}")
        self._device = array
        self._device_dirty = True
        self._host_dirty = False
        return self

    # -- element access (DataBuffer.cs:32-48) ----------------------------------
    def __getitem__(self, idx):
        return self.get_data()[idx]

    def __setitem__(self, idx, value) -> None:
        self.get_data()  # fold in any device results before mutating
        self._host[idx] = value
        self._host_dirty = True

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        state = "host-dirty" if self._host_dirty else (
            "device-dirty" if self._device_dirty else "clean"
        )
        return f"DataBuffer(shape={self._host.shape}, dtype={self.dtype}, {state})"
