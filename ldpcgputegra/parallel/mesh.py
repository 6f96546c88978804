"""Device mesh construction and multi-host init."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = [
    "decode_mesh",
    "decode_mesh_2d",
    "initialize_distributed",
    "local_batch_size",
]

BATCH_AXIS = "dp"
TP_AXIS = "tp"


def decode_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """1-D mesh over the codeword-batch (data-parallel) axis.

    Decoding has no model state, so a single ``dp`` axis is the natural
    mesh; intra-codeword (block-row) sharding for giant codes gets its own
    axis when needed.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (BATCH_AXIS,))


def decode_mesh_2d(
    dp: int,
    tp: int,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """2-D ``(dp, tp)`` mesh: codeword batch over ``dp``, each codeword's
    Tanner graph block-row-sharded over ``tp`` (``parallel.rowshard``).

    The production topology for the giant DVB-S2 codes: tp moves
    ``deg x Z x B`` ints per layer, dp only counters.  The cards of one
    host are joined all to all (NVLink), so the mesh follows the
    algorithm alone: any ``dp x tp`` split of the devices in order.
    """
    if devices is None:
        devices = jax.devices()
    assert len(devices) >= dp * tp, (
        f"need {dp * tp} devices for a {dp}x{tp} mesh, have {len(devices)}"
    )
    arr = np.asarray(devices[: dp * tp]).reshape(dp, tp)
    return Mesh(arr, (BATCH_AXIS, TP_AXIS))


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Multi-host bring-up (jax.distributed); no-op for single process.

    The reference has no distributed backend at all (SURVEY §5.8); this is
    the multi-process replacement for its multi-stream host threading.
    ``local_device_ids`` gives this process its own card(s) when several
    processes share one host.
    """
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.devices.size
    assert global_batch % n == 0, (
        f"global batch {global_batch} not divisible by {n} devices"
    )
    return global_batch // n
