"""Device mesh management.

The reference has no distributed backend (NCCL is future work,
PROJECT_SUMMARY.md:271); BASELINE.json's north star requires one.  The
communication layer is ``jax.sharding.Mesh`` + ``shard_map`` with XLA
collectives (NCCL over NVLink on an H100 host) — tables hash-partitioned over a 1-D ``hosts``
axis, shuffles as all-to-all.
"""

from __future__ import annotations

from typing import Optional

from ..utils.jaxenv import ensure_jax

jax = ensure_jax()

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

AXIS = "hosts"


def make_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over available devices (or an explicit subset)."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(
                f"need {num_devices} devices, have {len(devices)} "
                f"({[d.platform for d in devices]})"
            )
        devices = devices[:num_devices]
    import numpy as np

    return Mesh(np.array(devices), (AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Rows sharded across hosts (tables hash/range-partitioned by row)."""
    return NamedSharding(mesh, P(AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (``jax.distributed``) — the NCCL-init analogue.

    No-op in single-process mode."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
