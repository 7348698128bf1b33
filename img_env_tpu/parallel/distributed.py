"""Multi-host mesh initialization.

The reference scales across machines by launching more ROS masters; here one
``jax.distributed`` job owns all hosts and the same [scene, model] mesh spans
every device — XLA runs the collectives (NCCL on GPUs), with no per-step
host involvement (SURVEY.md §5 "Distributed communication").

Usage on each host (give the coordinator address, process count and id
unless the cluster environment supplies them):

    from img_env_tpu.parallel.distributed import initialize, global_mesh
    initialize()                       # no-op on single-host
    mesh = global_mesh(model=1)        # spans all processes' devices
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from img_env_tpu.parallel.mesh import make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """jax.distributed.initialize with env-var fallbacks; returns True when a
    multi-process runtime was started (False = single-host, nothing to do)."""
    num = num_processes if num_processes is not None else int(
        os.environ.get("IMG_ENV_NUM_PROCESSES", "1"))
    if num <= 1 and coordinator_address is None and "COORDINATOR_ADDRESS" not in os.environ:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("COORDINATOR_ADDRESS"),
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(scene: Optional[int] = None, model: int = 1):
    """Mesh over ALL devices of the distributed job (jax.devices() is global).

    Scene shards are laid out host-major so each host's scenes live on its
    local chips: batch construction needs only process-local data
    (jax.make_array_from_process_local_data handles the assembly).
    """
    return make_mesh(scene=scene, model=model, devices=jax.devices())


def process_local_batch(mesh, global_shape, local_array):
    """Assemble a globally-sharded scene batch from per-host local slices."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from img_env_tpu.parallel.mesh import SCENE_AXIS

    sharding = NamedSharding(mesh, P(SCENE_AXIS))
    return jax.make_array_from_process_local_data(
        sharding, local_array, global_shape)
