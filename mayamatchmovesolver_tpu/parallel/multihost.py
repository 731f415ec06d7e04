"""Multi-host entry point: jax.distributed bootstrap + host-aware mesh.

The reference is single-process (SURVEY.md section 2.3); this is the
multi-host scaling layer it never had, per SURVEY section 7 step 7 and
the BASELINE multi-host target.  Design:

  * `initialize()` wraps jax.distributed.initialize — after it,
    jax.devices() is the GLOBAL device list and collectives cross
    hosts transparently.
  * `host_mesh()` builds a 2-D (hosts, chips) Mesh whose outer axis
    maps to DCN (cross-host network) and inner axis to ICI (the
    on-slice interconnect).  Shard the frame/keyframe-block axis over
    BOTH axes flattened — frame-block reductions are one psum whose
    hierarchical (ICI-then-DCN) lowering XLA performs automatically.
    Keep large, frequent collectives on the inner ('chips') axis and
    let only the small reduced camera system cross 'dcn'.
  * process 0 is the result owner: `gather_to_primary()` pulls
    globally-sharded arrays onto every host (allgather semantics) so
    process 0 can write results; `is_primary()` gates file output.

On CPU test meshes the same code runs with
`jax_cpu_collectives_implementation=gloo` (see
tests/test_parallel/test_multihost.py, which spawns two OS processes).
"""

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None):
    """Bootstrap the multi-process runtime (no-op when single-process).

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    when arguments are omitted — the standard launcher contract.  Safe
    to call unconditionally: with no coordinator configured the process
    stays single-host.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return True


def is_primary():
    """True on the result-owning process (process 0)."""
    return jax.process_index() == 0


def num_hosts():
    return jax.process_count()


def host_mesh(axis_names=("dcn", "chips")):
    """Global 2-D mesh (hosts x local devices).

    The outer axis crosses hosts (the network), the inner axis stays
    on-host (NVLink between the cards of one host).  Requires the same
    local device count on every host.
    """
    devices = jax.devices()
    n_hosts = jax.process_count()
    per_host = len(devices) // n_hosts
    if per_host * n_hosts != len(devices):
        raise ValueError(
            "uneven device distribution: %d devices / %d hosts"
            % (len(devices), n_hosts)
        )
    # jax.devices() is sorted by (process_index, local id).
    grid = np.asarray(devices).reshape(n_hosts, per_host)
    return Mesh(grid, axis_names)


def frame_mesh(axis_name="frames"):
    """1-D global mesh over every device — the frame-block axis used by
    parallel.sharded / parallel.ba_sharded.  On multi-host runs the
    device order keeps each host's chips contiguous, so a blocked frame
    sharding keeps neighboring frame blocks on the same host and the
    psum's hierarchical lowering reduces on-host before crossing the
    network."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def gather_to_primary(x):
    """Replicate a (possibly sharded) array onto every process and
    return it as a host numpy array (process 0 writes results; the
    reference writes solved values back to Maya attrs,
    adjust_base.cpp:297-342)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def sync_hosts(name="barrier"):
    """Cross-host barrier (useful before timing sections)."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
