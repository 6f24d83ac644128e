"""Multi-process bootstrap: consume the env contract the provisioner emits
(port of ``tpu_kubernetes/parallel/distributed.py``).

The provisioner bakes the same keys onto every host
(terraform/modules/files/install_tpu_agent.sh.tpl):

  JAX_COORDINATOR_ADDRESS  host:port of process 0 (the rendezvous)
  JAX_NUM_PROCESSES        hosts
  JAX_PROCESS_ID           this host's index
  TPU_ACCELERATOR_TYPE / TPU_SLICE_TOPOLOGY / TPU_SLICE_NAME
  MEGASCALE_NUM_SLICES / MEGASCALE_SLICE_ID   (multislice)

The reference runs one process per host, which drives every chip of the
host. The port runs one process per card: :func:`initialize` joins
``torch.distributed`` with rank = ``JAX_PROCESS_ID`` × local cards + local
rank and world size = ``JAX_NUM_PROCESSES`` × local cards, over NCCL for
``cuda`` and gloo for ``cpu`` (or the backend the caller names), and
rendezvous at ``JAX_COORDINATOR_ADDRESS`` unless given an ``init_method``.
On one process it is a no-op. The reference's persistent XLA compile
cache has no counterpart: the port's kernels are built once into
``ops/_build.py``'s build directory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class DistributedEnv:
    coordinator_address: str | None
    num_processes: int
    process_id: int
    accelerator_type: str | None
    slice_topology: str | None
    num_slices: int = 1
    slice_id: int = 0

    @property
    def multi_host(self) -> bool:
        return self.num_processes > 1

    @property
    def multi_slice(self) -> bool:
        return self.num_slices > 1


def read_env(env: dict[str, str] | None = None) -> DistributedEnv:
    e = env if env is not None else os.environ
    return DistributedEnv(
        coordinator_address=e.get("JAX_COORDINATOR_ADDRESS"),
        num_processes=int(e.get("JAX_NUM_PROCESSES", "1")),
        process_id=int(e.get("JAX_PROCESS_ID", "0")),
        accelerator_type=e.get("TPU_ACCELERATOR_TYPE"),
        slice_topology=e.get("TPU_SLICE_TOPOLOGY"),
        num_slices=int(e.get("MEGASCALE_NUM_SLICES", "1")),
        slice_id=int(e.get("MEGASCALE_SLICE_ID", "0")),
    )


def backend_for(device: str) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if str(device).startswith("cuda") else "gloo"


def initialize(env: dict[str, str] | None = None, *, device: str = "cuda",
               local_rank: int = 0, local_size: int = 1,
               init_method: str | None = None,
               backend: str | None = None) -> DistributedEnv:
    """Join the process group of ``JAX_NUM_PROCESSES`` × ``local_size``
    ranks as rank ``JAX_PROCESS_ID`` × ``local_size`` + ``local_rank``.
    No-op when that world is one process. ``init_method`` defaults to
    ``tcp://JAX_COORDINATOR_ADDRESS``; ``backend`` to :func:`backend_for`
    ``device``. A failed init raises."""
    import torch.distributed as dist

    denv = read_env(env)
    world = denv.num_processes * local_size
    if world <= 1:
        return denv
    if init_method is None:
        if not denv.coordinator_address:
            raise ValueError(
                f"{world} ranks need a rendezvous: JAX_COORDINATOR_ADDRESS "
                "(host:port of process 0) or an init_method")
        init_method = f"tcp://{denv.coordinator_address}"
    dist.init_process_group(
        backend or backend_for(device), init_method=init_method,
        world_size=world, rank=denv.process_id * local_size + local_rank)
    return denv
