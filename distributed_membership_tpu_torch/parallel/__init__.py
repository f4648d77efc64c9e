"""The node-axis mesh of the sharded backends (the JAX package's
``parallel/``): :class:`~distributed_membership_tpu_torch.parallel.mesh.LocalMesh`
holds every shard on one device, and ``collectives`` combines the dense
sharded step's per-shard partials on it."""

from distributed_membership_tpu_torch.parallel.mesh import (  # noqa: F401
    LocalMesh, mesh_shape)
