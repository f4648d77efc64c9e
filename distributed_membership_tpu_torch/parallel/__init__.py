"""The node-axis mesh of the sharded backend (the JAX package's
``parallel/``): :class:`~distributed_membership_tpu_torch.parallel.mesh.LocalMesh`
holds every shard on one device."""

from distributed_membership_tpu_torch.parallel.mesh import (  # noqa: F401
    LocalMesh, mesh_shape)
