"""The parallel layer (port of ``vqvae_tpu/parallel/``): meshes over the
ranks of a ``torch.distributed`` world, the multi-process scaffolding,
the mesh side of the train step and the sequence-parallel decoder."""

from vqvae_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
)
