"""Multi-device parallelism: the subdomain batch sharded over the
process's devices (PyTorch port of ``splashsurf_tpu.parallel``)."""

from splashsurf_tpu_torch.parallel.mesh import (
    make_mesh,
    sharded_levelset_step,
    sharded_reconstruction_demo,
)

__all__ = ["make_mesh", "sharded_levelset_step", "sharded_reconstruction_demo"]
