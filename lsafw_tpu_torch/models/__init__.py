"""models layer of the PyTorch port: the physics assemblers (flow, solid,
membrane, DG) composed from the batched element kernels of
:mod:`lsafw_tpu_torch.fem.assembly`."""

from lsafw_tpu_torch.models.elasticity import ElasticityEigenAssembler

__all__ = ["ElasticityEigenAssembler"]
