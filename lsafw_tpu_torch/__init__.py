"""PyTorch / CUDA port of lsafw_tpu: global linear stability analysis of
incompressible flows on an NVIDIA GPU.

This package runs the cylinder leading-eigenpair path of the reference
(``bench.py``'s pipeline): mesh, Taylor-Hood assembly on the device,
ramped Newton baseflow whose steps solve on the device band LU (real,
panel-pivoted) with f64 GCR refinement, linearized eigensystem, and a
shift-invert Krylov-Schur eigensolve on the complex band LU (pivoted
within ``LSAFW_PIVOT_MEM_GB``, else pivot-free) with f64 refinement.
Hand-written CUDA kernels carry every band substitution, pivoted and
pivot-free (``csrc/band_subst.cu``), and the refinement matvecs and the
permutations into and out of the band's order (``csrc/spmv_gather.cu``).
The same kernels carry the adjoint sensitivity (``sensitivity``) and
the non-modal toolbox: resolvent gains and pseudospectra
(``resolvent``) and transient growth by Crank-Nicolson (``transient``,
the Cayley transform on a real factor).  It imports nothing of the JAX
package.  ``solver/direct.py`` keeps host SuperLU for
``linear_solver="lu"`` and the shift-invert ``method="lu"``, which run
only when asked for.

Entry points take ``device=`` and default to ``"cuda"``; they run on
the CPU only when the caller passes ``device="cpu"``.
"""

import torch

# The band factor and its substitution are f32/complex64 preconditioners
# of an f64 refinement.  TF32 (about three decimal digits) would weaken
# the factor's refinement contraction, which on this very operator costs
# 16x when products drop to reduced precision, so every f32 product and
# convolution runs in full f32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on; a CUDA device without a
    usable GPU raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


__all__ = ["resolve_device"]
