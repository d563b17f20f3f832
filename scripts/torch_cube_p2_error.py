"""P2 discretisation error of the unit cube's Dirichlet-Laplacian
eigenvalues on Kuhn-split ``unit_cube(n)`` meshes, with the port on the CPU.

    python scripts/torch_cube_p2_error.py 8 16

For each n: the four smallest eigenvalues of the port's P2 membrane pencil
(``models.membrane.assemble_membrane_evp``) by scipy's shift-invert
``eigsh``, and their relative errors against 3 pi^2 and 6 pi^2 (a triple).
``chip_smoke.py`` phase 13b bounds the card's 32^3 eigenvalues by the
errors at 16^3 (the P2 error falls as h^4).
"""

import sys

import numpy as np
import scipy.sparse.linalg as spla

from lsafw_tpu_torch.meshing.mesh import unit_cube
from lsafw_tpu_torch.models.membrane import assemble_membrane_evp


def main(sizes) -> None:
    exact = np.pi ** 2 * np.array([3.0, 6.0, 6.0, 6.0])
    for n in sizes:
        K, M, _ = assemble_membrane_evp(unit_cube(n), device="cpu")
        lam = np.sort(spla.eigsh(K.to_scipy(), k=4, M=M.to_scipy(), sigma=20.0,
                                 return_eigenvectors=False))
        rel = np.abs(lam - exact) / exact
        print(f"n={n} dofs={K.shape[0]} lambda={lam.tolist()} rel_err={rel.tolist()}")


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [8, 16])
