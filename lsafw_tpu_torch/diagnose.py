"""Runtime report of the port: versions, the device, its f64 and
complex128 arithmetic, and the kernel toolchain.

    python -m lsafw_tpu_torch.diagnose          # the CUDA device
    python -m lsafw_tpu_torch.diagnose --cpu    # the arithmetic checks on the CPU

Counterpart of the reference's ``diagnose``.  Without a CUDA device the
report says so and exits 1, unless ``--cpu`` asks for the CPU.  It exits
1 as well where an arithmetic check fails.
"""

from __future__ import annotations

import sys


def _arith(dtype, device) -> str:
    """'ok' where a sum of ``dtype`` tensors on ``device`` keeps its dtype
    and value, else what went wrong."""
    import torch

    try:
        one = torch.ones(4, dtype=dtype, device=device) * (1 + 1j if dtype.is_complex else 1.0)
        s = one + one
        want = 2 + 2j if dtype.is_complex else 2.0
        if s.dtype != dtype or not bool((s == want).all()):
            return f"WRONG ({s.dtype}, {s[0].item()})"
        return "ok"
    except Exception as exc:  # the report names any failure
        return f"unsupported ({type(exc).__name__}: {exc})"


def main(argv: list[str] | None = None) -> int:
    import numpy
    import scipy
    import torch

    import lsafw_tpu_torch
    from lsafw_tpu_torch.utils.cuda_build import BUILD_DIR, nvcc

    cpu = "--cpu" in (sys.argv[1:] if argv is None else argv)
    print(f"python          : {sys.version.split()[0]}")
    print(f"lsafw_tpu_torch : {lsafw_tpu_torch.__version__}")
    print(f"torch           : {torch.__version__}")
    print(f"CUDA (torch)    : {torch.version.cuda}")
    print(f"numpy           : {numpy.__version__}")
    print(f"scipy           : {scipy.__version__}")
    try:
        print(f"nvcc            : {nvcc()}")
    except RuntimeError as exc:
        print(f"nvcc            : not found ({exc})")
    built = sorted(BUILD_DIR.glob("*.so")) if BUILD_DIR.is_dir() else []
    print(f"built kernels   : {len(built)} in {BUILD_DIR}"
          + "".join(f"\n                  {p.name}" for p in built))
    if torch.cuda.is_available():
        device = torch.device("cuda")
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        print(f"device          : {names[0]} (cuda)")
        print(f"devices         : {torch.cuda.device_count()} {names}")
    elif cpu:
        device = torch.device("cpu")
        print("device          : cpu (asked for with --cpu; no CUDA device)")
    else:
        print("device          : none: no CUDA device (torch.cuda.is_available() is False); "
              "pass --cpu for the CPU")
        return 1
    checks = {name: _arith(dt, device) for name, dt in (("float64", torch.float64),
                                                        ("complex128", torch.complex128))}
    for name, result in checks.items():
        print(f"{name:<16}: {result}")
    return 0 if all(r == "ok" for r in checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
