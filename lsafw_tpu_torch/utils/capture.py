"""Capture of what native code writes to the process's stdout and stderr.

Counterpart of the reference's ``utils.capture``: file descriptors 1
and 2 are redirected into a temporary file for the duration of a block,
and the captured lines are re-emitted through a logger, for native
components (the C++ sparsity builder, CUDA libraries) that write to the
descriptors directly.  The nvcc builds of ``utils.cuda_build`` run as
subprocesses whose output is already captured and raised on failure, so
they do not need it.
"""

from __future__ import annotations

import logging
import os
import tempfile
from contextlib import contextmanager
from typing import Iterator

from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@contextmanager
def capture_c_streams(target_logger: logging.Logger | None = None,
                      level: int = logging.DEBUG) -> Iterator[None]:
    """Redirect fd 1 and 2 into a temporary file while the block runs, then
    log each non-empty captured line at ``level``."""
    target = target_logger or logger
    saved_out, saved_err = os.dup(1), os.dup(2)
    with tempfile.TemporaryFile(mode="w+b") as tmp:
        try:
            os.dup2(tmp.fileno(), 1)
            os.dup2(tmp.fileno(), 2)
            yield
        finally:
            os.dup2(saved_out, 1)
            os.dup2(saved_err, 2)
            os.close(saved_out)
            os.close(saved_err)
            tmp.seek(0)
            for line in tmp.read().decode(errors="replace").splitlines():
                if line.strip():
                    target.log(level, "[captured] %s", line)
