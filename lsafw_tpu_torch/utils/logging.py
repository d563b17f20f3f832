"""Logging utilities: package loggers, their console set-up and a
wall-clock stage timer."""

from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager
from typing import Iterator


_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def setup_logging(verbose: bool = False) -> None:
    """One console handler (stderr) on the package's root logger
    ``lsafw_tpu_torch``, at INFO (DEBUG with ``verbose``); other loggers
    are left as they are."""
    root = logging.getLogger("lsafw_tpu_torch")
    root.setLevel(logging.DEBUG if verbose else logging.INFO)
    root.handlers.clear()
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(logging.Formatter(_FMT))
    root.addHandler(console)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name if name.startswith("lsafw_tpu_torch") else f"lsafw_tpu_torch.{name}")


@contextmanager
def timed(logger: logging.Logger, label: str) -> Iterator[dict]:
    """Wall-clock stage timer (the reference's perf_counter_ns stage timers,
    ``.examples/cube.py:31-79``); yields a dict that receives ``seconds``."""
    out: dict = {}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out["seconds"] = time.perf_counter() - t0
        logger.info("%s took %.3f s", label, out["seconds"])
