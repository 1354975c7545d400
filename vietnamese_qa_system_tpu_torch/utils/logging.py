"""Host-side logging: ``get_logger``, ``dist_print`` and ``in_notebook``.

The port's copy of ``vietnamese_qa_system_tpu/utils/logging.py``.  The
process index comes from ``core/distributed.py`` (``torch.distributed``'s
rank, 0 without a process group), so asking for it initialises no device
runtime: a logger made at import time stays inert.
"""

from __future__ import annotations

import logging
import sys

from ..core.distributed import process_index


def dist_print(*args, **kwargs) -> None:
    """Print only on process 0."""
    if process_index() == 0:
        print(*args, **kwargs)


class _Rank0InfoFilter(logging.Filter):
    """Non-zero processes drop records below WARNING."""

    def filter(self, record: logging.LogRecord) -> bool:
        return record.levelno >= logging.WARNING or process_index() == 0


def get_logger(name: str = "vqa_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(asctime)s [p%(process)d] %(levelname)s %(name)s: %(message)s"))
        handler.addFilter(_Rank0InfoFilter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def in_notebook() -> bool:
    """True when running inside IPython / Jupyter."""
    try:
        from IPython import get_ipython  # type: ignore

        ip = get_ipython()
        return ip is not None and "IPKernelApp" in ip.config
    except Exception:
        return False
