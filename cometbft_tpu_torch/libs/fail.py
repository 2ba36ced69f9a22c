"""Fail points: deterministic crash injection for recovery testing
(reference: ``internal/fail/fail.go``).

Counterpart of ``cometbft_tpu/libs/fail.py``: the ``CMT_FAIL_INDEX``
environment variable names the Nth call to :func:`fail_point` at which
the process dies with exit code 38.  Unarmed, a call is a no-op."""

from __future__ import annotations

import os
import sys

__all__ = ["ENV_VAR", "EXIT_CODE", "fail_point", "labels_seen"]

ENV_VAR = "CMT_FAIL_INDEX"
EXIT_CODE = 38              # "killed by fail point"

_index = int(os.environ.get(ENV_VAR, "-1"))
_counter = 0
_labels: list[str] = []


def fail_point(label: str) -> None:
    """Die hard (``os._exit``: no cleanup, no flushing, like a real crash)
    when this is the ``CMT_FAIL_INDEX``-th call in the process."""
    if _index < 0:
        return
    global _counter
    _labels.append(label)
    my_idx = _counter
    _counter += 1
    if my_idx == _index:
        print(f"FAIL POINT {my_idx} ({label}): crashing",
              file=sys.stderr, flush=True)
        os._exit(EXIT_CODE)


def labels_seen() -> list[str]:
    return list(_labels)
