"""Structured metrics logging (JSONL) and PSNR (the counterpart of the JAX
package's utils/metrics.py; numpy only).

The reference's observability is `print(epoch//1000, loss)` (ipt.py:121).
Here a training or render step can emit a JSON line with step, loss, PSNR
and rays/s.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

import numpy as np


def psnr(a, b, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None):
        self._fh = open(path, "a") if path else None
        self._stream = stream if stream is not None else sys.stderr
        self._t0 = time.time()

    def log(self, **kv) -> None:
        kv.setdefault("t", round(time.time() - self._t0, 3))
        line = json.dumps(kv)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._stream:
            print(line, file=self._stream, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
