"""Profiling hooks (the counterpart of the JAX package's utils/profiling.py).

profile_trace(log_dir) records a torch.profiler trace of the enclosed block
(CPU and, where there is a card, CUDA activities) and writes it as a Chrome
trace file under log_dir.

span(name) marks a stretch of the port's host work, named
ipt.<layer>.<what>: while a torch.profiler session records (profile_trace,
the CLI's --profile, the benchmark's traced runs), it is
record_function(name), which the trace puts on the kernels' timeline;
otherwise it is one check of a Python boolean and a shared no-op context,
with no device operation, synchronisation or allocation.  spanned(name)
wraps a whole function in span(name).

count(name, value) adds the sum of a tensor (or an int) to a tally while a
profiler session records, and marks the trace with the tally's entry
(record_function("ipt.count.<name>#<entry>")); otherwise it is the same
one check as span.  The sum stays on the device: nothing is read back
while the session records.  counted(marks) reads, once, the entries whose
marks a trace holds, so that a reader of one traced run takes that run's
counts alone, however many runs one process traces.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, TypeVar, Union

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

F = TypeVar("F", bound=Callable)

_OFF = contextlib.nullcontext()

COUNT_MARK = "ipt.count."
_tally: Dict[int, Union[torch.Tensor, int]] = {}  # entry -> its sum (int64 scalar or int)
_entries = itertools.count()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the enclosed block into log_dir/trace_<pid>_<ns>.json (open it
    in chrome://tracing or Perfetto) when log_dir is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def span(name: str):
    """A context manager: record_function(name) while a profiler records,
    else a shared no-op.  The flag is torch.autograd.profiler's, set by
    every torch.profiler session for its whole length and read by every
    thread (autograd's backward thread too)."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


def spanned(name: str) -> Callable[[F], F]:
    """Decorator: the function's whole body under span(name)."""

    def wrap(fn: F) -> F:
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return run  # type: ignore[return-value]

    return wrap


def count(name: str, value: Union[torch.Tensor, int]) -> None:
    """While a profiler records: value's sum (a tensor's, as an int64
    scalar on its device) joins the tally as a new entry, and the trace gets
    the mark ipt.count.<name>#<entry>.  Otherwise one check and nothing."""
    if not _profiler._is_profiler_enabled:
        return
    entry = next(_entries)
    _tally[entry] = (value.detach().sum(dtype=torch.int64) if isinstance(value, torch.Tensor)
                     else int(value))
    with record_function(f"{COUNT_MARK}{name}#{entry}"):
        pass


def counted(marks: Iterable[str]) -> Dict[str, int]:
    """{name: sum} of the tally's entries that the trace events `marks`
    (names of count's marks; other names are passed over) point to, read to
    the host; each entry is read once and then dropped."""
    out: Dict[str, int] = {}
    for mark in marks:
        if mark.startswith(COUNT_MARK):
            name, _, entry = mark[len(COUNT_MARK):].rpartition("#")
            value = _tally.pop(int(entry), None)
            if value is not None:
                out[name] = out.get(name, 0) + int(value)
    return out
