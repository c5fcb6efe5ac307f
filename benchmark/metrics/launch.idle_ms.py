"""Idle ms per job of the card charged to the kernel wrappers' spans
(ipt.launch.<wrapper>): their checks, parameters and ctypes launches, and
on the CPU their plain versions.  The rule is benchmark/lib/spans.py's."""

from benchmark.lib.spans import idle_ms


def read(s):
    return idle_ms(s, "launch")
