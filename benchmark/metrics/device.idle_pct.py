"""Share of the traced window in which no device operation ran: 1 - (union
of device operation intervals / window), in %."""


def read(s):
    return 100.0 * (1.0 - s.busy_s / s.window_s) if s.window_s > 0 else None
