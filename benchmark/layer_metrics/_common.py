"""Arithmetic the per-layer readers share."""

from typing import Optional

from ..roofline import peaks


def idle_share(r) -> float:
    """Percent of the traced window in which no device operation ran."""
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)


def span_ms(r, span: str) -> Optional[float]:
    """Device ms a traced step of the operations launched inside ``span``;
    None where the span launched nothing."""
    ops = r.trace.in_span(span)
    return r.trace.device_s(ops) * 1e3 / r.trace.units if ops else None


def mfu(r, ops_by_precision) -> float:
    """Percent: the least time of a step's required work at the peaks, over
    the measured window's time a step."""
    return 100.0 * peaks.least_seconds(ops_by_precision) / (r.window.seconds / r.window.units)
