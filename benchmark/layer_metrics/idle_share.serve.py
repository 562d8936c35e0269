"""Percent of the traced window in which the device ran no operation:
1 − busy / wall, busy being the union of the kernels', copies' and sets'
intervals in the profiler's trace."""

from benchmark.layer_metrics._common import idle_share as read  # noqa: F401
