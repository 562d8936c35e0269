"""One reader per per-layer metric, ``<metric>.py`` with ``read(r) → float |
None``: ``r.ctx`` is the run's context, ``r.trace`` the traced window and
``r.window`` the measured one. A reader that finds nothing returns None,
and the metric is left out of the result."""
