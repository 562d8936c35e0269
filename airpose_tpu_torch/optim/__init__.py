from .bundle_adjust import (
    BAConfig,
    BAState,
    ba_debug_report,
    bundle_adjust,
    bundle_adjust_sharded,
    export_results,
    init_from_predictions,
    joints_only_forward,
    print_debug_report,
)

__all__ = [
    "BAConfig",
    "BAState",
    "ba_debug_report",
    "bundle_adjust",
    "bundle_adjust_sharded",
    "export_results",
    "init_from_predictions",
    "joints_only_forward",
    "print_debug_report",
]
