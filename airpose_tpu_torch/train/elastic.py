"""Elastic / preemption handling (copy of airpose_tpu/train/elastic.py).

Replicates the reference's cluster fault-tolerance semantics (SURVEY.md
§2.10): a wall-clock deadline from --time_to_run; when exceeded, save a
final checkpoint and exit with code 3 so the scheduler's
on_exit_hold/periodic_release cycle requeues the job (ref
copenet_real/copenet_trainer_cluster.py:44-60, is_cluster_mixedmap.py:56-59);
on restart, auto-resume from the saved state (ref copenet_trainer.py:49-53).
KeyboardInterrupt also checkpoints before exiting (ref
copenet_trainer.py:64-74).
"""

import sys
import time
from typing import Optional

CHECKPOINT_EXIT_CODE = 3  # the requeue-me exit code the scheduler watches


class DeadlineGuard:
    def __init__(self, time_to_run_s: Optional[float] = None):
        self.start = time.monotonic()
        self.budget = time_to_run_s

    def expired(self) -> bool:
        return self.budget is not None and (
            time.monotonic() - self.start
        ) > self.budget

    def checkpoint_and_exit(self, ckpt_manager, state):
        """Save `last` and exit with the requeue code."""
        ckpt_manager.save(state, "last")
        sys.exit(CHECKPOINT_EXIT_CODE)


def run_with_preemption_handling(loop_fn, ckpt_manager, get_state):
    """Run `loop_fn()`; on KeyboardInterrupt checkpoint current state and
    exit cleanly (reference's interrupted-training behavior)."""
    try:
        return loop_fn()
    except KeyboardInterrupt:
        ckpt_manager.save(get_state(), "last")
        print("interrupted: checkpoint saved", file=sys.stderr)
        raise SystemExit(1)
