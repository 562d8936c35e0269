from .metrics import (canonical_joints, h36m_eval_metrics, mpe, mpjpe, pa_mpjpe,
                      procrustes_align, twoview_eval_metrics)

__all__ = ["canonical_joints", "h36m_eval_metrics", "mpe", "mpjpe", "pa_mpjpe",
           "procrustes_align", "twoview_eval_metrics"]
