"""Joint tables (copy of airpose_tpu/data/joints.py:54-61, the part the
losses use)."""

# SMPL-X kinematic joint for each of H36M's 17 movable joints, in the
# H36M_MOVABLE order (Hip, RHip, RKnee, RAnkle, LHip, LKnee, LAnkle, Spine,
# Thorax, Neck, Head, LShldr, LElb, LWri, RShldr, RElb, RWri). Name-based:
# the torso joints (Spine → spine2, Thorax → spine3) are approximate, so the
# joints-supervised loss pelvis-aligns its 3D term.
SMPLX_TO_H36M17 = (0, 2, 5, 8, 1, 4, 7, 6, 9, 12, 15, 16, 18, 20, 17, 19, 21)
