"""Joint-name tables, detector→SMPL maps, and flip permutations (copy of
airpose_tpu/data/joints.py).

Data-format constants carried over from the reference
(ref copenet/src/copenet/constants.py:28-125): the 49-joint
convention (25 OpenPose + 24 ground-truth joints), the SMPL joint map, the
LSP/H36M selectors, and the left/right flip permutations used for
horizontal-flip augmentation. These are interoperability tables (dataset /
detector contracts), not code.
"""

# 25 OpenPose joints followed by the 24 ground-truth "superset" joints
# (ref constants.py:28-79).
JOINT_NAMES = [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
    "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
    "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee",
    "Left Ankle", "Right Wrist", "Right Elbow", "Right Shoulder",
    "Left Shoulder", "Left Elbow", "Left Wrist", "Neck (LSP)",
    "Top of Head (LSP)", "Pelvis (MPII)", "Thorax (MPII)", "Spine (H36M)",
    "Jaw (H36M)", "Head (H36M)", "Nose", "Left Eye", "Right Eye",
    "Left Ear", "Right Ear",
]

JOINT_IDS = {name: i for i, name in enumerate(JOINT_NAMES)}

# Joint name → SMPL(+extra landmark) index (ref constants.py:84-101).
JOINT_MAP = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17,
    "OP RElbow": 19, "OP RWrist": 21, "OP LShoulder": 16,
    "OP LElbow": 18, "OP LWrist": 20, "OP MidHip": 0,
    "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8,
    "OP LHip": 1, "OP LKnee": 4, "OP LAnkle": 7,
    "OP REye": 25, "OP LEye": 26, "OP REar": 27,
    "OP LEar": 28, "OP LBigToe": 29, "OP LSmallToe": 30,
    "OP LHeel": 31, "OP RBigToe": 32, "OP RSmallToe": 33, "OP RHeel": 34,
    "Right Ankle": 8, "Right Knee": 5, "Right Hip": 45,
    "Left Hip": 46, "Left Knee": 4, "Left Ankle": 7,
    "Right Wrist": 21, "Right Elbow": 19, "Right Shoulder": 17,
    "Left Shoulder": 16, "Left Elbow": 18, "Left Wrist": 20,
    "Neck (LSP)": 47, "Top of Head (LSP)": 48,
    "Pelvis (MPII)": 49, "Thorax (MPII)": 50,
    "Spine (H36M)": 51, "Jaw (H36M)": 52,
    "Head (H36M)": 53, "Nose": 24, "Left Eye": 26,
    "Right Eye": 25, "Left Ear": 28, "Right Ear": 27,
}

# Selectors (ref constants.py:104-110).
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]

# SMPL-X kinematic joint for each of H36M's 17 movable joints, in the
# data/h36m.py H36M_MOVABLE order (Hip, RHip, RKnee, RAnkle, LHip, LKnee,
# LAnkle, Spine, Thorax, Neck, Head, LShldr, LElb, LWri, RShldr, RElb,
# RWri). Name-based correspondence — the released J_regressor_h36m asset
# is not shipped, so torso joints (Spine→spine2, Thorax→spine3) are
# approximate; the joints-supervised loss pelvis-aligns its 3D term so
# bone-offset mismatch cancels to first order.
SMPLX_TO_H36M17 = (0, 2, 5, 8, 1, 4, 7, 6, 9, 12, 15, 16, 18, 20, 17, 19, 21)
J24_TO_J17 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17]
J24_TO_J14 = J24_TO_J17[:14]

# Left/right flip permutations (ref constants.py:113-125).
SMPL_JOINTS_FLIP_PERM = [
    0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19, 18,
    21, 20, 23, 22,
]
SMPL_POSE_FLIP_PERM = [
    3 * i + c for i in SMPL_JOINTS_FLIP_PERM for c in (0, 1, 2)
]
J24_FLIP_PERM = [
    5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 15, 16, 17, 18, 19,
    21, 20, 23, 22,
]
J49_FLIP_PERM = [
    0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15, 18, 17, 22,
    23, 24, 19, 20, 21,
] + [25 + i for i in J24_FLIP_PERM]
