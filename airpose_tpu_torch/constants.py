"""Constants of the perception chain, the training steps and the serving
wire (copy of airpose_tpu/constants.py:9-50)."""

# Synthetic (AerialPeople) camera model.
FOCAL_LENGTH = (1475.0, 1475.0)
IMG_SIZE = (1920, 1080)  # (W, H)
CX = IMG_SIZE[0] / 2.0
CY = IMG_SIZE[1] / 2.0

# Real (DJI) per-camera intrinsics. The real loss projects with the focal
# lengths; the principal points of the loss come from the calib yml.
REAL_FOCAL_LENGTH0 = (1537.0, 1517.0)
REAL_FOCAL_LENGTH1 = (1361.0, 1378.0)
REAL_CX0, REAL_CY0 = 1018.0, 577.0
REAL_CX1, REAL_CY1 = 978.0, 667.0

NUM_ITERS = 3           # IEF iterations
CROP_SIZE = 224         # network input resolution
TRANS_SCALE = 0.05      # distance scaling of translations in the IEF state

# ImageNet normalization of the crops.
IMG_NORM_MEAN = (0.485, 0.456, 0.406)
IMG_NORM_STD = (0.229, 0.224, 0.225)

# 3D-joint / rotmat limb up-weighting index sets of the losses.
LIMB_JOINTS_3D_L1 = (4, 5, 18, 19)    # knees, elbows     (×w)
LIMB_JOINTS_3D_L2 = (7, 8, 20, 21)    # ankles, wrists    (×w²)
LIMB_ROTMAT_L1 = (3, 4, 17, 18)       # same, shifted by the missing root
LIMB_ROTMAT_L2 = (6, 7, 19, 20)

# Wire format of the 3-step drone sync protocol: 145 float32 =
# 10 betas + 3 trans (pre-scaled by TRANS_SCALE) + 22*6 pose —
# ref copenet_real/scripts/copenet_rosViz.py:83-85.
WIRE_NUM_FLOATS = 145
