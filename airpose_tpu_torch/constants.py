"""Constants of the perception chain and the synthetic training step (copy of
airpose_tpu/constants.py:9-45)."""

# Synthetic (AerialPeople) camera model.
FOCAL_LENGTH = (1475.0, 1475.0)
IMG_SIZE = (1920, 1080)  # (W, H)
CX = IMG_SIZE[0] / 2.0
CY = IMG_SIZE[1] / 2.0

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
