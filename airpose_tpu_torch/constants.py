"""Constants of the perception chain (copy of airpose_tpu/constants.py:9-33)."""

# Synthetic (AerialPeople) camera model.
FOCAL_LENGTH = (1475.0, 1475.0)
IMG_SIZE = (1920, 1080)  # (W, H)
CX = IMG_SIZE[0] / 2.0
CY = IMG_SIZE[1] / 2.0

NUM_ITERS = 3           # IEF iterations
CROP_SIZE = 224         # network input resolution
TRANS_SCALE = 0.05      # distance scaling of translations in the IEF state
