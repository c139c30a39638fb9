"""Global scene constants.

Mirrors the reference constants (reference: utils/constant.py:1-43) so cameras,
zoom factors and geometry thresholds produce identical scenes.
"""

CANONICAL_ZOOM_FACTOR = 1000 / 1280  # utils/constant.py:12

DEFAULT_GEO_THRESH = 0.05  # utils/constant.py:17
PERTURB_EPSILON = 0.01  # utils/constant.py:18

NSR_BOUND = 1.6  # utils/constant.py:21

GLOBAL_SEED = 42

# Background augmentation keys (utils/constant.py:25-28)
WHITE_BKG = 0
BLACK_BKG = 1
NOISE_BKG = 2
CHESSBOARD_BKG = 3

# Ratio of (reconstruction) / (smpl mesh) (utils/constant.py:39)
SMPL_SCALE = 0.9

# Camera distances, pre-multiplied by SMPL_SCALE as in the reference
# (utils/constant.py:13-14,35-36,40-43)
CANONICAL_CAMERA_DIST_TRAIN = 2.0 * SMPL_SCALE
CANONICAL_CAMERA_DIST_VAL = 1.6 * SMPL_SCALE
CAN_HEAD_OFFSET = 0.47 * SMPL_SCALE
CAN_HEAD_CAMERA_DIST = 0.5 * SMPL_SCALE
