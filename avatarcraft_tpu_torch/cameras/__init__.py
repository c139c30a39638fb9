from avatarcraft_tpu_torch.cameras.camera import PinholeCamera, intrinsic_matrix
from avatarcraft_tpu_torch.cameras.paths import (
    default_360_path,
    describe_view,
    pose_spherical,
)
from avatarcraft_tpu_torch.cameras.rays import (
    camera_rays,
    canonical_camera,
    dataset_rays,
    pose2rays,
)

__all__ = [
    "PinholeCamera",
    "intrinsic_matrix",
    "pose_spherical",
    "default_360_path",
    "describe_view",
    "camera_rays",
    "pose2rays",
    "canonical_camera",
    "dataset_rays",
]
