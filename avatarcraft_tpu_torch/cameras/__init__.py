from avatarcraft_tpu_torch.cameras.camera import PinholeCamera, intrinsic_matrix
from avatarcraft_tpu_torch.cameras.paths import (
    default_360_path,
    describe_view,
    pose_spherical,
    style_360_path,
)
from avatarcraft_tpu_torch.cameras.rays import (
    camera_rays,
    canonical_camera,
    dataset_rays,
    pose2rays,
    sparse_ray_sampling,
)

__all__ = [
    "PinholeCamera",
    "intrinsic_matrix",
    "pose_spherical",
    "default_360_path",
    "describe_view",
    "style_360_path",
    "camera_rays",
    "pose2rays",
    "canonical_camera",
    "dataset_rays",
    "sparse_ray_sampling",
]
