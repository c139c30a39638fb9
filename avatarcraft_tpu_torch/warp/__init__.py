from avatarcraft_tpu_torch.warp.warp import (
    WarpData,
    build_vertex_face_table,
    closest_point_on_triangles,
    geometry_guided_near_far,
    make_warp_fn,
    warp_samples_to_canonical,
)

__all__ = [
    "WarpData",
    "build_vertex_face_table",
    "closest_point_on_triangles",
    "geometry_guided_near_far",
    "make_warp_fn",
    "warp_samples_to_canonical",
]
