"""Point-cloud ops and the wrappers of the CUDA kernels."""

from cmflow_tpu_torch.ops.pointops import (
    ball_query,
    farthest_point_sample,
    gather_points,
    group_points,
    interpolation_weights,
    knn,
    knn_with_dists,
    masked_square_distance,
    query_and_group,
    square_distance,
    three_interpolate,
    three_nn,
)

__all__ = [
    "ball_query",
    "farthest_point_sample",
    "gather_points",
    "group_points",
    "interpolation_weights",
    "knn",
    "knn_with_dists",
    "masked_square_distance",
    "query_and_group",
    "square_distance",
    "three_interpolate",
    "three_nn",
]
