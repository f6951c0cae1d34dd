from .ops import (  # noqa: F401
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
    knn,
    three_interpolate,
    three_nn,
)
