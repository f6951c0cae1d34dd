from .ops import (  # noqa: F401
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
    knn,
    three_interpolate,
    three_nn,
)
from .paconv import assign_score_withk  # noqa: F401
