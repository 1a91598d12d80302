from etch_tpu_torch.ops.ball_query import ball_query  # noqa: F401
from etch_tpu_torch.ops.fps import fps  # noqa: F401
from etch_tpu_torch.ops.grouping import gather_points, group_points  # noqa: F401
from etch_tpu_torch.ops.interpolate import knn_interpolate  # noqa: F401
from etch_tpu_torch.ops.knn import knn  # noqa: F401
