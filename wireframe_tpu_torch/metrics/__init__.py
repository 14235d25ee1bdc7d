from wireframe_tpu_torch.metrics.hausdorff import (  # noqa: F401
    hausdorff_distance_line,
    hausdorff_distance_line_torch,
)
from wireframe_tpu_torch.metrics.ap_calculator import APCalculator  # noqa: F401
from wireframe_tpu_torch.metrics.wed import (  # noqa: F401
    graph_edit_distance,
    compute_edge_indices,
    setdiff_rows,
)
from wireframe_tpu_torch.metrics.rmse import (  # noqa: F401
    aligned_rmse,
    hungarian_rmse,
)
