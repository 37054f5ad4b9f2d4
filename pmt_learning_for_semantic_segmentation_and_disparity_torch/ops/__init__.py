from .correlation import (  # noqa: F401
    correlation,
    correlation1d_backward_cuda,
    correlation1d_cuda,
    correlation1d_vjp_plain,
    correlation2d_backward_cuda,
    correlation2d_cuda,
    correlation2d_vjp_plain,
    correlation_plain,
)
from .costvolume import concat_cost_volume, soft_argmin, upsampled_soft_argmin  # noqa: F401
from .resize import (  # noqa: F401
    adaptive_avg_pool,
    avg_pool,
    resize_bilinear,
    resize_bilinear_align_corners,
    resize_nearest,
    upsample_nearest,
)
from .warp import apply_disparity  # noqa: F401
