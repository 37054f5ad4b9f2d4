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
from .resize import (  # noqa: F401
    avg_pool,
    resize_bilinear,
    resize_nearest,
    upsample_nearest,
)
