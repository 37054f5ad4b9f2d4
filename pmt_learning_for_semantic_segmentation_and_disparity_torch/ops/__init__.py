from .correlation import (  # noqa: F401
    correlation,
    correlation1d_cuda,
    correlation2d_cuda,
    correlation_plain,
)
from .resize import (  # noqa: F401
    avg_pool,
    resize_bilinear,
    resize_nearest,
    upsample_nearest,
)
