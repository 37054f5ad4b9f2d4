from .step import compute_metrics, make_forward_fn  # noqa: F401
