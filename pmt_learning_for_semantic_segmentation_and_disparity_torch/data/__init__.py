from .manifests import read_manifest, get_text_dataset  # noqa: F401
from .datasets import (  # noqa: F401
    StereoSegDataset,
    ClassBalancer,
    build_datasets,
    normalization_for,
)
from .augment import RandomCropAugment, color_jitter_pair  # noqa: F401
from .labels import (  # noqa: F401
    img_id2train_id,
    roses_one_hot,
    garden_one_hot,
    decode_segmap,
    CITYSCAPES_LABELS,
)
from .pipeline import DataLoader, pad_to_bucket, prefetch_to_device, prefetch_to_mesh  # noqa: F401
from .synthetic import (  # noqa: F401
    apply_fixture_to_config,
    make_cityscapes_fixture,
    make_roses_fixture,
)
from . import imageio, png  # noqa: F401
