"""Manifest (txt-file) dataset lists: a copy of the JAX package's
``data/manifests.py``.

Mirror of util/utilLoad.py:1-23: each manifest is a text file of relative
image paths resolved against the manifest's directory (with the reference's
special case for 'kfold' manifests living one directory deeper).
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple


def read_manifest(path: str) -> List[str]:
    """GetDirFromText (utilLoad.py:1-8). kfold manifests live one level
    deeper (<root>/kfold*/list.txt); the reference resolves their entries
    against everything BEFORE the first '/kfold' component
    (file_name.rsplit('/kfold', 1)), matched anywhere in the path."""
    norm = path.replace(os.sep, "/")
    if "kfold" in norm:
        base = norm.rsplit("/kfold", 1)[0]
    else:
        base = os.path.dirname(path)
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            out.append(line if os.path.isabs(line) else os.path.join(base, line))
    return out


def get_text_dataset(data_cfg) -> Tuple[List[str], ...]:
    """getTextDataset (utilLoad.py:9-23): returns the 10 lists
    (train colorL/colorR/disp/seg/inst, then the test five)."""

    def rd(p):
        return read_manifest(p) if p else []

    return (
        rd(data_cfg.color_l), rd(data_cfg.color_r), rd(data_cfg.disp),
        rd(data_cfg.seg), rd(data_cfg.inst),
        rd(data_cfg.color_l_test), rd(data_cfg.color_r_test),
        rd(data_cfg.disp_test), rd(data_cfg.seg_test), rd(data_cfg.inst_test),
    )
