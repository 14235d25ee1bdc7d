"""`.xyz` LiDAR point-cloud ingest.

File format (reference README.md:40-55): whitespace-separated rows of
``X Y Z R G B A Intensity`` floats.  The port parses with ``np.loadtxt``
only; the JAX package's C++ fast parser (`wireframe_tpu/io/native`) is
not copied yet (ROADMAP queue A).  Both give identical float64 arrays.
"""

from __future__ import annotations

import numpy as np


def read_xyz(path: str) -> np.ndarray:
    """Read an .xyz file into an (N, C) float64 array.

    C is inferred from the first row (8 for the Building3D corpus).
    """
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


def select_features(pc: np.ndarray, use_color: bool, use_intensity: bool,
                    scale_intensity: bool = False) -> np.ndarray:
    """Channel selection + color scaling.

    Matches datasets/building3d.py:102-111: RGBA divided by 256 and — when
    `scale_intensity=False` — the raw intensity column left unscaled
    (SURVEY.md §7 quirk 3).  `scale_intensity=True` (the framework
    default via DataConfig.scale_intensity) divides by 2^16, the 16-bit
    LiDAR range.  The reference's `use_intensity and not use_color` branch
    crashes on a 1-D concatenate (building3d.py:108); fixed here (quirk 2).
    """
    pc = np.array(pc, dtype=np.float64, copy=True)
    denom = 65536.0 if scale_intensity else 1.0
    if not use_color and not use_intensity:
        return pc[:, 0:3]
    if use_color and not use_intensity:
        out = pc[:, 0:7]
        out[:, 3:] = out[:, 3:] / 256.0
        return out
    if not use_color and use_intensity:
        return np.concatenate((pc[:, 0:3], pc[:, 7:8] / denom), axis=1)
    out = pc
    out[:, 3:7] = out[:, 3:7] / 256.0
    out[:, 7] = out[:, 7] / denom
    return out
