"""Bounding-box repair (own copy of ``stlt_tpu/data/boxes.py::fix_box``).

Matches the reference's ``fix_box`` chain (``src/utils/data_utils.py:205-231``)
bit for bit: boxes are int-cast, non-negative, corner-ordered, clamped to the
frame and de-degenerated. The released checkpoints were trained on these
quirks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def fix_box(box: Sequence[float], video_size: Tuple[int, int]) -> List[int]:
    """Repair one ``[x1, y1, x2, y2]`` box. ``video_size`` is
    ``(height, width)``, the order the reference passes."""
    height, width = video_size
    x1, y1, x2, y2 = (max(0, int(v)) for v in box)
    if x1 > x2:
        x1, x2 = x2, x1
    if y1 > y2:
        y1, y2 = y2, y1
    x1 = min(x1, width - 1)
    x2 = min(x2, width - 1)
    y1 = min(y1, height - 1)
    y2 = min(y2, height - 1)
    if x1 == x2 == 0:
        x2 = 1
    if y1 == y2 == 0:
        y2 = 1
    if x1 == x2:
        x1 -= 1
    if y1 == y2:
        y1 -= 1
    return [x1, y1, x2, y2]
