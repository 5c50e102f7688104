"""Small file-shuffling utilities.

Port of vit_research_tpu/utils/fileops.py: frame movers (reference:
nba_proj/move_ims_to_temp.py, nba_proj/move_files.py) and result-dir
cleanup (reference: nba_proj/clear_test_results.py).
"""

from __future__ import annotations

import os
import shutil


def move_frames(src_dir: str, dst_dir: str, *, pattern: str | None = None,
                limit: int | None = None, copy: bool = False) -> int:
    """Move (or copy) frame files between directories, in name order;
    ``pattern`` keeps names containing it, ``limit`` caps the count.
    Returns the number moved."""
    os.makedirs(dst_dir, exist_ok=True)
    moved = 0
    op = shutil.copy if copy else shutil.move
    for name in sorted(os.listdir(src_dir)):
        if pattern and pattern not in name:
            continue
        if limit is not None and moved >= limit:
            break
        op(os.path.join(src_dir, name), os.path.join(dst_dir, name))
        moved += 1
    return moved


def clear_dirs(*dirs: str, recreate: bool = True) -> None:
    """Wipe result directories (reference: nba_proj/clear_test_results.py)."""
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
        if recreate:
            os.makedirs(d, exist_ok=True)
