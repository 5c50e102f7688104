"""Frame / clip naming conventions shared by the whole pipeline.

Port of vit_research_tpu/data/naming.py, unchanged. The reference names
frames ``vid{N}_frame_{M}.jpg`` (reference:
nba_proj/preprocess_frames.py:87) and clip directories
``vid{N}_clip_{K}_{left|right|none}``
(reference: nba_proj/generate_clips_hmm.py:68-86), and sorts both with a
split-on-underscore comparator (reference: nba_proj/dataset.py:20-24).
"""

from __future__ import annotations

import re

_FRAME_RE = re.compile(r"^vid(\d+)_frame_(\d+)\.(jpg|jpeg|png)$")
_CLIP_RE = re.compile(r"^vid(\d+)_clip_(\d+)_(left|right|none)$")


def frame_name(vid: int, frame: int, ext: str = "jpg") -> str:
    return f"vid{vid}_frame_{frame}.{ext}"


def clip_dir_name(vid: int, clip: int, side: str) -> str:
    return f"vid{vid}_clip_{clip}_{side}"


def parse_frame_name(name: str) -> tuple[int, int]:
    """'vid3_frame_120.jpg' -> (3, 120)."""
    m = _FRAME_RE.match(name)
    if not m:
        # Tolerant fallback mirroring the reference's split-based parser.
        parts = name.split("_")
        return int(parts[0][3:]), int(parts[2].split(".")[0])
    return int(m.group(1)), int(m.group(2))


def parse_clip_dir(name: str) -> tuple[int, int, str]:
    """'vid3_clip_7_left' -> (3, 7, 'left')."""
    m = _CLIP_RE.match(name)
    if not m:
        parts = name.split("_")
        return int(parts[0][3:]), int(parts[2]), parts[3]
    return int(m.group(1)), int(m.group(2)), m.group(3)


def is_frame_name(name: str) -> bool:
    """True when ``name`` parses as a vid{N}_frame_{M} filename."""
    try:
        parse_frame_name(name)
        return True
    except (ValueError, IndexError):
        return False


def is_canonical_frame_name(name: str) -> bool:
    """Strict ``vid{N}_frame_{M}.{jpg|jpeg|png}`` match only.

    Unlike :func:`is_frame_name`, rejects names the tolerant fallback
    parser would accept — notably temp/partial suffixes like
    ``vid1_frame_5.jpg.part`` or ``vid1_frame_5.jpg.tmp`` that an
    atomic copy-then-rename writer leaves visible mid-write. Consumers
    that tail a directory a writer is still filling (``cli segment
    --follow``) must use this, or they race the rename."""
    return _FRAME_RE.match(name) is not None


def list_frames(directory) -> list[str]:
    """Sorted frame filenames in ``directory``, ignoring strays
    (.DS_Store, notes.txt, editor backups) that would crash the tolerant
    frame-name parser with an opaque ValueError."""
    import os

    return sorted((f for f in os.listdir(directory) if is_frame_name(f)),
                  key=frame_sort_key)


def frame_sort_key(name: str) -> tuple[int, int]:
    return parse_frame_name(name)


def clip_sort_key(name: str) -> tuple[int, int]:
    vid, clip, _ = parse_clip_dir(name)
    return vid, clip


def frame_num(name: str) -> int:
    """Frame number from a frame name.

    Accepts the full ``vid{N}_frame_{M}[.ext]`` form plus the bare-number
    form the reference's evaluation harness documents ('23117')
    (reference: nba_proj/test/get_clip_sequences.py:555-567, which takes
    the last underscore-separated segment)."""
    m = _FRAME_RE.match(name)
    if m:
        return int(m.group(2))
    return int(name.split("_")[-1].split(".")[0])


def vid_num(name: str) -> int:
    return parse_frame_name(name)[0]
