"""Video ingest: download (gated) + frame extraction.

Port of vit_research_tpu/data/video.py, the reference's L0 layer:
- yt-dlp format-136 downloads (reference: nba_proj/finding_ball.py:7-18),
  gated on yt-dlp being installed;
- cv2.VideoCapture frame dump with resize and windowed frame ranges,
  writing ``vid{N}_frame_{i}.jpg`` (reference:
  nba_proj/preprocess_frames.py:59-91, nba_proj/script.py:45-86). Without
  OpenCV it raises the reference's RuntimeError.
"""

from __future__ import annotations

import os

from vit_research_tpu_torch.data import naming


def download_video(url: str, out_path: str, *, format_id: str = "136") -> bool:
    """Download via yt-dlp when available; returns False when gated."""
    try:
        import yt_dlp
    except ImportError:
        print("[video] yt-dlp unavailable in this image; skipping download")
        return False
    opts = {"format": format_id, "outtmpl": out_path}
    with yt_dlp.YoutubeDL(opts) as ydl:
        ydl.download([url])
    return True


def extract_frames(video_path: str, out_dir: str, vid: int, *,
                   size: tuple = (1080, 1920), frame_range=None,
                   every: int = 1, quality: int = 90) -> list[str]:
    """Dump frames ``vid{N}_frame_{i}.jpg`` (1-indexed).

    Args:
      size: (H, W) resize target (reference used 1920x1080).
      frame_range: optional (start, end) inclusive window of frame
        indices (the reference hardcoded per-game ranges).
      every: keep every n-th frame.
    """
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("OpenCV required for frame extraction") from e

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    paths = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        i += 1
        if frame_range:
            if i > frame_range[1]:
                break  # don't decode the rest of a 2-hour broadcast
            if i < frame_range[0]:
                continue
        if (i - 1) % every:
            continue
        h, w = size
        if frame.shape[0] != h or frame.shape[1] != w:
            frame = cv2.resize(frame, (w, h))
        path = os.path.join(out_dir, naming.frame_name(vid, i))
        cv2.imwrite(path, frame, [cv2.IMWRITE_JPEG_QUALITY, quality])
        paths.append(path)
    cap.release()
    return paths
