"""Video input path of the Qwen2.5-VL reward stack.

Counterpart of `reflectionflow_tpu/models/qwen_vl/video.py`: the frame-count
policy (`smart_nframes`), uniform and multi-point frame sampling, the
per-frame pixel budget (the total pixels spread over the sampled frames), and
temporal patching (`video_to_patches`: bundles of `temporal_patch_size`
frames, the last frame repeated to fill one, grid (T/tp, H/ps, W/ps)).

Readers (`_read_decoded`): decoded sources only, as in the JAX package: a
(T, H, W, 3) array, a list of frames, a `.npy` / `.npz` file, or a directory
of JPEG, PNG, BMP or WebP frames read by the port's own decoders
(`train/data.py::decode_image`, the same pixels as PIL; the card's machine
has no PIL); a codec container path raises. Frames are resized with the port's copy of PIL's
bicubic (`train/data.py::resize`, bit for bit).
"""

from __future__ import annotations

import math
import os

import numpy as np

from ...config import QwenVLVisionConfig

# pixel and frame budgets
VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 24576 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768


def round_by_factor(x: float, factor: int) -> int:
    return round(x / factor) * factor


def ceil_by_factor(x: float, factor: int) -> int:
    return math.ceil(x / factor) * factor


def floor_by_factor(x: float, factor: int) -> int:
    return math.floor(x / factor) * factor


def smart_nframes(total_frames: int, video_fps: float, nframes: int | None = None, fps: float | None = None,
                  min_frames: int = FPS_MIN_FRAMES, max_frames: int = FPS_MAX_FRAMES) -> int:
    """An explicit `nframes` rounded to FRAME_FACTOR, or an `fps`-derived count
    clamped to [min_frames, max_frames]; a multiple of FRAME_FACTOR, at most
    `total_frames`."""
    if nframes is not None and fps is not None:
        raise ValueError("only one of nframes / fps may be given")
    if nframes is not None:
        n = round_by_factor(nframes, FRAME_FACTOR)
    else:
        fps = FPS if fps is None else fps
        lo = ceil_by_factor(min_frames, FRAME_FACTOR)
        hi = floor_by_factor(min(max_frames, total_frames), FRAME_FACTOR)
        n = total_frames / video_fps * fps
        n = round_by_factor(min(max(n, lo), hi), FRAME_FACTOR)
    n = min(n, total_frames)
    if not FRAME_FACTOR <= n <= total_frames:
        raise ValueError(f"nframes must lie in [{FRAME_FACTOR}, {total_frames}], got {n}")
    return n


def sample_frame_indices(total_frames: int, video_fps: float, sample_type: str = "uniform",
                         nframes: int | None = None, fps: float | None = None,
                         min_frames: int = FPS_MIN_FRAMES, max_frames: int = FPS_MAX_FRAMES) -> list[int]:
    """"uniform": `smart_nframes` indices evenly spaced over the clip.
    "multi_pts": 4 anchor points with 6 consecutive frames (at a working 8 fps)
    around each."""
    if sample_type == "uniform":
        n = smart_nframes(total_frames, video_fps, nframes=nframes, fps=fps, min_frames=min_frames,
                          max_frames=max_frames)
        return np.linspace(0, total_frames - 1, n).round().astype(int).tolist()
    if sample_type == "multi_pts":
        frames_each_pts, num_pts, work_fps = 6, 4, 8
        n = int(total_frames * work_fps // video_fps)
        if n < frames_each_pts + 1:
            raise ValueError(f"clip too short for multi_pts sampling: {n} working frames")
        frame_idx = np.linspace(0, total_frames - 1, n).round().astype(int).tolist()
        pts = np.linspace(frames_each_pts // 2, n - frames_each_pts // 2 - 1, num_pts).round().astype(int).tolist()
        idx: list[int] = []
        for pt in pts:
            idx.extend(frame_idx[pt - frames_each_pts // 2 : pt + frames_each_pts // 2])
        return idx
    raise ValueError(f"unknown sample_type {sample_type!r}")


def _read_frame_dir(path: str) -> np.ndarray:
    from ...train.data import decode_image

    names = sorted(n for n in os.listdir(path) if n.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".webp")))
    if not names:
        raise ValueError(f"no image frames found in directory {path}")
    frames = []
    for n in names:
        with open(os.path.join(path, n), "rb") as f:
            frames.append(decode_image(f.read()))
    return np.stack(frames)


def _read_decoded(source) -> np.ndarray:
    """A decoded source -> (T, H, W, 3) uint8."""
    if isinstance(source, np.ndarray):
        frames = source
    elif isinstance(source, (list, tuple)):
        frames = np.stack([np.asarray(f) for f in source])
    elif isinstance(source, (str, os.PathLike)):
        path = os.fspath(source)
        if path.startswith("file://"):
            path = path[7:]
        if os.path.isdir(path):
            frames = _read_frame_dir(path)
        elif path.endswith(".npy"):
            frames = np.load(path)
        elif path.endswith(".npz"):
            frames = np.load(path)["frames"]
        else:
            raise ValueError(f"no video codec backend; decode {path!r} externally and pass frames as an "
                             "array, a frame directory, or .npy/.npz")
    else:
        raise TypeError(f"unsupported video source: {type(source)}")
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (T, H, W, 3) frames, got {frames.shape}")
    if np.issubdtype(frames.dtype, np.floating):
        # decoded floats in [0, 1] or in [0, 255]
        scale = 255.0 if float(frames.max(initial=0.0)) <= 1.0 + 1e-6 else 1.0
        frames = np.clip(np.rint(frames * scale), 0, 255)
    return np.clip(frames, 0, 255).astype(np.uint8)


def fetch_video(source, video_fps: float = FPS, sample_type: str = "uniform", nframes: int | None = None,
                fps: float | None = None, min_pixels: int = VIDEO_MIN_PIXELS, max_pixels: int | None = None,
                total_pixels: int = VIDEO_TOTAL_PIXELS, image_factor: int = 28) -> np.ndarray:
    """A decoded video source -> sampled, budget-resized (T', H', W', 3) uint8.
    Without `max_pixels` the per-frame cap spreads `total_pixels` over the
    sampled frames, floored at about `min_pixels`; a given `max_pixels` is a
    hard cap that the upscale floor never exceeds."""
    from ...train.data import resize
    from .vision import smart_resize

    frames = _read_decoded(source)
    frames = frames[sample_frame_indices(len(frames), video_fps, sample_type=sample_type, nframes=nframes, fps=fps)]
    T, H, W, _ = frames.shape
    if max_pixels is None:
        max_pixels = max(min(VIDEO_MAX_PIXELS, total_pixels / T * FRAME_FACTOR), int(min_pixels * 1.05))
    min_pixels = min(min_pixels, int(max_pixels))
    nh, nw = smart_resize(H, W, factor=image_factor, min_pixels=min_pixels, max_pixels=int(max_pixels))
    if (nh, nw) != (H, W):
        frames = np.stack([resize(f, (nw, nh)) for f in frames])
    return frames


def video_to_patches(frames: np.ndarray, cfg: QwenVLVisionConfig) -> tuple[np.ndarray, tuple[int, int, int]]:
    """(T, H, W, 3) uint8 (H, W multiples of patch * merge) -> patches (L,
    3*tp*ps*ps) in Qwen's order + grid (ceil(T/tp), H/ps, W/ps); T is padded to
    a multiple of `temporal_patch_size` by repeating the last frame."""
    from .vision import frames_to_patches

    tp = cfg.temporal_patch_size
    T = frames.shape[0]
    if T % tp:
        frames = np.concatenate([frames, np.repeat(frames[-1:], tp - T % tp, axis=0)])
    return frames_to_patches(frames, cfg)
