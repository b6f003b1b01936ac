"""Host-side video frame sampling for training.

Port of ``video_gpt_tpu/data/video.py`` for one host: cv2 random-access
frame reads at a fixed or flexible stride, random frame-block
partitioning, resolution sanity checks, retry-on-bad-sample, ``.txt``
manifests (path \\t frame_count) or directory walks, and one fixed
resolution bucket per run. Every sample is a pure function of (seed,
index), the same function as the JAX package's shard 0 of 1 (multi-host
sharding is not ported). cv2 is imported only where a file is read. The
preprocessing computes in numpy the arithmetic of the JAX package's native
frame library (``native/frame_ops.cpp``, ``preprocess_frame``), which that
package takes whenever the library loads: a fractional box filter to
shrink, bilinear to enlarge, a centre crop at a fractional offset, and
floats throughout.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

VIDEO_EXTENSIONS = (
    ".mp4", ".avi", ".mkv", ".flv", ".mov", ".wmv", ".mpg", ".mpeg",
    ".3gp", ".m4v", ".ts", ".webm", ".vob", ".rm", ".rmvb", ".ogv",
    ".ogg", ".mts", ".m2ts", ".f4v", ".asf", ".divx", ".mxf",
)


def list_videos(path: str, min_frames: Optional[int] = None) -> List[str]:
    """Directory walk or ``path\\tframe_count`` manifest; manifests drop
    videos too short to sample."""
    if os.path.isfile(path) and path.lower().endswith(".txt"):
        out = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("\t")
                if not parts or not parts[0]:
                    continue
                if min_frames is not None:
                    if len(parts) < 2:
                        continue
                    try:
                        if int(parts[1]) < min_frames:
                            continue
                    except ValueError:
                        continue
                out.append(parts[0])
        return out
    out = []
    for root, _dirs, files in os.walk(path):
        for f in files:
            if f.lower().endswith(VIDEO_EXTENSIONS):
                out.append(os.path.abspath(os.path.join(root, f)))
    return sorted(out)


def random_block_partition(num_frames: int, rng: random.Random
                           ) -> Tuple[int, ...]:
    """Random composition of num_frames into >= 2 positive parts."""
    if num_frames == 1:
        return (1,)
    k = rng.randint(2, num_frames)
    cuts = sorted(rng.sample(range(1, num_frames), k - 1))
    parts, prev = [], 0
    for c in cuts + [num_frames]:
        parts.append(c - prev)
        prev = c
    return tuple(parts)


def _fma(a, b, c):
    """a * b + c rounded once to float32, as the native library's build
    (-O3 -march=native) contracts it: a float32 product is exact in
    float64."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _box_weights(n_src: int, n_dst: int, inv: np.float32,
                 off: np.float32) -> np.ndarray:
    """[n_dst, n_src] weights of the area filter along one axis: output t
    averages the source span [off + t inv, off + (t + 1) inv), clamped to
    the image, each source pixel weighted by its overlap with the span."""
    t = np.arange(n_dst, dtype=np.float32)
    lo = np.maximum(_fma(t, inv, off), np.float32(0))
    hi = np.minimum(_fma(t + np.float32(1), inv, off), np.float32(n_src))
    w = np.zeros((n_dst, n_src), np.float64)
    for i in range(n_dst):
        for s in range(int(lo[i]), min(int(np.ceil(hi[i])), n_src)):
            w[i, s] = (min(hi[i], np.float32(s + 1))
                       - max(lo[i], np.float32(s)))
    sums = w.sum(1, keepdims=True)
    return np.divide(w, sums, out=np.zeros_like(w), where=sums > 0)


def _bilinear_weights(n_src: int, n_dst: int, inv: np.float32,
                      off: np.float32) -> np.ndarray:
    """[n_dst, n_src] weights of the bilinear sample along one axis at
    (t + 0.5) inv - 0.5 + off, clamped to [0, n_src - 1]."""
    t = np.arange(n_dst, dtype=np.float32)
    pos = _fma(t + np.float32(0.5), inv, off) - np.float32(0.5)
    pos = np.clip(pos, np.float32(0), np.float32(n_src - 1))
    i0 = pos.astype(np.int64)
    i1 = np.minimum(i0 + 1, n_src - 1)
    frac = (pos - i0.astype(np.float32)).astype(np.float64)
    w = np.zeros((n_dst, n_src), np.float64)
    rows = np.arange(n_dst)
    np.add.at(w, (rows, i0), 1.0 - frac)
    np.add.at(w, (rows, i1), frac)
    return w


@functools.lru_cache(maxsize=32)
def resample_matrices(src_h: int, src_w: int, height: int, width: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The cover-resize and centre crop of an (src_h, src_w) frame to
    (height, width) as two separable matrices (rows [height, src_h], cols
    [width, src_w]): frame channel c maps to rows @ x[..., c] @ cols.T.
    The float32 scale, offsets and sample positions of ``preprocess_frame``
    (native/frame_ops.cpp): one scale covers both sides; shrinking takes
    the area filter, enlarging (and scale 1) the bilinear sample. Both
    filters are a product of a row weight and a column weight, so the
    matrices reproduce them exactly."""
    scale = max(np.float32(height) / np.float32(src_h),
                np.float32(width) / np.float32(src_w))
    inv = np.float32(1) / scale
    y_off = _fma(-np.float32(height), inv, src_h) * np.float32(0.5)
    x_off = _fma(-np.float32(width), inv, src_w) * np.float32(0.5)
    weights = _box_weights if scale < 1 else _bilinear_weights
    return (weights(src_h, height, inv, y_off),
            weights(src_w, width, inv, x_off))


def fit_to_resolution(frame: np.ndarray, height: int, width: int
                      ) -> np.ndarray:
    """Aspect-preserving scale to cover (height, width), then centre crop:
    [height, width, 3] float32 pixel values (not rounded) of an HxWx3
    uint8 frame."""
    rows, cols = resample_matrices(frame.shape[0], frame.shape[1], height,
                                   width)
    x = frame.astype(np.float64)
    return np.einsum("ys,sxc,tx->ytc", rows, x, cols,
                     optimize=True).astype(np.float32)


def preprocess_to_resolution(frames: Sequence[np.ndarray], th: int, tw: int
                             ) -> np.ndarray:
    """Cover-resize + centre crop + normalise to [-1, 1] float32
    (``px * 2/255 - 1``, in float32 as the native library computes it)."""
    pixels = np.stack([fit_to_resolution(f, th, tw) for f in frames])
    return pixels * np.float32(2.0 / 255.0) - np.float32(1.0)


@dataclasses.dataclass
class ClipSample:
    pixels: np.ndarray            # [F, H, W, 3] float32 in [-1, 1]
    frame_blocks: Tuple[int, ...]


class VideoClipDataset:
    """Random clips of ``frame_num`` frames for training."""

    MIN_SIDE = 128       # videos with a smaller side are skipped
    MAX_ASPECT = 4.0     # and so are more elongated ones
    MAX_RETRY = 1000     # unreadable draws before giving up

    def __init__(
        self,
        source: str,
        frame_num: int,
        frame_interval: int = 1,
        flexible_interval: bool = False,
        interval_bound: Optional[int] = None,
        target_resolution: Tuple[int, int] = (176, 320),
        scheme: str = "interleaved",   # 'interleaved' | 'frame_block'
        seed: int = 0,
    ):
        self.frame_num = frame_num
        self.frame_interval = frame_interval
        self.flexible_interval = flexible_interval
        self.interval_bound = interval_bound
        self.target_resolution = target_resolution
        if scheme not in ("interleaved", "frame_block"):
            raise ValueError(f"unknown scheme {scheme!r}; expected "
                             "'interleaved' or 'frame_block'")
        self.scheme = scheme
        self.seed = seed
        data = list_videos(source,
                           min_frames=(frame_num - 1) * frame_interval + 1)
        if not data:
            raise ValueError(f"no videos found under {source}")
        self.data = data

    def __len__(self) -> int:
        return len(self.data)

    def _read_clip(self, path: str, rng: random.Random) -> np.ndarray:
        import cv2
        cap = cv2.VideoCapture(path)
        try:
            total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            if self.flexible_interval:
                # random stride up to the video's span / interval_bound
                max_iv = (total - 1) // max(self.frame_num - 1, 1)
                if max_iv < self.frame_interval:
                    raise ValueError(f"too few frames: {total}")
                if self.interval_bound is not None:
                    max_iv = min(max_iv, self.interval_bound)
                interval = rng.randint(self.frame_interval, max_iv)
            else:
                interval = self.frame_interval
            max_start = total - (self.frame_num - 1) * interval
            if max_start <= 0:
                raise ValueError(f"too few frames: {total}")
            start = rng.randint(0, max_start - 1)
            frames = []
            for i in range(self.frame_num):
                cap.set(cv2.CAP_PROP_POS_FRAMES, start + i * interval)
                ok, frame = cap.read()
                if not ok:
                    raise ValueError(f"failed frame read in {path}")
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        finally:
            cap.release()
        h, w = frames[0].shape[:2]
        if min(h, w) < self.MIN_SIDE:
            raise ValueError(f"resolution too low: {w}x{h}")
        if max(h, w) / min(h, w) > self.MAX_ASPECT:
            raise ValueError(f"extreme aspect ratio: {w}x{h}")
        return np.stack(frames)

    def _sample_rng(self, epoch: int, vid: int, attempt: int
                    ) -> random.Random:
        """All of a sample's randomness (start, stride, retry re-draw,
        block partition) derives from (seed, epoch, index, attempt); the 0
        is the JAX package's shard index."""
        seed_int = int(np.random.SeedSequence(
            [self.seed, 0, epoch, vid, attempt]).generate_state(1)[0])
        return random.Random(seed_int)

    def sample(self, index: int) -> ClipSample:
        """Sample with retry on unreadable data; a pure function of
        (seed, index). ``index`` may exceed the dataset length: each
        wraparound (epoch) re-rolls the clip window and block partition."""
        epoch, vid0 = divmod(index, len(self.data))
        for attempt in range(self.MAX_RETRY):
            rng = self._sample_rng(epoch, vid0, attempt)
            # attempt 0 reads the indexed video; retries re-draw uniformly
            vid = vid0 if attempt == 0 else rng.randrange(len(self.data))
            try:
                frames = self._read_clip(self.data[vid], rng)
                break
            except ValueError:
                continue
        else:
            raise RuntimeError("too many unreadable videos")
        th, tw = self.target_resolution
        pixels = preprocess_to_resolution(frames, th, tw)
        if self.scheme == "frame_block":
            blocks = random_block_partition(self.frame_num, rng)
        else:
            blocks = (1,) * self.frame_num
        return ClipSample(pixels=pixels, frame_blocks=blocks)
