"""Host-side video/audio decode feed.

Replaces decord + the ffmpeg/ffprobe subprocesses
(reference: Vidi1.5_9B/vidi/dataset/vid_utils.py:10-79) with:

1. a first-party C++ decoder (`native/vidi_media.cc`, libavformat/libavcodec/
   libswscale/libswresample via ctypes) — frames, 16 kHz mono PCM, duration;
2. an OpenCV fallback for frames/duration when the native lib isn't built
   (no audio — returns silence), and for the frames of any clip whose width
   the native frame decode cannot take (`native_frames_safe`).

Frame sampling matches vid_utils.py:10-24: uniform stride round(avg_fps/fps),
or linspace over a time_range.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libvidi_media.so"),
    os.path.join(os.path.dirname(__file__), "libvidi_media.so"),
]
_native = None


def _load_native():
    global _native
    if _native is not None:
        return _native
    for p in _NATIVE_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            try:
                lib = ctypes.CDLL(p)
            except OSError:
                # built against libav libraries that are not installed: cv2 decodes
                continue
            lib.vm_probe.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.vm_probe.restype = ctypes.c_int
            lib.vm_decode_frames.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int]
            lib.vm_decode_frames.restype = ctypes.c_int
            lib.vm_decode_audio.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
            lib.vm_decode_audio.restype = ctypes.c_int
            if hasattr(lib, "vm_stream_open"):  # older .so builds lack it
                lib.vm_stream_open.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
                lib.vm_stream_open.restype = ctypes.c_void_p
                lib.vm_stream_next.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_int]
                lib.vm_stream_next.restype = ctypes.c_int
                lib.vm_stream_close.argtypes = [ctypes.c_void_p]
                lib.vm_stream_close.restype = None
            _native = lib
            return lib
    _native = False
    return False


def native_frames_safe(width: int) -> bool:
    """Whether the native library may decode frames `width` pixels wide.
    Its RGB24 conversion writes past the end of each output row when
    width % 16 >= 8, corrupting the heap (the process aborts with "double
    free or corruption" on 56 or 120 px clips). Heights do not matter. The
    rule comes from `python3 scripts/native_decode_probe.py`,
    which decodes cv2-written clips through the library in subprocesses
    (widths 16-1398, heights 16-130) under glibc's malloc checks."""
    return width % 16 < 8


def probe(path: str) -> Tuple[float, float, int, int, int]:
    """-> (duration_s, fps, n_frames, width, height)."""
    lib = _load_native()
    if lib:
        dur = ctypes.c_double()
        fps = ctypes.c_double()
        nf = ctypes.c_long()
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = lib.vm_probe(path.encode(), ctypes.byref(dur), ctypes.byref(fps),
                          ctypes.byref(nf), ctypes.byref(w), ctypes.byref(h))
        if rc == 0:
            return dur.value, fps.value, nf.value, w.value, h.value
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 1.0
    nf = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    return (nf / fps if fps else 0.0), fps, nf, w, h


def get_media_length(path: str) -> float:
    """Duration in seconds (vid_utils.py:67-79 ffprobe equivalent)."""
    return probe(path)[0]


def _frame_indices(n_frames: int, avg_fps: float, fps: float,
                   time_range: Optional[Tuple[float, float]]) -> np.ndarray:
    if time_range is None:
        stride = max(int(round(avg_fps / fps)), 1)
        return np.arange(0, n_frames, stride, dtype=np.int64)
    idx_s = int(round(time_range[0] * avg_fps))
    idx_e = min(int(round(time_range[1] * avg_fps)), n_frames - 1)
    num_steps = (time_range[1] - time_range[0]) * fps
    return np.linspace(idx_s, idx_e, int(round(num_steps)), dtype=np.int64)


def load_video(path: str, fps: float = 1.0,
               time_range: Optional[Tuple[float, float]] = None) -> List[np.ndarray]:
    """-> list of RGB uint8 HWC frames sampled at `fps` (vid_utils.py:10-24)."""
    duration, avg_fps, n_frames, w, h = probe(path)
    idx = _frame_indices(n_frames, avg_fps, fps, time_range)

    lib = _load_native()
    if lib and native_frames_safe(w):
        out = np.empty((len(idx), h, w, 3), np.uint8)
        c_idx = (ctypes.c_long * len(idx))(*idx.tolist())
        rc = lib.vm_decode_frames(
            path.encode(), c_idx, len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h)
        if rc == 0:
            return list(out)
    return _load_video_cv2(path, idx)


def stream_video(path: str, fps: float = 1.0, chunk: int = 112,
                 time_range: Optional[Tuple[float, float]] = None):
    """Yield [<=chunk, H, W, 3] RGB uint8 frame blocks, sampled exactly like
    `load_video`, decoding incrementally — the consumer can overlap device
    work (transfer + tower encode) with the next chunk's host decode.
    Short streams pad by repeating the last decoded frame, matching
    vm_decode_frames / vid_utils.py semantics."""
    duration, avg_fps, n_frames, w, h = probe(path)
    idx = _frame_indices(n_frames, avg_fps, fps, time_range)
    n = len(idx)
    if n == 0:
        return

    lib = _load_native()
    if lib and hasattr(lib, "vm_stream_open") and native_frames_safe(w):
        c_idx = (ctypes.c_long * n)(*idx.tolist())
        handle = lib.vm_stream_open(path.encode(), c_idx, n, w, h)
        if handle:
            try:
                served = 0
                while served < n:
                    cap = min(chunk, n - served)
                    buf = np.empty((cap, h, w, 3), np.uint8)
                    got = lib.vm_stream_next(
                        handle,
                        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                        cap)
                    if got <= 0:
                        if served == 0:
                            break  # codec unsupported: cv2 fallback below
                        raise IOError(f"stream decode failed: {path}")
                    served += got
                    yield buf[:got]
                if served >= n:
                    return
            finally:
                lib.vm_stream_close(handle)

    yield from _stream_cv2(path, idx, chunk)


def _stream_cv2(path: str, idx: np.ndarray, chunk: int):
    """Sequential OpenCV read of sampled `idx`, yielded in `chunk` blocks
    (dup indices repeated; short streams pad with the last decoded frame)."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    n = len(idx)
    try:
        wi = 0
        pos = 0
        out: List[np.ndarray] = []
        last = None
        while wi < n:
            ok, frame = cap.read()
            if not ok:
                break
            if pos == int(idx[wi]):
                last = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                while wi < n and int(idx[wi]) == pos:  # dup indices
                    out.append(last)
                    wi += 1
                if len(out) >= chunk:
                    yield np.stack(out[:chunk])
                    out = out[chunk:]
            pos += 1
        if last is None:
            raise IOError(f"no frames decoded: {path}")
        while wi < n:  # header over-reported: repeat last frame
            out.append(last)
            wi += 1
        while out:
            yield np.stack(out[:chunk])
            out = out[chunk:]
    finally:
        cap.release()


def _load_video_cv2(path: str, idx: np.ndarray) -> List[np.ndarray]:
    if len(idx) == 0:
        return []
    return [f for block in _stream_cv2(path, idx, chunk=len(idx))
            for f in block]


def load_audio(path: str, sample_rate: int = 16000,
               time_range: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """-> float32 mono PCM in [-1, 1] (vid_utils.py:26-50 equivalent).

    Falls back to silence (matching the video duration) when no audio stream
    exists or the native decoder is unavailable.
    """
    lib = _load_native()
    full_duration = get_media_length(path)
    duration = full_duration
    if time_range is not None:
        duration = max(0.0, min(time_range[1], full_duration) - time_range[0])
    if lib:
        # decode from t=0, so the buffer must reach time_range[1] (the slice
        # below uses absolute sample offsets)
        max_samples = int((full_duration + 1.0) * sample_rate) + sample_rate
        buf = np.zeros(max_samples, np.float32)
        n_out = ctypes.c_long()
        rc = lib.vm_decode_audio(
            path.encode(), sample_rate,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_samples, ctypes.byref(n_out))
        if rc == 0 and n_out.value > 0:
            audio = buf[: n_out.value]
            if time_range is not None:
                s = int(time_range[0] * sample_rate)
                e = int(time_range[1] * sample_rate)
                audio = audio[s:e]
            return audio
    return np.zeros(int(duration * sample_rate), np.float32)
