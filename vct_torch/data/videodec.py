"""Python bindings for the native video decoder (``vct_torch/native/videodec.cpp``).

The port's copy of ``vct/data/videodec.py``: ffmpeg demux, threaded decode
and pixel-format conversion with the GIL released for the whole read.

Two modes:
  * ``resize="cv2"`` (default): decode at the source size natively (the
    pixels of cv2's decode) and resize each frame with cv2.INTER_LINEAR, as
    the cv2 ingest path does.
  * ``resize="native"``: swscale's bilinear resize inside the decoder; the
    pixels differ slightly from cv2.INTER_LINEAR.

The library links libavformat, libavcodec, libavutil and libswscale and
builds on first use into ``.vct_torch_build/host-<hash>/``
(``vct_torch.data.clipcache.build_host_library``). ``is_available()`` is
False where those libraries or their headers are missing (``chip_smoke.py``'s
files phase prints which); the decode entry points then raise.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from vct_torch.data.clipcache import build_host_library

__all__ = ["build_library", "is_available", "decode_video_native"]

_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")
_lib = None
_available: Optional[bool] = None


def build_library() -> str:
    """Build the decoder if needed; returns the library's path. Raises
    ``RuntimeError`` where it does not compile or link."""
    return str(build_host_library("videodec.cpp", _FLAGS, _LIBS))


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.vd_open.restype = p
    lib.vd_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.vd_dims.restype = None
    lib.vd_dims.argtypes = [p, ctypes.POINTER(i64)]
    lib.vd_read.restype = i64
    lib.vd_read.argtypes = [p, u8p, i64]
    lib.vd_close.restype = None
    lib.vd_close.argtypes = [p]
    _lib = lib
    return lib


def is_available() -> bool:
    """True when the native decoder builds and loads on the running host."""
    global _available
    if _available is None:
        try:
            _load()
            _available = True
        except (RuntimeError, OSError):
            _available = False
    return _available


def decode_video_native(
    path: str,
    height: int,
    width: int,
    max_frames: Optional[int] = None,
    chunk: int = 64,
    resize: str = "cv2",
) -> List[np.ndarray]:
    """Decode into a list of (height, width, 3) uint8 RGB frames (the
    contract of ``vct_torch.data.video.decode_video``)."""
    lib = _load()
    native_resize = resize == "native"
    handle = lib.vd_open(
        str(path).encode(), width if native_resize else 0,
        height if native_resize else 0,
    )
    if not handle:
        raise IOError(f"Could not open video file {path}")
    frames: List[np.ndarray] = []
    try:
        dims = (ctypes.c_int64 * 2)()
        lib.vd_dims(handle, dims)
        src_h, src_w = int(dims[0]), int(dims[1])
        buf = np.empty((chunk, src_h, src_w, 3), np.uint8)
        buf_p = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        needs_resize = not native_resize and (src_h, src_w) != (height, width)
        if needs_resize:
            import cv2
        while max_frames is None or len(frames) < max_frames:
            want = chunk
            if max_frames is not None:
                want = min(chunk, max_frames - len(frames))
            n = lib.vd_read(handle, buf_p, want)
            if n < 0:
                raise IOError(f"Decode error in {path} after {len(frames)} frames")
            if n == 0:
                break
            for i in range(n):
                frame = buf[i]
                if needs_resize:
                    frame = cv2.resize(frame, (width, height))
                frames.append(np.array(frame))
    finally:
        lib.vd_close(handle)
    return frames
