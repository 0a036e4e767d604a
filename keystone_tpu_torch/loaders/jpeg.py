"""Batch JPEG decode to (m, H, W, 3) uint8 images at a fixed size (the
counterpart of the reference's native ``decode_jpegs``).

Two decoders, chosen by the device the images are wanted on, as the
kernel wrappers choose by their tensors' device:

- the CPU: ``csrc/jpeg.cpp``, the port's copy of the reference's libjpeg
  decode and bilinear resize, built with ``g++ -ljpeg``; it gives the
  reference's pixels exactly;
- a CUDA device: ``csrc/nvjpeg.cu``, nvJPEG from the CUDA toolkit and the
  same resize as a kernel, built with ``nvcc -lnvjpeg``; the images land
  on the card.  nvJPEG's IDCT differs from libjpeg's by a few levels.

A decoder that fails to build or load raises, naming its library:
nothing falls back to another decoder or to the CPU.  Libraries build at
first use, into ``keystone_tpu_torch/_build/``.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from keystone_tpu_torch.kernels import build
from keystone_tpu_torch.utils.device import resolve_device

_P = ctypes.c_void_p
_I64 = ctypes.c_int64

#: decoder launches by device type (one a batch); reset with ``reset_launches``
LAUNCHES = {"libjpeg": 0, "nvjpeg": 0}

#: the nvJPEG decoder of each device, made once per process
_decoders: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack(blobs: List[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """JPEG byte strings as (one uint8 array, int64 offsets, int64 sizes)."""
    sizes = np.asarray([len(b) for b in blobs], np.int64)
    offsets = np.zeros(len(blobs), np.int64)
    if len(blobs) > 1:
        np.cumsum(sizes[:-1], out=offsets[1:])
    buf = np.frombuffer(b"".join(blobs), np.uint8) if blobs else np.zeros(0, np.uint8)
    return buf, offsets, sizes


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _load(name: str, library: str) -> ctypes.CDLL:
    try:
        return build.load(name)
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"the {library} JPEG decoder (csrc/{name}) failed to build or load: {e}") from e


def _libjpeg() -> ctypes.CDLL:
    with build.LOCK:
        lib = _load("jpeg", "libjpeg")
        lib.ks_jpeg_decode.restype = ctypes.c_int
        lib.ks_jpeg_decode.argtypes = [_P, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P, _P]
        return lib


def _nvjpeg(device: torch.device):
    with build.LOCK:
        return _nvjpeg_locked(device)


def _nvjpeg_locked(device: torch.device):
    lib = _load("nvjpeg", "nvJPEG (libnvjpeg)")
    lib.ks_nvjpeg_create.restype = ctypes.c_int
    lib.ks_nvjpeg_create.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.ks_nvjpeg_info.restype = ctypes.c_int
    lib.ks_nvjpeg_info.argtypes = [_P, _P, _P, _P, _I64, _P, _P]
    lib.ks_nvjpeg_decode.restype = ctypes.c_int
    lib.ks_nvjpeg_decode.argtypes = [_P, _P, _P, _P, _I64, _P, _P, _P, _I64, _I64, _P, _P, _P]
    key = device.index if device.index is not None else torch.cuda.current_device()
    handle = _decoders.get(key)
    if handle is None:
        with torch.cuda.device(key):
            h = ctypes.c_void_p()
            st = lib.ks_nvjpeg_create(ctypes.byref(h))
        if st != 0:
            raise RuntimeError(f"nvJPEG (libnvjpeg) could not create a decoder: nvjpegStatus_t {st}")
        handle = _decoders[key] = h.value
    return lib, handle


def decode(buf: np.ndarray, offsets: np.ndarray, sizes: np.ndarray, size: Tuple[int, int],
           device="cuda") -> Tuple[torch.Tensor, np.ndarray]:
    """Decode the packed JPEGs (``pack``) and resize each to ``size``
    (H, W): ``(images (m, H, W, 3) uint8 on device, ok (m,) bool)``.  An
    image that does not decode is all zeros, with ``ok`` False."""
    dev = resolve_device(device)
    buf = np.ascontiguousarray(buf, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    m = len(sizes)
    th, tw = int(size[0]), int(size[1])
    status = np.zeros(m, np.int32)
    if dev.type == "cpu":
        out = np.zeros((m, th, tw, 3), np.uint8)
        if m:
            _libjpeg().ks_jpeg_decode(_ptr(buf), _ptr(offsets), _ptr(sizes), m, th, tw, 0, _ptr(out),
                                      _ptr(status))
            LAUNCHES["libjpeg"] += 1
        return torch.from_numpy(out), status == 0
    lib, handle = _nvjpeg(dev)
    out = torch.zeros((m, th, tw, 3), dtype=torch.uint8, device=dev)
    if not m:
        return out, status == 0
    heights = np.zeros(m, np.int32)
    widths = np.zeros(m, np.int32)
    lib.ks_nvjpeg_info(handle, _ptr(buf), _ptr(offsets), _ptr(sizes), m, _ptr(heights), _ptr(widths))
    scratch = torch.empty(max(1, int((heights.astype(np.int64) * widths * 3).max())), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ks_nvjpeg_decode(handle, _ptr(buf), _ptr(offsets), _ptr(sizes), m, _ptr(heights), _ptr(widths),
                                   scratch.data_ptr(), th, tw, out.data_ptr(), _ptr(status), stream)
        if err == 0:
            # nvJPEG may still read the host bitstream (this call's buffers)
            # from the stream's queued work: done before they go
            torch.cuda.current_stream(dev).synchronize()
    if err != 0:
        raise RuntimeError(f"the resize kernel after nvJPEG failed to launch or run: CUDA error {err}")
    LAUNCHES["nvjpeg"] += 1
    return out, status == 0
