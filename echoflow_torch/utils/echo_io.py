"""Echo image IO / resize host helpers (a copy of `echoflow.utils.echo_io`).

Equivalents of reference src/utils/echo_utils.py:25-194: per-frame [0,1]
normalization + spatial resize (bilinear for images, nearest for label
images), optional horizontal flip, readers for .npy/.mhd/.h5 sources, and a
video writer. skimage/SimpleITK are not dependencies here: resizes use
cv2 (bilinear/nearest), .mhd files are read with a minimal MetaImage parser
(the CAMUS path's only ITK need), and videos are written with PIL/cv2.
"""

from __future__ import annotations

import os

import numpy as np


def _resize_frame(frame: np.ndarray, imsize, is_label: bool) -> np.ndarray:
    import cv2

    interp = cv2.INTER_NEAREST if is_label else cv2.INTER_LINEAR
    return cv2.resize(frame, (imsize[1], imsize[0]), interpolation=interp)


def transformResizeImage(echo: np.ndarray, imsize, outtype=np.float32) -> np.ndarray:
    """(F-or-C, H, W) or (H, W) array -> per-frame [0,1]-normalized (float
    path only), spatially resized, channels-first (reference
    echo_utils.py:25-61)."""
    echo = np.asarray(echo)
    if echo.ndim == 2:
        echo = echo[None]
    elif echo.ndim != 3:
        raise ValueError(f"expected 2- or 3-dim input, got {echo.ndim}-dim")

    is_label = outtype != np.float32
    if not is_label:
        echo = echo.astype(np.float32)
        for f in range(echo.shape[0]):
            lo, hi = echo[f].min(), echo[f].max()
            echo[f] = (echo[f] - lo) / (hi - lo)

    out = np.stack([_resize_frame(echo[f], imsize, is_label)
                    for f in range(echo.shape[0])])
    return out.astype(outtype)


def transformResizeAndFlipImage(echo, imsize, outtype=np.float32) -> np.ndarray:
    """transformResizeImage + width flip (reference echo_utils.py:63-103)."""
    return np.flip(transformResizeImage(echo, imsize, outtype), axis=-1).copy()


def read_mhd(fname: str) -> np.ndarray:
    """Minimal MetaImage (.mhd + raw) reader for the CAMUS layout:
    uncompressed MET_UCHAR/MET_SHORT/MET_FLOAT, local or referenced raw.
    Returns (frames/z, H, W) like itk.GetArrayFromImage."""
    header = {}
    with open(fname, "r", errors="ignore") as f:
        for line in f:
            if "=" not in line:
                continue
            key, val = line.split("=", 1)
            header[key.strip()] = val.strip()
            if header.get("ElementDataFile", "") == "LOCAL":
                break

    dims = [int(x) for x in header["DimSize"].split()]
    dtype = {
        "MET_UCHAR": np.uint8, "MET_CHAR": np.int8,
        "MET_USHORT": np.uint16, "MET_SHORT": np.int16,
        "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
    }[header.get("ElementType", "MET_UCHAR")]

    datafile = header["ElementDataFile"]
    if datafile == "LOCAL":
        raise NotImplementedError("inline-data .mhd not supported; CAMUS uses .raw")
    raw_path = os.path.join(os.path.dirname(fname), datafile)
    data = np.fromfile(raw_path, dtype=dtype)
    # MetaImage stores x-fastest; numpy view is reversed (z, y, x).
    return data.reshape(tuple(reversed(dims)))


def readTransformResizeImage(fname: str, imsize, outtype=np.float32) -> np.ndarray:
    """Load a .mhd or .npy image/video and transformResize it
    (reference echo_utils.py:105-131)."""
    ext = os.path.splitext(fname)[1]
    if ext == ".mhd":
        echo = read_mhd(fname).astype(np.float32)
    elif ext == ".npy":
        echo = np.load(fname)
    else:
        raise ValueError(f"cannot read extension {ext!r} of {fname}")
    return transformResizeImage(echo, imsize, outtype)


def readH5TransformResizeImage(fname: str, dataset_key: str, imsize,
                               outtype=np.float32) -> np.ndarray:
    import h5py

    with h5py.File(fname, "r") as f:
        echo = np.array(f[dataset_key])
    return transformResizeImage(echo, imsize, outtype)


def makeVideo(frames: np.ndarray, filename: str, fps: int = 30,
              labels: np.ndarray | None = None):
    """Write a (F, H, W) or (F, H, W, 3) sequence to a video file, with an
    optional label overlay (reference makeVideo, echo_utils.py:148-194 —
    matplotlib FuncAnimation there; cv2 writer here)."""
    import cv2

    from echoflow_torch.utils.visualize import echonet_overlay

    frames = np.asarray(frames, np.float32)
    if frames.max() > 1.5:
        frames = frames / 255.0
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(filename, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for i in range(frames.shape[0]):
        fr = frames[i]
        if labels is not None:
            fr = echonet_overlay(fr if fr.ndim == 2 else fr[..., 0], labels[i])
        elif fr.ndim == 2:
            fr = np.stack([fr] * 3, axis=-1)
        writer.write(cv2.cvtColor((fr * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    writer.release()
    return filename
