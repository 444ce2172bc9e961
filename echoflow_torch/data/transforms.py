"""CAMUS-era data transforms and augmentations (a copy of
`echoflow.data.transforms`; the time resample runs on the port's
`ops/resize.resize_linear`, and .mhd files are read by the port's
`utils/echo_io.read_mhd`).

Host-side equivalents of reference src/utils/camus_transforms.py:46-805 and
src/transform_utils.py:40-486: intensity windowing, rotation about the
transducer apex (top-center of the sector), Gaussian/speckle noise, salt &
pepper, one-hot, sequence loading/resampling, and the CAMUS directory
walker. Functional core + thin dict-pipeline classes mirroring the
reference's transform API (each class maps a data dict -> data dict).
"""

from __future__ import annotations

import os
import re

import numpy as np


# ------------------------------------------------------------ functional core

def intensity_window(img: np.ndarray, scale_range=(1.0, 1.0),
                     rng: np.random.RandomState | None = None) -> np.ndarray:
    """Random intensity windowing (reference random_Windower,
    camus_transforms.py:249-279): map a random sub-range of the intensity
    range to the full range and clip the complement."""
    rng = rng or np.random
    lo_s, hi_s = sorted(scale_range)
    assert 0.0 < lo_s <= hi_s <= 1.0, "scale range must be in (0, 1]"
    im_min, im_max = img.min(), img.max()
    sc = lo_s + (hi_s - lo_s) * rng.rand()
    im_range = im_max - im_min
    locut = im_min + im_range * ((1.0 - sc) * rng.rand())
    hicut = locut + sc * im_range
    alpha = (img - locut) / (hicut - locut)
    return np.clip((1.0 - alpha) * im_min + alpha * im_max, im_min, im_max)


def rotate_about_apex(img: np.ndarray, degrees: float, order: int = 1) -> np.ndarray:
    """Rotate (H, W) or (C, H, W) about the ultrasound apex at top-center
    — xy center (w/2 - 0.5, 0.5) — counterclockwise for positive degrees
    (reference random_Rotater, camus_transforms.py:471-522). order 0 =
    nearest (labels), 1 = linear (images)."""
    import cv2

    arr = np.asarray(img)
    squeeze = arr.ndim == 2
    planes = arr[None] if squeeze else arr
    h, w = planes.shape[-2:]
    center = (w / 2.0 - 0.5, 0.5)
    mat = cv2.getRotationMatrix2D(center, degrees, 1.0)
    interp = cv2.INTER_NEAREST if order == 0 else cv2.INTER_LINEAR
    out = np.stack([
        cv2.warpAffine(p.astype(np.float32), mat, (w, h), flags=interp,
                       borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
        for p in planes
    ])
    out = out[0] if squeeze else out
    return out.astype(np.int64) if order == 0 else out.astype(np.float32)


def random_rotation_angle(scale: float, rtype: str = "uniform",
                          rng: np.random.RandomState | None = None) -> float:
    """Random angle: uniform in [-scale, scale] or normal(0, scale) clipped
    to +-3*scale (reference camus_transforms.py:484-490)."""
    rng = rng or np.random
    if rtype == "normal":
        return float(np.clip(scale * rng.randn(), -3 * scale, 3 * scale))
    return float(2.0 * scale * rng.rand() - scale)


def gaussian_noise(img: np.ndarray, std: float,
                   rng: np.random.RandomState | None = None) -> np.ndarray:
    rng = rng or np.random
    return (img + std * rng.randn(*img.shape)).astype(np.float32)


def salt_pepper(img: np.ndarray, amount: float = 0.01,
                rng: np.random.RandomState | None = None) -> np.ndarray:
    """Salt & pepper on the image's own intensity range
    (reference AddSaltPepper, camus_transforms.py:731-759)."""
    rng = rng or np.random
    out = img.copy()
    lo, hi = img.min(), img.max()
    mask = rng.rand(*img.shape)
    out[mask < amount / 2] = lo
    out[mask > 1 - amount / 2] = hi
    return out


def one_hot_np(label: np.ndarray, num_classes: int) -> np.ndarray:
    """(H, W) int -> (num_classes, H, W) float32
    (reference OneHot, camus_transforms.py:761-797)."""
    return np.stack([(label == k) for k in range(num_classes)]).astype(np.float32)


def resample_sequence_frames(video: np.ndarray, num_frames: int,
                             align_corners: bool = True) -> np.ndarray:
    """Trilinear time-resample of a (T, H, W) sequence (reference
    LoadImageSequenceToNumpy resamples CAMUS sequences to 10 frames)."""
    import torch

    from echoflow_torch.ops.resize import resize_linear

    return resize_linear(torch.from_numpy(video.astype(np.float32)), 0, num_frames,
                         align_corners).numpy()


def echo_cone_gaussian_noise(img: np.ndarray, sig_range=(0.0, 0.0),
                             sig: float | None = None,
                             rng: np.random.RandomState | None = None) -> np.ndarray:
    """Echo-specific Gaussian noise (reference random_GaussNoiser,
    camus_transforms.py:368-393): add N(0, sig), clip to [0, 1], then zero
    every pixel that was < eps before noising — noise never leaks outside
    the ultrasound cone."""
    rng = rng or np.random
    img = np.asarray(img, np.float32)
    cone = (img >= np.finfo(np.float32).eps).astype(np.float32)
    if sig is None:
        lo, hi = sorted(sig_range)
        assert 0.0 <= lo and hi <= 1.0, "sig_range must be within [0, 1]"
        sig = lo + (hi - lo) * rng.rand()
    noised = np.clip(img + sig * rng.standard_normal(img.shape), 0.0, 1.0)
    return (noised * cone).astype(np.float32)


def _skimage_like_resize(chw: np.ndarray, size, order: int,
                         anti_aliasing: bool) -> np.ndarray:
    """Spatial resize of a channels-first (C, H, W) array to `size` (H', W')
    with skimage.transform.resize semantics: half-pixel coordinate mapping,
    optional Gaussian pre-blur on downsampling (sigma = max(0, (1/zoom - 1)
    / 2) per axis), order 0 = nearest / 1 = linear. skimage is not a
    dependency; cv2 provides the identical half-pixel linear/nearest sample
    and scipy.ndimage the blur."""
    import cv2

    h, w = chw.shape[-2:]
    th, tw = int(size[0]), int(size[1])
    planes = chw.astype(np.float32)
    if anti_aliasing and order != 0 and (th < h or tw < w):
        from scipy.ndimage import gaussian_filter

        sy = max(0.0, ((h / th) - 1.0) / 2.0)
        sx = max(0.0, ((w / tw) - 1.0) / 2.0)
        planes = np.stack([gaussian_filter(p, (sy, sx), mode="constant")
                           for p in planes])
    interp = cv2.INTER_NEAREST if order == 0 else cv2.INTER_LINEAR
    return np.stack([cv2.resize(p, (tw, th), interpolation=interp)
                     for p in planes])


# ------------------------------------------------------ dict-pipeline classes

class IdentityTransform:
    def __call__(self, data):
        return data


class LoadSITKFromFilename:
    """data[field]: list of .mhd paths -> list of loaded arrays (z, H, W)
    (reference camus_transforms.py:46-60). ITK is not a dependency — the
    built-in MetaImage reader produces the same (z, y, x)-ordered array that
    itk.GetArrayFromImage would."""

    def __init__(self, field):
        self.field = field

    def __call__(self, data):
        from echoflow_torch.utils.echo_io import read_mhd

        data = dict(data)
        data[self.field] = [read_mhd(p) for p in data[self.field]]
        return data


class SitkToNumpy:
    """List of loaded images -> list of float32 arrays with each channel
    normalized to [0, 1], or int64 unnormalized arrays for labels
    (reference camus_transforms.py:82-110, `normed` switch)."""

    def __init__(self, field, normed=True):
        self.field = field
        self.normed = normed

    def __call__(self, data):
        data = dict(data)
        entries = []
        for entry in data[self.field]:
            arr = np.asarray(entry)
            if self.normed:
                arr = arr.astype(np.float32).copy()
                for c in range(arr.shape[0]):
                    lo, hi = arr[c].min(), arr[c].max()
                    arr[c] = (arr[c] - lo) / (hi - lo)
            else:
                arr = arr.astype(np.int64)
            entries.append(arr)
        data[self.field] = entries
        return data


class ResizeImagesAndLabels:
    """Paired resize of data[image_field]/data[label_field] lists of
    (C, H, W) arrays (reference camus_transforms.py:135-205): images linear
    + anti-aliased float32, labels nearest int64 and squeezed to (H, W)."""

    def __init__(self, size, image_field, label_field, image_alias=True,
                 label_alias=False, image_order=1, label_order=0):
        self.size = size
        self.image_field = image_field
        self.label_field = label_field
        self.image_alias = image_alias
        self.label_alias = label_alias
        self.image_order = image_order
        self.label_order = label_order

    def __call__(self, data):
        data = dict(data)
        images, labels = [], []
        for img, lab in zip(data[self.image_field], data[self.label_field]):
            assert img.shape[1:3] == np.asarray(lab).shape[-2:], (
                "image/label spatial shapes must match before resize")
            r_img = _skimage_like_resize(img, self.size, self.image_order,
                                         self.image_alias)
            lab_chw = np.asarray(lab)
            if lab_chw.ndim == 2:
                lab_chw = lab_chw[None]
            r_lab = np.squeeze(_skimage_like_resize(
                lab_chw, self.size, self.label_order, self.label_alias))
            images.append(r_img.astype(np.float32) if self.image_order
                          else r_img.astype(np.int64))
            labels.append(r_lab.astype(np.float32) if self.label_order
                          else r_lab.astype(np.int64))
        data[self.image_field] = images
        data[self.label_field] = labels
        return data


class ResizeTransform:
    """Single-field resize (reference camus_transforms.py:213-247)."""

    def __init__(self, size, field, alias=True, order=1):
        self.size = size
        self.field = field
        self.alias = alias
        self.order = order

    def __call__(self, data):
        data = dict(data)
        out = []
        for entry in data[self.field]:
            r = _skimage_like_resize(np.asarray(entry), self.size, self.order,
                                     self.alias)
            out.append(r.astype(np.float32) if self.order else r.astype(np.int64))
        data[self.field] = out
        return data


class ResizeImage:
    """Sequence-aware single-field resize (reference
    transform_utils.py:129-190): entries are (C, H, W) images or
    (T, C, H, W) sequences. The reference's is_label+is_sequence branch
    crashes (`list.astype`); here labels resize nearest and cast int64 in
    both modes."""

    def __init__(self, size, image_field, is_sequence=False, is_label=False,
                 anti_aliasing=True, order=1):
        self.size = size
        self.image_field = image_field
        self.is_sequence = is_sequence
        self.is_label = is_label
        self.anti_aliasing = anti_aliasing
        self.order = order

    def __call__(self, data):
        data = dict(data)
        out = []
        order = 0 if self.is_label else self.order
        for entry in data[self.image_field]:
            arr = np.asarray(entry)
            if self.is_sequence:
                frames = arr if arr.ndim == 4 else arr[:, None]
                r = np.stack([
                    _skimage_like_resize(f, self.size, order, self.anti_aliasing)
                    for f in frames])
            else:
                r = _skimage_like_resize(arr, self.size, order, self.anti_aliasing)
            out.append(r.astype(np.int64) if self.is_label else r.astype(np.float32))
        data[self.image_field] = out
        return data


class random_video_windower:
    """Callable per-channel intensity windower (reference
    transform_utils.py:193-225): one random window fraction shared across
    channels, per-channel min/max/clip. Input and output (C, H, W)."""

    def __init__(self, scale, rng=None):
        scale = sorted(scale)
        assert 0.0 < scale[0] <= scale[1] <= 1.0, (
            f"scale range {scale} must be in (0, 1]")
        self.scale = scale
        self.rng = rng

    def __call__(self, images):
        rng = self.rng or np.random
        chw = np.asarray(images, np.float32)
        mins = chw.min(axis=(1, 2), keepdims=True)
        maxs = chw.max(axis=(1, 2), keepdims=True)
        sc = self.scale[0] + (self.scale[1] - self.scale[0]) * rng.rand()
        rng_width = maxs - mins
        locut = mins + rng_width * ((1.0 - sc) * rng.rand())
        hicut = locut + sc * rng_width
        alpha = (chw - locut) / (hicut - locut)
        out = (1.0 - alpha) * mins + alpha * maxs
        return np.clip(out, mins, maxs)


class WindowImage:
    """Dict wrapper over random_video_windower (reference
    transform_utils.py:228-267). Sequence entries (1, T, H, W) are squeezed,
    windowed with T as the channel axis, and re-expanded — the reference's
    exact (quirky) behavior: each frame gets its own min/max window.

    Deliberate divergence: the reference's non-sequence `is_label` path
    windows the entry *before* the integer cast (transform_utils.py:257-262,
    despite its own "should not window the label" comment), corrupting label
    values whenever the random window is not the identity. Here labels pass
    through untouched — the behavior the reference's comment intended."""

    def __init__(self, scale=(1.0, 1.0), image_field="image_sequence",
                 is_sequence=True, is_label=False, rng=None):
        self.image_field = image_field
        self.is_sequence = is_sequence
        self.is_label = is_label
        self.windower = random_video_windower(scale, rng=rng)

    def __call__(self, data):
        data = dict(data)
        out = []
        for entry in data[self.image_field]:
            if self.is_sequence:
                entry = np.asarray(entry, np.float32)
                # Squeeze only the leading singleton: np.squeeze() with no
                # axis would also collapse a T=1 sequence's frame axis and
                # window image rows as if they were frames.
                if entry.ndim == 4 and entry.shape[0] == 1:
                    entry = entry[0]
                windowed = self.windower(entry)
                out.append(np.expand_dims(windowed, 0))
            elif self.is_label:
                out.append(np.asarray(entry).astype(np.int64))
            else:
                out.append(self.windower(entry).astype(np.float32))
        data[self.image_field] = out
        return data


class GaussianNoiseEcho:
    """Cone-masked Gaussian noise over a list field (reference
    camus_transforms.py:423-468, delegating to random_GaussNoiser)."""

    def __init__(self, sig_range=(0.0, 0.0), field="images", rng=None):
        self.sig_range = tuple(sorted(sig_range))
        self.field = field
        self.rng = rng

    def __call__(self, data):
        data = dict(data)
        data[self.field] = [
            echo_cone_gaussian_noise(e, self.sig_range, rng=self.rng)
            for e in data[self.field]]
        return data


class RotateImages:
    """Independent random apex rotation of a single field's entries
    (reference camus_transforms.py:655-728) — the one-sided variant of
    RotateImagesAndLabels for autoencoder inputs. Each entry draws its own
    angle. The reference computes the rotation center from the
    pre-transpose (C, H, W) shape, which lands on the apex top-center
    (w/2-0.5, c-0.5) only for square single-channel images — the intended
    apex center is used here."""

    def __init__(self, scalestd=0.0, rtype="normal", field="images", order=1,
                 rng=None):
        assert 0.0 <= scalestd <= 60.0, f"scale {scalestd} must be in [0, 60]"
        assert rtype in ("normal", "uniform")
        self.scale = scalestd
        self.rtype = rtype
        self.field = field
        self.order = order
        self.rng = rng

    def __call__(self, data):
        data = dict(data)
        out = []
        for entry in data[self.field]:
            angle = random_rotation_angle(self.scale, self.rtype, self.rng)
            rot = rotate_about_apex(np.asarray(entry), angle, order=self.order)
            out.append(rot.astype(np.float32) if self.order
                       else rot.astype(np.int64))
        data[self.field] = out
        return data


class WindowImagesAndLabels:
    """Intensity windowing of data['images']; labels untouched
    (reference camus_transforms.py:281-366)."""

    def __init__(self, scale=(1.0, 1.0), image_field="images", label_field="labels",
                 rng=None):
        self.scale = scale
        self.image_field = image_field
        self.rng = rng

    def __call__(self, data):
        data = dict(data)
        value = data[self.image_field]
        if isinstance(value, (list, tuple)):
            data[self.image_field] = [
                intensity_window(img, self.scale, self.rng) for img in value]
        else:  # a single image/stack: window it as one unit
            data[self.image_field] = intensity_window(
                np.asarray(value), self.scale, self.rng)
        return data


class RotateImagesAndLabels:
    """Same random apex rotation applied to each (image, label) pair
    (reference camus_transforms.py:524-652)."""

    def __init__(self, scale=10.0, rtype="uniform", image_field="images",
                 label_field="labels", rng=None):
        self.scale = scale
        self.rtype = rtype
        self.image_field = image_field
        self.label_field = label_field
        self.rng = rng

    def __call__(self, data):
        data = dict(data)
        imgs = data[self.image_field]
        labs = data[self.label_field]
        if isinstance(imgs, (list, tuple)):
            images, labels = [], []
            for img, lab in zip(imgs, labs):
                angle = random_rotation_angle(self.scale, self.rtype, self.rng)
                images.append(rotate_about_apex(img, angle, order=1))
                labels.append(rotate_about_apex(lab, angle, order=0))
            data[self.image_field] = images
            data[self.label_field] = labels
        else:  # single (C, H, W)/(H, W) image with its (H, W) label
            angle = random_rotation_angle(self.scale, self.rtype, self.rng)
            data[self.image_field] = rotate_about_apex(np.asarray(imgs), angle, order=1)
            data[self.label_field] = rotate_about_apex(np.asarray(labs), angle, order=0)
        return data


class RotateVideoAndLabels:
    """One random angle for the whole video plus its ED/ES labels
    (reference transform_utils.py:324-388)."""

    def __init__(self, scale=10.0, rtype="uniform", video_field="video",
                 label_fields=("label_ED", "label_ES"), rng=None):
        self.scale = scale
        self.rtype = rtype
        self.video_field = video_field
        self.label_fields = label_fields
        self.rng = rng

    def __call__(self, data):
        data = dict(data)
        angle = random_rotation_angle(self.scale, self.rtype, self.rng)
        video = np.asarray(data[self.video_field])
        data[self.video_field] = np.stack(
            [rotate_about_apex(f, angle, order=1) for f in video])
        for field in self.label_fields:
            data[field] = rotate_about_apex(np.asarray(data[field]), angle, order=0)
        return data


class GaussianNoiseImageSequence:
    """Additive Gaussian noise on a video sequence
    (reference transform_utils.py:391-414)."""

    def __init__(self, std=0.02, video_field="video", rng=None):
        self.std = std
        self.video_field = video_field
        self.rng = rng

    def __call__(self, data):
        data = dict(data)
        data[self.video_field] = gaussian_noise(
            np.asarray(data[self.video_field], np.float32), self.std, self.rng)
        return data


class NormalizedImageSequence:
    """[0,1] or [-1,1] normalization of a sequence
    (reference transform_utils.py:417-441)."""

    def __init__(self, mode="zeroone", video_field="video"):
        assert mode in ("zeroone", "pmone")
        self.mode = mode
        self.video_field = video_field

    def __call__(self, data):
        data = dict(data)
        v = np.asarray(data[self.video_field], np.float32)
        v = (v - v.min()) / (v.max() - v.min())
        if self.mode == "pmone":
            v = 2.0 * v - 1.0
        data[self.video_field] = v
        return data


# --------------------------------------------------------- CAMUS directory

def make_camus_echo_dataset(root: str, views=("2CH", "4CH")) -> dict:
    """Walk CAMUS `patientNNNN/` dirs, parse `Info_{view}.cfg` for the
    ED/ES frame order, and emit per-patient dicts of sequence paths with an
    order tag appended (reference transform_utils.py:444-486)."""
    dataset = {}
    for entry in sorted(os.listdir(root)):
        pdir = os.path.join(root, entry)
        if not (os.path.isdir(pdir) and re.match(r"patient\d+", entry)):
            continue
        record = {}
        for view in views:
            cfg_path = os.path.join(pdir, f"Info_{view}.cfg")
            if not os.path.exists(cfg_path):
                continue
            info = {}
            with open(cfg_path) as f:
                for line in f:
                    if ":" in line:
                        k, v = line.split(":", 1)
                        info[k.strip()] = v.strip()
            ed = int(info.get("ED", 1))
            es = int(info.get("ES", 2))
            order = "ED_first" if ed < es else "ES_first"
            seq = os.path.join(pdir, f"{entry}_{view}_sequence.mhd")
            record[view] = {
                "sequence": f"{seq}::{order}",
                "ED": os.path.join(pdir, f"{entry}_{view}_ED.mhd"),
                "ED_gt": os.path.join(pdir, f"{entry}_{view}_ED_gt.mhd"),
                "ES": os.path.join(pdir, f"{entry}_{view}_ES.mhd"),
                "ES_gt": os.path.join(pdir, f"{entry}_{view}_ES_gt.mhd"),
                "info": info,
            }
        if record:
            dataset[entry] = record
    return dataset


def load_camus_sequence(tagged_path: str, num_frames: int = 10,
                        norm: str = "zeroone") -> np.ndarray:
    """Read a CAMUS .mhd sequence (path possibly tagged `::ES_first`),
    reverse to ED-first if needed, normalize, and time-resample to
    `num_frames` (reference LoadImageSequenceToNumpy,
    transform_utils.py:40-112)."""
    from echoflow_torch.utils.echo_io import read_mhd

    path, _, order = tagged_path.partition("::")
    video = read_mhd(path).astype(np.float32)
    if order == "ES_first":
        video = video[::-1].copy()
    video = (video - video.min()) / (video.max() - video.min())
    if norm == "pmone":
        video = 2.0 * video - 1.0
    if video.shape[0] != num_frames:
        video = resample_sequence_frames(video, num_frames)
    return video


# ----------------------------------------------------- reference-named shims

class random_GaussNoiser:
    """Bare-image cone-masked Gaussian noiser (reference
    camus_transforms.py:368-393; the dict-pipeline GaussianNoiseEcho above
    delegates to the same op)."""

    def __init__(self, sig_range):
        self.sig_range = tuple(sorted(sig_range))
        assert 0.0 <= self.sig_range[0] and self.sig_range[1] <= 1.0, \
            f"random_GaussNoiser: sig_range {sig_range} must be in [0.0, 1.0]."

    def __call__(self, img, sig=None):
        return echo_cone_gaussian_noise(img, self.sig_range, sig=sig)


# camus_transforms.py:395-420 defines random_SpeckleNoiser as a verbatim
# duplicate of random_GaussNoiser; same here.
random_SpeckleNoiser = random_GaussNoiser

# camus_transforms.py:799-805.
identity_Transform = IdentityTransform
