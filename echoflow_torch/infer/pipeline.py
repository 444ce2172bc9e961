"""Full-video multi-heartbeat segmentation with shift-ensemble label fusion
(port of `echoflow.infer.pipeline`).

Per video, after host decode:

  1. Every shift's "slice + trilinear tail-stretch to round(L_k/32)*32
     frames" is a linear map on the time axis, built on the host as a
     (K, T', T) matrix stack (banker's rounding, reference
     fuse_utils.py:22) and applied as one einsum.
  2. Only the clips that exist are gathered (`clip_src`) and run through
     the network in balanced chunks.
  3. Softmax re-interpolation to each shift's true length is the transposed
     matrix stack, again one einsum, then argmax.
  4. Shift alignment is a gather with host-built index/validity matrices
     (reference fuse_utils.py:84-98).
  5. Per-frame SIMPLE/STAPLE/majority fusion runs batched over frames
     (`ops/fusion.py`), or the softmax-mean path fuses probabilities.
  6. The binary mask is bit-packed on the device, 8 pixels per byte.

On the card the decoder tail of every forward is the CUDA kernel of
`ops/decoder_heads.py`; host operands are cached per video length on the
device; `segment_videos` dispatches ahead from pinned host memory.

On one CUDA device the device work of a video (steps 1-6 after the
upload, `_run`) runs as CUDA graphs, as echoflow jits `run`
(`utils/graphs.GraphedFunction`): one graph for each of echoflow's keys
(t_pad, k_num, n_fwd, fuse_method, mono), with the video's dtype and
(H, W), made at the second video with the key (the first runs eagerly)
and replayed after that; the per-length operands are the graph's inputs,
so two lengths of one bucket with the same number of forwarded clips share
a graph. The wrapper keeps the graphs of its 8 most recently used keys.
`engine._run.__wrapped__` is the eager body. On the CPU, and on several
devices (`devices`, whose replicas and streams do not fit one capture),
the engine runs the eager body.

With `devices` the forward is data-parallel (echoflow's `mesh`): each chunk
of clips is split into one contiguous shard per device, each shard is
forwarded by that device's replica of the folded model (with the kernel),
and the probabilities come back to the first device, where re-interp,
fusion and packing run. Two settled differences from echoflow: its mesh
engine drops its Pallas decoder (the port keeps the kernel per shard), and
it shards fusion over frames (the port fuses on the first device; the
masks are the same either way).

Each layer runs in a span (`utils/profiling.span`), which opens the
`torch.profiler.record_function` range `echoflow_torch.<layer>`: the
device layers shift, backbone, projections, decoder_tail, reinterp and
fusion also put device stamps around their work, which time it inside a
replay too (a replay fires no range); copies and model_forward are host
spans. The engine numbers the videos it is handed, and a video's spans
carry that number: `engine.queue` (from `_dispatch`'s submit to the start
of its stage), `engine.stage` (on the dispatch thread: the operands, the
mono check, the pinned staging, the upload, the graph's feed and replay,
the enqueued download), `engine.fetch` (the wait for the mask, then the
unpack) and the device spans of its replay. `engine.operand_hits` and
`engine.operand_misses` count the per-length operand cache's lookups.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from echoflow_torch.infer.model import forward, inference_model
from echoflow_torch.ops.fusion import fuse_frames, softmax_mean_fuse
from echoflow_torch.ops.normalize import zeroone_normalize
from echoflow_torch.ops.resize import _linear_resize_matrix_np, resize_linear
from echoflow_torch.parallel.mesh import data_devices
from echoflow_torch.utils.concurrency import get_or_build
from echoflow_torch.utils.device import upload
from echoflow_torch.utils.graphs import model_graphs
from echoflow_torch.utils.profiling import count, record, span

CLIP_LEN = 32


def _packbits(mask: torch.Tensor) -> torch.Tensor:
    """Bit-pack a binary (T, H, W) uint8 mask along W (8 pixels/byte, most
    significant bit first, as np.packbits) to cut device->host traffic 8x;
    the inverse is `_unpackbits`. No-op if W % 8 != 0."""
    t, h, w = mask.shape
    if w % 8 != 0:
        return mask
    # 128, 64, ..., 1 made on the device (no host-to-device copy)
    weights = (2 ** torch.arange(7, -1, -1, device=mask.device)).to(torch.uint8)
    return (mask.reshape(t, h, w // 8, 8) * weights).sum(dim=-1, dtype=torch.uint8)


def _unpackbits(packed: np.ndarray, width: int) -> np.ndarray:
    if packed.shape[-1] == width:
        return packed
    return np.unpackbits(packed, axis=-1)[..., :width]


def round_half_even(x: float) -> int:
    """np.round semantics (banker's rounding): load-bearing for clip counts
    (reference fuse_utils.py:22,29)."""
    return int(np.round(x))


def divide_to_consecutive_clips(video: np.ndarray, clip_length: int = CLIP_LEN,
                                interpolate_last: bool = False) -> np.ndarray:
    """Reference-parity host helper: (3, L, H, W) -> (N, 3, clip_length, H, W).

    With interpolate_last, the whole video is trilinear-stretched
    (align_corners=False) to round(L/clip)*clip frames first
    (reference fuse_utils.py:16-33)."""
    length = video.shape[1]
    target = round_half_even(length / clip_length) * clip_length
    src = video
    if length % clip_length != 0 and interpolate_last:
        src = resize_linear(torch.from_numpy(np.asarray(video, np.float32)), 1, target,
                            align_corners=False).numpy()
    clips = [src[:, s: s + clip_length] for s in range(0, target, clip_length)
             if s + clip_length <= src.shape[1]]
    return np.stack(clips) if clips else np.empty((0, 3, clip_length, *video.shape[2:]))


def _shift_plan(length: int, num_clips: int, step: int):
    """Per-shift (shift_offset, L_k, L_k') with the reference's shift-count
    clamp (fuse_utils.py:38-48), hardened at the lower edge: for
    32 <= L < 32 + step the reference computes num_clips = 0 and crashes
    downstream; echoflow clamps < 1 to 1 and segments the single shift."""
    if length < CLIP_LEN + num_clips * step:
        num_clips = (length - CLIP_LEN) // step
    if num_clips < 1:
        num_clips = 1
    plan = []
    for k in range(num_clips):
        off = k * step
        lk = length - off
        lk_interp = max(CLIP_LEN, round_half_even(lk / CLIP_LEN) * CLIP_LEN)
        plan.append((off, lk, lk_interp))
    return plan


def _build_host_operands(length: int, num_clips: int, step: int, t_pad: int):
    """The host-computable pieces of one video length: the forward and
    backward time-resize matrix stacks, the shift-alignment gather indices,
    and validity masks (verbatim from echoflow)."""
    plan = _shift_plan(length, num_clips, step)
    k_num = len(plan)
    c_max = t_pad // CLIP_LEN

    fwd = np.zeros((k_num, t_pad, t_pad), np.float32)   # (K, T', T)
    bwd = np.zeros((k_num, t_pad, t_pad), np.float32)   # (K, T, T')
    clip_valid = np.zeros((k_num, c_max), np.float32)
    frame_valid_per_shift = np.zeros((k_num, t_pad), np.float32)

    for k, (off, lk, lki) in enumerate(plan):
        m = _linear_resize_matrix_np(lk, lki, False)     # (L_k', L_k)
        fwd[k, :lki, off:off + lk] = m
        if lki != lk:
            back = _linear_resize_matrix_np(lki, lk, False)  # (L_k, L_k')
        else:
            back = np.eye(lk, dtype=np.float32)
        bwd[k, :lk, :lki] = back
        clip_valid[k, : lki // CLIP_LEN] = 1.0
        frame_valid_per_shift[k, :lk] = 1.0

    # Shift-aligned gather: rater k for original frame i is local frame
    # i - off_k. Validity per reference fuse_utils.py:82-98: frame 0 ->
    # shift 0 only; frame i >= 1 -> shifts k < min(i, K) with i - off_k >= 0.
    gather_idx = np.zeros((t_pad, k_num), np.int64)
    valid = np.zeros((t_pad, k_num), np.float32)
    for i in range(length):
        for k, (off, lk, _) in enumerate(plan):
            local = i - off
            if i == 0:
                ok = k == 0
            else:
                ok = (k < min(i, k_num)) and local >= 0
            if ok and 0 <= local < lk:
                gather_idx[i, k] = local
                valid[i, k] = 1.0
    # Frames the fusion can't source from any shift fall back to shift 0
    # (only possible for 1 <= i < step; the reference misaligns there).
    for i in range(length):
        if valid[i].sum() == 0:
            gather_idx[i, 0] = i
            valid[i, 0] = 1.0

    # Flat indices (into the k-major (K * c_max) clip grid) of the clips
    # that actually exist: shift k contributes its first lki/32 slots. Only
    # these reach the network; the padded tail slots would meet all-zero
    # `bwd` columns anyway, so dropping them from the forward is exact.
    valid_clip_idx = np.flatnonzero(clip_valid.reshape(-1)).astype(np.int32)

    return dict(fwd=fwd, bwd=bwd, clip_valid=clip_valid, gather_idx=gather_idx,
                valid=valid, k_num=k_num, c_max=c_max,
                valid_clip_idx=valid_clip_idx)


@dataclass
class _Pending:
    """A packed mask on its way to the host: `packed` is a host tensor
    (pinned, filled asynchronously on the card) that is complete once
    `done` has fired (None on the CPU, where it is complete at once)."""

    packed: torch.Tensor
    done: object = None
    seq: int | None = None     # the engine's number for the video

    def numpy(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.packed.numpy()


@dataclass
class VideoSegmenter:
    """Batched full-video segmentation engine.

    Parameters
    ----------
    variables : the port's state dict of the network over either backbone
        (`models/r2plus1d.motion_seg_net`; its keys name it), unfolded, or
        folded: a state dict without BN statistics is taken as folded
    device : "cuda" (default) or "cpu". A CUDA device that is not there
        raises; the engine never falls back to the CPU by itself.
    devices : optional list of devices of one type (echoflow's `mesh`): the
        forward is sharded over them, one folded replica per distinct
        device, built once here; a device may repeat. The first is the
        engine's `device`, where the rest of the work runs. `forward_chunk`
        is then the chunk per device.
    dtype : compute dtype. "auto" resolves to bfloat16 on CUDA and float32
        on the CPU. float32 is the parity path, with TF32 off for the
        process; a 16-bit folded backbone on CUDA is fitted to cuDNN's
        tensor cores, the same function (`infer/model.inference_model`).
    backbone_dtype : dtype of the conv backbone only (None: `dtype`).
    forward_chunk : clips per forward chunk (bounds peak activation memory)
    bucket : videos are padded to a multiple of this many frames
    fold_bn : absorb every BatchNorm into its conv at construction
    decoder : "kernel" runs the folded forward with the decoder-tail kernel
        (its plain version on the CPU) and needs a folded model;
        "model" runs the module's forward
    operand_cache_size : LRU cap on per-length device operands
    """

    variables: dict
    device: object = "cuda"
    devices: object = None
    dtype: object = "auto"
    backbone_dtype: object = None
    forward_chunk: int = 30
    bucket: int = 64
    fold_bn: bool = True
    decoder: str = "kernel"
    operand_cache_size: int = 64

    def __post_init__(self):
        if self.decoder not in ("kernel", "model"):
            raise ValueError(f"decoder must be 'kernel' or 'model'; got {self.decoder!r}")
        if self.devices is not None:
            self._devices = data_devices(devices=self.devices)
            if len({d.type for d in self._devices}) != 1:
                raise ValueError(f"VideoSegmenter: devices of one type, got {self.devices}")
            self.device = self._devices[0]
        self.device = torch.device(self.device)
        if self.devices is None:
            self._devices = [self.device]
        if self.dtype == "auto":
            self.dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self._model = inference_model(self.variables, self.device, self.dtype,
                                      self.backbone_dtype, self.fold_bn,
                                      kernel=self.decoder == "kernel")
        # One replica per distinct device; the first device's is `_model`.
        self._replicas = {dev: copy.deepcopy(self._model).to(dev) for dev in self._devices
                          if dev != self.device}
        self._replicas[self.device] = self._model
        self._operand_cache = OrderedDict()
        self._cache_lock = threading.Lock()
        # Every video is staged and dispatched on one thread of the engine
        # (made at first use): cuBLAS and cuDNN make their handles per
        # thread at its first call, which a graph capture refuses, so a
        # key's warm-up and capture must run on one thread.
        self._dispatcher = None
        self._seqs = itertools.count()
        if self.device.type == "cuda" and len(self._devices) == 1:
            self._run = model_graphs(self._run, self._model)

    def _chunk_plan(self, n_fwd: int):
        """Balanced forward chunking for `n_fwd` clips: n_chunks is the
        fewest chunks of <= forward_chunk, and the chunk size is the
        balanced ceil(n_fwd / n_chunks), so the padding waste is < n_chunks
        clips (40 valid clips at forward_chunk=30 forward 2x20, not 2x30).
        With `devices`, forward_chunk is per device and the chunk rounds up
        to a multiple of their number, so each shard is even (echoflow's
        mesh formula). Returns (n_chunks, chunk, total)."""
        n_dev = len(self.devices) if self.devices else 1
        per_step = max(1, self.forward_chunk) * n_dev
        n_chunks = max(1, -(-n_fwd // per_step))
        chunk = -(-n_fwd // n_chunks)
        chunk = -(-chunk // n_dev) * n_dev
        return n_chunks, chunk, n_chunks * chunk

    def _forward(self, xs: torch.Tensor, model) -> torch.Tensor:
        seg, _ = forward(model, xs, self.decoder == "kernel", self.dtype, with_motion=False)
        with span("reinterp", device=seg.device):
            return torch.softmax(seg, dim=1)

    def _forward_chunk(self, xs: torch.Tensor) -> list:
        """Softmax probabilities of one chunk, on the first device: one
        contiguous shard of the clips per device, each copied without
        waiting and forwarded by that device's replica."""
        if len(self._devices) == 1:
            return [self._forward(xs, self._model)]
        per = xs.shape[0] // len(self._devices)
        out = []
        for i, dev in enumerate(self._devices):
            shard = xs[i * per:(i + 1) * per].to(dev, non_blocking=True)
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                probs = self._forward(shard, self._replicas[dev])
            out.append(probs.to(self.device, non_blocking=True))
        return out

    def _operands(self, length: int, num_clips: int, step: int, t_pad: int):
        """Per-length device operands, built once (LRU-bounded)."""
        built = []

        def build():
            built.append(True)
            ops = _build_host_operands(length, num_clips, step, t_pad)
            vidx = ops["valid_clip_idx"]
            n_valid = len(vidx)
            _, _, total = self._chunk_plan(n_valid)
            # Forward-gather indices: valid slots, then clip 0 as padding.
            clip_src = np.zeros(total, np.int64)
            clip_src[:n_valid] = vidx
            # Inverse map grid slot -> forwarded position; slots that were
            # never forwarded point at row `total`, an appended zero row.
            clip_inv = np.full(ops["k_num"] * ops["c_max"], total, np.int64)
            clip_inv[vidx] = np.arange(n_valid)
            dev = [upload(torch.from_numpy(a), self.device) for a in
                   (ops["fwd"], ops["bwd"], ops["gather_idx"], ops["valid"],
                    clip_src, clip_inv)]
            return ops["k_num"], n_valid, dev

        ops = get_or_build(self._operand_cache, self._cache_lock,
                           (length, num_clips, step, t_pad), build,
                           lru_cap=self.operand_cache_size)
        count("engine.operand_misses" if built else "engine.operand_hits")
        return ops

    @torch.no_grad()
    def _run(self, video, k_num, n_fwd, fuse_method, mono, fwd, bwd, gather_idx,
             valid, clip_src, clip_inv):
        t_pad = video.shape[1]
        c_max = t_pad // CLIP_LEN
        with span("shift", device=video.device):
            # uint8 from the host (4x less traffic), normalized on the
            # device; zeroone is idempotent, so pre-normalized floats are
            # unchanged. Padding replicates the last frame: the min/max
            # are unaffected.
            video = zeroone_normalize(video.float())
            h, w = video.shape[2], video.shape[3]
            # 1. shift + tail-stretch, all shifts at once: (K, C, T', H, W)
            shifted = torch.einsum("kst,cthw->kcshw", fwd, video)
            if mono:
                # Replicate to RGB only after the channel-proportional work.
                shifted = shifted.expand(k_num, 3, *shifted.shape[2:])
            # 2. slice to clips and keep only the clips that exist
            clips = shifted.reshape(k_num, 3, c_max, CLIP_LEN, h, w).movedim(1, 2)
            clips = clips.reshape(k_num * c_max, 3, CLIP_LEN, h, w)[clip_src]
        n_chunks, chunk, _ = self._chunk_plan(n_fwd)
        probs = [p for i in range(n_chunks)
                 for p in self._forward_chunk(clips[i * chunk:(i + 1) * chunk])]
        with span("reinterp", device=video.device):
            # Restore the full k-major (K * c_max) clip grid; slots never
            # forwarded read the appended zero row (exact zeros, as the
            # all-zero `bwd` columns they meet would give).
            probs.append(probs[0].new_zeros((1, *probs[0].shape[1:])))
            probs = torch.cat(probs)[clip_inv]
            # 3. reassemble (K, 2, T', H, W); re-interp to true lengths
            probs = probs.reshape(k_num, c_max, 2, CLIP_LEN, h, w).movedim(2, 1)
            probs = probs.reshape(k_num, 2, c_max * CLIP_LEN, h, w)
            interp = torch.einsum("kts,kcshw->kcthw", bwd, probs)   # (K, 2, T, H, W)
            k_idx = torch.arange(k_num, device=interp.device)[None, :]
        # 4. shift-aligned rater stack (T, K, ...), fused per frame
        with span("fusion", device=video.device):
            if fuse_method == "softmax":
                stack = interp.movedim(2, 0)[gather_idx, k_idx]     # (T, K, 2, H, W)
                return _packbits(softmax_mean_fuse(stack, valid))
            labels = torch.argmax(interp, dim=1).to(torch.uint8)    # (K, T, H, W)
            stack = labels.movedim(1, 0)[gather_idx, k_idx]         # (T, K, H, W)
            return _packbits(fuse_frames(stack, valid, method=fuse_method))

    def _dispatch(self, video, num_clips, step, fuse_method, mono):
        """A Future of `_stage_and_run` on the engine's dispatch thread,
        under the video's number."""
        with self._cache_lock:
            if self._dispatcher is None:
                self._dispatcher = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="echoflow-dispatch")
        return self._dispatcher.submit(self._stage_and_run, video, num_clips, step,
                                       fuse_method, mono, next(self._seqs), time.time_ns())

    # ----------------------------------------------------------------- api
    def segment_video_async(self, video: np.ndarray, num_clips: int = 1,
                            step: int = 1, fuse_method: str = "simple",
                            mono: bool | None = None):
        """Enqueue segmentation without waiting for the card; returns
        (pending, (length, width)). `pending.numpy()` waits and gives the
        packed mask; `_unpackbits(..., width)[:length]` unpacks it. The
        staging and dispatch run on the engine's dispatch thread; this call
        waits for them, not for the card.

        `mono=None` detects grayscale-in-RGB videos (all three channels
        bit-identical, the normal case for echo AVIs) and ships one
        channel, replicated on the device: 3x less host->device traffic for
        identical masks. Pass False to force the RGB path."""
        if fuse_method not in ("majority", "simple", "staple", "softmax"):
            raise ValueError(f"unknown fuse method: {fuse_method}")
        return self._dispatch(video, num_clips, step, fuse_method, mono).result()

    def _stage_and_run(self, video, num_clips, step, fuse_method, mono, seq, submitted):
        """`segment_video_async`'s work, on the dispatch thread: the host
        operands, the pinned upload, the device work, the pinned download,
        for the video numbered `seq`, handed over at `submitted`
        (`time.time_ns()`)."""
        record("engine.queue", seq, submitted, time.time_ns())
        with span("engine.stage", id=seq):
            return self._stage(video, num_clips, step, fuse_method, mono, seq)

    def _stage(self, video, num_clips, step, fuse_method, mono, seq):
        length = int(video.shape[1])
        t_pad = max(self.bucket, -(-length // self.bucket) * self.bucket)
        k_num, n_fwd, dev_ops = self._operands(length, num_clips, step, t_pad)

        video = np.asarray(video)
        if video.shape[0] == 1:
            mono = True   # a single channel can only take the mono path
        elif mono is None:
            mono = (video.shape[0] == 3
                    and np.array_equal(video[0], video[1])
                    and np.array_equal(video[1], video[2]))
        dtype = torch.uint8 if video.dtype == np.uint8 else torch.float32
        src = torch.from_numpy(np.ascontiguousarray(video[:1] if mono else video))
        cuda = self.device.type == "cuda"
        vid = torch.empty((src.shape[0], t_pad, *src.shape[2:]), dtype=dtype,
                          pin_memory=cuda)
        vid[:, :length] = src
        vid[:, length:] = src[:, -1:]  # replicate-pad: keeps min/max honest
        with span("copies"):
            vid = vid.to(self.device, non_blocking=True)

        packed = self._run(vid, k_num, n_fwd, fuse_method, mono, *dev_ops)
        if not cuda:
            return _Pending(packed, seq=seq), (length, int(video.shape[3]))
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        with span("copies"):
            host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return _Pending(host, done, seq), (length, int(video.shape[3]))

    @staticmethod
    def _fetch(pending: _Pending, length: int, width: int) -> np.ndarray:
        """The (L, H, W) mask of a dispatched video: the wait for its
        download, then the unpack."""
        with span("engine.fetch", id=pending.seq):
            return _unpackbits(pending.numpy(), width)[:length]

    def segment_video(self, video: np.ndarray, num_clips: int = 1, step: int = 1,
                      fuse_method: str = "simple") -> np.ndarray:
        """video: (3, L, H, W), uint8 raw intensities (preferred) or float
        already in [0, 1]; per-channel zeroone normalization happens on the
        device either way. Returns (L, H, W) uint8 labels (the reference
        `segment_a_video_with_fusion` contract, fuse_utils.py:36-102)."""
        pending, (length, width) = self.segment_video_async(video, num_clips, step,
                                                            fuse_method)
        return self._fetch(pending, length, width)

    def segment_videos(self, videos, num_clips: int = 1, step: int = 1,
                       fuse_method: str = "simple", queue_depth: int = 3):
        """Segment a sequence of videos with dispatch-ahead pipelining: up
        to `queue_depth` videos are in flight; staging and dispatch run on
        the engine's dispatch thread (FIFO, so order is kept) and results
        are fetched on background threads, so host->device copies, the
        card's work and the caller's per-video work overlap. Yields
        (L, H, W) uint8 masks in order."""
        from collections import deque

        if fuse_method not in ("majority", "simple", "staple", "softmax"):
            raise ValueError(f"unknown fuse method: {fuse_method}")

        def fetch(handle_future):
            pending, (length, width) = handle_future.result()
            return self._fetch(pending, length, width)

        with ThreadPoolExecutor(max_workers=2) as fetch_pool:
            inflight: deque = deque()
            for video in videos:
                handle = self._dispatch(video, num_clips, step, fuse_method, None)
                inflight.append(fetch_pool.submit(fetch, handle))
                if len(inflight) >= queue_depth:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()


def segment_a_video_with_fusion(video, segmenter: VideoSegmenter,
                                interpolate_last: bool = True, step: int = 1,
                                num_clips: int = 10, fuse_method: str = "simple",
                                class_list=(0, 1)) -> np.ndarray:
    """Reference-named alias (fuse_utils.py:36) over a `VideoSegmenter`.
    `interpolate_last` and `class_list` exist for signature parity: the
    engine always tail-interpolates and the EchoNet task is binary."""
    del interpolate_last, class_list
    return segmenter.segment_video(np.asarray(video), num_clips=num_clips,
                                   step=step, fuse_method=fuse_method)
