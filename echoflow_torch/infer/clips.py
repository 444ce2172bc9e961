"""Batched raw clip inference for the clip studies (port of
`echoflow.infer.clips`).

Every start point's 32-frame clip goes through the network in chunks of
`forward_chunk` clips, and the raw per-clip outputs come back: the
segmentation softmax and the motion fields, which the clip studies plot and
the motion propagation of `infer/propagate.py` consumes. Unlike
`VideoSegmenter` (infer/pipeline.py) nothing is fused.

With `fold_bn=True` (the default) the chunks run the folded forward of
`models/fast_forward.py`, whose decoder tail is the CUDA kernel of
`ops/decoder_heads.py` (with its motion head) on the card and the plain
decoder on the CPU. echoflow's ClipForward passes `pallas=False` there; the
port uses its kernel, as its engine does. With `fold_bn=False` the chunks
run the module's own forward.

Only the clips that exist are forwarded: echoflow pads the stack to a whole
number of chunks for XLA, the port's last chunk is shorter (the outputs of
the real clips are the same).

On the card each chunk's forward runs as a CUDA graph, as echoflow jits its
`lax.map` over the chunks (`utils/graphs.GraphedFunction`): one graph for
each chunk shape (so a shorter last chunk is a second graph), made at the
second chunk of that shape and replayed after that. `_forward.__wrapped__`
is the eager forward; the CPU runs it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from echoflow_torch.models.fast_forward import folded_forward
from echoflow_torch.models.fold_bn import fold_state_dict, is_folded
from echoflow_torch.models.r2plus1d import R2Plus1DMotionSegNet
from echoflow_torch.utils.device import upload
from echoflow_torch.utils.graphs import GraphedFunction, model_memory, module_bindings

CLIP_LEN = 32


@dataclass
class ClipForward:
    """Chunked batched forward over arbitrary clip stacks.

    Parameters mirror `VideoSegmenter`: `variables` is the port's state
    dict (a state dict without BN statistics is taken as folded), `device`
    is "cuda" (default; raises without a card) or "cpu", and float32 on
    CUDA turns TF32 off for cuDNN and matmuls (process-wide). `dtype` is
    the compute dtype; `forward_chunk` clips are forwarded at a time.
    """

    variables: dict
    device: object = "cuda"
    dtype: object = torch.float32
    forward_chunk: int = 8
    fold_bn: bool = True
    with_motion: bool = True

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ClipForward: no CUDA device (pass device='cpu' to run on "
                               "the CPU)")
        if self.device.type == "cuda" and self.dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        state = dict(self.variables)
        folded = is_folded(state)
        if self.fold_bn and not folded:
            state = fold_state_dict(state)
            folded = True
        model = R2Plus1DMotionSegNet(folded=folded)
        model.load_state_dict(state)
        model.eval().requires_grad_(False)
        if self.fold_bn:
            model.r2plus1d_model.to(self.dtype)
        else:   # fp32 parameters, BatchNorm statistics included (flax's rule)
            model.compute_dtype = self.dtype
        self._model = model.to(self.device)
        if self.device.type == "cuda":
            self._forward = self._graphed(self._forward)

    def _graphed(self, forward, wrapper=GraphedFunction):
        """`forward` (the eager chunk forward) as CUDA graphs of the model:
        its parameters are the graphs' bindings, its pool their memory."""
        model = self._model
        return wrapper(forward, memory=model_memory(model, self.device),
                       bindings=lambda **others: module_bindings(model))

    @torch.no_grad()
    def _forward(self, xs: torch.Tensor):
        if self.fold_bn:
            seg, motion = folded_forward(self._model, xs, dtype=self.dtype,
                                         with_motion=self.with_motion)
        else:
            seg, motion = self._model(xs)
        probs = torch.softmax(seg, dim=1)
        return (probs, motion) if self.with_motion else (probs,)

    def __call__(self, clips: np.ndarray):
        """clips: (N, 3, 32, H, W) float in [0, 1]. Returns
        (seg_probs (N, 2, 32, H, W), motion (N, 4, 32, H, W)), float32
        numpy, or just (seg_probs,) when constructed with
        `with_motion=False`. On the card every chunk's outputs are copied
        into pinned host memory without waiting; the call waits once, at
        its end."""
        clips = np.ascontiguousarray(clips, np.float32)
        n, _, t, h, w = clips.shape
        cuda = self.device.type == "cuda"
        heads = (2, 4) if self.with_motion else (2,)
        outs = tuple(torch.empty((n, c, t, h, w), dtype=torch.float32, pin_memory=cuda)
                     for c in heads)
        step = max(1, self.forward_chunk)
        for start in range(0, n, step):
            xs = upload(torch.from_numpy(clips[start:start + step]), self.device)
            for host, out in zip(outs, self._forward(xs)):
                host[start:start + len(xs)].copy_(out, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return tuple(o.numpy() for o in outs)

    def segment_start_points(self, video: np.ndarray, starts,
                             clip_length: int = CLIP_LEN):
        """Forward the clip at every start point in one batch.

        video: (3, L, H, W) float in [0, 1]. Returns (segmentations
        (S, 32, H, W) uint8 argmax labels, seg_probs, motion), the arrays
        the study notebooks derive every plot from."""
        starts = np.asarray(starts, np.int64)
        if starts.size == 0:
            # e.g. a systole exactly clip_length long has no covering
            # window (the infer/ef.py start-point helpers return empty).
            _, _, h, w = video.shape
            empty = lambda ch: np.zeros((0, ch, clip_length, h, w), np.float32)
            outs = (empty(2),) if not self.with_motion else (empty(2), empty(4))
            return (np.zeros((0, clip_length, h, w), np.uint8), *outs)
        clips = np.stack([video[:, s:s + clip_length] for s in starts])
        out = self(clips)
        labels = np.argmax(out[0], axis=1).astype(np.uint8)
        return (labels, *out)
