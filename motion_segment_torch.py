"""Segment and motion-track heart structures in an echo video (CLI of
echoflow_torch, the PyTorch + CUDA port of `motion_segment.py`).

Same flags and artifacts as `motion_segment.py`
({name}_ED_Frame_{i}_segmentation.pkl, {name}_ES_Frame_{i}_segmentation.pkl,
{name}_whole_video_segmentation.pkl, {name}_annotated.gif), with the
engine of `echoflow_torch.infer.pipeline` on an NVIDIA GPU.

Usage:
    python motion_segment_torch.py -p video.avi [-m weights.pth|.pkl]
        [-d cuda|cpu] [-f num_shifts] [-s step]
        [--fuse_method simple|staple|majority|softmax]
        [-c gif,binary,binary_video,all] [-o outdir] [--height 112]
        [--width 112] [--precision fp32|auto|mixed|bf16] [-v]

Decoding (cv2), the GIF (matplotlib, PIL) and the rest run on the host;
`main` decodes the video and hands it to `run`, which does everything
after decoding.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

DEVICES = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def parse_args(argv=None):
    from echoflow_torch.models.r2plus1d import backbones

    ap = argparse.ArgumentParser(
        description="Segment and motion track heart structure in an Echo Video")
    ap.add_argument("-p", "--path", required=True, type=str, help="Path to the video")
    ap.add_argument("-m", "--model", required=False, type=str,
                    default="save_models/R2plus1DMotionSegNet_model.pth",
                    help="Path to the saved model weights (.pth reference or port "
                         "checkpoint, or .pkl echoflow checkpoint)")
    ap.add_argument("-d", "--device", required=False, type=str, default="cuda",
                    help="cuda (default; 'gpu' is an alias) or cpu. Without a CUDA "
                         "device, cuda raises")
    ap.add_argument("--fuse_method", required=False, type=str, default="simple",
                    help="simple | staple | majority | softmax")
    ap.add_argument("-f", "--fuse", required=False, type=int, default=1,
                    help="Number of shifted video copies to fuse (1 = no fusion)")
    ap.add_argument("-s", "--step", required=False, type=int, default=1,
                    help="Shift step between fused copies")
    ap.add_argument("-o", "--output", required=False, type=str, default=".")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-c", "--content", required=False, type=str, default="binary",
                    help="gif, binary, binary_video, all (comma-separated)")
    ap.add_argument("--backbone", required=False, type=str, default="r2plus1d_18",
                    choices=list(backbones()),
                    help="the backbone of the seeded network run when no weights are "
                         "found: CLAS-FV's R(2+1)D-18 (default) or ir-CSN-152 under the "
                         "same decoder (a checkpoint's keys name its own)")
    ap.add_argument("--height", required=False, type=int, default=112)
    ap.add_argument("--width", required=False, type=int, default=112)
    ap.add_argument("--precision", required=False, type=str, default="fp32",
                    choices=("auto", "fp32", "mixed", "bf16"),
                    help="fp32 (default): the parity path, TF32 off; auto: the "
                         "engine's default (bf16 on CUDA, fp32 on the CPU); mixed: "
                         "bf16 conv backbone with fp32 decoder and heads; bf16: bf16 "
                         "everywhere")
    return ap.parse_args(argv)


def resolve_device(name: str) -> str:
    """The `-d` flag as a torch device type: cuda (or its alias gpu), cpu."""
    try:
        return DEVICES[name.lower()]
    except KeyError:
        raise ValueError(f"-d {name!r}: use cuda (or gpu) or cpu") from None


def precision_policy(name: str) -> dict:
    """A `--precision` value as `VideoSegmenter` dtype arguments. auto: the
    engine's own default ("auto": bf16 on CUDA, fp32 on the CPU); fp32:
    the parity path; mixed: bf16 backbone, fp32 decoder and heads; bf16:
    bf16 everywhere."""
    import torch

    return {
        "auto": {},
        "fp32": {"dtype": torch.float32},
        "mixed": {"dtype": torch.float32, "backbone_dtype": torch.bfloat16},
        "bf16": {"dtype": torch.bfloat16},
    }[name]


def read_video_rgb(path: str):
    """Decode an AVI to (F, H, W, 3) uint8 RGB on the host (cv2)."""
    import cv2
    import numpy as np

    capture = cv2.VideoCapture(path)
    frame_count = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
    frames = []
    try:
        for count in range(frame_count):
            ret, frame = capture.read()
            if not ret:
                raise ValueError(f"Failed to load frame #{count} of {path}.")
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        capture.release()
    if not frames:
        raise ValueError(f"No frames decoded from {path}")
    return np.stack(frames)


def load_and_preprocess_video(path: str, height: int = 112, width: int = 112):
    """Decode and preprocess as `motion_segment.py` does: RGB decode ->
    (3, F, H, W) -> trilinear resize of H and W to the model size
    (align_corners=True, on the CPU) when needed -> per-channel [0, 1]
    normalization. Returns (3, F, height, width) float32."""
    import numpy as np
    import torch

    from echoflow_torch.ops.normalize import zeroone_normalizer
    from echoflow_torch.ops.resize import trilinear_resize

    raw = read_video_rgb(path)  # (F, H, W, 3) uint8
    video = np.ascontiguousarray(raw.transpose(3, 0, 1, 2))  # (3, F, H, W) uint8
    if video.shape[2:] != (height, width):
        x = torch.from_numpy(video.astype(np.float32))[None]
        video = trilinear_resize(x, (video.shape[1], height, width), align_corners=True)[0]
        video = video.numpy()
    return zeroone_normalizer(video)


def load_weights(path: str, backbone: str = "r2plus1d_18") -> dict:
    """The port's state dict from a `.pth` (reference or port checkpoint)
    or an echoflow `.pkl`; seeded random weights of the network over
    `backbone`, with a warning, when the file is missing."""
    from echoflow_torch.models.r2plus1d import create_model
    from echoflow_torch.train.checkpoint import load_model_variables

    if os.path.exists(path):
        return load_model_variables(path)
    print(f"WARNING: weights not found at {path}; "
          "running with randomly initialized weights.", file=sys.stderr)
    return create_model(seed=0, backbone=backbone).state_dict()


def run(video, args):
    """Everything after decoding: segment the preprocessed video
    (3, F, H, W) float32 in [0, 1], compute the per-beat EFs and write the
    artifacts `args.content` asks for. Returns (segmentations, efs,
    edes_pairs)."""
    import numpy as np

    from echoflow_torch.infer.ef import compute_ef_using_putative_clips
    from echoflow_torch.infer.pipeline import VideoSegmenter
    from echoflow_torch.models.fold_bn import is_folded
    from echoflow_torch.models.r2plus1d import backbone_of, backbones, param_count

    device = resolve_device(args.device)
    state = load_weights(args.model, args.backbone)
    backbone = backbone_of(state)   # a checkpoint's own, whatever --backbone says
    if args.verbose:
        net = backbones()[backbone]
        model = net(folded=is_folded(state))
        model.load_state_dict(state)
        print(f"{net.title} MotionNet has {param_count(model)} parameters.")

    segmenter = VideoSegmenter(state, device=device, **precision_policy(args.precision))
    segmentations = segmenter.segment_video(
        video, num_clips=args.fuse, step=args.step, fuse_method=args.fuse_method)

    predicted_efs, edes_pairs = compute_ef_using_putative_clips(
        segmentations, test_pat_index=args.path, return_edes=True)

    if args.verbose:
        print("Identified {:d} systoles".format(len(predicted_efs)))
        if predicted_efs:
            print("\nEjection fractions measured at each systole are:")
            for i, ef in enumerate(predicted_efs):
                ed, es = edes_pairs[i]
                print("Systole #{:d}: ED {:d} & ES {:d} length={:d}".format(
                    i + 1, ed, es, es - ed))
                print("EF: {:.2f}\n".format(ef))
            print("The average ejection fraction is {:.2f}".format(
                float(np.mean(predicted_efs))))

    name = os.path.basename(args.path)
    name = name[: name.rfind(".")] if "." in name else name
    content = args.content.lower().split(",")
    os.makedirs(args.output, exist_ok=True)

    if "gif" in content or "all" in content:
        from echoflow_torch.utils.visualize import make_annotated_gif

        make_annotated_gif(segmentations, video,
                           filename=os.path.join(args.output, name + "_annotated.gif"))

    if "binary" in content or "all" in content:
        for ed, es in edes_pairs:
            with open(os.path.join(
                    args.output, name + f"_ED_Frame_{ed}_segmentation.pkl"), "wb") as f:
                pickle.dump(segmentations[ed], f)
            with open(os.path.join(
                    args.output, name + f"_ES_Frame_{es}_segmentation.pkl"), "wb") as f:
                pickle.dump(segmentations[es], f)

    if "binary_video" in content or "all" in content:
        with open(os.path.join(
                args.output, name + "_whole_video_segmentation.pkl"), "wb") as f:
            pickle.dump(segmentations, f)

    return segmentations, predicted_efs, edes_pairs


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)   # a bad -d fails before the decode
    video = load_and_preprocess_video(args.path, args.height, args.width)
    return run(video, args)


def cli(argv=None):
    """Console-script entry point: setuptools wrappers run
    `sys.exit(entry())`, so main()'s (segmentations, efs, pairs) is
    dropped and 0 returned."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
