"""motion_segment_torch.py against motion_segment.py: both CLIs with
`-c all` on the CPU, on a model-sized AVI and on one that needs the
resize, with the same seeded weights saved once as an echoflow `.pkl`;
then the port CLI's own flags, preprocessing and errors."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

import motion_segment
import motion_segment_torch
from echoflow.data.synthetic import make_beating_video, write_synthetic_avi
from echoflow.models.r2plus1d import R2Plus1DMotionSegNet as FlaxNet, init_variables
from echoflow.train.checkpoint import save_checkpoint

from echoflow_torch.models.convert import state_dict_from_variables
from echoflow_torch.models.r2plus1d import R2Plus1DMotionSegNet
from echoflow_torch.ops.normalize import zeroone_normalizer

torch.set_num_threads(2)

SIZE = 32
MASK_TOL = 1e-4   # resized case: the two resizes differ by float32 rounding


@pytest.fixture(scope="module")
def weights_pkl(tmp_path_factory):
    """echoflow's init, seg head x50, the head bias centred on a clip's
    median logit margin (tests/test_torch_pipeline.py), saved as an
    echoflow training checkpoint."""
    v = jax.tree.map(np.asarray, init_variables(
        jax.random.PRNGKey(3), FlaxNet(), (1, 3, 32, SIZE, SIZE)))
    v["params"]["seg_head"]["kernel"] = v["params"]["seg_head"]["kernel"] * 50.0
    model = R2Plus1DMotionSegNet()
    model.load_state_dict(state_dict_from_variables(v))
    beat = make_beating_video(num_frames=32, height=SIZE, width=SIZE, period=20.0, seed=1)
    with torch.no_grad():
        seg, _ = model.eval()(torch.from_numpy(zeroone_normalizer(beat.video.copy()))[None])
    med = float((seg[0, 1] - seg[0, 0]).median())
    v["params"]["seg_head"]["bias"] = (v["params"]["seg_head"]["bias"]
                                       + np.array([med / 2, -med / 2], np.float32))
    path = tmp_path_factory.mktemp("weights") / "seeded.pkl"
    save_checkpoint(str(path), {"step": 0, "params": v["params"],
                                "batch_stats": v["batch_stats"], "opt_state": None,
                                "rng": None})
    return str(path)


def _gif_frames(path):
    from PIL import Image

    with Image.open(path) as im:
        return im.n_frames


@pytest.mark.parametrize("hw", [(SIZE, SIZE), (40, 48)], ids=["model_sized", "resized"])
def test_cli_matches_echoflow_cli(tmp_path, weights_pkl, hw):
    avi = str(tmp_path / "echo.avi")
    write_synthetic_avi(avi, num_frames=64, height=hw[0], width=hw[1], period=20.0, seed=3)
    runs = {}
    for name, cli in (("echoflow", motion_segment), ("port", motion_segment_torch)):
        out = tmp_path / name
        segs, efs, pairs = cli.main(["-p", avi, "-m", weights_pkl, "-d", "cpu", "-f", "2",
                                     "-s", "1", "-c", "all", "-o", str(out),
                                     "--height", str(SIZE), "--width", str(SIZE)])
        files = sorted(os.listdir(out))
        pkls = {}
        for f in files:
            if f.endswith(".pkl"):
                with open(out / f, "rb") as fh:
                    pkls[f] = pickle.load(fh)
        runs[name] = dict(segs=segs, efs=efs, pairs=pairs, files=files, pkls=pkls,
                          gif=_gif_frames(out / "echo_annotated.gif"))
    want, got = runs["echoflow"], runs["port"]
    assert got["segs"].shape == (64, SIZE, SIZE) and got["segs"].dtype == np.uint8
    assert 0.05 < got["segs"].mean() < 0.95
    assert got["files"] == want["files"]
    assert got["gif"] == want["gif"] == 64
    for f, mask in want["pkls"].items():
        assert got["pkls"][f].shape == mask.shape and got["pkls"][f].dtype == mask.dtype
        if hw == (SIZE, SIZE):   # the same float32 video in: identical masks
            np.testing.assert_array_equal(got["pkls"][f], mask, err_msg=f)
        else:
            assert float((got["pkls"][f] != mask).mean()) <= MASK_TOL, f
    assert got["pairs"] == want["pairs"]
    assert got["efs"] == want["efs"] and all(np.isfinite(got["efs"]))
    if hw == (SIZE, SIZE):
        assert len(got["pairs"]) >= 1


@pytest.mark.parametrize("hw", [(SIZE, SIZE), (40, 48)], ids=["model_sized", "resized"])
def test_preprocess_matches_echoflow(tmp_path, hw):
    avi = str(tmp_path / "echo.avi")
    write_synthetic_avi(avi, num_frames=12, height=hw[0], width=hw[1])
    got = motion_segment_torch.load_and_preprocess_video(avi, SIZE, SIZE)
    want = motion_segment.load_and_preprocess_video(avi, SIZE, SIZE)
    assert got.shape == (3, 12, SIZE, SIZE) and got.dtype == np.float32
    np.testing.assert_array_equal(motion_segment_torch.read_video_rgb(avi),
                                  motion_segment.read_video_rgb(avi))
    if hw == (SIZE, SIZE):
        np.testing.assert_array_equal(got, want)
    else:
        # fp32 sums of two-term products in another order
        # (tests/test_torch_resize.py), through the [0, 1] normalization.
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        for c in range(3):
            assert float(got[c].min()) == 0.0 and float(got[c].max()) == 1.0


def test_flags_and_precision_policy():
    args = motion_segment_torch.parse_args(["-p", "v.avi"])
    assert args.device == "cuda" and args.precision == "fp32"
    assert (args.fuse, args.step, args.fuse_method, args.content) == (1, 1, "simple", "binary")
    policy = motion_segment_torch.precision_policy
    assert policy("auto") == {}
    assert policy("fp32") == {"dtype": torch.float32}
    assert policy("mixed") == {"dtype": torch.float32, "backbone_dtype": torch.bfloat16}
    assert policy("bf16") == {"dtype": torch.bfloat16}
    from echoflow_torch.infer.pipeline import VideoSegmenter

    assert VideoSegmenter.__dataclass_fields__["dtype"].default == "auto"


def test_device_flag():
    resolve = motion_segment_torch.resolve_device
    assert [resolve(d) for d in ("cuda", "gpu", "CUDA", "cpu", "Cpu")] == \
        ["cuda", "cuda", "cuda", "cpu", "cpu"]
    for bad in ("tpu", "", "cuda:0"):
        with pytest.raises(ValueError):
            resolve(bad)
    with pytest.raises(ValueError):   # before any decode: the path does not exist
        motion_segment_torch.main(["-p", "missing.avi", "-d", "tpu"])


def _video():
    beat = make_beating_video(num_frames=40, height=SIZE, width=SIZE, period=20.0, seed=2)
    return zeroone_normalizer(beat.video.copy())


def test_run_defaults_to_the_card(tmp_path, weights_pkl):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = motion_segment_torch.parse_args(["-p", "echo.avi", "-m", weights_pkl,
                                            "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        motion_segment_torch.run(_video(), args)


def test_missing_weights_warn_and_use_seeded_init(tmp_path, capsys):
    args = motion_segment_torch.parse_args([
        "-p", "echo.avi", "-m", str(tmp_path / "none.pth"), "-d", "cpu", "-c", "binary_video",
        "-o", str(tmp_path), "-v"])
    segs, efs, pairs = motion_segment_torch.run(_video(), args)
    out = capsys.readouterr()
    assert "WARNING: weights not found" in out.err
    assert "R2+1D MotionNet has 31575731 parameters." in out.out
    assert segs.shape == (40, SIZE, SIZE) and segs.dtype == np.uint8
    with open(tmp_path / "echo_whole_video_segmentation.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f), segs)
    assert os.listdir(tmp_path) == ["echo_whole_video_segmentation.pkl"]


def test_cli_returns_zero(tmp_path, weights_pkl):
    avi = str(tmp_path / "echo.avi")
    write_synthetic_avi(avi, num_frames=40, height=SIZE, width=SIZE, period=20.0)
    assert motion_segment_torch.cli(["-p", avi, "-m", weights_pkl, "-d", "cpu",
                                     "--height", str(SIZE), "--width", str(SIZE),
                                     "-o", str(tmp_path / "out")]) == 0
