"""The port's plain-numpy utilities against echoflow's: the config tree,
the metrics logger, the segmentation cleanup, the echo IO helpers, the
CAMUS metrics (all bitwise on the same seeded inputs), and the profiling
helpers (waiting for a result, and a torch.profiler trace with the
program's spans). Mirrors
`tests/test_{config,utils_misc,camus_metrics}.py` and the cleanup tests of
`tests/test_camus.py`."""

import json
import os

import numpy as np
import pytest
import torch

import echoflow.config as JC
import echoflow.metrics.camus as JM
import echoflow.utils.cleanup as JCl
import echoflow.utils.echo_io as JIO
import echoflow.utils.metrics_log as JL
import echoflow_torch.config as TC
import echoflow_torch.metrics.camus as TM
import echoflow_torch.utils.cleanup as TCl
import echoflow_torch.utils.echo_io as TIO
import echoflow_torch.utils.metrics_log as TL
from echoflow_torch.utils.profiling import block_until_ready, trace


def _rng():
    return np.random.RandomState(0)


# ---------------------------------------------------------------------- config

def test_config_defaults_match_echoflow():
    cfg = TC.EchoflowConfig()
    assert cfg.to_dict() == JC.EchoflowConfig().to_dict()
    assert cfg.model.clip_length == 32 and cfg.train.lr == 1e-4
    assert cfg.ef.trim_percentiles == (5, 85, 95) and cfg.infer.fuse_method == "simple"


def test_config_flag_overrides_match_echoflow():
    flags = ["train.lr=3e-4", "infer.num_clips=5", "model.dtype=bfloat16",
             "ef.trim_percentiles=10,80,90", "infer.interpolate_last=false",
             "data.root=/x", "model.image_size=64,64"]
    got = TC.EchoflowConfig.from_flags(flags)
    assert got.to_dict() == JC.EchoflowConfig.from_flags(flags).to_dict()
    assert got.infer.interpolate_last is False and got.model.image_size == (64, 64)


# ---------------------------------------------------------------------- logging

@pytest.mark.parametrize("fmt", ["jsonl", "csv"])
def test_metrics_logger_writes_what_echoflows_writes(tmp_path, fmt):
    rows = []
    for mod, name in ((JL, "jax"), (TL, "torch")):
        log = mod.MetricsLogger(str(tmp_path / name / f"m.{fmt}"), fmt=fmt)
        log.log(1, {"loss": 2.5, "dice": np.float32(0.9), "t": torch.tensor(0.25)})
        log.log(2, {"loss": 2.0, "dice": 0.92, "t": 0.5})
        rows.append([{k: v for k, v in r.items() if k != "wall_time_s"} for r in log.read()])
    assert rows[0] == rows[1] and len(rows[1]) == 2
    assert [str(r["step"]) for r in rows[1]] == ["1", "2"]
    if fmt == "jsonl":
        with open(tmp_path / "torch" / "m.jsonl") as f:
            assert [json.loads(line)["loss"] for line in f] == [2.5, 2.0]


# ---------------------------------------------------------------------- profiling

def test_block_until_ready_returns_the_nested_result():
    x = torch.ones(1000) * 3
    assert block_until_ready((x, [x])) == (x, [x])
    assert block_until_ready({"sum": [x.sum(), (x * 2).sum()]})["sum"][1] == 6000.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(32, 32).sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    with open(os.path.join(log_dir, "spans.json")) as f:
        assert {"host", "device", "counters", "dropped", "totals"} <= set(json.load(f))


# ---------------------------------------------------------------------- cleanup

def test_cleanup_binary_matches_echoflow():
    mask = np.zeros((20, 20), np.uint8)
    mask[2:10, 2:10] = 1
    mask[5, 5] = 0          # a hole
    mask[15:17, 15:17] = 1  # a small spurious component
    for fill in (True, False):
        got = TCl.cleanup_binary(mask, fill_holes=fill)
        np.testing.assert_array_equal(got, JCl.cleanup_binary(mask, fill_holes=fill))
    got = TCl.cleanupBinary(mask)
    assert got[5, 5] == 1 and got[15, 15] == 0 and got[3, 3] == 1
    assert not TCl.cleanup_binary(np.zeros((4, 4))).any()


def test_cleanup_segmentation_matches_echoflow():
    rng = _rng()
    lab = (rng.rand(3, 24, 24) * 3.6).astype(np.uint8)
    lab[:, 2:10, 2:10] = 1
    for num_classes in (None, 3):
        np.testing.assert_array_equal(TCl.cleanup_segmentation(lab, num_classes),
                                      JCl.cleanup_segmentation(lab, num_classes))
    np.testing.assert_array_equal(TCl.cleanupSegmentation(lab[0]),
                                  JCl.cleanupSegmentation(lab[0]))


# ---------------------------------------------------------------------- echo IO

def test_transform_resize_images_match_echoflow():
    rng = _rng()
    video = (rng.rand(5, 20, 24) * 255).astype(np.float32)
    lab = rng.randint(0, 4, (20, 24)).astype(np.int64)
    for fn in ("transformResizeImage", "transformResizeAndFlipImage"):
        got, want = getattr(TIO, fn)(video, (16, 16)), getattr(JIO, fn)(video, (16, 16))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(getattr(TIO, fn)(lab, (10, 10), outtype=np.int64),
                                      getattr(JIO, fn)(lab, (10, 10), outtype=np.int64))
    with pytest.raises(ValueError):
        TIO.transformResizeImage(np.zeros((1, 2, 3, 4)), (2, 2))


def test_read_mhd_npy_and_h5_match_echoflow(tmp_path):
    import h5py

    rng = _rng()
    vol = (rng.rand(4, 8, 10) * 255).astype(np.uint8)
    vol.tofile(tmp_path / "img.raw")
    (tmp_path / "img.mhd").write_text("ObjectType = Image\nNDims = 3\nDimSize = 10 8 4\n"
                                      "ElementType = MET_UCHAR\nElementDataFile = img.raw\n")
    mhd = str(tmp_path / "img.mhd")
    np.testing.assert_array_equal(TIO.read_mhd(mhd), vol)
    np.testing.assert_array_equal(TIO.read_mhd(mhd), JIO.read_mhd(mhd))
    np.save(tmp_path / "img.npy", vol.astype(np.float32))
    with h5py.File(tmp_path / "img.h5", "w") as f:
        f["echo"] = vol
    for path in (mhd, str(tmp_path / "img.npy")):
        np.testing.assert_array_equal(TIO.readTransformResizeImage(path, (8, 8)),
                                      JIO.readTransformResizeImage(path, (8, 8)))
    np.testing.assert_array_equal(
        TIO.readH5TransformResizeImage(str(tmp_path / "img.h5"), "echo", (6, 6)),
        JIO.readH5TransformResizeImage(str(tmp_path / "img.h5"), "echo", (6, 6)))
    with pytest.raises(ValueError, match="extension"):
        TIO.readTransformResizeImage(str(tmp_path / "img.png"), (8, 8))


def test_make_video_writes_the_same_file(tmp_path):
    rng = _rng()
    frames = rng.rand(6, 16, 16).astype(np.float32)
    labels = (rng.rand(6, 16, 16) > 0.5).astype(np.uint8)
    for mod, name in ((JIO, "jax"), (TIO, "torch")):
        for lab in (None, labels):
            mod.makeVideo(frames, str(tmp_path / f"{name}{lab is None}.avi"), labels=lab)
    for flag in (True, False):
        a = (tmp_path / f"jax{flag}.avi").read_bytes()
        b = (tmp_path / f"torch{flag}.avi").read_bytes()
        assert len(b) > 0 and a == b


# ---------------------------------------------------------------------- CAMUS metrics

def _fake_batch(rng, n=3, h=16, w=16):
    labels = rng.randint(0, 4, (n, 1, h, w)).astype(np.int64)
    logits = rng.randn(n, 4, h, w).astype(np.float32)
    for i in range(n):
        for k in range(4):
            logits[i, k][labels[i, 0] == k] += 2.0
    return logits, labels


def test_camus_metrics_match_echoflow():
    logits, labels = _fake_batch(_rng())
    np.testing.assert_array_equal(TM.getDices(logits, labels), JM.getDices(logits, labels))
    for autoseg in (logits, np.argmax(logits, axis=1)):
        for lab in (labels, labels[:, 0][:, None], np.eye(4)[labels[:, 0]].transpose(0, 3, 1, 2)):
            want = JM.camus_dice_by_name(autoseg, lab)
            got = TM.camus_dice_by_name(autoseg, lab)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    assert TM.camus_dice_by_name(logits, labels, {"LVLA": [1, 3]}).keys() == \
        JM.camus_dice_by_name(logits, labels, {"LVLA": [1, 3]}).keys()
    a, b = {"x": np.array([1.0]), "y": np.array([2.0])}, {"x": np.array([3.0]), "z": np.array([4.0])}
    got, want = TM.dict_extend_values(a, b), JM.dict_extend_values(a, b)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
    assert TM.labColorMap() == JM.labColorMap()
    img = _rng().rand(16, 16).astype(np.float32) * 255
    np.testing.assert_array_equal(TM.camus_overlay(img, labels[0, 0]),
                                  JM.camus_overlay(img, labels[0, 0]))
