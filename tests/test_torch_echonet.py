"""echoflow_torch.data.{echonet,fixtures,qa} and the EchoNet path of
train_clasfv_torch.py against echoflow's, on synthetic EchoNet-format roots
that both packages write from the same seeds."""

import filecmp
import json
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from echoflow.data import echonet as JE
from echoflow.data import fixtures as JF
from echoflow.data import qa as JQ

from echoflow_torch.data import echonet as TE
from echoflow_torch.data import fixtures as TF
from echoflow_torch.data import qa as TQ

torch.set_num_threads(2)

# The port's trilinear resize against echoflow's: float32 sums of two-term
# products in another order (tests/test_torch_resize.py), then the [0, 1]
# normalization.
RESIZE_TOL = 1e-6


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's `tmp_path`, removed after the test. The files written here
    hold the whole model (126 MB of weights; a checkpoint with Adam's
    state 362 MB), and pytest keeps the directories of its last three
    runs: left alone, they fill the disk that later checkpoints are saved
    to (`torch.save` then fails)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Six 80-frame videos (two per split), written by echoflow."""
    path = tmp_path_factory.mktemp("echonet")
    JF.make_synthetic_echonet_root(path, n_videos=6, num_frames=80, height=48, width=56)
    return str(path)


@pytest.mark.parametrize("order", ["ed_first", "es_first"])
def test_fixture_root_matches_echoflow(tmp_path, order):
    kw = dict(n_videos=4, num_frames=50, height=40, width=40, seed=2, trace_file_order=order)
    JF.make_synthetic_echonet_root(tmp_path / "jax", **kw)
    TF.make_synthetic_echonet_root(tmp_path / "port", **kw)
    for name in ("FileList.csv", "VolumeTracings.csv"):
        assert (tmp_path / "jax" / name).read_text() == (tmp_path / "port" / name).read_text()
    names = sorted(p.name for p in (tmp_path / "jax" / "Videos").iterdir())
    assert len(names) == 4
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax" / "Videos",
                                               tmp_path / "port" / "Videos", names,
                                               shallow=False)
    assert (mismatch, errors) == ([], [])


def test_fusion_rater_stacks_match():
    got, want = TF.make_fusion_rater_stacks(), JF.make_fusion_rater_stacks()
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_index_matches(root):
    got, want = TE.EchoNetIndex(root), JE.EchoNetIndex(root)
    pd.testing.assert_frame_equal(got.file_list, want.file_list)
    assert got.trace_frame_order == want.trace_frame_order
    assert got.traces.keys() == want.traces.keys()
    for name in want.traces:
        for frame, chords in want.traces[name].items():
            np.testing.assert_array_equal(got.traces[name][frame], chords)
        for order in ("area", "file"):
            g = got.traced_frames(name, (48, 56), order=order)
            w = want.traced_frames(name, (48, 56), order=order)
            assert g[:2] == w[:2]
            np.testing.assert_array_equal(g[2], w[2])
            np.testing.assert_array_equal(g[3], w[3])
    for split in ("train", "val", "test"):
        pd.testing.assert_frame_equal(got.split(split), want.split(split))
        assert len(got.split(split)) == 2
    with pytest.raises(ValueError):
        got.traced_frames(name, (48, 56), order="size")


def test_avi_decode_and_rasterize_match(root):
    path = TE.EchoNetIndex(root).video_path("synth0001.avi")
    video = TE.load_avi(path)
    assert video.shape == (3, 80, 48, 56) and video.dtype == np.float32
    np.testing.assert_array_equal(video, JE.load_avi(path))
    rng = np.random.RandomState(0)
    for _ in range(5):
        chords = np.cumsum(rng.uniform(-3, 6, (21, 4)), axis=0) + 10
        np.testing.assert_array_equal(TE.rasterize_trace(chords, (48, 56)),
                                      JE.rasterize_trace(chords, (48, 56)))
    ys, xs = rng.randint(0, 40, 8), rng.randint(0, 50, 8)
    np.testing.assert_array_equal(TE.polygon_mask(ys, xs, (48, 56)),
                                  JE.polygon_mask(ys, xs, (48, 56)))


def test_mean_and_std_match(root):
    for split, max_videos in (("train", 128), ("test", 1)):
        got = TE.get_mean_and_std(TE.EchoNetIndex(root), split, max_videos=max_videos, seed=3)
        want = JE.get_mean_and_std(JE.EchoNetIndex(root), split, max_videos=max_videos, seed=3)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_window_samplers_match():
    """Same draws from `RandomState` in the same order, and the same
    exceptions where the reference's window does not exist."""
    cases = np.random.RandomState(1)
    rngs = [np.random.RandomState(7), np.random.RandomState(7)]
    for _ in range(300):
        ed = int(cases.randint(0, 60))
        es = ed + int(cases.randint(-3, 40))
        vlen = max(es, ed) + int(cases.randint(1, 40))
        length = int(cases.choice([8, 32, 96]))
        outs = []
        for mod, rng in zip((TE, JE), rngs):
            try:
                outs.append(mod.random_start_and_end(ed, es, vlen, length, rng))
            except (AssertionError, ValueError) as exc:
                outs.append(type(exc))
        assert outs[0] == outs[1], (ed, es, vlen, length)
        mid = int(cases.randint(0, vlen))
        assert TE.random_start_given_mid_point(mid, vlen, length, rngs[0]) == \
            JE.random_start_given_mid_point(mid, vlen, length, rngs[1])
    assert rngs[0].randint(1 << 30) == rngs[1].randint(1 << 30)


def _same_item(got, want, exact):
    gv, (gf, *gt) = got
    wv, (wf, *wt) = want
    assert gf == wf and gv.shape == wv.shape and gv.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(gv, wv)
    else:
        np.testing.assert_allclose(gv, wv, rtol=0, atol=RESIZE_TOL)
    assert gt[:5] == wt[:5]   # EF, es/ed clip index, es/ed index
    for g, w in zip(gt[5:], wt[5:]):   # es/ed frame, es/ed label
        np.testing.assert_array_equal(g, w)


def _datasets(root, cls_name, **kw):
    mean_std = JE.get_mean_and_std(JE.EchoNetIndex(root), "train")
    return (getattr(TE, cls_name)(root, mean_std=mean_std, **kw),
            getattr(JE, cls_name)(root, mean_std=mean_std, **kw))


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("clip_length", [32, 8, "full", 96])
def test_dataset_items_match(root, split, clip_length):
    """Equal filenames, indices and labels; videos bitwise, or within the
    resize tolerance where a short window is shrunk (96 > 80 frames)."""
    got, want = _datasets(root, "EchoNetDynamicDataset", split=split,
                          clip_length=clip_length, seed=4, raise_for_es_ed=False)
    assert len(got) == len(want) == 2
    for i in range(len(want)):
        _same_item(got[i], want[i], exact=clip_length != 96)


def test_dataset_period_and_subset_match(root):
    got, want = _datasets(root, "EchoNetDynamicDataset", split="test", clip_length=16,
                          period=2, subset_indices=[1, 0, 1], seed=5)
    assert len(got) == 3
    for i in range(3):
        _same_item(got[i], want[i], exact=True)


def test_dataset_special_test_indices_match(root, monkeypatch):
    """Patient 919's 3x temporal upsample and the blue videos' grayscale
    replication, reached by pointing both packages' tables at test index
    0 (the real indices need the full test split)."""
    for mod in (TE, JE):
        monkeypatch.setattr(mod, "BROKEN_FRAMERATE_TEST_INDEX", 0)
        monkeypatch.setattr(mod, "BLUE_VIDEOS", [0])
    for clip_length in ("full", 32):
        got, want = _datasets(root, "EchoNetDynamicDataset", split="test",
                              clip_length=clip_length, seed=6)
        item = got[0]
        if clip_length == "full":
            assert item[0].shape[1] == 240
        np.testing.assert_array_equal(item[0][0], item[0][1])   # grayscale replicated
        _same_item(item, want[0], exact=False)


def test_dataset_rejects_ed_after_es(root, tmp_path):
    """A video whose ED trace comes after its ES: the clasfv dataset raises
    (the reference's cross-heartbeat rejection); the ED/ES-only one does
    not."""
    vt = pd.read_csv(f"{root}/VolumeTracings.csv")
    fl = pd.read_csv(f"{root}/FileList.csv")
    name = "synth0000.avi"
    frames = sorted(vt[vt.FileName == name].Frame.unique())
    swap = {frames[0]: frames[1], frames[1]: frames[0]}
    sel = vt.FileName == name
    vt.loc[sel, "Frame"] = vt.loc[sel, "Frame"].map(swap)
    (tmp_path / "Videos").mkdir()
    (tmp_path / "Videos" / name).symlink_to(f"{root}/Videos/{name}")
    vt[sel].to_csv(tmp_path / "VolumeTracings.csv", index=False)
    fl[fl.FileName == name].to_csv(tmp_path / "FileList.csv", index=False)
    for mod in (TE, JE):
        ds = mod.EchoNetDynamicDataset(str(tmp_path), split="train", seed=0)
        with pytest.raises(ValueError, match="different heartbeats"):
            ds[0]
    got, want = _datasets(str(tmp_path), "EchoNetEDESOnlyDataset", split="train", seed=0)
    item = got[0]   # each read draws the next windows
    assert item["ed_index"] > item["es_index"]
    _same_ed_es_item(item, want[0], exact=True)


def _same_ed_es_item(got, want, exact):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k.endswith("_video_clip"):
            assert got[k].shape == w.shape and got[k].dtype == np.float32
            if exact:
                np.testing.assert_array_equal(got[k], w)
            else:
                np.testing.assert_allclose(got[k], w, rtol=0, atol=RESIZE_TOL)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("clip_length", [32, 96])
def test_ed_es_only_dataset_items_match(root, clip_length):
    got, want = _datasets(root, "EchoNetEDESOnlyDataset", split="train",
                          clip_length=clip_length, seed=8)
    for i in range(len(want)):
        _same_ed_es_item(got[i], want[i], exact=clip_length == 32)


def test_fold_indices_match():
    path = str(Path(__file__).resolve().parent.parent / "fold_indexes"
               / "stanford_valid_sampled_indices")
    assert TE.load_fold_indices(path) == JE.load_fold_indices(path)
    assert len(TE.load_fold_indices(path)) == 1258


@pytest.fixture(scope="module")
def qa_root(tmp_path_factory):
    """The real dataset's systolic-first trace order, one video with a
    malformed third traced frame (as tests/test_qa.py)."""
    path = tmp_path_factory.mktemp("echonet_qa")
    TF.make_synthetic_echonet_root(path, n_videos=4, num_frames=40, height=48, width=48,
                                   trace_file_order="es_first")
    vt = pd.read_csv(path / "VolumeTracings.csv")
    bad = vt.iloc[:3].copy()
    bad["Frame"] = 35
    bad["FileName"] = "synth0000.avi"
    pd.concat([vt, bad]).to_csv(path / "VolumeTracings.csv", index=False)
    return str(path)


@pytest.mark.parametrize("split", ["train", "test"])
def test_qa_report_matches(qa_root, split):
    got, want = TQ.qa_report(qa_root, split), JQ.qa_report(qa_root, split)
    assert got == want
    assert list(got["multi_trace_videos"]) == ["synth0000.avi"]
    assert TQ.BLUE_TEST_INDICES is TE.BLUE_VIDEOS
    assert TQ.BROKEN_FRAMERATE_TEST_INDICES == [TE.BROKEN_FRAMERATE_TEST_INDEX] == [919]


def test_qa_main_prints_the_report(qa_root, capsys):
    TQ.main([qa_root, "--split", "test"])
    got = capsys.readouterr().out
    JQ.main([qa_root, "--split", "test"])
    assert got == capsys.readouterr().out
    assert json.loads(got)["split"] == "test"


@pytest.mark.parametrize("recipe", ["clasfv", "ed_es_only"])
def test_trainers_first_echonet_batches_match(root, recipe):
    import train_clasfv
    import train_clasfv_torch

    cls = "EchoNetEDESOnlyDataset" if recipe == "ed_es_only" else "EchoNetDynamicDataset"
    got_ds, want_ds = _datasets(root, cls, split="train", clip_length=32, seed=9)
    batcher = "echonet_ed_es_batches" if recipe == "ed_es_only" else "echonet_batches"
    got = next(getattr(train_clasfv_torch, batcher)(got_ds, 2, 1))
    want = next(getattr(train_clasfv, batcher)(want_ds, 2, 1))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_train_clasfv_torch_trains_on_an_echonet_root(tmp_path):
    import train_clasfv_torch

    data = tmp_path / "echonet"
    TF.make_synthetic_echonet_root(data, n_videos=6, num_frames=40, height=24, width=24)
    out = tmp_path / "ck.pth"
    state = train_clasfv_torch.main([
        "--data", str(data), "--device", "cpu", "--epoch-subsample", "2", "--steps", "2",
        "--image-size", "24", "--clip-length", "8", "--batch-size", "2", "--epochs", "1",
        "--out", str(out), "--log-every", "1"])
    assert state.step == 1   # two training videos: one batch of 2
    ck = torch.load(str(out) + ".last", weights_only=True)
    assert ck["step"] == 1 and np.isfinite(ck["extra"]["val_loss"])
    assert out.exists()
    # bf16 on the same root: fp32 parameters in its checkpoint, which resumes.
    args16 = ["--data", str(data), "--device", "cpu", "--epoch-subsample", "2", "--steps", "2",
              "--image-size", "24", "--clip-length", "8", "--batch-size", "2",
              "--out", str(tmp_path / "ck16.pth"), "--compute-dtype", "bf16"]
    state = train_clasfv_torch.main(args16 + ["--epochs", "1"])
    assert state.step == 1 and state.model.compute_dtype == torch.bfloat16
    ck16 = torch.load(str(tmp_path / "ck16.pth.last"), weights_only=True)
    assert all(v.dtype == torch.float32 for v in ck16["model"].values()
               if v.is_floating_point())
    state = train_clasfv_torch.main(args16 + ["--epochs", "2", "--resume",
                                              str(tmp_path / "ck16.pth.last")])
    assert state.step == 2
