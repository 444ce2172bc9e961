"""echoflow_torch.utils.visualize against echoflow.utils.visualize: the same
masks, frames and values (numpy, from a seed) through both modules."""

import numpy as np
import pytest

from echoflow.data.synthetic import make_beating_video
from echoflow.utils import visualize as JV

from echoflow_torch.utils import visualize as TV


def _beat(frames=6, size=32):
    beat = make_beating_video(num_frames=frames, height=size, width=size, period=6.0,
                              base_radius=8.0, amplitude=3.0, seed=2)
    video = beat.video / 255.0
    return beat.masks, video.astype(np.float32)


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("with_truth", [False, True])
def test_overlay_matches(rgb, with_truth):
    masks, video = _beat()
    frame = video[:, 0].transpose(1, 2, 0) if rgb else video[0, 0]
    truth = masks[3] if with_truth else None
    got = TV.echonet_overlay(frame, masks[0], truth=truth)
    want = JV.echonet_overlay(frame, masks[0], truth=truth)
    assert got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_volume_curve_matches():
    masks, _ = _beat(frames=12)
    got = TV.simpson_volume_curve(masks)
    np.testing.assert_array_equal(got, JV.simpson_volume_curve(masks))
    assert got.shape == (12,) and got.max() > got.min() > 0


def test_annotated_gif_matches(tmp_path):
    masks, video = _beat()
    for mod, name in ((TV, "port.gif"), (JV, "jax.gif")):
        assert mod.make_annotated_gif(masks, video, str(tmp_path / name)) == \
            str(tmp_path / name)
    _same_file(tmp_path / "port.gif", tmp_path / "jax.gif")
    from PIL import Image

    with Image.open(tmp_path / "port.gif") as im:
        assert im.n_frames == 6


def test_contours_and_animation_match(tmp_path):
    masks, video = _beat()
    frame = video[0, 0]
    got = TV.plotContours(frame, [masks[0], masks[3]])
    np.testing.assert_array_equal(got, JV.plotContours(frame, [masks[0], masks[3]]))
    assert got.shape == (32, 32, 3) and got.dtype == np.float32
    images = [TV.echonet_overlay(video[0, t], masks[t]) for t in range(6)]
    TV.save_animation_from_images(images, str(tmp_path / "port.gif"))
    JV.save_animation_from_images(images, str(tmp_path / "jax.gif"))
    _same_file(tmp_path / "port.gif", tmp_path / "jax.gif")


def test_small_helpers_match():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 4, (3, 16, 16))
    pred = rng.randint(0, 4, (3, 16, 16))
    assert TV.labColorMap() == JV.labColorMap()
    np.testing.assert_array_equal(TV.label2LabColorMap(labels[0]),
                                  JV.label2LabColorMap(labels[0]))
    np.testing.assert_array_equal(TV.get_class_pixels(labels, 2), JV.get_class_pixels(labels, 2))
    values = np.concatenate([rng.randn(30), [8.0, -9.0]])
    np.testing.assert_array_equal(TV.find_outlier(values), JV.find_outlier(values))
    for k in range(4):
        for epi in (False, True):
            assert TV.categorical_dice(labels, pred, k, epi=epi) == \
                JV.categorical_dice(labels, pred, k, epi=epi)
        np.testing.assert_array_equal(TV.categorical_dice(labels, pred, k, individual=True),
                                      JV.categorical_dice(labels, pred, k, individual=True))
    for lv_epi in (False, True):
        assert TV.get_all_dice(pred, labels, LVepi=lv_epi) == \
            JV.get_all_dice(pred, labels, LVepi=lv_epi)


def test_plots_match(tmp_path):
    rng = np.random.RandomState(1)
    values = {"a": rng.randn(20), "b": np.append(rng.randn(19), 9.0)}
    got = TV.box_plot_outliers(values, str(tmp_path / "port_box.png"))
    want = JV.box_plot_outliers(values, str(tmp_path / "jax_box.png"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    masks, video = _beat()
    TV.show_sequence_of_images(video[0], str(tmp_path / "port_seq.png"), cols=4)
    JV.show_sequence_of_images(video[0], str(tmp_path / "jax_seq.png"), cols=4)
    TV.show_pred_labels(video[0], masks, str(tmp_path / "port_pred.png"), cols=3)
    JV.show_pred_labels(video[0], masks, str(tmp_path / "jax_pred.png"), cols=3)
    from PIL import Image

    for name in ("box", "seq", "pred"):
        with Image.open(tmp_path / f"port_{name}.png") as a, \
                Image.open(tmp_path / f"jax_{name}.png") as b:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
