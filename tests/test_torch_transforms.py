"""The port's CAMUS transforms (`echoflow_torch.data.transforms`) against
echoflow's on the same seeded numpy inputs and the same random streams
(two `RandomState`s of one seed, one a side): every output bitwise equal
but the time resample's. That one runs, as asked of the port, on its
`ops/resize.resize_linear`: the same float32 matrices as echoflow's, but a
torch matmul against XLA's dot, whose float32 sums round differently, so
it is held to ULP1 absolute, one float32 unit in the last place at 1.0
(its outputs lie in [0, 1]; twice that after the [-1, 1] normalization);
measured: 14% of the elements of a 17 -> 10 frame resample differ, by
5.96e-8. Mirrors `tests/test_transforms.py`."""

import numpy as np
import pytest

import echoflow.data.transforms as J
import echoflow_torch.data.transforms as T

ULP1 = float(np.spacing(np.float32(1.0)))


def _rng():
    return np.random.RandomState(0)


def _same(a, b, atol=0.0):
    """Bitwise equal (or within `atol`), nested lists and dicts of arrays
    alike."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k], atol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, atol)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        if atol:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _both(fn_name, *args, **kwargs):
    """fn(*args, rng=RandomState(0)) on each side."""
    return (getattr(J, fn_name)(*args, rng=_rng(), **kwargs),
            getattr(T, fn_name)(*args, rng=_rng(), **kwargs))


def test_intensity_window():
    img = _rng().rand(32, 32).astype(np.float32) * 100
    _same(*_both("intensity_window", img, (0.5, 0.8)))
    _same(*_both("intensity_window", img, (1.0, 1.0)))


@pytest.mark.parametrize("order", [0, 1])
def test_rotate_about_apex(order):
    img = _rng().rand(3, 40, 36).astype(np.float32)
    if order == 0:
        img = (img > 0.5).astype(np.int64)
    for deg in (-20.0, 7.5):
        _same(J.rotate_about_apex(img, deg, order), T.rotate_about_apex(img, deg, order))
        _same(J.rotate_about_apex(img[0], deg, order), T.rotate_about_apex(img[0], deg, order))


@pytest.mark.parametrize("rtype", ["uniform", "normal"])
def test_random_rotation_angle(rtype):
    _same(*_both("random_rotation_angle", 12.0, rtype))


def test_noise_salt_pepper_and_one_hot():
    img = (0.5 * np.ones((50, 50))).astype(np.float32)
    img[0, 0], img[0, 1] = 0.0, 1.0
    _same(*_both("salt_pepper", img, amount=0.2))
    _same(*_both("gaussian_noise", img, 0.1))
    _same(*_both("echo_cone_gaussian_noise", img, (0.05, 0.2)))
    _same(J.echo_cone_gaussian_noise(img, sig=0.1, rng=_rng()),
          T.echo_cone_gaussian_noise(img, sig=0.1, rng=_rng()))
    lab = _rng().randint(0, 4, (8, 8))
    _same(J.one_hot_np(lab, 4), T.one_hot_np(lab, 4))


@pytest.mark.parametrize("frames,align", [(17, True), (7, True), (23, False)])
def test_resample_sequence_frames(frames, align):
    video = _rng().rand(frames, 8, 9).astype(np.float32)
    _same(J.resample_sequence_frames(video, 10, align),
          T.resample_sequence_frames(video, 10, align), atol=ULP1)


def test_dict_pipelines():
    def data():
        rng = _rng()
        return {"images": [rng.rand(32, 32).astype(np.float32) for _ in range(2)],
                "labels": [rng.randint(0, 4, (32, 32)).astype(np.int64) for _ in range(2)]}

    def vdata():
        rng = _rng()
        return {"video": rng.rand(6, 32, 32).astype(np.float32) * 50,
                "label_ED": (rng.rand(32, 32) > 0.5).astype(np.int64),
                "label_ES": (rng.rand(32, 32) > 0.5).astype(np.int64)}

    outs = []
    for M in (J, T):
        rng = np.random.RandomState(1)
        out = M.WindowImagesAndLabels((0.6, 0.9), rng=rng)(data())
        out = M.RotateImagesAndLabels(15.0, rng=rng)(out)
        single = M.RotateImagesAndLabels(5.0, rng=rng)({"images": data()["images"][0][None],
                                                        "labels": data()["labels"][0]})
        video = M.RotateVideoAndLabels(10.0, rng=rng)(vdata())
        video = M.GaussianNoiseImageSequence(0.05, rng=rng)(video)
        outs.append((out, single, M.NormalizedImageSequence("pmone")(video),
                     M.NormalizedImageSequence("zeroone")(vdata()),
                     M.WindowImagesAndLabels((0.7, 1.0), rng=rng)({"images": data()["images"][0]}),
                     M.IdentityTransform()({"x": 1})))
    _same(*outs)


def _write_mhd(path, vol, name):
    vol.tofile(path / f"{name}.raw")
    z, h, w = vol.shape
    (path / f"{name}.mhd").write_text(
        f"NDims = 3\nDimSize = {w} {h} {z}\nElementType = MET_UCHAR\n"
        f"ElementDataFile = {name}.raw\n")
    return str(path / f"{name}.mhd")


@pytest.mark.parametrize("order", ["ED_first", "ES_first"])
def test_camus_directory_walker_and_sequence(tmp_path, order):
    pdir = tmp_path / "patient0001"
    pdir.mkdir()
    ed, es = (1, 12) if order == "ED_first" else (12, 1)
    (pdir / "Info_2CH.cfg").write_text(f"ED: {ed}\nES: {es}\nNbFrame: 20\n")
    (tmp_path / "not_a_patient").mkdir()
    _write_mhd(pdir, (_rng().rand(20, 16, 16) * 255).astype(np.uint8),
               "patient0001_2CH_sequence")
    want, got = J.make_camus_echo_dataset(str(tmp_path)), T.make_camus_echo_dataset(str(tmp_path))
    _same(want, got)
    assert got["patient0001"]["2CH"]["sequence"].endswith("::" + order)
    for norm in ("zeroone", "pmone"):
        _same(J.load_camus_sequence(want["patient0001"]["2CH"]["sequence"], 10, norm),
              T.load_camus_sequence(got["patient0001"]["2CH"]["sequence"], 10, norm),
              atol=ULP1 * (2 if norm == "pmone" else 1))
        _same(J.load_camus_sequence(want["patient0001"]["2CH"]["sequence"], 20, norm),
              T.load_camus_sequence(got["patient0001"]["2CH"]["sequence"], 20, norm))


def test_load_sitk_and_to_numpy(tmp_path):
    path = _write_mhd(tmp_path, (_rng().rand(1, 12, 10) * 255).astype(np.uint8), "img")
    outs = []
    for M in (J, T):
        data = M.LoadSITKFromFilename("images")({"images": [path]})
        outs.append((data, M.SitkToNumpy("images")(dict(data)),
                     M.SitkToNumpy("images", normed=False)(dict(data))))
    _same(*outs)


def test_resizes():
    rng = _rng()
    img, lab = rng.rand(1, 24, 24).astype(np.float32), rng.randint(0, 4, (1, 24, 24))
    seq, lab2 = rng.rand(5, 1, 16, 16).astype(np.float32), rng.randint(0, 3, (1, 16, 16))
    outs = []
    for M in (J, T):
        outs.append((
            M.ResizeImagesAndLabels((12, 12), "images", "labels")({"images": [img],
                                                                    "labels": [lab]}),
            M.ResizeImagesAndLabels((36, 30), "images", "labels", image_alias=False)(
                {"images": [img], "labels": [lab[0]]}),
            M.ResizeTransform((8, 8), "images")({"images": [img]}),
            M.ResizeTransform((8, 8), "labels", order=0)({"labels": [lab]}),
            M.ResizeImage((8, 8), "seq", is_sequence=True)({"seq": [seq]}),
            M.ResizeImage((8, 8), "labs", is_label=True)({"labs": [lab2]}),
            M.ResizeImage((8, 8), "labs", is_label=True, is_sequence=True)({"labs": [lab2]})))
    _same(*outs)


def test_windowers_and_noisers():
    rng = _rng()
    imgs = rng.rand(3, 16, 16).astype(np.float32) * np.array([1, 10, 100])[:, None, None]
    seq = rng.rand(1, 6, 8, 8).astype(np.float32)
    cone = np.zeros((1, 16, 16), np.float32)
    cone[:, 4:12, 4:12] = 0.5
    outs = []
    for M in (J, T):
        r = np.random.RandomState(3)
        outs.append((
            M.random_video_windower((0.5, 0.8), rng=r)(imgs),
            M.WindowImage((0.6, 0.9), "image_sequence", rng=r)({"image_sequence": [seq]}),
            M.WindowImage((0.6, 0.9), "x", is_sequence=False, rng=r)({"x": [imgs]}),
            M.WindowImage((0.6, 0.9), "x", is_sequence=False, is_label=True, rng=r)(
                {"x": [(imgs > 5).astype(np.int64)]}),
            M.GaussianNoiseEcho((0.1, 0.1), "images", rng=r)({"images": [cone]}),
            M.RotateImages(10.0, "uniform", "images", rng=r)({"images": [cone, cone]}),
            M.RotateImages(10.0, "normal", "labs", order=0, rng=r)(
                {"labs": [(cone > 0).astype(np.int64)]})))
    _same(*outs)


def test_reference_named_shims():
    assert T.random_SpeckleNoiser is T.random_GaussNoiser   # a verbatim duplicate
    assert T.identity_Transform is T.IdentityTransform
    img = _rng().rand(16, 16).astype(np.float32)
    img[0] = 0.0   # outside the echo cone
    np.random.seed(0)
    want = J.random_GaussNoiser((0.05, 0.1))(img)
    np.random.seed(0)
    got = T.random_GaussNoiser((0.05, 0.1))(img)
    _same(want, got)
    assert np.all(got[0] == 0.0)
