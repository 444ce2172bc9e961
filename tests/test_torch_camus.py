"""The port's legacy CAMUS harness against echoflow's: the 4-class losses
(values and input gradients within 1e-5, float32), the generic harness
(datasets, batching, losses), SegNet and ShapeAutoencoder from converted
flax weights (forwards within 1e-5), the ACNN loss, `run_training` with
`MultiSteps` against `optax.MultiSteps(adamw)` over mini-steps carried into
a second call and the ACNN loop (parameters within 1e-5), and
`train_camus_torch.py` end to end on the CPU. Mirrors
`tests/test_{camus,generic}.py`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import echoflow.train.camus_losses as JL
import echoflow.train.generic as JG
import echoflow_torch.train.camus_losses as TL
import echoflow_torch.train.generic as TG
from echoflow_torch.models.convert import load_flax_params

torch.set_num_threads(2)
TOL = 1e-5
N, C, FR, H = 2, 4, 10, 16


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(N, C, FR, H, H).astype(np.float32)
    return {
        "video": rng.rand(N, 1, FR, H, H).astype(np.float32),
        "motion": (0.05 * rng.randn(N, 4, FR, H, H)).astype(np.float32),
        "logits": logits,
        "softmax": (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32),
        "lab_ed": rng.randint(0, C, (N, H, H)).astype(np.int32),
        "lab_es": rng.randint(0, C, (N, H, H)).astype(np.int32),
    }


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------- losses

def test_elementwise_losses_match_echoflow():
    x = _inputs()
    a, b = x["video"][:, :, 0], x["video"][:, :, 1]
    _close(TL.local_cross_correlation(torch.from_numpy(a), torch.from_numpy(b), 4),
           JL.local_cross_correlation(jnp.asarray(a), jnp.asarray(b), 4))
    _close(TL.cross_correlation(torch.from_numpy(a), torch.from_numpy(b)),
           JL.cross_correlation(jnp.asarray(a), jnp.asarray(b)))
    m = x["motion"][:, :2, 0]
    _close(TL.smoothness_loss(torch.from_numpy(m)), JL.smoothness_loss(jnp.asarray(m)))
    lg, lab = x["logits"][:, :, 0], x["lab_ed"]
    _close(TL.cross_entropy(torch.from_numpy(lg), torch.from_numpy(lab)),
           JL.cross_entropy(jnp.asarray(lg), jnp.asarray(lab)))
    sm = x["softmax"][:, :, 0]
    oh = np.eye(C, dtype=np.float32)[lab].transpose(0, 3, 1, 2)
    for k in range(C):
        _close(TL.class_dice_loss(torch.from_numpy(sm), torch.from_numpy(oh), k, 1e-7),
               JL.class_dice_loss(jnp.asarray(sm), jnp.asarray(oh), k, 1e-7))
    for weighted in (False, True):
        got, want = TL.get_weights(torch.from_numpy(lab), weighted), \
            JL.get_weights(jnp.asarray(lab), weighted)
        assert got.keys() == want.keys()
        for k in want:
            _close(float(got[k]), float(want[k]))
    with pytest.raises(ValueError):
        TL.local_cross_correlation(torch.zeros(1, 1, 6, 6), torch.zeros(1, 1, 6, 6), 4)


def _loss_fns(M, array):
    """(name, fn(video, motion, logits, softmax, lab_ed, lab_es)) of the
    three CAMUS losses of module M, each a scalar."""
    def sgs_ots(v, m, lg, sm, a, b, weighted=False):
        sgs, ots = M.sgs_ots_loss(a, b, m, sm, weighted=weighted)
        return sgs + 2.0 * ots

    return [("ota", lambda v, m, lg, sm, a, b: M.ota_loss(v, m)),
            ("sga", lambda v, m, lg, sm, a, b: M.sga_loss(a, b, lg, sm)),
            ("sga_weighted", lambda v, m, lg, sm, a, b: M.sga_loss(a, b, lg, sm, weighted=True)),
            ("sgs_ots", sgs_ots),
            ("sgs_ots_weighted", lambda *args: sgs_ots(*args, weighted=True))]


@pytest.mark.parametrize("index", range(5), ids=["ota", "sga", "sga_weighted", "sgs_ots",
                                                 "sgs_ots_weighted"])
def test_warp_chain_losses_and_gradients_match_echoflow(index):
    """Values and the gradients with respect to the video, the motion, the
    logits and the softmax, float32, within 1e-5."""
    x = _inputs(1)
    name, jfn = _loss_fns(JL, jnp.asarray)[index]
    _, tfn = _loss_fns(TL, torch.from_numpy)[index]
    diff = ("video", "motion", "logits", "softmax")
    jargs = [jnp.asarray(x[k]) for k in diff]
    want, jgrads = jax.value_and_grad(
        lambda *a: jfn(*a, jnp.asarray(x["lab_ed"]), jnp.asarray(x["lab_es"])),
        argnums=(0, 1, 2, 3))(*jargs)
    targs = [torch.from_numpy(x[k]).requires_grad_() for k in diff]
    got = tfn(*targs, torch.from_numpy(x["lab_ed"]), torch.from_numpy(x["lab_es"]))
    got.backward()
    _close(float(got.detach()), float(want))
    for k, t, j in zip(diff, targs, jgrads):
        g = np.zeros(x[k].shape) if t.grad is None else t.grad.numpy()
        _close(g, np.asarray(j))


def test_reference_named_aliases():
    x = _inputs(2)
    v, m, lg, sm = (torch.from_numpy(x[k]) for k in ("video", "motion", "logits", "softmax"))
    ed, es = torch.from_numpy(x["lab_ed"]), torch.from_numpy(x["lab_es"])
    labels = {"label_ED": ed[:, None], "label_ES": es}
    assert float(TL.OTA_loss(v, m)) == float(TL.ota_loss(v, m))
    assert float(TL.SGA_loss(labels, lg, sm)) == float(TL.sga_loss(ed, es, lg, sm))
    assert [float(t) for t in TL.SGS_OTS_loss(labels, m, sm)] == \
        [float(t) for t in TL.sgs_ots_loss(ed, es, m, sm)]
    one_hot = TL.convert_to_1hot_tensor(ed[:, None], C)
    assert one_hot.shape == (N, C, H, H) and float(one_hot.sum()) == N * H * H
    assert float(TL.dice_loss(one_hot, one_hot, class_index=1, eps=1e-7)) < 1e-5
    flow = x["motion"][:, :2, 0]
    _close(TL.huber_loss(torch.from_numpy(flow)), JL.huber_loss(jnp.asarray(flow)))


# ---------------------------------------------------------------------- generic harness

def _toy_records(n=8, h=16, w=16, seed=0):
    rng = np.random.RandomState(seed)
    recs = []
    for _ in range(n):
        cy, cx = rng.randint(5, 11, 2)
        yy, xx = np.mgrid[0:h, 0:w]
        lab = (((yy - cy) ** 2 + (xx - cx) ** 2) <= 9).astype(np.int32)
        img = (0.2 + 0.6 * lab + 0.05 * rng.randn(h, w)).astype(np.float32)
        recs.append({"inputs": img[None], "outputs": lab})
    return recs


def test_dataset_and_batching_match_echoflow():
    aug = [lambda d: {**d, "aug": 1}]
    jd = JG.TransformDataset(_toy_records(6), global_transforms=aug, augment_transforms=aug)
    td = TG.TransformDataset(_toy_records(6), global_transforms=aug, augment_transforms=aug)
    assert len(td) == len(jd) == 6 and td[0]["aug"] == 1
    for kw in (dict(rng=np.random.RandomState(0)), dict(shuffle=False),
               dict(shuffle=False, drop_last=False)):
        want = list(JG.batch_iterator(jd, 4, **kw))
        got = list(TG.batch_iterator(td, 4, **{k: (np.random.RandomState(0) if k == "rng"
                                                   else v) for k, v in kw.items()}))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    c = TG.collate_dicts([{"a": np.ones(2)}, {"a": np.zeros(2)}])
    np.testing.assert_array_equal(c["a"], JG.collate_dicts([{"a": np.ones(2)},
                                                            {"a": np.zeros(2)}])["a"])


def test_better_loss_one_hot_batch_and_foreground_dice_match_echoflow():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 4, 8, 8).astype(np.float32)
    labels = rng.randint(0, 4, (3, 8, 8))
    weight = rng.rand(4).astype(np.float32) + 0.5
    for w in (None, weight):
        _close(TG.BetterLoss(w)(torch.from_numpy(logits), torch.from_numpy(labels)),
               JG.BetterLoss(w)(jnp.asarray(logits), jnp.asarray(labels)))
    _close(TG.BetterLoss(weight)(torch.from_numpy(logits), torch.from_numpy(labels)),
           torch.nn.CrossEntropyLoss(weight=torch.from_numpy(weight))(
               torch.from_numpy(logits), torch.from_numpy(labels)))
    lab = np.stack([np.array([[0, 1], [2, 3]]), np.array([[3, 3], [0, 1]])])
    np.testing.assert_array_equal(TG.OneHotBatch()(lab[:, None]), JG.OneHotBatch()(lab[:, None]))
    one_hot = np.eye(4, dtype=np.float32)[labels].transpose(0, 3, 1, 2)
    _close(TG.foreground_dice_loss(torch.from_numpy(logits), torch.from_numpy(one_hot)),
           JG.foreground_dice_loss(jnp.asarray(logits), jnp.asarray(one_hot)))


def _flax_segnet(hw=32, seed=0):
    import train_camus

    model = train_camus.build_model()
    return model, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1, hw, hw)))


def _flax_ae(hw=32, classes=4, seed=1):
    ae = JG.ShapeAutoencoder(num_classes=classes, latent_dim=8, hidden=4)
    return ae, ae.init(jax.random.PRNGKey(seed), jnp.zeros((1, classes, hw, hw)))


def _port_segnet(variables):
    import train_camus_torch

    return load_flax_params(train_camus_torch.SegNet(), variables)


def _port_ae(variables, hw=32, classes=4):
    return load_flax_params(TG.ShapeAutoencoder(num_classes=classes, latent_dim=8, hidden=4,
                                                image_size=(hw, hw)), variables)


@pytest.mark.parametrize("hw", [32, 24])
def test_segnet_and_autoencoder_from_flax_weights(hw):
    rng = np.random.RandomState(3)
    model, variables = _flax_segnet(hw)
    x = rng.rand(2, 1, hw, hw).astype(np.float32)
    with torch.no_grad():
        _close(_port_segnet(variables)(torch.from_numpy(x)), model.apply(variables, jnp.asarray(x)))
    ae, ae_vars = _flax_ae(hw)
    y = rng.rand(2, 4, hw, hw).astype(np.float32)
    want_recon, want_z = ae.apply(ae_vars, jnp.asarray(y))
    with torch.no_grad():
        recon, z = _port_ae(ae_vars, hw)(torch.from_numpy(y))
    _close(recon, want_recon)
    _close(z, want_z)
    assert recon.shape == (2, 4, hw, hw) and z.shape == (2, 8)


def test_acnn_loss_matches_echoflow():
    rng = np.random.RandomState(4)
    ae, ae_vars = _flax_ae(16, classes=2)
    port_ae = _port_ae(ae_vars, 16, classes=2)
    logits = rng.randn(2, 2, 16, 16).astype(np.float32)
    labels = (rng.rand(2, 16, 16) > 0.5).astype(np.int32)
    for weight in (0.0, 1.0):
        want, jg = jax.value_and_grad(lambda lg: JG.acnn_loss(
            lg, jnp.asarray(labels), ae, ae_vars, prior_weight=weight, num_classes=2))(
            jnp.asarray(logits))
        lg = torch.from_numpy(logits).requires_grad_()
        got = TG.acnn_loss(lg, torch.from_numpy(labels), port_ae, prior_weight=weight,
                           num_classes=2)
        got.backward()
        _close(float(got.detach()), float(want))
        _close(lg.grad.numpy(), np.asarray(jg))


def test_run_training_multisteps_matches_optax():
    """5 mini-steps at k = 2 (updates after mini-steps 2 and 4, the fifth
    gradient left accumulated), then a second call with the returned
    optimizer over 3 more (its first completes the carried update): the
    parameters and average losses against echoflow's `run_training` with
    `optax.MultiSteps(adamw)` and its `opt_state` passed back in."""
    import train_camus_torch

    model, variables = _flax_segnet(16)
    ds = JG.TransformDataset([{"images": r["inputs"], "labels": r["outputs"] * 3}
                              for r in _toy_records(10)])
    batches = list(JG.batch_iterator(ds, 2, rng=np.random.RandomState(0)))   # 5 batches
    optimizer = optax.MultiSteps(optax.adamw(2e-3, weight_decay=1e-5), every_k_schedule=2)
    params, opt_state, javg1, _ = JG.run_training(
        lambda p, x: model.apply(p, x), variables, iter(batches), effective_batchsize=2,
        optimizer=optimizer, keys=("images", "labels"))
    params, opt_state, javg2, _ = JG.run_training(
        lambda p, x: model.apply(p, x), params, iter(batches[:3]), effective_batchsize=2,
        optimizer=optimizer, opt_state=opt_state, keys=("images", "labels"))

    port = load_flax_params(train_camus_torch.SegNet(), variables)
    port, opt, avg1, example = TG.run_training(port, iter(batches), effective_batchsize=2,
                                               learning_rate=2e-3, weight_decay=1e-5,
                                               keys=("images", "labels"))
    assert opt.mini_step == 1 and example[0].shape == (4, 16, 16)
    port, opt, avg2, _, dices = TG.run_training(port, iter(batches[:3]), optimizer=opt,
                                                keys=("images", "labels"), do_dice=True)
    assert opt.mini_step == 0 and set(dices) == {"BG", "LV", "Myo", "LA", "LVepi"}
    _close(avg1, javg1)
    _close(avg2, javg2)
    want = load_flax_params(train_camus_torch.SegNet(), params).state_dict()
    for k, v in port.state_dict().items():
        _close(v.numpy(), want[k].numpy())
    jv = JG.run_validation(lambda p, x: model.apply(p, x), params, iter(batches),
                           keys=("images", "labels"), do_dice=True, return_all=True)
    tv = TG.run_validation(port, iter(batches), keys=("images", "labels"), do_dice=True,
                           return_all=True)
    _close(tv[0], jv[0])
    _close(tv[3], jv[3])
    assert tv[2].keys() == jv[2].keys()


def test_run_training_acnn_matches_echoflow():
    """The ACNN loop: a fresh optimizer each call, the shape prior frozen."""
    import train_camus_torch

    model, variables = _flax_segnet(16)
    ae, ae_vars = _flax_ae(16)
    ds = JG.TransformDataset([{"images": r["inputs"], "labels": r["outputs"] * 2}
                              for r in _toy_records(8, seed=1)])
    batches = list(JG.batch_iterator(ds, 2, shuffle=False))
    params, _, javg, _ = JG.run_training_acnn(lambda p, x: model.apply(p, x), variables, ae,
                                              ae_vars, iter(batches), effective_batchsize=2,
                                              prior_weight=0.5, learning_rate=2e-3)
    port_ae = _port_ae(ae_vars, 16)
    port, _, avg, _ = TG.run_training_acnn(load_flax_params(train_camus_torch.SegNet(),
                                                            variables), port_ae,
                                           iter(batches), effective_batchsize=2,
                                           prior_weight=0.5, learning_rate=2e-3)
    _close(avg, javg)
    want = load_flax_params(train_camus_torch.SegNet(), params).state_dict()
    for k, v in port.state_dict().items():
        _close(v.numpy(), want[k].numpy())
    assert not any(p.requires_grad for p in port_ae.parameters())
    jv = JG.run_validation_acnn(lambda p, x: model.apply(p, x), params, ae, ae_vars,
                                iter(batches), prior_weight=0.5)
    tv = TG.run_validation_ACNN(port, port_ae, iter(batches), prior_weight=0.5)
    _close(tv[0], jv[0])


# ---------------------------------------------------------------------- entry point

def _write_fake_camus_patient(root, name, hw=32, seed=0):
    rng = np.random.RandomState(seed)
    pdir = root / name
    pdir.mkdir()
    (pdir / "Info_2CH.cfg").write_text("ED: 1\nES: 12\nNbFrame: 20\n")
    for tag, is_label in (("ED", False), ("ED_gt", True), ("ES", False), ("ES_gt", True)):
        vol = (rng.randint(0, 4, (1, hw, hw)) if is_label
               else rng.rand(1, hw, hw) * 255).astype(np.uint8)
        raw = f"{name}_2CH_{tag}.raw"
        vol.tofile(pdir / raw)
        (pdir / f"{name}_2CH_{tag}.mhd").write_text(
            f"NDims = 3\nDimSize = {hw} {hw} 1\nElementType = MET_UCHAR\n"
            f"ElementDataFile = {raw}\n")


@pytest.mark.parametrize("extra", [[], ["--acnn"]], ids=["plain", "acnn"])
def test_train_camus_torch_runs_on_the_cpu(extra):
    import train_camus_torch

    model, dices, losses = train_camus_torch.main(
        ["--synthetic", "--epochs", "1", "--device", "cpu", "--samples", "8",
         "--image-size", "32"] + extra)
    assert {"BG", "LV", "Myo", "LA", "LVepi"} == set(dices)
    assert all(0.0 <= v <= 1.0 for v in dices.values())
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert next(model.parameters()).device == torch.device("cpu")


def test_train_camus_torch_on_a_camus_directory(tmp_path):
    import train_camus_torch

    for i in range(2):
        _write_fake_camus_patient(tmp_path, f"patient000{i + 1}", seed=i)
    _, dices, losses = train_camus_torch.main(
        ["--data", str(tmp_path), "--epochs", "2", "--batch-size", "2", "--image-size", "32",
         "--device", "cpu"])
    assert {"LV", "Myo", "LA", "LVepi"} <= set(dices) and len(losses) == 3
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            train_camus_torch.main(["--synthetic", "--epochs", "1"])
