"""CLAS-FV over ir-CSN-152 (echoflow_torch.models.csn) on the CPU against the
benchmark's plain reference (portbench/reference/csn.py), at a small size
on seeded weights: four stages of 1, 2, 1, 1 blocks of middle width 4, 8,
8, 8 (stride 1, 2, 2, 2), 17 frames of 65 x 65, a batch of 4, so the last
stage still normalizes 108 values a channel. At these sizes every tap's
upsampling weights are binary fractions (each tap's extent less one
divides the clip's: 16, 8, 4 and 2 into 16 frames, 32 to 2 into 64
pixels), which the port computes in fp32 as torch does for an fp32 input
and the reference in float64: the two agree exactly.

Bars: float64 1e-10, fp32 1e-5, relative L2. The reference's objective
(`reference/train.total_loss`) warps fp32 one-hot labels, so it runs in
fp32 alone: in float64 both networks' outputs go through the port's fused
objective, which the fp32 cases hold to the reference's. A leaf's gradient, and a
leaf after the steps, is held against the larger of its own norm and the
median leaf's (`drivers/train.py`'s measure): a zero-initialized leaf
starts from nought. Leaves whose reference gradient is under 1e-3 of the
median leaf's are rounding alone (the comb biases before their BatchNorm,
the unused fc) and are left out of the steps: Adam moves them by its
step size whatever the rounding's sign.
"""

import numpy as np
import pytest
import torch

from echoflow_torch.models.csn import CSNMotionSegNet, fold_pairs
from echoflow_torch.models.fold_bn import fold_state_dict, is_folded
from echoflow_torch.models.r2plus1d import create_model, motion_seg_net, param_count
from echoflow_torch.train.losses import clasfv_total_loss_fused
from portbench.reference import csn as ref
from portbench.reference.train import Adam, total_loss
from portbench.synthetic import training_batch, training_sample

STAGES = ((1, 4, 1), (2, 8, 2), (1, 8, 2), (1, 8, 2))
T, H, W, N = 17, 65, 65, 4
CFG = {"in_channels": 3, "clip_length": T, "height": H, "width": W, "stem_width": 64,
       "stem_kernel": [3, 7, 7], "stem_stride": [1, 2, 2], "stem_padding": [1, 3, 3],
       "pool_kernel": [1, 3, 3], "pool_stride": [1, 2, 2], "pool_padding": [0, 1, 1],
       "stage_blocks": [s[0] for s in STAGES], "stage_mid_widths": [s[1] for s in STAGES],
       "stage_strides": [s[2] for s in STAGES], "expansion": 4, "decoder_width": 64,
       "seg_classes": 2, "motion_channels": 4, "kinetics_classes": 400, "bn_eps": 1e-3,
       "decoder_bn_eps": 1e-5}
BARS = {torch.float64: 1e-10, torch.float32: 1e-5}
DTYPES = [torch.float64, torch.float32]
IDS = ["f64", "f32"]
ZERO_LEAF = 1e-3


def _model(dtype, seed=3):
    from echoflow_torch.models.r2plus1d import init_weights

    model = CSNMotionSegNet(stages=STAGES)
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():   # running statistics away from the identity, for eval and folding
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=torch.Generator().manual_seed(7)))
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(8))
    model = model.to(dtype)
    model.output_dtype = dtype
    return model


def _batch(dtype, seed=0):
    host = training_batch([training_sample(T, H, W, seed=seed + i) for i in range(N)])
    batch = {k: torch.as_tensor(v) for k, v in host.items()}
    batch["video"] = batch["video"].to(dtype)
    return batch


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _fused_loss(video, seg, motion, batch):
    return clasfv_total_loss_fused(video, seg, motion, batch["ed_label"], batch["es_label"],
                                   batch["ed_idx"], batch["es_idx"])[0]


def _reference_loss(dtype):
    """The objective the reference network's outputs go through (module
    docstring)."""
    return total_loss if dtype == torch.float32 else _fused_loss


def _rel(a, b, floor=0.0):
    return float((a - b).double().norm() / max(float(b.double().norm()), floor, 1e-300))


def test_published_width_parameter_count():
    """29,958,294 at the published widths: the backbone's 28,883,968, the
    Kinetics fc's 819,600, the decoder's and heads' 254,726."""
    with torch.device("meta"):
        model = motion_seg_net("ir_csn_152")
    fc = sum(p.numel() for p in model.backbone.fc.parameters())
    assert param_count(model) == 29_958_294
    assert param_count(model.backbone) - fc == 28_883_968 and fc == 819_600
    assert model.backbone.tap_channels == (64, 256, 512, 1024, 2048)
    assert model.comb_1_layer.in_channels == 3904
    assert set(model.state_dict()) == set(ref.state_shapes(_published_cfg()))


def _published_cfg():
    return {**CFG, "stage_blocks": [3, 8, 36, 3], "stage_mid_widths": [64, 128, 256, 512],
            "clip_length": 32, "height": 112, "width": 112}


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_outputs_match_the_reference(dtype, train):
    """seg and motion of the port's forward (train-mode BatchNorm, or eval
    with running statistics) against the plain reference's on the same
    state dict."""
    model = _model(dtype).train(train)
    p = _params(model)
    batch = _batch(dtype)
    with torch.no_grad():
        seg, motion = model(batch["video"])
        rseg, rmotion = ref.forward(p, batch["video"], CFG, train=train)
    assert seg.dtype == dtype and seg.shape == (N, 2, T, H, W) and motion.shape == (N, 4, T, H, W)
    assert _rel(seg, rseg) <= BARS[dtype] and _rel(motion, rmotion) <= BARS[dtype]


def _grads(model, p, batch, loss_fn):
    """(port loss, port grads, reference loss, reference grads) in train
    mode: the port's network and fused loss, the reference's network and
    `loss_fn`."""
    model.train().zero_grad()
    seg, motion = model(batch["video"])
    total = _fused_loss(batch["video"], seg, motion, batch)
    total.backward()
    grads = {k: q.grad.detach().clone() if q.grad is not None else torch.zeros_like(q)
             for k, q in model.named_parameters()}
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()
              if k in grads}
    rseg, rmotion = ref.forward({**p, **leaves}, batch["video"], CFG, train=True)
    rtotal = loss_fn(batch["video"], rseg, rmotion, batch)
    rgrads = dict(zip(leaves, torch.autograd.grad(rtotal, list(leaves.values()),
                                                  allow_unused=True)))
    rgrads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in rgrads.items()}
    return total.detach(), grads, rtotal.detach(), rgrads


def _worst(got, want, keys):
    """The worst leaf's gap, each over the larger of its norm in `want`
    and the median leaf's: (gap, leaf)."""
    median = float(np.median([float(want[k].double().norm()) for k in keys]))
    return max((_rel(got[k], want[k], median), k) for k in keys)


def _as_close_to_float64(port, plain, truth, keys):
    """fp32: each leaf of the port's run as close to the float64 run
    (`truth`) as the plain reference's fp32 run is, within 1.5x, less the
    fp32 bar. At this size BatchNorm's cancellations leave both fp32 runs
    up to 7e-3 from float64 (a shortcut's BatchNorm scale), and within 3e-5
    of each other."""
    median = float(np.median([float(truth[k].double().norm()) for k in keys]))
    for k in keys:
        floor = max(float(truth[k].double().norm()), median)
        gap = float((port[k].double() - truth[k]).norm()) / floor
        plain_gap = float((plain[k].double() - truth[k]).norm()) / floor
        assert gap <= 1.5 * plain_gap + BARS[torch.float32], (k, gap, plain_gap)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_loss_and_every_leafs_gradient_match_the_reference(dtype):
    """The first step's loss and every leaf's gradient: float64 against the
    reference network within 1e-10; fp32 against the reference network and
    objective (the loss within 1e-5; the gradients as close to float64 as
    the reference's, `_as_close_to_float64`)."""
    model = _model(dtype)
    total, grads, rtotal, rgrads = _grads(model, _params(model), _batch(dtype),
                                          _reference_loss(dtype))
    assert _rel(total, rtotal) <= BARS[dtype]
    if dtype == torch.float64:
        worst = _worst(grads, rgrads, list(rgrads))
        assert worst[0] <= BARS[dtype], worst
        return
    truth = _model(torch.float64)
    _, exact, _, _ = _grads(truth, _params(truth), _batch(torch.float64), _fused_loss)
    _as_close_to_float64(grads, rgrads, exact, list(rgrads))


def _port_steps(dtype, batches):
    """The parameters after the port's train steps (`make_train_step`, Adam
    as `make_optimizer` makes it) on `batches`, from `_model`'s state."""
    from echoflow_torch.train.loop import (TrainConfig, TrainState, lr_schedule, make_optimizer,
                                           make_train_step)

    model = _model(dtype)
    cfg = TrainConfig()
    state = TrainState(model=model.train(), optimizer=make_optimizer(cfg, model.parameters()),
                       schedule=lr_schedule(cfg))
    step = make_train_step()
    for batch in batches:
        state, _ = step(state, batch)
    return {k: v.detach() for k, v in state.model.named_parameters()}


def _reference_steps(dtype, batches):
    """(parameters after the steps, first gradients' norms) of the
    reference network through `_reference_loss` and optax's Adam written
    out, from `_model`'s state."""
    start = _params(_model(dtype))
    params = {k: v for k, v in start.items() if v.is_floating_point() and "running" not in k}
    buffers = {k: v for k, v in start.items() if k not in params}
    adam, first = Adam(params, lr=1e-4), None
    for batch in batches:
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        seg, motion = ref.forward({**leaves, **buffers}, batch["video"], CFG, train=True)
        loss = _reference_loss(dtype)(batch["video"], seg, motion, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        for v in params.values():
            v.requires_grad_(False)
        first = first or {k: float(g.double().norm()) for k, g in grads.items()}
        adam.step(params, grads)
    return params, first


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_three_adam_steps_match_the_reference(dtype):
    """Three train steps on three batches from the same state: the port's
    against the reference's, every leaf but those moved by rounding alone
    (module docstring); float64 within 1e-10, fp32 as close to float64 as
    the reference's fp32 steps (`_as_close_to_float64`)."""
    batches = [_batch(dtype, seed=10 * i) for i in range(3)]
    got = _port_steps(dtype, batches)
    want, first = _reference_steps(dtype, batches)
    median = float(np.median(list(first.values())))
    moving = [k for k in want if first[k] >= ZERO_LEAF * median]
    assert set(want) - set(moving) <= {"comb_1_layer.bias", "comb_2_layer.bias",
                                       "ir_csn_model.fc.weight", "ir_csn_model.fc.bias"}
    if dtype == torch.float64:
        worst = _worst(got, want, moving)
        assert worst[0] <= BARS[dtype], worst
        return
    truth = _port_steps(torch.float64, [_batch(torch.float64, seed=10 * i) for i in range(3)])
    _as_close_to_float64(got, want, truth, moving)


@pytest.mark.parametrize("backbone", ["r2plus1d_18", "ir_csn_152"])
@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_a_state_dict_names_its_backbone(backbone, folded):
    """`backbone_of` reads the backbone from a state dict's keys, folded or
    not, which is how folding and the engine pick the network; a state
    dict of neither raises."""
    from echoflow_torch.models.r2plus1d import backbone_of

    with torch.device("meta"):
        state = motion_seg_net(backbone, folded=folded).state_dict()
    assert backbone_of(state) == backbone
    with pytest.raises(ValueError, match="names no backbone"):
        backbone_of({k.split(".", 1)[1]: v for k, v in state.items() if "." in k})


def test_folding_keeps_the_eval_forward():
    """`fold_state_dict` folds an ir-CSN-152 state dict: every conv's BatchNorm,
    the depthwise convs' and the shortcuts' included, each with its own
    eps (the backbone's 1e-3, the decoder's 1e-5): the folded state dict
    loads strictly into the folded network, holds no BatchNorm, and its
    fp32 forward is the unfolded fp32 eval forward within 1e-5."""
    model = _model(torch.float32).eval()
    state = {k: v.float() for k, v in model.state_dict().items()}
    pairs = fold_pairs(state)
    bns = {k[:-len(".running_var")] for k in state if k.endswith("running_var")}
    assert {bn for _, bn, _ in pairs if bn} == bns
    assert {eps for _, bn, eps in pairs if bn and bn.startswith("ir_csn")} == {1e-3}
    folded_state = fold_state_dict(state)
    assert is_folded(folded_state)
    folded = CSNMotionSegNet(folded=True, stages=STAGES)
    folded.load_state_dict(folded_state, strict=True)
    video = _batch(torch.float32)["video"]
    with torch.no_grad():
        for a, b in zip(folded.eval()(video), model(video)):
            assert _rel(a, b) <= BARS[torch.float32]


def test_the_folded_engine_segments_as_the_unfolded_model():
    """`VideoSegmenter` over an ir-CSN-152 state dict at the published widths on
    the CPU: its folded forward with the decoder tail's plain version
    (`fold_bn=True`, the default) gives the masks of the unfolded network's
    own forward (`fold_bn=False, decoder="model"`), bit for bit. The seg
    head is scaled so that no pixel's two logits lie within the two
    paths' rounding of each other."""
    from echoflow_torch.infer.pipeline import VideoSegmenter

    state = create_model(seed=4, backbone="ir_csn_152").state_dict()
    state["segmentation_head.weight"] = state["segmentation_head.weight"] * 300.0
    rng = np.random.RandomState(0)
    video = (rng.rand(3, 32, 112, 112) * 255).astype(np.uint8)
    masks = [VideoSegmenter(state, device="cpu", fold_bn=fold,
                            decoder="kernel" if fold else "model", forward_chunk=1)
             .segment_video(video, num_clips=1) for fold in (True, False)]
    assert masks[0].shape == (32, 112, 112)
    assert 0.05 < masks[0].mean() < 0.95
    assert np.array_equal(masks[0], masks[1])


def test_the_folded_clip_forward_labels_as_the_unfolded_model():
    """`ClipForward` over an ir-CSN-152 state dict at the published widths
    on the CPU: its folded forward with the decoder tail's plain version
    (`fold_bn=True`, the default) gives the argmax labels of the unfolded
    network's own forward, bit for bit, and its motion within 1e-5. The seg
    head is scaled as in the engine's test above."""
    from echoflow_torch.infer.clips import ClipForward

    state = create_model(seed=4, backbone="ir_csn_152").state_dict()
    state["segmentation_head.weight"] = state["segmentation_head.weight"] * 300.0
    video = np.random.RandomState(1).rand(3, 32, 112, 112).astype(np.float32)
    labels, _, motion = ClipForward(state, device="cpu", forward_chunk=1) \
        .segment_start_points(video, [0])
    model = motion_seg_net("ir_csn_152")
    model.load_state_dict(state)
    with torch.no_grad():
        seg, want_motion = model.eval()(torch.from_numpy(video[None]))
    assert labels.shape == (1, 32, 112, 112)
    assert 0.05 < labels.mean() < 0.95
    assert np.array_equal(labels, seg.argmax(dim=1).numpy().astype(np.uint8))
    np.testing.assert_allclose(motion, want_motion.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_every_backbone_of_the_table_builds_and_names_itself(folded):
    """Each entry of `backbones()` builds its own net class by its name,
    whose state dict `backbone_of` names back, and whose `backbone` is the
    module its keys are under."""
    from echoflow_torch.models.r2plus1d import backbone_of, backbones

    for name, net in backbones().items():
        with torch.device("meta"):
            model = motion_seg_net(name, folded=folded)
        assert type(model) is net and net.name == name and model.folded == folded
        assert backbone_of(model.state_dict()) == name
        assert model.backbone is getattr(model, net.backbone_attr)


@pytest.mark.parametrize("cli", ["motion_segment_torch", "train_clasfv_torch"])
def test_both_clis_offer_exactly_the_tables_backbones(cli, capsys):
    """`--backbone` of both CLIs offers the names of `backbones()`, and no
    other."""
    import importlib
    import re

    from echoflow_torch.models.r2plus1d import backbones

    module = importlib.import_module(cli)
    with pytest.raises(SystemExit):
        module.parse_args(["--help"])
    offered = re.search(r"--backbone \{([^}]*)\}", capsys.readouterr().out).group(1)
    assert offered.split(",") == list(backbones())
