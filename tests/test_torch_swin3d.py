"""CLAS-FV over Video Swin-B (echoflow_torch.models.swin3d) on the CPU against
the benchmark's plain reference (portbench/reference/swin3d.py), at a small
size on seeded weights that reaches every path: width 8, four stages of two
blocks with 1, 2, 2 and 4 heads, windows of (2, 5, 5), 17 frames of 65 x 65
(tokens 9 x 17^2, 9 x 9^2, 9 x 5^2, 9 x 3^2). Every stage pads its windows
(9 frames into windows of 2, 17 and 9 into 5), the shifted blocks of
stages 1 and 2 roll in all three dimensions and mask, stage 3 is one
window in H and W and shifts in time alone, stage 4's 3 x 3 is a window
clipped to 18 tokens that reads the [:18, :18] corner of the full window's
bias index, and each merging pads an odd size (17, 9, 5). At these sizes
every tap's upsampling weights are binary fractions (tap extents 9, 17, 9,
5, 3 into 17 and 65), so the two agree to rounding.

Bars: float64 1e-10, fp32 1e-5, relative L2; gradients as in
test_torch_csn.py (each leaf against the larger of its norm and the
median leaf's; the biases before a norm, whose gradients are rounding
alone, left out).
"""

import hashlib

import numpy as np
import pytest
import torch

from echoflow_torch.models.r2plus1d import create_model, init_weights, motion_seg_net, param_count
from echoflow_torch.models.swin3d import (SwinMotionSegNet, bias_indices, relative_index,
                                          shift_mask)
from echoflow_torch.ops.attention import gathered_bias, plain_window_attention, window_attention
from echoflow_torch.train.losses import clasfv_total_loss_fused
from portbench.reference import swin3d as ref
from portbench.synthetic import training_batch, training_sample

T, H, W, N = 17, 65, 65, 2
SMALL = {"embed_dim": 8, "depths": (2, 2, 2, 2), "heads": (1, 2, 2, 4), "window": (2, 5, 5)}
CFG = {"in_channels": 3, "clip_length": T, "height": H, "width": W, "patch_size": [2, 4, 4],
       "embed_dim": 8, "depths": [2, 2, 2, 2], "num_heads": [1, 2, 2, 4],
       "window_size": [2, 5, 5], "mlp_ratio": 4, "drop_path_rate": 0.0, "layer_norm_eps": 1e-5,
       "decoder_width": 64, "seg_classes": 2, "motion_channels": 4, "kinetics_classes": 400,
       "bn_eps": 1e-5, "decoder_bn_eps": 1e-5}
PUBLISHED = {**CFG, "clip_length": 32, "height": 112, "width": 112, "embed_dim": 128,
             "depths": [2, 2, 18, 2], "num_heads": [4, 8, 16, 32], "window_size": [8, 7, 7]}
BARS = {torch.float64: 1e-10, torch.float32: 1e-5}
DTYPES = [torch.float64, torch.float32]
IDS = ["f64", "f32"]
ROUNDING_ONLY = {"comb_1_layer.bias", "comb_2_layer.bias", "swin3d_model.norm.bias",
                 "swin3d_model.fc.weight", "swin3d_model.fc.bias"}


def _model(dtype, seed=3, drop_path_rate=0.0):
    model = SwinMotionSegNet(drop_path_rate=drop_path_rate, **SMALL)
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():   # running statistics away from the identity, for eval and folding
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=torch.Generator().manual_seed(7)))
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(8))
        for name, p in model.named_parameters():   # LayerNorms and biases away from their init
            if p.dim() == 1 and name.startswith("swin3d_model"):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(9)))
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


def _rel(a, b, floor=0.0):
    return float((a - b).double().norm() / max(float(b.double().norm()), floor, 1e-300))


def _loss(video, seg, motion, batch):
    return clasfv_total_loss_fused(video, seg, motion, batch["ed_label"], batch["es_label"],
                                   batch["ed_idx"], batch["es_idx"])[0]


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_outputs_match_the_reference(dtype, train):
    """seg and motion of the port's forward (train-mode decoder BatchNorm,
    or eval) against the plain reference's on the same state dict: float64
    within 1e-10; fp32 as close to the float64 reference as the fp32
    reference is, within 1.5x, less the fp32 bar (train-mode BatchNorm
    leaves either fp32 forward ~2e-5 from float64, by the thread count's
    summation order)."""
    model = _model(dtype).train(train)
    batch = _batch(dtype)
    with torch.no_grad():
        got = model(batch["video"])
        want = ref.forward(_params(model), batch["video"], CFG, train=train)
        if dtype == torch.float32:
            truth = ref.forward({k: v.double() if v.is_floating_point() else v
                                 for k, v in _params(model).items()},
                                batch["video"].double(), CFG, train=train)
    assert got[0].shape == (N, 2, T, H, W) and got[1].shape == (N, 4, T, H, W)
    for a, b, i in zip(got, want, range(2)):
        if dtype == torch.float64:
            assert _rel(a, b) <= BARS[dtype]
        else:
            assert _rel(a, truth[i]) <= 1.5 * _rel(b, truth[i]) + BARS[dtype]


def _grads(model, batch, drop_masks=None):
    """(port loss, port grads, reference loss, reference grads) in train
    mode through the fused loss."""
    p = _params(model)
    model.train().zero_grad()
    seg, motion = model(batch["video"])
    total = _loss(batch["video"], seg, motion, batch)
    total.backward()
    grads = {k: q.grad.detach().clone() if q.grad is not None else torch.zeros_like(q)
             for k, q in model.named_parameters()}
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items() if k in grads}
    rseg, rmotion = ref.forward({**p, **leaves}, batch["video"], _cfg(model), train=True,
                                drop_masks=drop_masks)
    rtotal = _loss(batch["video"], rseg, rmotion, batch)
    rgrads = torch.autograd.grad(rtotal, list(leaves.values()), allow_unused=True)
    rgrads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(leaves, rgrads)}
    return total.detach(), grads, rtotal.detach(), rgrads


def _cfg(model):
    blocks = [b for layer in model.swin3d_model.layers for b in layer.blocks]
    return {**CFG, "drop_path_rate": blocks[-1].drop_path}


def _worst(got, want):
    keys = [k for k in want if k not in ROUNDING_ONLY]
    median = float(np.median([float(want[k].double().norm()) for k in keys]))
    return max((_rel(got[k], want[k], median), k) for k in keys)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_loss_and_every_leafs_gradient_match_the_reference(dtype):
    """The loss and every leaf's gradient (the bias tables, LayerNorms,
    Linears, the patch embedding, the decoder) of one train-mode step:
    the port's route (`ops/attention`'s explicit backward, the table's
    gradient by fixed-order sums; the windows' and merging's autograd
    functions) against autograd of the plain reference."""
    model = _model(dtype)
    total, grads, rtotal, rgrads = _grads(model, _batch(dtype))
    assert _rel(total, rtotal) <= BARS[dtype]
    if dtype == torch.float64:
        worst = _worst(grads, rgrads)
        assert worst[0] <= BARS[dtype], worst
        return
    _, truth, _, _ = _grads(_model(torch.float64), _batch(torch.float64))
    _as_close_to_float64(grads, rgrads, truth)


def _as_close_to_float64(port, plain, truth):
    """fp32: each leaf of the port's run as close to the float64 run
    (`truth`) as the plain reference's fp32 run is, within 1.5x, less the
    fp32 bar (test_torch_csn.py's measure): the fused loss's warps and
    the decoder's BatchNorms leave both fp32 runs up to ~1e-3 from
    float64 at the motion head."""
    keys = [k for k in truth if k not in ROUNDING_ONLY]
    median = float(np.median([float(truth[k].double().norm()) for k in keys]))
    for k in keys:
        floor = max(float(truth[k].double().norm()), median)
        gap = float((port[k].double() - truth[k]).norm()) / floor
        plain_gap = float((plain[k].double() - truth[k]).norm()) / floor
        assert gap <= 1.5 * plain_gap + BARS[torch.float32], (k, gap, plain_gap)


def test_stochastic_depth_at_given_masks_matches_the_reference():
    """With stochastic depth (rates 0 to 0.5 over the 8 blocks), a train
    forward draws each branch's keep mask from the model's generator
    (attention branch, then MLP, block by block; none at rate 0); the
    reference given those masks (drawn again from a generator of the same
    seed) computes the same loss and gradients in float64, and the masks
    drop some samples."""
    model = _model(torch.float64, drop_path_rate=0.5)
    model.generator = torch.Generator().manual_seed(11)
    blocks = [b for layer in model.swin3d_model.layers for b in layer.blocks]
    again = torch.Generator().manual_seed(11)
    masks = [(1.0 - b.drop_path + torch.rand((N,), generator=again, dtype=torch.float64)).floor()
             for b in blocks if b.drop_path > 0 for _ in range(2)]
    assert len(masks) == 14 and 0 < float(torch.stack(masks).mean()) < 1
    total, grads, rtotal, rgrads = _grads(model, _batch(torch.float64), masks)
    assert _rel(total, rtotal) <= 1e-10
    assert _worst(grads, rgrads)[0] <= 1e-10
    assert model.draws and not _model(torch.float64).draws


def _step(model, remat):
    """One `make_train_step(remat=remat)` step of `model` (float64, Adam):
    the loss and every leaf's gradient."""
    from echoflow_torch.train.loop import TrainState, make_train_step

    state = TrainState(model=model.train(), optimizer=torch.optim.Adam(model.parameters()),
                       schedule=lambda step: 1e-4, generator=model.generator)
    _, metrics = make_train_step(remat=remat)(state, _batch(torch.float64))
    return float(metrics["loss"]), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("drop_path_rate", [0.0, 0.5], ids=["no-drop", "drop"])
def test_remat_step_over_swin(drop_path_rate):
    """`make_train_step(remat=True)` over the Swin network: without
    stochastic depth its loss and every gradient are the plain step's
    (float64, 1e-12); with it the step raises ValueError naming the
    backbone, since the recompute would draw masks the loss never saw."""
    model = _model(torch.float64, drop_path_rate=drop_path_rate)
    model.generator = torch.Generator().manual_seed(11)
    if model.draws:
        with pytest.raises(ValueError, match="swin3d_b"):
            _step(model, remat=True)
        return
    loss, grads = _step(model, remat=False)
    remat_loss, remat_grads = _step(_model(torch.float64), remat=True)
    assert abs(remat_loss - loss) <= 1e-12 * abs(loss)
    assert max(_rel(remat_grads[k], g) for k, g in grads.items() if g.norm() > 0) <= 1e-12


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("n", [50, 18], ids=["full", "clipped"])
def test_attention_route_matches_its_plain_version(masked, n):
    """`window_attention` (explicit backward, the table's gradient by
    fixed-order sums over `bias_indices`' rows) against autograd of
    `plain_window_attention` on the gathered bias, float64: the output,
    qkv's gradient and the table's; a window clipped to 18 tokens reads
    the [:18, :18] corner of the index."""
    g = torch.Generator().manual_seed(0)
    window, heads, c, nw = (2, 5, 5), 2, 16, 3
    index, rows = bias_indices(window, n, torch.device("cpu"))
    table = torch.randn(3 * 9 * 9, heads, generator=g, dtype=torch.float64, requires_grad=True)
    qkv = torch.randn(2 * nw, n, 3 * c, generator=g, dtype=torch.float64, requires_grad=True)
    mask = None
    if masked:
        mask = torch.where(torch.rand(nw, n, n, generator=g) < 0.3, -100.0, 0.0).double()
    dout = torch.randn(2 * nw, n, c, generator=g, dtype=torch.float64)
    got = window_attention(qkv, table, heads, index, rows, mask)
    dq, dt = torch.autograd.grad(got, (qkv, table), dout)
    want = plain_window_attention(qkv, gathered_bias(table, index, n), heads, mask)
    wq, wt = torch.autograd.grad(want, (qkv, table), dout)
    for a, b in ((got, want), (dq, wq), (dt, wt)):
        assert _rel(a, b) <= 1e-12
    assert torch.equal(index.view(n, n), torch.from_numpy(relative_index(window))[:n, :n])


def test_bias_rows_cover_each_pair_once():
    """`bias_indices`' rows list every flat pair position once, each under
    its own table row, padded with n x n; the full (8, 7, 7) window's
    index (2535 rows) is the reference's, pair by pair."""
    for window, n in (((8, 7, 7), 392), ((8, 7, 7), 128), ((2, 5, 5), 18)):
        index, rows = bias_indices(window, n, torch.device("cpu"))
        flat = rows[rows < n * n]
        assert sorted(flat.tolist()) == list(range(n * n))
        owner = torch.arange(rows.shape[0]).unsqueeze(1).expand_as(rows)[rows < n * n]
        assert torch.equal(index[flat], owner)
        assert torch.equal(index.view(n, n), ref.relative_index(window, n))
    assert rows.shape[0] == 3 * 9 * 9


@pytest.mark.parametrize("size,window,shift", [((16, 28, 28), (8, 7, 7), (4, 3, 3)),
                                               ((16, 7, 7), (8, 7, 7), (4, 0, 0)),
                                               ((10, 20, 20), (2, 5, 5), (1, 2, 2))])
def test_shift_masks_are_the_references(size, window, shift):
    """The port's mask of the shifted windows (the published region labels
    by slices) is the reference's (region arithmetic per token)."""
    got = shift_mask(size, window, shift, torch.device("cpu"), torch.float32)
    assert torch.equal(got, ref.shift_mask(size, window, shift).float())
    assert got.shape[0] == np.prod([s // w for s, w in zip(size, window)])


def test_published_width_parameter_count():
    """88,184,926 at the published widths: the backbone's 87,638,984, the
    Kinetics head's 410,000, the decoder's and heads' 135,942; the taps
    128, 128, 256, 512, 1024 into comb1's 2048; the reference's keys and
    shapes."""
    with torch.device("meta"):
        model = motion_seg_net("swin3d_b")
    fc = sum(p.numel() for p in model.backbone.fc.parameters())
    assert param_count(model) == 88_184_926
    assert param_count(model.backbone) - fc == 87_638_984 and fc == 410_000
    assert model.backbone.tap_channels == (128, 128, 256, 512, 1024)
    assert model.comb_1_layer.in_channels == 2048
    shapes = ref.state_shapes(PUBLISHED)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(s) for k, s in shapes.items()}
    blocks = [b for layer in model.swin3d_model.layers for b in layer.blocks]
    assert [b.drop_path for b in blocks] == pytest.approx(np.linspace(0, 0.3, 24).tolist())
    assert [b.shift for b in blocks[:2]] == [(0, 0, 0), (4, 3, 3)]


def test_seeded_init_follows_the_published_rule():
    """`create_model(backbone="swin3d_b")`: Linear weights and bias tables
    with std about 0.02, Linear biases 0, LayerNorms the identity, the
    patch conv within +-1/sqrt(96); the decoder's CLAS-FV init; the
    Kinetics head 0; the same weights for the same seed."""
    a = create_model(seed=2, backbone="swin3d_b").state_dict()
    b = create_model(seed=2, backbone="swin3d_b").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    qkv = a["swin3d_model.layers.2.blocks.5.attn.qkv.weight"]
    table = a["swin3d_model.layers.0.blocks.1.attn.relative_position_bias_table"]
    assert abs(float(qkv.std()) - 0.02) < 1e-3 and abs(float(table.std()) - 0.02) < 2e-3
    assert float(a["swin3d_model.layers.2.blocks.5.mlp.fc1.bias"].abs().max()) == 0
    assert torch.equal(a["swin3d_model.norm.weight"], torch.ones(1024))
    assert float(a["swin3d_model.patch_embed.proj.weight"].abs().max()) <= 96 ** -0.5
    assert float(a["swin3d_model.fc.weight"].abs().max()) == 0
    assert float(a["motion_head.weight"].std()) < 0.01 < float(a["comb_2_layer.weight"].std())


# SHA-256 of `create_model(seed=5, backbone=...)`'s state dict (keys and bytes),
# read before Video Swin-B was added.
SEEDED = {"r2plus1d_18": "513032927c38d589dd6f908d0de30a566ffea4f38dfa0493b6d85276bb458030",
          "ir_csn_152": "c528de09ddf4be4c6c5277c987c8f8308cea91c2a25e08a398a680018b3d0bcf"}


@pytest.mark.parametrize("backbone", list(SEEDED))
def test_other_backbones_seeded_weights_are_unchanged(backbone):
    h = hashlib.sha256()
    for k, v in create_model(seed=5, backbone=backbone).state_dict().items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == SEEDED[backbone]


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_a_swin_state_dict_names_its_backbone(folded):
    from echoflow_torch.models.r2plus1d import backbone_of

    with torch.device("meta"):
        state = motion_seg_net("swin3d_b", folded=folded).state_dict()
    assert backbone_of(state) == "swin3d_b"


def test_folding_folds_the_decoder_alone_and_keeps_the_eval_forward():
    """A Swin state dict folds its decoder's two BatchNorms (eps 1e-5); its
    LayerNorms, Linears and bias tables pass through; the folded state
    dict loads strictly into the folded network, whose fp32 eval forward
    is the unfolded one's within 1e-5."""
    from echoflow_torch.models.fold_bn import fold_state_dict, is_folded
    from echoflow_torch.models.swin3d import fold_pairs

    model = _model(torch.float32).eval()
    state = {k: v.float() for k, v in model.state_dict().items()}
    assert {bn for _, bn, _ in fold_pairs(state) if bn} == {"comb_batch_norm_1",
                                                              "comb_batch_norm_2"}
    folded_state = fold_state_dict(state)
    assert is_folded(folded_state)
    table = "swin3d_model.layers.3.blocks.1.attn.relative_position_bias_table"
    assert torch.equal(folded_state[table], state[table])
    folded = SwinMotionSegNet(folded=True, **SMALL)
    folded.load_state_dict(folded_state, strict=True)
    video = _batch(torch.float32)["video"]
    with torch.no_grad():
        for a, b in zip(folded.eval()(video), model(video)):
            assert _rel(a, b) <= BARS[torch.float32]


def _published_state(video):
    """Seeded published-width weights whose seg head is scaled (no pixel's
    two logits within the two paths' rounding) and centred on `video`'s
    median logit gap (both classes present)."""
    from echoflow_torch.infer.model import inference_model

    state = create_model(seed=4, backbone="swin3d_b").state_dict()
    state["segmentation_head.weight"] = state["segmentation_head.weight"] * 300.0
    model = inference_model(state, "cpu", torch.float32, fold_bn=False, kernel=False)
    with torch.no_grad():
        seg, _ = model(torch.from_numpy(video[None]).float() / 255.0)
    gap = float((seg[:, 1] - seg[:, 0]).median())
    state["segmentation_head.bias"] = state["segmentation_head.bias"] + torch.tensor(
        [gap / 2, -gap / 2])
    return state


def test_the_folded_engine_segments_as_the_unfolded_model():
    """`VideoSegmenter` over a Video Swin-B state dict at the published
    widths on the CPU in fp32: its folded forward with the decoder tail's
    plain version gives the masks of the unfolded network's own forward,
    bit for bit, both classes present."""
    from echoflow_torch.infer.pipeline import VideoSegmenter

    rng = np.random.RandomState(0)
    video = (rng.rand(3, 32, 112, 112) * 255).astype(np.uint8)
    state = _published_state(video)
    masks = [VideoSegmenter(state, device="cpu", fold_bn=fold,
                            decoder="kernel" if fold else "model", forward_chunk=1)
             .segment_video(video, num_clips=1) for fold in (True, False)]
    assert masks[0].shape == (32, 112, 112)
    assert 0.05 < masks[0].mean() < 0.95
    assert np.array_equal(masks[0], masks[1])


def test_clip_forward_runs_the_swin_network():
    """`ClipForward` over a Video Swin-B state dict (folded, the plain
    decoder tail on the CPU) gives the unfolded module's softmax and
    motion within fp32 rounding."""
    from echoflow_torch.infer.clips import ClipForward

    clips = np.random.RandomState(1).rand(1, 3, 32, 112, 112).astype(np.float32)
    state = create_model(seed=4, backbone="swin3d_b").state_dict()
    folded = ClipForward(state, device="cpu", forward_chunk=1)(clips)
    plain = ClipForward(state, device="cpu", forward_chunk=1, fold_bn=False)(clips)
    for a, b in zip(folded, plain):
        assert a.shape[2:] == (32, 112, 112)
        assert np.abs(a - b).max() <= 1e-4


@pytest.mark.parametrize("dtypes", [(torch.bfloat16, None), (torch.float32, torch.bfloat16),
                                    (torch.float16, None)], ids=["bf16", "mixed", "fp16"])
def test_a_sixteen_bit_refuses_swin(dtypes):
    """The 16-bit engine backbone is not built for Video Swin-B: a
    ValueError that names the backbone."""
    from echoflow_torch.infer.model import inference_model

    with torch.device("meta"):
        state = motion_seg_net("swin3d_b").state_dict()
    with pytest.raises(ValueError, match="swin3d_b"):
        inference_model(state, "cpu", dtypes[0], dtypes[1])


def test_attention_and_windows_are_counted_and_spanned():
    """One forward of the small model counts one `swin.attention.launches`
    a block (8) and runs the spans `swin.attention` and `swin.windows`
    (their `record_function` ranges, forward and backward)."""
    from torch.profiler import ProfilerActivity, profile

    from echoflow_torch.utils.profiling import counters

    model = _model(torch.float32).train()
    video = _batch(torch.float32)["video"]
    before = counters().get("swin.attention.launches", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        seg, motion = model(video)
        (seg.sum() + motion.sum()).backward()
    assert counters()["swin.attention.launches"] - before == 8
    names = [e.name for e in prof.events()]
    assert names.count("echoflow_torch.swin.attention") == 16
    # per block: partition and reverse forward and backward; per merging: one each way
    assert names.count("echoflow_torch.swin.windows") == 8 * 4 + 3 * 2


def test_train_state_and_trainer_take_swin(tmp_path):
    """`create_train_state(TrainConfig(backbone="swin3d_b"))` hands its
    generator to the model, whose training forward draws from it, and
    refuses a bf16 compute dtype; the trainer's `--backbone swin3d_b` runs
    a step on the CPU."""
    import train_clasfv_torch
    from echoflow_torch.train.loop import TrainConfig, create_train_state

    state = create_train_state(0, TrainConfig(backbone="swin3d_b"), device="cpu")
    assert state.model.generator is state.generator and state.model.draws
    with pytest.raises(ValueError, match="swin3d_b"):
        create_train_state(0, TrainConfig(backbone="swin3d_b", compute_dtype=torch.bfloat16),
                           device="cpu")
    out = tmp_path / "ck.pth"
    train_clasfv_torch.main(["--synthetic", "--device", "cpu", "--steps", "1", "--epochs", "1",
                             "--batch-size", "2", "--image-size", "24", "--clip-length", "8",
                             "--backbone", "swin3d_b", "--out", str(out)])
    assert out.exists()


def test_the_patch_embedding_conv_has_its_route():
    """The patch embedding's conv class, (2,4,4)/(2,4,4), is in
    `ops/conv.ROUTES` (no fall to the default), recorded as a train
    forward runs it."""
    from echoflow_torch.ops import conv as C

    seen = set()
    plain = C.convolution

    def recording(x, weight, bias=None, stride=1, padding=0, transposed=False, groups=1):
        seen.add(C.geometry_class(weight.shape, tuple(stride), transposed, groups))
        return plain(x, weight, bias, stride, padding, transposed, groups)

    C.convolution = recording
    try:
        _model(torch.float32).train()(_batch(torch.float32)["video"])
    finally:
        C.convolution = plain
    assert "(2,4,4)/(2,4,4)" in seen and seen <= set(C.ROUTES)
