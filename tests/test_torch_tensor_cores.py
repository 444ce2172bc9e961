"""The folded backbone fitted to cuDNN's 16-bit tensor cores
(`models/fold_bn.fit_tensor_cores`: `pad_widths`, `temporal_convs_as_2d`,
`channels_last`) on the CPU: the same function in float64, widths that are
multiples of 8, weights in `channels_last_3d`, R(2+1)D-18 changed and
ir-CSN-152 left alone, and the gate closed on every fp32 and CPU engine
(fp32 on the card is the parity path)."""

import pytest
import torch

from echoflow_torch.models.fast_forward import backbone_input, folded_forward
from echoflow_torch.models.fold_bn import (channels_last, fit_tensor_cores, fold_state_dict,
                                           pad_widths, temporal_convs_as_2d)
from echoflow_torch.models.r2plus1d import TemporalConv3d, create_model, motion_seg_net
from echoflow_torch.utils.profiling import counters

# (pairs padded, temporal convs made 2D) of each backbone: R(2+1)D-18's
# stem (45) and both (2+1)D convs of layers 2-4's first block (230, 460,
# 921: each block computes its midplanes once); its 17 (3, 1, 1) convs.
FITTED = {"r2plus1d_18": (7, 17), "ir_csn_152": (0, 0)}


def _folded_state(backbone, seed=5):
    """A folded state dict whose BatchNorms were away from the identity, so
    that every folded conv has a bias that is not zero."""
    state = create_model(seed=seed, backbone=backbone).state_dict()
    g = torch.Generator().manual_seed(seed)
    for bn in [k[:-len("running_var")] for k in state if k.endswith("running_var")]:
        shape = state[f"{bn}running_var"].shape
        state[f"{bn}running_mean"] = 0.1 * torch.randn(shape, generator=g)
        state[f"{bn}running_var"] = torch.empty(shape).uniform_(0.5, 1.5, generator=g)
        state[f"{bn}weight"] = torch.empty(shape).uniform_(0.5, 1.5, generator=g)
        state[f"{bn}bias"] = 0.1 * torch.randn(shape, generator=g)
    return fold_state_dict(state)


def _folded_model(backbone, state, dtype=torch.float64):
    model = motion_seg_net(backbone, folded=True)
    model.load_state_dict(state)
    return model.eval().requires_grad_(False).to(dtype)


def _padded_counter():
    return counters().get("engine.padded_widths", 0)


def _conv_weights(backbone):
    return [m.weight for m in backbone.modules() if isinstance(m, torch.nn.Conv3d)]


def _channels_last(backbone) -> bool:
    return all(w.is_contiguous(memory_format=torch.channels_last_3d)
               for w in _conv_weights(backbone))


@pytest.mark.parametrize("backbone", sorted(FITTED))
def test_fitting_keeps_the_backbones_function(backbone):
    """1 x 3 x 8 x 32 x 32 in float64: the fitted backbone's five taps are the
    folded one's within 1e-12 (only the order of the sums changes); every
    conv's output width is a multiple of 8; each parameter is the old one
    with zeros appended; `pad_widths` and `temporal_convs_as_2d` return
    R(2+1)D-18's 7 and 17 and ir-CSN-152's 0 and 0, whose state dict stays
    as it was; a second call changes nothing. `channels_last` puts every
    conv weight of R(2+1)D-18 in `channels_last_3d`, and its input is laid
    out so (`fast_forward.backbone_input`); ir-CSN-152's depthwise convs
    keep it NCDHW, its weights and input as they were."""
    state = _folded_state(backbone)
    plain, fitted = (_folded_model(backbone, state) for _ in range(2))
    assert (pad_widths(fitted.backbone), temporal_convs_as_2d(fitted.backbone)) == \
        FITTED[backbone]
    assert (pad_widths(fitted.backbone), temporal_convs_as_2d(fitted.backbone)) == (0, 0)
    made = backbone == "r2plus1d_18"
    assert channels_last(fitted.backbone) == made
    assert _channels_last(fitted.backbone) == made
    assert made or all(w.is_contiguous() for w in _conv_weights(fitted.backbone))
    convs = [m for m in fitted.backbone.modules() if isinstance(m, torch.nn.Conv3d)]
    assert all(m.out_channels % 8 == 0 for m in convs)
    assert sum(isinstance(m, TemporalConv3d) for m in convs) == FITTED[backbone][1]
    before, after = plain.state_dict(), fitted.state_dict()
    assert set(before) == set(after)
    for k, old in before.items():
        new, kept = after[k].clone(), tuple(slice(0, s) for s in old.shape)
        assert torch.equal(new[kept], old), k
        new[kept] = 0
        assert not new.any(), k
        if backbone == "ir_csn_152":
            assert new.shape == old.shape, k
    video = torch.rand((1, 3, 8, 32, 32), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0))
    x = backbone_input(fitted.backbone, video)
    assert x.is_contiguous(memory_format=torch.channels_last_3d) == made
    assert backbone_input(plain.backbone, video) is video
    want, got = plain.backbone(video), fitted.backbone(x)
    assert len(got) == 5
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float(b.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_folded_forward_counts_channels_last_forwards():
    """`fast_forward.folded_forward` of the float64 folded R(2+1)D-18 on
    1 x 3 x 8 x 32 x 32, as folded (NCDHW) and fitted as a 16-bit engine
    is (`pad_widths`, `temporal_convs_as_2d`, `channels_last`; each block
    ends in a temporal conv, a conv2d, which keeps the layout on the CPU
    too): the segmentation and motion within 1e-12 of each other (the
    projections read the channels-last taps in place), and
    `backbone.channels_last` counts one for the fitted forward, none for
    the NCDHW one."""
    state = _folded_state("r2plus1d_18")
    ncdhw, fitted = (_folded_model("r2plus1d_18", state) for _ in range(2))
    pad_widths(fitted.backbone)
    temporal_convs_as_2d(fitted.backbone)
    assert channels_last(fitted.backbone)
    video = torch.rand((1, 3, 8, 32, 32), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(1))
    outs = []
    for model, grows in ((ncdhw, 0), (fitted, 1)):
        n0 = counters().get("backbone.channels_last", 0)
        outs.append(folded_forward(model, video, dtype=torch.float64))
        assert counters().get("backbone.channels_last", 0) - n0 == grows
    for a, b in zip(*outs):
        assert float(a.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("backbone,dtype,device,fitted", [
    ("r2plus1d_18", torch.bfloat16, "cuda", True), ("r2plus1d_18", torch.float16, "cuda", True),
    ("r2plus1d_18", torch.float32, "cuda", False), ("r2plus1d_18", torch.bfloat16, "cpu", False),
    ("ir_csn_152", torch.bfloat16, "cuda", False), ("ir_csn_152", torch.float16, "cuda", False)],
    ids=["bf16-cuda", "fp16-cuda", "fp32-cuda", "bf16-cpu", "csn-bf16-cuda", "csn-fp16-cuda"])
def test_fit_tensor_cores_opens_only_for_16_bits_on_cuda(backbone, dtype, device, fitted):
    """The gate reads the backbone's dtype and the engine's device (the
    backbone itself stays on the CPU here): a 16-bit R(2+1)D-18 on CUDA is
    padded and counted, its conv weights put in `channels_last_3d`; an
    fp32 one or one on the CPU is left as it is, NCDHW, and counts
    nothing. A 16-bit ir-CSN-152 on CUDA has nothing to pad or make 2D, and
    its depthwise convs (aten's `conv_depthwise3d` wants NCDHW) keep every
    weight as it was."""
    model = _folded_model(backbone, _folded_state(backbone), dtype)
    before, n0 = model.state_dict(), _padded_counter()
    assert fit_tensor_cores(model.backbone, device) == (7 if fitted else 0)
    assert _padded_counter() - n0 == (7 if fitted else 0)
    assert any(isinstance(m, TemporalConv3d) for m in model.modules()) == fitted
    assert _channels_last(model.backbone) == fitted
    if not fitted:
        assert all(w.is_contiguous() for w in _conv_weights(model.backbone))
        after = model.state_dict()
        assert all(torch.equal(after[k], v) for k, v in before.items())


@pytest.mark.parametrize("engine,dtype", [("segmenter", torch.float32),
                                          ("segmenter", torch.bfloat16),
                                          ("segmenter", "auto"),
                                          ("clips", torch.float32),
                                          ("clips", torch.bfloat16)],
                         ids=["segmenter-fp32", "segmenter-bf16", "segmenter-auto",
                              "clips-fp32", "clips-bf16"])
def test_cpu_engines_do_not_fit_the_backbone(engine, dtype):
    """`VideoSegmenter` and `ClipForward` on the CPU, fp32 and bf16 alike:
    the counter stays where it was, no conv becomes a `TemporalConv3d`,
    every conv weight stays NCDHW, and the model's state dict is the folded
    one (cast to the backbone's dtype)."""
    from echoflow_torch.infer.clips import ClipForward
    from echoflow_torch.infer.pipeline import VideoSegmenter

    state = _folded_state("r2plus1d_18")
    n0 = _padded_counter()
    if engine == "segmenter":
        model = VideoSegmenter(state, device="cpu", dtype=dtype)._model
    else:
        model = ClipForward(state, device="cpu", dtype=dtype)._model
    assert _padded_counter() == n0
    assert not any(isinstance(m, TemporalConv3d) for m in model.modules())
    assert all(w.is_contiguous() for w in _conv_weights(model.backbone))
    got = model.state_dict()
    assert set(got) == set(state)
    for k, v in state.items():
        assert got[k].shape == v.shape, k
        assert torch.equal(got[k], v.to(got[k].dtype)), k

