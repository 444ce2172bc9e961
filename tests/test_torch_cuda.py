"""CUDA kernels of echoflow_torch against their plain versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere. This file imports neither
jax nor echoflow, so on a machine without them it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from echoflow_torch.ops.decoder_heads import decoder_heads, reference_decoder_heads

SHAPES = dict(b1=(64,), w2=(64, 64), b2=(64,), ws=(64, 2), bs=(2,), wm=(64, 4), bm=(4,))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("with_motion", [True, False])
@pytest.mark.parametrize("sizes", [(56, 28, 14, 7), (56, 7), (28,)])
def test_decoder_heads_kernel_matches_plain(cuda, sizes, with_motion):
    """The main path's source sizes with 2 clips (30 in the engine), and
    fewer sources, with and without the motion head."""
    g = torch.Generator(device="cuda").manual_seed(0)
    projs = [torch.randn(2, 32, s, s, 64, device="cuda", generator=g) * 0.2 for s in sizes]
    w = {k: torch.randn(*s, device="cuda", generator=g) * 0.3 for k, s in SHAPES.items()}
    before = decoder_heads.launches
    seg, mot = decoder_heads(projs, **w, out_hw=(112, 112), with_motion=with_motion)
    torch.cuda.synchronize()
    assert decoder_heads.launches == before + 1
    rseg, rmot = reference_decoder_heads(projs, **w, out_hw=(112, 112),
                                         with_motion=with_motion)
    # fp32 on both sides; only the summation order differs.
    torch.testing.assert_close(seg, rseg, rtol=1e-4, atol=1e-4)
    if with_motion:
        torch.testing.assert_close(mot, rmot, rtol=1e-4, atol=1e-4)
    else:
        assert mot is None


@pytest.mark.cuda
def test_decoder_heads_rejects_what_the_kernel_cannot_take(cuda):
    p = [torch.zeros(1, 2, 8, 8, 32, device="cuda")]   # 32 channels: not compiled
    w = {k: torch.zeros(*s, device="cuda") for k, s in SHAPES.items()}
    with pytest.raises(ValueError):
        decoder_heads(p, **w, out_hw=(16, 16))
    p = [torch.zeros(1, 2, 8, 8, 64, device="cuda").transpose(2, 3)]   # not contiguous
    with pytest.raises(ValueError):
        decoder_heads(p, **w, out_hw=(16, 16))
    p = [torch.zeros(1, 2, 8, 8, 64, device="cuda", dtype=torch.bfloat16)]
    with pytest.raises(ValueError):
        decoder_heads(p, **w, out_hw=(16, 16))


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu_engine(cuda):
    from echoflow_torch.data.synthetic import make_beating_video
    from echoflow_torch.infer.pipeline import VideoSegmenter
    from echoflow_torch.models.r2plus1d import create_model

    state = create_model(seed=1).state_dict()
    state["segmentation_head.weight"] = state["segmentation_head.weight"] * 50.0
    video = make_beating_video(num_frames=45, height=32, width=32, period=20.0,
                               seed=1).video.astype(np.uint8)
    gpu = VideoSegmenter(state, dtype=torch.float32, bucket=32, forward_chunk=4)
    cpu = VideoSegmenter(state, device="cpu", bucket=32, forward_chunk=4)
    before = decoder_heads.launches
    for method in ("majority", "simple", "softmax"):
        a = gpu.segment_video(video, num_clips=2, step=1, fuse_method=method)
        b = cpu.segment_video(video, num_clips=2, step=1, fuse_method=method)
        # argmax near-ties between two fp32 backends may flip a pixel.
        assert (a != b).mean() <= 1e-3
    assert decoder_heads.launches > before
