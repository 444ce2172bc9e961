"""The plain reference against the port's CPU paths at a tiny size, and the
benchmark's frozen copies against what they copy."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import flops, peaks, synthetic
from portbench.harness import ROOT, Cell, load_cell
from portbench.reference import archive, ef
from portbench.reference.train import train_steps
from portbench.tests.tiny import OVERRIDES


def _cell(name, kind, root=ROOT):
    bench, work, config, traffic, limits = load_cell(name, root)
    o = OVERRIDES[kind]
    return Cell(name, {**config, **o["config"]}, {**traffic, **o["traffic"]}, limits,
                2**31 + 11, 1.0, False, "cpu")


def test_the_archive_reference_agrees_with_the_port_on_the_cpu():
    from echoflow_torch.infer import ef as port_ef
    from echoflow_torch.infer.pipeline import VideoSegmenter
    from portbench.drivers import stream

    cell = _cell("fp32-archive", "archive")
    pool, rng = stream.make_pool(cell.traffic, cell.seed)
    stream.check_indices(pool, rng, 2)
    state, _ = stream.prepare_weights(cell, rng, torch.device("cpu"))
    video = pool[-1][1]
    engine = VideoSegmenter(state, device="cpu", dtype=torch.float32)
    got = engine.segment_video(video, num_clips=2, step=1, fuse_method="simple")
    want = archive.segment_video(state, cell.config, video, num_clips=2, step=1)
    assert 0.05 < want.mean() < 0.95                     # both classes
    assert np.mean(got != want) <= 1e-4                  # argmax near-ties of two fp32 paths
    assert port_ef.compute_ef_using_putative_clips(got) == ef.ef_list(got)


def test_the_reference_ef_is_the_ports_on_beating_masks():
    from echoflow_torch.infer import ef as port_ef

    for seed, period in ((1, 30.0), (2, 44.0), (3, 52.0)):
        _, masks, *_ = synthetic.beating_video(160, 64, 64, period=period, seed=seed)
        want = port_ef.compute_ef_using_putative_clips(masks)
        assert len(want) >= 2
        assert ef.ef_list(masks) == want


def _area_curves(ties: bool, n=400):
    """LV-area-like curves from a seed: beats with noise, rounded to even
    counts when `ties`, so that equal heights fall within the distance."""
    rng = np.random.default_rng(17)
    for _ in range(n):
        t = np.arange(int(rng.integers(80, 320)))
        x = 1000 + 30 * np.sin(2 * np.pi * t / rng.uniform(30, 60)) + rng.normal(0, 3, t.size)
        yield np.round(x / 2) * 2 if ties else x


def test_the_ports_peak_finder_ranks_equal_heights_as_the_reference_allows():
    from echoflow_torch.ops.peaks import find_peaks_1d

    differ = 0
    for x in _area_curves(ties=True):
        p05, p95 = np.percentile(x, [5, 95])
        prominence = 0.5 * (p95 - p05)
        got = find_peaks_1d(x, distance=ef.DISTANCE, prominence=prominence)
        assert np.array_equal(got, ef.find_peaks(x, prominence, "last"))
        differ += not np.array_equal(got, ef.find_peaks(x, prominence, "scipy"))
    assert differ > 0          # scipy's own ranking of ties is another
    for x in _area_curves(ties=False, n=100):
        p05, p95 = np.percentile(x, [5, 95])
        prominence = 0.5 * (p95 - p05)
        found = [ef.find_peaks(x, prominence, ties) for ties in ef.TIES]
        assert all(np.array_equal(found[0], f) for f in found[1:])


def test_the_reference_ef_lists_start_with_scipys_and_hold_the_ports():
    from echoflow_torch.infer import ef as port_ef

    _, masks, *_ = synthetic.beating_video(160, 64, 64, period=44.0, seed=2)
    lists = ef.ef_lists(masks)
    assert lists[0] == ef.ef_list(masks)
    assert port_ef.compute_ef_using_putative_clips(masks) in lists
    assert lists[0] + [50.0] not in lists


def test_the_train_reference_follows_the_ports_step_on_the_cpu():
    from echoflow_torch.train.loop import compiled_steps, prefetch_to_device
    from portbench.drivers import train

    cell = _cell("fp32-train", "train")
    batches = train.make_batches(cell)[:1]
    state = train.make_state_of_port(cell, torch.device("cpu"))
    step, _ = compiled_steps(state)
    start = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    state, metrics = step(state, next(prefetch_to_device(iter(batches), "cpu")))
    losses, first, after = train_steps(train.make_state(cell.config, cell.seed, "cpu"),
                                       cell.config, batches)
    assert abs(float(metrics["loss"]) - losses[0]) <= 1e-5 * abs(losses[0])
    opt = state.optimizer
    got = {k: opt.state[p]["exp_avg"] / 0.1 for k, p in state.model.named_parameters()}
    median = float(np.median([float(g.norm()) for g in first.values()]))
    for k, g in first.items():
        assert float((got[k] - g).norm()) <= 1e-4 * max(float(g.norm()), median), k
    # Adam's first update is about lr x the gradient's sign, so an element
    # whose gradient is nought but for rounding moves either way: compare
    # each leaf's change by its norm, as the benchmark does.
    change = {k: float((p.detach() - start[k]).norm()) for k, p in state.model.named_parameters()}
    want = {k: float((after[k] - start[k]).norm()) for k in after}
    median = float(np.median(list(want.values())))
    moving = [k for k in want if float(first[k].norm()) >= train.ZERO_LEAF * float(
        np.median([float(g.norm()) for g in first.values()]))]
    assert set(want) - set(moving) == {"comb_1_layer.bias", "comb_2_layer.bias",
                                       "r2plus1d_model.fc.weight", "r2plus1d_model.fc.bias"}
    for k in moving:
        assert abs(change[k] - want[k]) <= 1e-2 * max(want[k], median), k


def test_flops_match_a_forward_hook_count_on_the_ports_model():
    from echoflow_torch.models.r2plus1d import R2Plus1DMotionSegNet

    cell = _cell("fp32-train", "train")
    cfg = cell.config
    model = R2Plus1DMotionSegNet().eval()
    counted = []

    def hook(mod, inputs, out):
        k = mod.weight.shape
        counted.append(2 * k[0] * k[1] * k[2] * k[3] * k[4] * out[0, 0].numel())

    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv3d):
            mod.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 3, cfg["clip_length"], cfg["height"], cfg["width"]))
    convs, _ = flops.conv_flops(cfg)
    full = cfg["clip_length"] * cfg["height"] * cfg["width"]
    heads = 2 * 64 * (64 + 2 + 4) * full       # comb2, the seg and the motion head
    assert sum(counted) == sum(f for _, f in convs) + heads


def test_flops_at_the_published_size():
    bench, work, cfg, traffic, limits = load_cell("fp32-train")
    convs, taps = flops.conv_flops(cfg)
    full = 32 * 112 * 112
    assert sum(f for _, f in convs) + 2 * 64 * 70 * full == pytest.approx(165.68e9, rel=1e-3)
    assert taps == [(32, 56, 56), (32, 56, 56), (16, 28, 28), (8, 14, 14), (4, 7, 7)]
    assert 4 * flops.clip_flops(cfg, train=True) == pytest.approx(2.006e12, rel=1e-3)


def test_the_frozen_bounds_give_the_records_numbers():
    sources = [(56, 56), (28, 28), (14, 14), (7, 7)]
    assert peaks.k1_bound_s(30, 32, sources) * 1e3 == pytest.approx(0.598, abs=5e-4)
    pixels = 8 * 112 * 112
    assert peaks.warp_bound_s("K2", pixels, 4, 3) * 1e6 == pytest.approx(1.92, abs=5e-3)
    assert peaks.warp_bound_s("K3", pixels, 4) * 1e6 == pytest.approx(1.20, abs=5e-3)
    assert peaks.warp_bound_s("K4", pixels, 4) * 1e6 == pytest.approx(1.44, abs=5e-3)


def test_the_frozen_generators_are_the_ports():
    from echoflow_torch.data.synthetic import make_beating_video, make_training_sample

    video, masks, ed, es = synthetic.beating_video(70, 40, 48, period=33.0, amplitude=6.0,
                                                   seed=9)
    port = make_beating_video(70, 40, 48, period=33.0, amplitude=6.0, seed=9)
    assert np.array_equal(video, port.video) and np.array_equal(masks, port.masks)
    assert np.array_equal(ed, port.ed_frames) and np.array_equal(es, port.es_frames)
    ours, theirs = synthetic.training_sample(8, 32, 32, seed=4), make_training_sample(8, 32, 32, 4)
    for key in theirs:
        assert np.array_equal(ours[key], theirs[key]), key


def test_the_weights_follow_the_ports_init_rule():
    from echoflow_torch.models.r2plus1d import R2Plus1DMotionSegNet
    from portbench.weights import make_state

    bench, work, cfg, traffic, limits = load_cell("fp32-train")
    state = make_state(cfg, 2**31 + 3, "cpu")
    model = R2Plus1DMotionSegNet()
    model.load_state_dict(state)                       # every key and shape
    w = state["r2plus1d_model.layer3.0.conv1.0.3.weight"]
    assert float(w.std()) == pytest.approx((2.0 / (256 * 3)) ** 0.5, rel=0.02)
    assert float(state["comb_1_layer.weight"].abs().max()) <= 1024 ** -0.5
    assert float(state["motion_head.weight"].std()) == pytest.approx(1e-5 ** 0.5, rel=0.2)
    assert torch.equal(make_state(cfg, 2**31 + 3, "cpu")["comb_1_layer.weight"],
                       state["comb_1_layer.weight"])
