"""Stream traffic: a seeded pool of synthetic echo videos segmented one
after another by the port's engine, `VideoSegmenter.segment_videos`, with
the EF of each mask computed on worker threads (a closed loop: the stream
hands the engine its next video when the engine asks for it).

Traffic parameters (portbench/traffic/<mix>.json): the pool's `lengths`
and `videos_per_length`, frame `height` and `width`, the beat's `period`,
`amplitude` and `base_radius` ranges, `num_clips`, `step` and `fuse` of
each video, the engine's `queue_depth`, `ef_workers`, how many pool videos the check compares
(`check_videos`, the longest among them) and how many videos a traced run
segments (`trace_videos`).

End-to-end: frames_per_s (frames of the videos whose mask and EF list came
back, over the window: from its start to the last EF), video_p95_ms (from
a video's hand-off to the stream to its EF list), peak_reserved_gib,
setup_s. Checked: each compared video's mask against the reference's
(`mask_diff_share`, the share of their pixels that differ), and its EF
list against the reference's EF of the same mask (`ef_mismatch`, the
videos whose list is none of those the method gives with equal LV areas
ranked either way: `reference.ef.ef_lists`).
"""

from __future__ import annotations

import gc
import math
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from portbench import flops, peaks
from portbench.harness import Outcome, print_setup
from portbench.reference import archive as ref_archive
from portbench.reference import ef as ref_ef
from portbench.reference.model import Precision, features
from portbench.synthetic import beating_video, normalize
from portbench.trace import traced
from portbench.weights import make_state

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_pool(traffic, seed):
    """[(length, (3, L, H, W) uint8 video)], grey in RGB as the AVIs are."""
    rng = np.random.default_rng([1, seed % 2**63])
    pool = []
    for length in traffic["lengths"]:
        for _ in range(traffic["videos_per_length"]):
            video, *_ = beating_video(
                length, traffic["height"], traffic["width"],
                period=rng.uniform(*traffic["period"]),
                base_radius=rng.uniform(*traffic["base_radius"]),
                amplitude=rng.uniform(*traffic["amplitude"]),
                seed=int(rng.integers(2**31)))
            pool.append((length, video.astype(np.uint8)))
    return pool, rng


def check_indices(pool, rng, n):
    """The pool videos the check compares: the first of the longest, and
    n - 1 others drawn from the seed."""
    longest = max(range(len(pool)), key=lambda i: pool[i][0])
    others = [i for i in range(len(pool)) if i != longest]
    return [longest] + sorted(rng.choice(others, size=min(n, len(pool)) - 1,
                                         replace=False).tolist())


def plan_of(length, traffic, forward_chunk):
    """The clips of one video: those that exist (`valid_clips`) and those
    forwarded in balanced chunks of at most `forward_chunk` (`chunks`)."""
    valid = sum(lki // ref_archive.CLIP
                for _, _, lki in ref_archive.shift_plan(length, traffic["num_clips"],
                                                        traffic["step"]))
    n_chunks = -(-valid // forward_chunk)
    return {"length": length, "valid_clips": valid,
            "chunks": [-(-valid // n_chunks)] * n_chunks}


def prepare_weights(cell, rng, device):
    """The state dict of the seed, with the seg head a ridge read-out of the
    decoder's features (the reference's, on `probe_clips` clips of videos
    drawn from the seed as the pool's are) that puts the logit margin at +1
    inside the probes' LV and -1 outside: masks that follow the ventricle,
    so the EF layer finds beats. Returns it and the head's leaves, which
    the reference takes again."""
    state = make_state(cell.config, cell.seed, device)
    t = cell.traffic
    feats, target = [], []
    prec = Precision("fp32")
    for _ in range(t["probe_clips"]):
        video, masks, *_ = beating_video(
            ref_archive.CLIP, t["height"], t["width"], period=rng.uniform(*t["period"]),
            base_radius=rng.uniform(*t["base_radius"]), amplitude=rng.uniform(*t["amplitude"]),
            seed=int(rng.integers(2**31)))
        with torch.no_grad(), prec.flags():
            y = features(state, torch.from_numpy(normalize(video))[None].to(device), cell.config)
        feats.append(y[0].reshape(y.shape[1], -1).T.double())
        target.append(torch.from_numpy(masks.reshape(-1) * 2.0 - 1.0).to(device))
    y, target = torch.cat(feats), torch.cat(target)
    del feats
    # Standardized features (dead ReLU channels held at zero) and a ridge
    # term: the raw least squares is singular and fits the probes alone.
    mean, std = y.mean(dim=0), y.std(dim=0)
    std = std.clamp(min=1e-3 * float(std.max()))
    z = torch.cat([(y - mean) / std, torch.ones_like(y[:, :1])], dim=1)
    ridge = t["ridge"] * len(z) * torch.eye(z.shape[1], dtype=z.dtype, device=device)
    ridge[-1, -1] = 0.0
    sol = torch.linalg.solve(z.T @ z + ridge, z.T @ target)
    del y, z
    w = sol[:-1] / std
    b = sol[-1] - (w * mean).sum()
    key_w, key_b = "segmentation_head.weight", "segmentation_head.bias"
    state[key_w] = (torch.stack([-w, w]) / 2).float().reshape(2, -1, 1, 1, 1)
    state[key_b] = (torch.stack([-b, b]) / 2).float()
    return state, {k: state[k].detach().clone() for k in (key_w, key_b)}


def _valid(mask, length, cell, efs):
    t = cell.traffic
    return (isinstance(mask, np.ndarray) and mask.shape == (length, t["height"], t["width"])
            and mask.dtype == np.uint8 and int(mask.max(initial=0)) <= 1
            and isinstance(efs, list) and all(math.isfinite(e) for e in efs))


class Stream:
    """The window's loop over the engine, and its records."""

    def __init__(self, cell, engine, pool, order, keep):
        self.cell, self.engine, self.pool, self.order, self.keep = cell, engine, pool, order, keep
        self.records, self.errors = [], []

    def _feed(self, deadline, count):
        n = 0
        while (deadline is None or time.perf_counter() < deadline) and \
                (count is None or n < count):
            idx = next(self.order)
            rec = {"index": idx, "length": self.pool[idx][0], "ok": False}
            self.records.append(rec)
            n += 1
            rec["handoff"] = time.perf_counter()
            yield self.pool[idx][1]

    def _ef(self, rec, mask):
        from echoflow_torch.infer import ef as port_ef

        with record_function("portbench.ef"):
            t = time.perf_counter()
            efs = port_ef.compute_ef_using_putative_clips(mask)
            rec["ef_s"] = time.perf_counter() - t
        rec["efs"] = [float(e) for e in efs]
        rec["ok"] = _valid(mask, rec["length"], self.cell, rec["efs"])
        rec["done"] = time.perf_counter()

    def run(self, deadline=None, count=None):
        """Segment videos until the deadline (or `count` videos); returns
        when every EF of them is done."""
        t = self.cell.traffic
        start = len(self.records)
        futures = []
        with ThreadPoolExecutor(max_workers=t["ef_workers"]) as ef_pool:
            try:
                masks = self.engine.segment_videos(
                    self._feed(deadline, count), num_clips=t["num_clips"], step=t["step"],
                    fuse_method=t["fuse"], queue_depth=t["queue_depth"])
                for j in range(start, sys.maxsize):
                    with record_function("portbench.wait"):
                        mask = next(masks, None)
                    if mask is None:
                        break
                    rec = self.records[j]
                    if rec["index"] in self.keep:
                        rec["mask"] = mask
                    futures.append(ef_pool.submit(self._ef, rec, mask))
            except Exception:   # the run goes on to report what failed
                self.errors.append(traceback.format_exc())
            for f in futures:
                try:
                    f.result()
                except Exception:
                    self.errors.append(traceback.format_exc())


def run(cell):
    device = torch.device(cell.device)
    t = cell.traffic
    marks = [("imports", time.perf_counter())]
    pool, rng = make_pool(t, cell.seed)
    keep = check_indices(pool, rng, t["check_videos"])
    marks.append(("videos", time.perf_counter()))
    if cell.control:
        return control(cell, pool, keep, rng, device)
    from echoflow_torch.infer.pipeline import VideoSegmenter
    from echoflow_torch.infer import ef as port_ef

    state, seg_head = prepare_weights(cell, rng, device)
    marks.append(("weights and the CUDA context", time.perf_counter()))
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    engine = VideoSegmenter(state, device=cell.device,
                            dtype=DTYPES[cell.config["precision"]["inference"]])
    del state
    marks.append(("engine", time.perf_counter()))
    # Warm-up: every length of the pool twice (the first runs the eager
    # body, the second captures its graph), and the EF once.
    for length in sorted({length for length, _ in pool}):
        videos = [v for n, v in pool if n == length][:2]
        for v in videos:
            mask = engine.segment_video(v, num_clips=t["num_clips"], step=t["step"],
                                        fuse_method=t["fuse"])
    port_ef.compute_ef_using_putative_clips(mask)
    if device.type == "cuda":
        torch.cuda.synchronize()

    def order():
        while True:
            yield from rng.permutation(len(pool)).tolist()

    stream = Stream(cell, engine, pool, order(), set(keep))
    marks.append(("warm-up and captures", time.perf_counter()))
    setup_s = time.perf_counter() - cell.t0
    print_setup(cell.t0, marks)
    trace, sessions = None, []

    def session():   # a traced session; a session the profiler lost is run again
        sessions.append(len(stream.records))
        stream.run(count=t["trace_videos"])

    t0 = time.perf_counter()
    if cell.trace:
        trace, _ = traced(session)
    else:
        stream.run(deadline=t0 + cell.seconds)
    done = [r for r in stream.records if r["ok"]]
    window_records = [r for r in stream.records[sessions[-1] if sessions else 0:] if r["ok"]]
    t_end = max([r["done"] for r in done], default=time.perf_counter())
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    for err in stream.errors:
        print(err, file=sys.stderr)
    forward_chunk = engine.forward_chunk
    del engine, stream.engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    window = t_end - t0
    latencies = [(r["done"] - r["handoff"]) * 1e3 for r in done]
    metrics = {"setup_s": setup_s, "peak_reserved_gib": peak / 2**30}
    if done:
        metrics["frames_per_s"] = sum(r["length"] for r in done) / window
        metrics["video_p95_ms"] = float(np.percentile(latencies, 95))
    checks = compare(cell, stream.records, keep, pool, seg_head, device)
    cfg = cell.config
    context = {
        "trace": trace, "config": cfg, "traffic": t,
        "videos": [plan_of(r["length"], t, forward_chunk) for r in window_records],
        "ef_s": [r["ef_s"] for r in window_records],
        "clip_flops": flops.clip_flops(cfg),
        "peak_flops": peaks.MODEL_PEAK[cfg["precision"]["inference"]],
        "window_s": trace.wall_s if trace is not None else window,
    }
    return Outcome(len(stream.records), len(stream.records) - len(done), metrics, checks,
                   peak, context, trace)


def reference_state(cell, device, seg_head):
    state = make_state(cell.config, cell.seed, device)
    state.update(seg_head)
    return state


def compare(cell, records, keep, pool, seg_head, device):
    """Every kept video's mask against the reference's mask of its pool
    video, and its EF list against the reference's EF lists of that mask."""
    t = cell.traffic
    params = reference_state(cell, device, seg_head)
    fp32 = Precision("fp32")
    differ = pixels = worst = 0.0
    mismatch, beats = 0, 0
    for idx in keep:
        got = [r for r in records if r["index"] == idx and "mask" in r]
        if not got:
            continue
        with fp32.flags():
            want = ref_archive.segment_video(params, cell.config, pool[idx][1],
                                             num_clips=t["num_clips"], step=t["step"],
                                             precision=fp32)
        for r in got:
            wrong = (np.count_nonzero(r["mask"] != want) if r["mask"].shape == want.shape
                     else want.size)
            differ, pixels = differ + wrong, pixels + want.size
            worst = max(worst, wrong / want.size)
            want_efs = ref_ef.ef_lists(r["mask"])
            beats += len(want_efs[0])
            if r.get("efs") not in want_efs:
                mismatch += 1
                print(f"EF lists differ on pool video {idx}: the program's {r.get('efs')}, "
                      f"the reference's {want_efs}; LV area by frame "
                      f"{r['mask'].sum(axis=(1, 2)).tolist()}", file=sys.stderr)
    print(f"compared: {sum(1 for r in records if 'mask' in r)} videos of {len(keep)} pool "
          f"videos, {beats} beats, the worst video's share of differing pixels {worst!r}",
          file=sys.stderr)
    return {"mask_diff_share": differ / max(pixels, 1.0), "ef_mismatch": float(mismatch)}


def control(cell, pool, keep, rng, device):
    """The reference in the configuration's lower precision in the
    program's place, over the kept videos: its masks and its EF lists go
    through the check."""
    t = cell.traffic
    state, seg_head = prepare_weights(cell, rng, device)
    low = Precision(cell.config["precision"]["control"])
    records = []
    for idx in keep:
        with low.flags():
            mask = ref_archive.segment_video(state, cell.config, pool[idx][1],
                                             num_clips=t["num_clips"], step=t["step"],
                                             precision=low)
        records.append({"index": idx, "length": pool[idx][0], "mask": mask,
                        "efs": ref_ef.ef_list(mask), "ok": True})
    del state
    checks = compare(cell, records, keep, pool, seg_head, device)
    return Outcome(len(records), 0, {}, checks)
