"""CLAS-FV joint training on an NVIDIA GPU (the port of `train_clasfv.py`).

Same recipe and flags as `train_clasfv.py`: random ED..ES 32-frame
windows, Adam lr 1e-4 with the drop to 1e-5 at epoch 3, batch 4, 10
epochs, best-validation checkpoint plus the latest one at `<out>.last`.
The warps of the loss run the port's CUDA kernels on the card.

    python train_clasfv_torch.py --data /path/to/EchoNet-Dynamic \
        [--folds fold_indexes] [--epoch-subsample 3500] [--device cuda|cpu]
    python train_clasfv_torch.py --synthetic --steps 50 [--device cuda|cpu]
    python train_clasfv_torch.py --synthetic --resume save_models/clasfv_torch.pth
    torchrun --nproc_per_node 8 train_clasfv_torch.py --data ... --batch-size 8

Under `torchrun` the run is data-parallel (`train/loop.fit_on_mesh`): rank
r trains on `cuda:LOCAL_RANK`, `--batch-size` stays the global batch (each
rank reads its contiguous shard of every batch, as on echoflow's mesh), and
rank 0 alone prints and writes checkpoints. A plain run is one process.

EchoNet-Dynamic samples are read from the dataset on the host, one at a
time, as `train_clasfv.py` reads them (`echoflow_torch/data/echonet.py`:
AVI decoding with cv2, the CSVs with pandas). fp32 is the default and
turns TF32 off for cuDNN and matmul; `--compute-dtype bf16` runs the model
in bf16 with fp32 parameters, Adam state and running statistics
(`TrainConfig.compute_dtype`).
"""

from __future__ import annotations

import argparse
import os
import time

_SAMPLE_CACHE: dict = {}


def parse_args(argv=None):
    from echoflow_torch.models.r2plus1d import backbones

    ap = argparse.ArgumentParser(description="Train CLAS-FV with echoflow_torch")
    ap.add_argument("--data", type=str, default=None, help="EchoNet-Dynamic root")
    ap.add_argument("--folds", type=str, default=None,
                    help="dir with stanford_{train,valid}_sampled_indices pickles "
                         "(EchoNet only; the repo's fold_indexes/)")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic beating-heart samples")
    ap.add_argument("--recipe", choices=["clasfv", "ed_es_only"], default="clasfv",
                    help="clasfv: joint ED..ES-window recipe; ed_es_only: two clips "
                         "per sample, one covering ED and one ES")
    ap.add_argument("--epoch-subsample", type=int, default=None,
                    help="randomly subsample this many videos per epoch (EchoNet only)")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=None, help="cap steps per epoch")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lr-drop-epoch", type=int, default=3)
    ap.add_argument("--lr-after-drop", type=float, default=1e-5)
    ap.add_argument("--clip-length", type=int, default=32)
    ap.add_argument("--compute-dtype", choices=["fp32", "bf16"], default="fp32",
                    help="model compute dtype (parameters and optimizer state stay "
                         "fp32). fp32 is the reference-parity default; bf16 is an "
                         "opt-in that changes the optimization trajectory (echoflow's "
                         "end-metric study, benchmarks/bf16_train_study.json: ES Dice "
                         "0.0056 below fp32)")
    ap.add_argument("--image-size", type=int, default=112)
    ap.add_argument("--backbone", choices=list(backbones()), default="r2plus1d_18",
                    help="the network's backbone: CLAS-FV's R(2+1)D-18 (default) or "
                         "ir-CSN-152 (Tran et al. 2019) under the same decoder and heads")
    ap.add_argument("--out", type=str, default="save_models/clasfv_torch.pth")
    ap.add_argument("--init-from", type=str, default=None,
                    help="stock torchvision r2plus1d_18 Kinetics-400 .pth: initialize "
                         "the backbone from it, heads stay fresh")
    ap.add_argument("--resume", type=str, default=None,
                    help="checkpoint to resume from: the port's .pth or an echoflow "
                         ".pkl (model, optimizer, step, generator, epoch counter)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-samples", type=int, default=0,
                    help="synthetic mode: pre-generate this many samples once and "
                         "draw batches from the pool")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def should_save_best(val: float, best_val: float) -> bool:
    """Only a finite validation loss strictly below the best so far wins."""
    import math

    return math.isfinite(val) and val < best_val


def _collate(samples):
    import numpy as np

    return {
        "video": np.stack([s["video"] for s in samples]).astype(np.float32),
        "ed_label": np.stack([s["ed_label"] for s in samples]).astype(np.int32),
        "es_label": np.stack([s["es_label"] for s in samples]).astype(np.int32),
        "ed_idx": np.asarray([s["ed_idx"] for s in samples], np.int32),
        "es_idx": np.asarray([s["es_idx"] for s in samples], np.int32),
    }


def synthetic_batches(batch_size, clip_length, image_size, steps, seed,
                      cache_samples: int = 0, pool_seed_base: int = 0):
    """Batches of `make_training_sample` (the seeds of `train_clasfv.py`).
    With cache_samples > 0 a fixed pool is generated once and batches draw
    from it; `pool_seed_base` keeps validation samples disjoint."""
    import numpy as np

    from echoflow_torch.data.synthetic import make_training_sample

    if cache_samples:
        key = (clip_length, image_size, cache_samples, pool_seed_base)
        if key not in _SAMPLE_CACHE:
            _SAMPLE_CACHE[key] = [make_training_sample(clip_length, image_size, image_size,
                                                       seed=pool_seed_base + i)
                                  for i in range(cache_samples)]
        pool = _SAMPLE_CACHE[key]
        rng = np.random.RandomState(seed)
        for _ in range(steps):
            yield _collate([pool[i] for i in rng.choice(len(pool), batch_size, replace=False)])
        return
    for step in range(steps):
        yield _collate([make_training_sample(clip_length, image_size, image_size,
                                             seed=pool_seed_base + seed + step * batch_size + i)
                        for i in range(batch_size)])


def synthetic_ed_es_batches(batch_size, clip_length, image_size, steps, seed,
                            pool_seed_base: int = 0):
    """Batches of `make_ed_es_only_sample` for the ed-or-es-only recipe."""
    import numpy as np

    from echoflow_torch.data.synthetic import make_ed_es_only_sample

    for step in range(steps):
        samples = [make_ed_es_only_sample(clip_length, image_size, image_size,
                                          seed=pool_seed_base + seed + step * batch_size + i)
                   for i in range(batch_size)]
        yield {
            "ed_video": np.stack([s["ed_video"] for s in samples]).astype(np.float32),
            "es_video": np.stack([s["es_video"] for s in samples]).astype(np.float32),
            "ed_label": np.stack([s["ed_label"] for s in samples]).astype(np.int32),
            "es_label": np.stack([s["es_label"] for s in samples]).astype(np.int32),
            "ed_idx": np.asarray([s["ed_idx"] for s in samples], np.int32),
            "es_idx": np.asarray([s["es_idx"] for s in samples], np.int32),
        }


def echonet_ed_es_batches(dataset, batch_size, steps=None):
    """Batches of `EchoNetEDESOnlyDataset` (two clips per sample)."""
    import numpy as np

    buf = []
    count = 0
    for i in range(len(dataset)):
        try:
            d = dataset[i]
        except Exception as exc:   # an unreadable video is skipped, as echoflow does
            print(f"skipping sample {i}: {exc}")
            continue
        buf.append(d)
        if len(buf) == batch_size:
            yield {
                "ed_video": np.stack([b["ed_video_clip"] for b in buf]).astype(np.float32),
                "es_video": np.stack([b["es_video_clip"] for b in buf]).astype(np.float32),
                "ed_label": np.stack([b["ed_label"] for b in buf]).astype(np.int32),
                "es_label": np.stack([b["es_label"] for b in buf]).astype(np.int32),
                "ed_idx": np.asarray([b["ed_clip_index"] for b in buf], np.int32),
                "es_idx": np.asarray([b["es_clip_index"] for b in buf], np.int32),
            }
            buf = []
            count += 1
            if steps is not None and count >= steps:
                return


def echonet_batches(dataset, batch_size, steps=None):
    """Batches of `EchoNetDynamicDataset`, skipping the samples it cannot
    give (an unreadable video, ED after ES), as echoflow's trainer does."""
    import numpy as np

    buf = []
    count = 0
    for i in range(len(dataset)):
        try:
            video, (_, _, es_ci, ed_ci, *_rest, es_lab, ed_lab) = dataset[i]
        except Exception as exc:   # skipped and reported, as echoflow does
            print(f"skipping sample {i}: {exc}")
            continue
        buf.append((video, ed_lab, es_lab, ed_ci, es_ci))
        if len(buf) == batch_size:
            yield _collate([{"video": b[0], "ed_label": b[1], "es_label": b[2],
                             "ed_idx": b[3], "es_idx": b[4]} for b in buf])
            buf = []
            count += 1
            if steps is not None and count >= steps:
                return


def echonet_epoch_batches(args, epoch, split):
    """The epoch's batches of EchoNet-Dynamic `split` as `train_clasfv.py`
    draws them: the pinned fold's indices with `--folds`, and with
    `--epoch-subsample` a fresh subsample of the training split every
    epoch (the ed-or-es-only notebook's 3500 videos), from
    `RandomState(seed + epoch)`."""
    import os

    import numpy as np

    from echoflow_torch.data.echonet import (EchoNetDynamicDataset, EchoNetEDESOnlyDataset,
                                             EchoNetIndex, load_fold_indices)

    subset = None
    if args.folds:
        name = ("stanford_train_sampled_indices" if split == "train"
                else "stanford_valid_sampled_indices")
        subset = load_fold_indices(os.path.join(args.folds, name))
    if split == "train" and args.epoch_subsample:
        rng = np.random.RandomState(args.seed + epoch)
        # The split's size from the index alone: a dataset would run
        # get_mean_and_std over its videos first.
        pool = subset if subset is not None else list(range(len(EchoNetIndex(args.data)
                                                                 .split(split))))
        k = min(args.epoch_subsample, len(pool))
        subset = [pool[j] for j in rng.choice(len(pool), k, replace=False)]
    ed_es_only = args.recipe == "ed_es_only"
    cls = EchoNetEDESOnlyDataset if ed_es_only else EchoNetDynamicDataset
    # image_size is the size a clip is shrunk to when its window is short;
    # echoflow's trainer leaves the dataset's default (112, 112).
    ds = cls(args.data, split=split, clip_length=args.clip_length,
             image_size=(args.image_size, args.image_size), subset_indices=subset,
             seed=args.seed + epoch)
    batcher = echonet_ed_es_batches if ed_es_only else echonet_batches
    return batcher(ds, args.batch_size, args.steps)


def main(argv=None):
    args = parse_args(argv)
    if not args.synthetic and args.data is None:
        raise SystemExit("pass --data <EchoNet root> or --synthetic")

    import numpy as np
    import torch
    import torch.distributed as dist

    from echoflow_torch.parallel import init_distributed
    from echoflow_torch.train.checkpoint import restore_train_state, save_checkpoint
    from echoflow_torch.train.loop import (
        TrainConfig, _sharded, compiled_steps, create_train_state, data_parallel, fit,
        fit_on_mesh, make_ed_es_only_eval_step, make_ed_es_only_train_step, make_eval_step,
        make_train_step, prefetch_to_device)

    # Under torchrun, one rank a card; a plain run stays one process.
    owned = not dist.is_initialized()
    distributed = init_distributed()
    rank, world = (dist.get_rank(), dist.get_world_size()) if distributed else (0, 1)
    if distributed and args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} is the global batch: it must "
                         f"divide by the {world} ranks")
    device = torch.device(args.device)
    if distributed and device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    say = print if rank == 0 else (lambda *a, **k: None)

    steps_per_epoch = args.steps or (7332 // args.batch_size)
    cfg = TrainConfig(lr=args.lr, lr_drop_step=args.lr_drop_epoch * steps_per_epoch,
                      lr_after_drop=args.lr_after_drop, clip_length=args.clip_length,
                      image_size=(args.image_size, args.image_size),
                      batch_size=args.batch_size,
                      compute_dtype={"fp32": torch.float32,
                                     "bf16": torch.bfloat16}[args.compute_dtype],
                      backbone=args.backbone)
    state = create_train_state(args.seed, cfg, device=device)
    start_epoch, best_val = 0, float("inf")
    if args.init_from:
        if args.resume:
            raise SystemExit("--init-from and --resume are mutually exclusive "
                             "(resume already carries weights)")
        from echoflow_torch.models.convert import load_kinetics_backbone
        from echoflow_torch.models.r2plus1d import backbones

        if not backbones()[args.backbone].kinetics_init:
            raise SystemExit("--init-from takes a torchvision r2plus1d_18 checkpoint")

        state.model.load_state_dict(load_kinetics_backbone(args.init_from,
                                                           state.model.state_dict()))
        say(f"initialized backbone from Kinetics checkpoint {args.init_from}")
    if args.resume:
        state, extra = restore_train_state(args.resume, state)
        start_epoch = int(extra.get("epoch", -1)) + 1
        # The best-val watermark too, so a worse epoch after the resume
        # cannot overwrite a better best checkpoint.
        best_val = float(extra.get("val_loss", float("inf")))
        say(f"resumed from {args.resume} at step {state.step}, starting epoch {start_epoch}")

    ed_es_only = args.recipe == "ed_es_only"
    step_factory, eval_factory = ((make_ed_es_only_train_step, make_ed_es_only_eval_step)
                                  if ed_es_only else (make_train_step, make_eval_step))
    if distributed:
        state = data_parallel(state)
    # Once a run, so that an epoch does not capture them again: on the card
    # CUDA graphs of the steps (echoflow's jit), in one process or under
    # data parallelism; on the CPU the eager steps.
    train_step, eval_step = compiled_steps(state, step_factory, eval_factory)

    def epoch_batches(epoch, split):
        if not args.synthetic:
            return echonet_epoch_batches(args, epoch, split)
        n = args.steps or 20
        # Validation draws from a disjoint seed range: a held-out population.
        val = split != "train"
        steps = max(2, n // 8) if val else n
        seed = args.seed + epoch * 100_000 + (7_777 if val else 0)
        base = 50_000_000 if val else 0
        if ed_es_only:
            return synthetic_ed_es_batches(args.batch_size, args.clip_length, args.image_size,
                                           steps, seed=seed, pool_seed_base=base)
        cache = (max(8, args.cache_samples // 8) if val else args.cache_samples) \
            if args.cache_samples else 0
        return synthetic_batches(args.batch_size, args.clip_length, args.image_size, steps,
                                 seed=seed, cache_samples=cache, pool_seed_base=base)

    for epoch in range(start_epoch, args.epochs):
        tic = time.time()
        if distributed:
            state, _ = fit_on_mesh(state, epoch_batches(epoch, "train"),
                                   log_every=args.log_every, steps=(train_step, eval_step))
            val_batches = _sharded(epoch_batches(epoch, "val"), rank, world)
        else:
            state, _ = fit(state, epoch_batches(epoch, "train"), log_every=args.log_every,
                           steps=(train_step, eval_step))
            val_batches = epoch_batches(epoch, "val")
        val_losses, ed_d, es_d = [], [], []
        for batch in prefetch_to_device(val_batches, device):
            m = eval_step(state, batch)
            val_losses.append(float(m["loss"]))
            ed_d.append(float(m["ed_dice"]))
            es_d.append(float(m["es_dice"]))
        val = float(np.mean(val_losses)) if val_losses else float("nan")
        say(f"epoch {epoch}: val loss {val:.4f} ED dice {np.mean(ed_d or [0]):.3f} "
            f"ES dice {np.mean(es_d or [0]):.3f} ({time.time() - tic:.0f}s)")
        extra = {"epoch": epoch, "val_loss": val, "seed": args.seed}
        # The validation metrics are the global batch's, so every rank takes
        # the same branch; rank 0 writes.
        # A NaN validation is a diverged run, never a better one.
        if should_save_best(val, best_val):
            best_val = val
            if rank == 0:
                save_checkpoint(args.out, state, extra=extra)
            say(f"saved checkpoint -> {args.out}")
        # The latest state always, so a run whose validation never wins
        # keeps its weights.
        if rank == 0:
            save_checkpoint(args.out + ".last", state, extra=extra)
    if distributed and owned:
        dist.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
