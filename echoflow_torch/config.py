"""Typed configuration tree (a copy of `echoflow.config`).

The reference scatters its configuration across three uncoordinated
mechanisms — argparse flags, an INI file for the external echonet package,
and a nested CAMUS dict — with the load-bearing numerics hard-coded in
notebooks (SURVEY.md §5). Here every such constant is a named, documented
field with the reference's value as the default. `from_flags` applies
`key=value` CLI overrides ("a.b.c=v" dotted paths).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    clip_length: int = 32            # frames per network input clip
    image_size: tuple = (112, 112)   # EchoNet-Dynamic native resolution
    seg_classes: int = 2             # background / LV
    motion_channels: int = 4         # forward x,y + backward x,y
    dtype: str = "float32"           # "bfloat16" for the fast path


@dataclass
class TrainRecipe:
    """The training-notebook recipe (BASELINE.md)."""

    batch_size: int = 4
    epochs: int = 10
    lr: float = 1e-4
    lr_drop_epoch: int = 3           # manual optimizer re-creation in the ref
    lr_after_drop: float = 1e-5
    smooth_weight: float = 0.005     # huber smoothness weight in OTA
    seed: int = 0


@dataclass
class InferenceConfig:
    num_clips: int = 1               # shifted copies to fuse (CLI -f)
    step: int = 1                    # shift stride (CLI -s)
    fuse_method: str = "simple"      # simple | staple | majority | softmax
    class_list: tuple = (0, 1)
    interpolate_last: bool = True    # trilinear ragged-tail stretch
    forward_chunk: int = 8           # clips per forward chunk
    bucket: int = 64                 # video-length compile bucket


@dataclass
class EFConfig:
    """Peak-picking constants (reference fuse_utils.py:105-120) — every one
    is load-bearing for EF parity."""

    peak_distance: int = 20
    prominence_scale: float = 0.50   # x (p95 - p05) of the LV-area curve
    trim_percentiles: tuple = (5, 85, 95)
    diastole_floor_percentile: float = 85.0
    first_frames_mean_window: int = 3
    npucks: int = 10                 # Simpson disks


@dataclass
class DataConfig:
    root: str = ""                   # EchoNet-Dynamic directory
    period: int = 1
    folds_dir: str = ""              # pinned fold pickles
    num_workers: int = 4


@dataclass
class EchoflowConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainRecipe = field(default_factory=TrainRecipe)
    infer: InferenceConfig = field(default_factory=InferenceConfig)
    ef: EFConfig = field(default_factory=EFConfig)
    data: DataConfig = field(default_factory=DataConfig)

    @classmethod
    def from_flags(cls, overrides: list[str]) -> "EchoflowConfig":
        """Build from defaults + "a.b=v" overrides (ints/floats/bools/strs
        coerced from the field's current type)."""
        cfg = cls()
        for item in overrides:
            path, _, raw = item.partition("=")
            keys = path.strip().split(".")
            obj = cfg
            for key in keys[:-1]:
                obj = getattr(obj, key)
            current = getattr(obj, keys[-1])
            if isinstance(current, bool):
                value = raw.strip().lower() in ("1", "true", "yes")
            elif isinstance(current, int):
                value = int(raw)
            elif isinstance(current, float):
                value = float(raw)
            elif isinstance(current, tuple):
                value = tuple(type(current[0])(x) for x in raw.split(","))
            else:
                value = raw
            setattr(obj, keys[-1], value)
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
