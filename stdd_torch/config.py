"""Configuration dataclasses.

Own copies of ``stdd_tpu.config``'s tree (same fields, same defaults), so a
configuration moves between the two packages field for field:
``I3DConfig``, ``DualEncoderConfig``, ``DetectorConfig``,
``PipelineConfig``, ``TrainConfig`` :109, ``MeshConfig`` :126 and ``Config``
:137, with dotted overrides (``apply_overrides`` :175) and YAML loading
(``load_yaml`` :201; PyYAML is imported only there). The port's I3D
computes the plain convolutions whatever ``s2d_stem``/``stem_t2`` say (both
are exact TPU re-layouts of the same math); ``fused_s2`` runs s2 through K2
(``ops/bottleneck.py``); ``temporal_only`` with ``stop_point`` builds the
FTCN trunk inside the I3D (1×1×1 middle convolutions, the stages before
``s{stop_point}``) and configures ``models/ftcn.py::FTCN``; ``int8_stages``
is not ported yet (ROADMAP §1 item 9) and is refused by
:class:`stdd_torch.models.i3d.I3D`.
``MeshConfig`` is kept field for field; nothing in the port reads it yet
(multi-card training is ROADMAP §1 item 5).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class I3DConfig:
    """I3D-ResNet50 backbone (reference: slowfast/models/video_model_builder.py:391)."""

    depth: int = 50
    width_per_group: int = 64
    num_groups: int = 1
    num_classes: int = 1
    num_frames: int = 32
    crop_size: int = 224
    input_channels: int = 3
    dropout_rate: float = 0.5
    # temporal kernel basis per stage for arch "i3d"
    temp_kernel: Tuple[Tuple[int, ...], ...] = ((5,), (3,), (3, 1), (3, 1), (1, 3))
    num_block_temp_kernel: Tuple[int, ...] = (3, 4, 6, 3)
    spatial_strides: Tuple[int, ...] = (1, 2, 2, 2)
    t_pool_after_s2: int = 2
    zero_init_final_bn: bool = True
    fc_init_std: float = 0.01
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1
    temporal_only: bool = False
    s2d_stem: bool = False
    stem_t2: bool = False
    fused_s2: bool = False
    int8_stages: Tuple[str, ...] = ()
    stop_point: int = 5


@dataclass(frozen=True)
class DualEncoderConfig:
    """Dual-branch AU+LMK transformer (reference: dualrun/model/dual_encoder.py:110)."""

    au_dim: int = 36
    lmk_dim: int = 132
    d_model: int = 256
    n_heads: int = 4
    depth: int = 4
    ff_mult: int = 4
    dropout: float = 0.1
    max_len: int = 512
    use_domain_head: bool = False
    n_domains: int = 5
    use_aux_heads: bool = False
    conv_dilations: Tuple[int, ...] = (1, 2, 4)


@dataclass(frozen=True)
class DetectorConfig:
    """YuNet face detector (reference: preprocessing/yunet/yunet.py:47):
    the settings :class:`stdd_torch.models.yunet.YuNet` and its
    ``detect_scaled`` take."""

    input_w: int = 320
    input_h: int = 320
    conf_threshold: float = 0.6
    nms_threshold: float = 0.3
    top_k: int = 128              # fixed-capacity padded detections
    max_faces: int = 16           # read by neither package; kept field for field


@dataclass(frozen=True)
class PipelineConfig:
    """Streaming scoring pipeline (reference: TEST2.py / test/af_realtime.py)."""

    clip_size: int = 32
    imsize: int = 224
    stride: int = 30
    detect_every: int = 4
    mesh_every: int = 4
    crop_scale: float = 0.5
    batch_clips: int = 8
    threshold: float = 0.362
    t_high: float = 0.75
    t_low: float = 0.65
    min_face_side: int = 40
    pool_method: str = "mean"
    max_tracks: int = 8
    decision_min_frames: int = 128
    decision_percentile: float = 80.0


@dataclass(frozen=True)
class TrainConfig:
    """Training defaults shared by the I3D (AltFreezing) and dual-encoder rigs."""

    base_lr: float = 1e-4
    weight_decay: float = 1e-4
    max_epochs: int = 30
    warmup_epochs: float = 2.0
    batch_size: int = 32
    alter_freq: int = 10          # AltFreezing spatial/temporal swap period (iters)
    optimizer: str = "adamw"
    lr_policy: str = "cosine"
    grad_clip: float = 1.0
    label_smoothing: float = 0.0
    seed: int = 42


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. ``data`` shards the batch; ``model`` is reserved for
    tensor-parallel extensions (the models here fit one card comfortably)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1       # -1 = all devices
    model_parallel: int = 1


@dataclass(frozen=True)
class Config:
    model: I3DConfig = field(default_factory=I3DConfig)
    dual: DualEncoderConfig = field(default_factory=DualEncoderConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def _coerce(value: str, target_type: Any) -> Any:
    if target_type is bool:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "yes", "on")
    if target_type in (int, float, str):
        return target_type(value)
    # tuples / typing containers: a python literal
    import ast

    v = ast.literal_eval(value) if isinstance(value, str) else value
    if isinstance(v, list):
        v = tuple(v)
    return v


def _replace_path(cfg: Any, path: List[str], value: Any) -> Any:
    name = path[0]
    if not hasattr(cfg, name):
        raise KeyError(f"unknown config key: {name!r} on {type(cfg).__name__}")
    if len(path) == 1:
        ftypes = {f.name: f.type for f in fields(cfg)}
        cur = getattr(cfg, name)
        target = type(cur) if cur is not None else ftypes[name]
        return dataclasses.replace(cfg, **{name: _coerce(value, target)})
    sub = _replace_path(getattr(cfg, name), path[1:], value)
    return dataclasses.replace(cfg, **{name: sub})


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply ``a.b.c=value`` dotted overrides (reference: config.py:46 update_args)."""
    for item in overrides:
        key, _, value = item.partition("=")
        cfg = _replace_path(cfg, key.strip().split("."), value.strip())
    return cfg


def _from_dict(cls: Any, d: Dict[str, Any]) -> Any:
    """``cls`` from a parsed YAML mapping: a sub-tree (a field whose default
    is a config, or a mapping) recursively, a list as a tuple (its inner
    lists as tuples), any other value as it is."""
    kwargs = {}
    for f in fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        factory = f.default_factory is not dataclasses.MISSING
        if (factory and dataclasses.is_dataclass(f.default_factory())) or isinstance(v, dict):
            default = f.default_factory() if factory else f.default
            kwargs[f.name] = _from_dict(type(default), v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def load_yaml(path: str, overrides: Optional[List[str]] = None) -> Config:
    """The tree from a YAML file, then ``overrides``. Needs PyYAML, imported
    here only; without it, build the tree with :func:`apply_overrides`."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("load_yaml needs PyYAML (the yaml module), which is not installed; "
                          "build the Config with apply_overrides(Config(), ['a.b=v', ...]) "
                          "instead") from e

    with open(path) as f:
        d = yaml.safe_load(f) or {}
    cfg = _from_dict(Config, d)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg
