"""Configuration dataclasses of the live scoring path.

Own copies of ``stdd_tpu.config.I3DConfig``, ``DualEncoderConfig``,
``DetectorConfig`` and ``PipelineConfig`` (same fields, same defaults), so a configuration moves between the two packages
field for field. The port's I3D computes the plain convolutions whatever
``s2d_stem``/``stem_t2`` say (both are exact TPU re-layouts of the same
math); ``fused_s2`` runs s2 through K2 (``ops/bottleneck.py``);
``temporal_only`` and ``int8_stages`` are not ported yet and are refused by
:class:`stdd_torch.models.i3d.I3D`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
