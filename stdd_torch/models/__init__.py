"""Model zoo. A plain registry keyed by name (the reference's string-plugin
loader, ``altfreezing/utils/plugin_loader.py:16``).

Port of ``stdd_tpu/models/__init__.py`` (``register_model`` :9,
``build_model`` :17): the same names, each builder taking the JAX builder's
arguments (and the port's ``dtype``) and importing its module only when
called, so ``import stdd_torch.models`` stays cheap.
"""

import dataclasses
from typing import Any, Callable, Dict

MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_model(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


def build_model(name: str, *args, **kwargs):
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](*args, **kwargs)


def _cfg(cfg):
    from ..config import I3DConfig

    return cfg or I3DConfig()


@register_model("i3d_ori")
def _build_i3d(cfg=None, **kw):
    """The production AltFreezing classifier (reference model/classifier/i3d_ori.py:112)."""
    from .i3d import I3D

    return I3D(cfg=_cfg(cfg), **kw)


@register_model("ftcn_tt")
def _build_ftcn(cfg=None, **kw):
    """FTCN temporal-only variant (reference i3d_temporal_var_fix_dropout_tt_cfg.py)."""
    from .ftcn import FTCN

    return FTCN(cfg=dataclasses.replace(_cfg(cfg), temporal_only=True), **kw)


@register_model("slowfast")
def _build_slowfast(cfg=None, **kw):
    """Dual-pathway SlowFast (reference video_model_builder.py:147)."""
    from .slowfast import SlowFast

    return SlowFast(cfg=_cfg(cfg), **kw)


@register_model("resunet")
def _build_resunet(cfg=None, **kw):
    """3D encoder-decoder mask predictor (reference ResUNet family,
    video_model_builder.py:1128-2742)."""
    from .unet3d import ResUNet3D

    return ResUNet3D(cfg=_cfg(cfg), **kw)


@register_model("resunet_light")
def _build_resunet_light(cfg=None, **kw):
    """Single-conv-decoder variant (reference ResUNetLight :1349)."""
    from .unet3d import ResUNet3D

    return ResUNet3D(cfg=_cfg(cfg), light=True, **kw)


def _register_resunet_variants():
    # LightFix :1578, Continus :1812, Common :2046, Common2 :2280, Strong
    # :2513 (unet3d.RESUNET_VARIANTS)
    for _name in ("lightfix", "continus", "common", "common2", "strong"):
        def _build(cfg=None, _n=_name, **kw):
            from .unet3d import make_resunet

            return make_resunet(_n, cfg=cfg, **kw)

        _build.__doc__ = f"Reference ResUNet{_name.capitalize()} variant."
        register_model(f"resunet_{_name}")(_build)


_register_resunet_variants()


@register_model("videoit")
def _build_videoit(**kw):
    """Per-patch time transformer (reference time_transformer.py:167)."""
    from .vit import VideoiT

    return VideoiT(**kw)


@register_model("st_transformer")
def _build_st_transformer(**kw):
    """Factorized space-time ViT (reference time_transformer.py:281)."""
    from .vit import SpatialTemporalTransformer

    return SpatialTemporalTransformer(**kw)


@register_model("resnet2d")
def _build_resnet2d(variant: str = "resnet18", **kw):
    """Legacy 2D frame classifier bases (reference model/classifier/_resnet_base.py)."""
    from .resnet2d import ResNet2D

    return ResNet2D(variant=variant, **kw)
