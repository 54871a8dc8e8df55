"""LibreFace Action-Unit extractor on the card: ResNet-18 encoder + sigmoid
MLP head.

Own copy of ``stdd_tpu/models/au_resnet.py``. The reference AU model
(torchvision resnet18 encoder → Linear(512,128) → ReLU → BatchNorm1d →
Dropout → Linear(128,12) → Sigmoid) and its inference adapter (Resize(256)
on the shorter side → CenterCrop(224) → ImageNet normalize; activations
thresholded at 0.5 into a binary AU dict). The modules are named after the
flax tree (``encoder/layer1_0/conv1``, ``fc1``, ``bn``, ``fc2``), so
``utils/weights.py::flax_to_torch`` is a layout change;
:func:`load_torchvision_state_dict` takes a LibreFace checkpoint's
torchvision-convention keys (``conv1``, ``bn1``, ``layer{1..4}.{0,1}.*``,
``downsample``, ``classifier.*``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

AU_KEYS = ["AU01", "AU02", "AU04", "AU06", "AU07", "AU10",
           "AU12", "AU14", "AU15", "AU17", "AU23", "AU24"]

IMAGENET_MEAN01 = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD01 = np.array([0.229, 0.224, 0.225], np.float32)
BN_EPS = 1e-5


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=0.1)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = _bn(features)
        self.has_down = cin != features or stride != 1
        if self.has_down:
            self.down_conv = nn.Conv2d(cin, features, 1, stride, bias=False)
            self.down_bn = _bn(features)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = self.down_bn(self.down_conv(x)) if self.has_down else x
        return F.relu(h + identity)


class ResNet18Encoder(nn.Module):
    """Standard ResNet-18 trunk, NCHW in → [B, 512] pooled features."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        for li, (f, s) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            for bi in range(2):
                setattr(self, f"layer{li + 1}_{bi}", BasicBlock(cin, f, s if bi == 0 else 1))
                cin = f

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for li in range(4):
            for bi in range(2):
                x = getattr(self, f"layer{li + 1}_{bi}")(x)
        return x.mean(dim=(2, 3))


class AUResNet18(nn.Module):
    """Encoder + the LibreFace AU head → 12 sigmoid activations. Takes
    [B, 224, 224, 3] normalized channels-last input, as the JAX model."""

    def __init__(self, num_labels: int = 12, dropout: float = 0.1):
        super().__init__()
        self.encoder = ResNet18Encoder()
        self.fc1 = nn.Linear(512, 128)
        self.bn = nn.BatchNorm1d(128, eps=BN_EPS, momentum=0.1)
        self.dropout = nn.Dropout(dropout)
        self.fc2 = nn.Linear(128, num_labels)

    def forward(self, x, return_features: bool = False):
        feats = self.encoder(x.permute(0, 3, 1, 2))
        h = self.bn(F.relu(self.fc1(feats)))
        out = torch.sigmoid(self.fc2(self.dropout(h)))
        return (out, feats) if return_features else out


def _aa_linear_weights(in_size: int, out_size: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.image.resize(method="linear", antialias=True)`` along one axis
    as an [out, in] matrix: a triangle kernel at half-pixel centres,
    widened by the scale when downsampling, each row renormalised to sum 1
    (which is what keeps the edge rows from fading)."""
    scale = out_size / in_size
    kscale = min(scale, 1.0)                       # antialias widens on a downscale
    sample = (torch.arange(out_size, dtype=torch.float64) + 0.5) / scale - 0.5
    x = torch.arange(in_size, dtype=torch.float64)
    w = torch.clamp(1.0 - torch.abs(sample[:, None] - x[None, :]) * kscale, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total > 0, w / torch.where(total > 0, total, 1.0), 0.0)
    return w.to(dtype)


def preprocess_faces(faces_rgb_u8: torch.Tensor) -> torch.Tensor:
    """Batched LibreFace transform on [B, H, W, 3] uint8 RGB: shorter side
    to 256 (bilinear, antialiased, as ``jax.image.resize``), center-crop
    224, scale to [0, 1], ImageNet normalize → [B, 224, 224, 3] float32."""
    B, H, W, C = faces_rgb_u8.shape
    if H <= W:
        nh, nw = 256, max(1, int(round(W * 256 / H)))
    else:
        nh, nw = max(1, int(round(H * 256 / W))), 256
    dev = faces_rgb_u8.device
    wy = _aa_linear_weights(H, nh).to(dev)
    wx = _aa_linear_weights(W, nw).to(dev)
    top, left = (nh - 224) // 2, (nw - 224) // 2
    wy, wx = wy[top:top + 224], wx[left:left + 224]
    x = faces_rgb_u8.float()
    x = torch.einsum("oh,bhwc->bowc", wy, x)
    x = torch.einsum("pw,bowc->bopc", wx, x)
    x = x / 255.0
    mean = torch.from_numpy(IMAGENET_MEAN01).to(dev)
    std = torch.from_numpy(IMAGENET_STD01).to(dev)
    return (x - mean) / std


class AUExtractor:
    """Batched AU inference service (faces in, binary AU dicts out), on the
    card unless ``device="cpu"``. ``variables`` is the flax tree of the JAX
    ``AUResNet18`` (numpy arrays)."""

    def __init__(self, variables=None, threshold: float = 0.5, device="cuda",
                 model: Optional[AUResNet18] = None):
        from ..utils.weights import flax_to_torch

        self.device = torch.device(device)
        if model is None:
            model = AUResNet18()
            model.load_state_dict(flax_to_torch(variables, model, "AU ResNet-18"))
        self.model = model.to(self.device).eval()
        self.threshold = threshold

    @classmethod
    def random_init(cls, seed: int = 0, **kw):
        """Random weights drawn from a ``torch.Generator`` seeded with
        ``seed``: kernels He-normal as torchvision's ResNet, biases zero,
        BatchNorm at identity statistics."""
        g = torch.Generator().manual_seed(seed)
        model = AUResNet18()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    fan = m.weight[0].numel()
                    m.weight.copy_(torch.randn(m.weight.shape, generator=g) * (2.0 / fan) ** 0.5)
                    if m.bias is not None:
                        m.bias.zero_()
        return cls(model=model, **kw)

    @classmethod
    def from_torch_checkpoint(cls, path: str, **kw):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        model = AUResNet18()
        load_torchvision_state_dict(model, sd)
        return cls(model=model, **kw)

    @torch.no_grad()
    def activations(self, faces_rgb_u8) -> np.ndarray:
        """[B, H, W, 3] uint8 RGB faces → [B, 12] sigmoid activations."""
        x = torch.as_tensor(np.ascontiguousarray(faces_rgb_u8)).to(self.device)
        return self.model(preprocess_faces(x)).float().cpu().numpy()

    def __call__(self, faces_rgb_u8) -> List[Dict[str, float]]:
        acts = self.activations(np.asarray(faces_rgb_u8))
        binary = (acts >= self.threshold).astype(float)
        return [dict(zip(AU_KEYS, row)) for row in binary]


def torchvision_to_port_keys(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A LibreFace torchvision-convention state dict → the port's
    ``AUResNet18`` keys. The reference wraps the encoder in an
    ``nn.Sequential`` of resnet18's children (0 conv1, 1 bn1, 4..7
    layer1..4) and the head in ``classifier`` (0 Linear, 2 BatchNorm1d, 4
    Linear); plain torchvision names are accepted too, and a ``module.``
    prefix is dropped."""
    sd = {}
    for k, v in state_dict.items():
        k = k.replace("module.", "")
        k = (k.replace("encoder.0.", "conv1.").replace("encoder.1.", "bn1.")
             .replace("encoder.4.", "layer1.").replace("encoder.5.", "layer2.")
             .replace("encoder.6.", "layer3.").replace("encoder.7.", "layer4."))
        sd[k] = torch.as_tensor(v.detach().cpu() if hasattr(v, "detach") else np.asarray(v))
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def take(dst: str, src: str, leaves) -> None:
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"].float()
            used.add(f"{src}.{leaf}")
        if f"{src}.running_mean" in sd:
            out[f"{dst}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
            used.add(f"{src}.num_batches_tracked")

    bn = ("weight", "bias", "running_mean", "running_var")
    take("encoder.conv1", "conv1", ("weight",))
    take("encoder.bn1", "bn1", bn)
    for li in range(1, 5):
        for bi in range(2):
            src, dst = f"layer{li}.{bi}", f"encoder.layer{li}_{bi}"
            take(f"{dst}.conv1", f"{src}.conv1", ("weight",))
            take(f"{dst}.bn1", f"{src}.bn1", bn)
            take(f"{dst}.conv2", f"{src}.conv2", ("weight",))
            take(f"{dst}.bn2", f"{src}.bn2", bn)
            if f"{src}.downsample.0.weight" in sd:
                take(f"{dst}.down_conv", f"{src}.downsample.0", ("weight",))
                take(f"{dst}.down_bn", f"{src}.downsample.1", bn)
    take("fc1", "classifier.0", ("weight", "bias"))
    take("bn", "classifier.2", bn)
    take("fc2", "classifier.4", ("weight", "bias"))
    # torchvision's own classification head (``fc``) is not part of the
    # LibreFace model; anything else left over is an error
    left = sorted(k for k in sd if k not in used and not k.startswith("fc."))
    if left:
        raise ValueError(f"unconsumed AU checkpoint entries: {left[:8]}")
    return out


def load_torchvision_state_dict(model: AUResNet18, state_dict: Mapping[str, Any]) -> AUResNet18:
    """Load a torchvision-convention LibreFace state dict into ``model``
    (the port's counterpart of ``au_resnet_torch_to_flax``); missing or
    mis-shaped entries raise."""
    from ..utils.weights import _check_covers

    sd = torchvision_to_port_keys(state_dict)
    _check_covers(sd, model, "AU checkpoint")
    model.load_state_dict(sd)
    return model
