"""Image frontend: VGG16 concept and region features.

Counterpart of ``multimodalworddiscovery_tpu/frontend/image.py``: VGG16
run over whole images (class posteriors as concept labels) and over region
crops from bounding boxes (penultimate-layer embeddings).  The network is
an ``nn.Module`` laid out as torchvision names VGG16's layers
(``features.{i}``, ``classifier.{0,3,6}``), so a torchvision state dict on
disk loads as it is (``load_torch_weights``); nothing is downloaded.  The
convolutions and products are cuDNN's and cuBLAS's: the reference runs them
in XLA, outside any Pallas kernel.  Keep ``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` off where a result is held to
float32.

Images are [..., H, W, 3] (channels last), as in the reference; the module
takes them so and reads them as NCHW views.  Boxes are normalized
(y1, x1, y2, x2) in [0, 1].
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodalworddiscovery_tpu_torch.models import flax_params

# torchvision VGG16 'D' configuration
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# the fc head's linear layers in torchvision's classifier (fc1, fc2, fc3)
_FC = (0, 3, 6)


class VGG16(nn.Module):
    """VGG16-D.  ``forward`` takes [N, H, W, 3] with H = W = ``input_size``
    (a multiple of 32) and returns (logits [N, num_classes], fc2 [N, fc_dim]).

    fc1 reads 512 * (input_size / 32)^2 features, flattened in (C, H, W)
    order as torch flattens; the reference's flax Dense infers that width
    from its input, and ``input_size`` fixes it here (224 for torchvision's
    weights)."""

    def __init__(self, num_classes: int = 1000, fc_dim: int = 4096, input_size: int = 224):
        super().__init__()
        if input_size % 32:
            raise ValueError(f"input_size must be a multiple of 32, got {input_size}")
        layers: list[nn.Module] = []
        in_c = 3
        for v in _CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_c, v, 3, padding=1), nn.ReLU(inplace=True)]
                in_c = v
        self.features = nn.Sequential(*layers)
        side = input_size // 32
        self.classifier = nn.Sequential(
            nn.Linear(512 * side * side, fc_dim), nn.ReLU(inplace=True), nn.Dropout(),
            nn.Linear(fc_dim, fc_dim), nn.ReLU(inplace=True), nn.Dropout(),
            nn.Linear(fc_dim, num_classes),
        )
        self.num_classes, self.fc_dim, self.input_size = num_classes, fc_dim, input_size

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.flatten(self.features(x.permute(0, 3, 1, 2)), 1)
        fc1, fc2, fc3 = (self.classifier[i] for i in _FC)
        h = torch.relu(fc1(x))
        feat = torch.relu(fc2(h))
        return fc3(feat), feat  # no dropout: the reference's forward has none


def init_vgg16(
    generator: torch.Generator | None = None,
    num_classes: int = 1000,
    fc_dim: int = 4096,
    input_size: int = 224,
    device="cuda",
) -> VGG16:
    """Random-init VGG16 on ``device``, drawn as flax initialises its layers
    (``flax_params.flax_init``) from ``generator`` (a CPU generator seeded
    0 when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = VGG16(num_classes, fc_dim, input_size)
    flax_params.flax_init(model, generator)
    return model.to(device).eval()


def load_torch_weights(path: str | Path, device="cuda") -> VGG16:
    """VGG16 from a torchvision state dict on disk (.pt / .pth), loaded with
    ``weights_only=True``; the class count, fc width and input size are
    read off the state dict (torchvision: 1000, 4096, 224)."""
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    fc1 = sd["classifier.0.weight"]
    side = int(round((fc1.shape[1] / 512) ** 0.5))
    model = VGG16(num_classes=sd["classifier.6.weight"].shape[0], fc_dim=fc1.shape[0],
                  input_size=32 * side)
    model.load_state_dict(sd)
    return model.to(device).eval()


def params_from_flax(tree: dict, device="cuda") -> VGG16:
    """VGG16 from the reference's flax tree (numpy arrays, optionally under
    "params"): conv_i kernels [kh, kw, in, out] become ``features`` weights
    [out, in, kh, kw], fc1-fc3 kernels [in, out] become ``classifier``
    weights [out, in].  Sizes come from the tree's shapes."""
    t = tree.get("params", tree)
    fc1 = np.asarray(t["fc1"]["kernel"])
    side = int(round((fc1.shape[0] / 512) ** 0.5))
    model = VGG16(num_classes=np.asarray(t["fc3"]["kernel"]).shape[1], fc_dim=fc1.shape[1],
                  input_size=32 * side)
    convs = [m for m in model.features if isinstance(m, nn.Conv2d)]
    arrays = []
    for i, _ in enumerate(convs):
        arrays += [np.asarray(t[f"conv_{i}"]["kernel"]).transpose(3, 2, 0, 1),
                   np.asarray(t[f"conv_{i}"]["bias"])]
    for name in ("fc1", "fc2", "fc3"):
        arrays += [np.asarray(t[name]["kernel"]).T, np.asarray(t[name]["bias"])]
    flax_params.copy_into(model, [torch.tensor(np.array(a, np.float32)) for a in arrays])
    return model.to(device).eval()


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 / float [..., H, W, 3] in [0, 255] or [0, 1] -> normalized
    float32; divided by 255 when the batch's largest value is over 2."""
    x = images.to(torch.float32)
    x = torch.where(torch.amax(x) > 2.0, x / 255.0, x)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor, size: int = 224) -> torch.Tensor:
    """RoIAlign-style crops: image [H, W, C], boxes [B, 4] -> [B, size,
    size, C] bilinear samples at half-pixel centers, clipped to the image:
    the reference's four-corner gather, batched over the boxes."""
    h, w, _ = image.shape
    y1, x1, y2, x2 = boxes.to(torch.float32).unbind(-1)
    k = (torch.arange(size, device=image.device) + 0.5).to(torch.float32)
    ys = y1[:, None] + (y2 - y1)[:, None] * k / size  # [B, size]
    xs = x1[:, None] + (x2 - x1)[:, None] * k / size
    yf = torch.clamp(ys * h - 0.5, 0.0, h - 1.0)
    xf = torch.clamp(xs * w - 0.5, 0.0, w - 1.0)
    y0, x0 = torch.floor(yf).long(), torch.floor(xf).long()
    y1i, x1i = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    wy = (yf - y0)[:, :, None, None]
    wx = (xf - x0)[:, None, :, None]

    def gather(yi, xi):  # image[yi][:, xi] per box -> [B, size, size, C]
        return image[yi[:, :, None], xi[:, None, :]]

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1i) * wx
    bot = gather(y1i, x0) * (1 - wx) + gather(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def resize(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[H, W, C] -> [height, width, C] float32, as ``jax.image.resize(image,
    (height, width, C), "bilinear")`` computes it: half-pixel centers, a
    triangle kernel widened by the shrink factor when shrinking
    (antialiased), weights normalized to sum 1.  That is
    ``F.interpolate(mode="bilinear", antialias=True)``."""
    x = image.to(torch.float32).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(height, width), mode="bilinear", antialias=True,
                      align_corners=False)
    return x[0].permute(1, 2, 0)


def image_concepts(model: VGG16, images: torch.Tensor) -> torch.Tensor:
    """Whole-image class posteriors [N, num_classes] (softmax over classes):
    the 'concept' distribution of the reference's VGG16 classifier path."""
    with torch.no_grad():
        logits, _ = model(preprocess(images))
    return torch.softmax(logits, dim=-1)


def region_embeddings(model: VGG16, image: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[B, 4] boxes on one image [H, W, 3] -> [B, fc_dim] penultimate
    embeddings of its crops at the model's input size."""
    crops = crop_and_resize(preprocess(image), boxes, size=model.input_size)
    with torch.no_grad():
        return model(crops)[1]
