"""CLIP image preprocessing, the port's own copy of the JAX package's
`image_processing`: resize the shorter side (bicubic), center crop, scale
to [0, 1], normalise with the OpenAI CLIP statistics. Outputs NHWC.

  * `ImageProcessor`, the host path: PIL's bicubic resize, bit for bit the
    JAX package's (eval parity), with the training flip drawn from a
    `numpy.random.Generator`. PIL is imported when an image is processed.
  * `preprocess_images_on_device`: uint8 batches resized, cropped and
    normalised on their device with `jax.image.resize`'s bicubic weights
    (Keys' cubic with a = -0.5, the kernel widened when downsampling, each
    output's weights renormalised), built here and applied as one product
    per resized axis. `F.interpolate(mode="bicubic")` uses a = -0.75 and
    other edges, so it would give other pixels.
  * `normalize_images_on_device`: host-resized uint8 batches normalised on
    the card, (x / 255 - mean) / std in fp32, then cast.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _resized_size(h: int, w: int, s: int):
    """(new_h, new_w): the shorter side to s (torchvision Resize(int))."""
    if w < h:
        return max(s, int(round(h * s / w))), s
    return s, max(s, int(round(w * s / h)))


@dataclasses.dataclass
class ImageProcessor:
    """Host-side (PIL) CLIP transform; call on a PIL image, an array or a
    list of them. random_flip mirrors the reference's training-time
    RandomHorizontalFlip(0.5)."""

    image_size: int = 224
    mean: Sequence[float] = CLIP_MEAN
    std: Sequence[float] = CLIP_STD
    random_flip: bool = False

    def __call__(self, image, rng: Union[np.random.Generator, None] = None):
        arr = self.raw_uint8(image, rng).astype(np.float32) / 255.0
        arr = (arr - np.asarray(self.mean, np.float32)) / np.asarray(self.std, np.float32)
        return np.ascontiguousarray(arr)  # (H, W, C)

    def raw_uint8(self, image, rng: Union[np.random.Generator, None] = None):
        """Resize + center-crop + flip only: uint8 (H, W, C), for
        `normalize_images_on_device`."""
        from PIL import Image

        if isinstance(image, (list, tuple)):
            return np.stack([self.raw_uint8(im, rng) for im in image])
        if not isinstance(image, Image.Image):
            image = Image.fromarray(np.asarray(image))
        image = image.convert("RGB")
        w, h = image.size
        s = self.image_size
        nh, nw = _resized_size(h, w, s)
        image = image.resize((nw, nh), Image.BICUBIC)
        left, top = (nw - s) // 2, (nh - s) // 2
        arr = np.asarray(image.crop((left, top, left + s, top + s)), np.uint8)
        if self.random_flip and (rng or np.random.default_rng()).random() < 0.5:
            arr = arr[:, ::-1]
        return np.ascontiguousarray(arr)


def normalize_images_on_device(images_uint8: torch.Tensor, dtype=None) -> torch.Tensor:
    x = images_uint8.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype or torch.float32)


def bicubic_weights(m: int, n: int, device=None) -> torch.Tensor:
    """(m, n) fp32 weights taking m input samples to n outputs, as
    `jax.image.scale_and_translate` builds them for a bicubic resize (scale
    n / m, no translation, antialiased)."""
    inv = torch.tensor(1.0 / (n / m), dtype=torch.float32, device=device)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=torch.float32, device=device)[:, None]).abs() / inv.clamp(min=1.0)
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, 0.0, w)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    # outputs whose sample lies outside the input are zero
    return torch.where(((sample >= -0.5) & (sample <= m - 0.5))[None, :], w, 0.0)


def preprocess_images_on_device(images_uint8: torch.Tensor, image_size: int = 224, dtype=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, S, S, 3) normalised, on the images' device:
    the shorter side resized to S with `jax.image.resize`'s bicubic, the
    center crop, then (x - mean) / std in fp32, cast to `dtype`."""
    b, h, w, c = images_uint8.shape
    s = image_size
    nh, nw = _resized_size(h, w, s)
    x = images_uint8.float() / 255.0
    dev = x.device
    if nh != h:
        x = torch.einsum("bhwc,hy->bywc", x, bicubic_weights(h, nh, dev))
    if nw != w:
        x = torch.einsum("bhwc,wx->bhxc", x, bicubic_weights(w, nw, dev))
    top, left = (nh - s) // 2, (nw - s) // 2
    x = x[:, top:top + s, left:left + s]
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=dev)
    return ((x - mean) / std).to(dtype or torch.float32)
