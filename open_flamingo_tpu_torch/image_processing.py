"""CLIP image normalisation on the device, the port's own copy of the JAX
package's `normalize_images_on_device` and the OpenAI CLIP statistics.

Host-resized uint8 batches (..., H, W, 3) become normalised pixels in the
model's dtype on the card: (x / 255 - mean) / std in fp32, then cast.
"""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_images_on_device(images_uint8: torch.Tensor, dtype=None) -> torch.Tensor:
    x = images_uint8.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype or torch.float32)
