"""Data constants the quantized stem folds in, and the float models' input
normalization."""

import torch

# ImageNet normalization constants (reference `teacher_training/dataset.py:20`)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(batch_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalized float NHWC, (u - 255 mean) / (255 std) in fp32
    (a true division, as the JAX package's ``normalize_images``), then cast."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=batch_u8.device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=batch_u8.device) * 255.0
    return ((batch_u8.float() - mean) / std).to(dtype)
