"""Data constants the quantized stem folds in."""

# ImageNet normalization constants (reference `teacher_training/dataset.py:20`)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
