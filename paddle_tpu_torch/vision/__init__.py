"""Vision: transforms, datasets, models and the vision and detection
ops (counterpart: paddle_tpu/vision)."""
from . import datasets, models, ops, transforms
from .models import (LeNet, ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152)

__all__ = ["datasets", "models", "ops", "transforms", "LeNet", "ResNet",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]
