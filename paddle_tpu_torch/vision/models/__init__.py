"""Vision models (counterpart: paddle_tpu/vision/models).  Parameter
and buffer names are the JAX package's (``conv1.weight``,
``bn1._mean``, ``layer1.0.conv1.weight``, ...), and Linear weights are
Paddle's ``[in, out]``, so a JAX model's ``state_dict()`` (as numpy)
loads through ``set_state_dict`` with nothing missing or unexpected.
``pretrained`` is taken and not read, as in the JAX package."""
from .lenet import LeNet
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     wide_resnet50_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .vit import VisionTransformer, vit_b_16, vit_l_16, vit_s_16
from .yolov3 import DarkNet53, YOLOv3, yolov3_darknet53

__all__ = ["LeNet", "MobileNetV1", "MobileNetV2", "mobilenet_v1",
           "mobilenet_v2", "BasicBlock", "BottleneckBlock", "ResNet",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "wide_resnet50_2", "VGG", "vgg11", "vgg13",
           "vgg16", "vgg19", "VisionTransformer", "vit_b_16", "vit_l_16",
           "vit_s_16", "DarkNet53", "YOLOv3", "yolov3_darknet53"]
