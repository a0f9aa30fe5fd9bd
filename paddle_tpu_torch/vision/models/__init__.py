"""paddle.vision.models for the port (counterpart of
paddle_tpu/vision/models/__init__.py): LeNet and the ResNet family. The
other zoo files (AlexNet, VGG, MobileNet, DenseNet, GoogLeNet,
InceptionV3, ShuffleNetV2, SqueezeNet) are ROADMAP queue 1 item 6b2:
their names raise NotImplementedError."""
from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)

__all__ = ["LeNet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2"]

# the reference's other zoo names, ported in item 6b2
LATER = frozenset({
    "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "MobileNetV1", "MobileNetV2", "MobileNetV3Small", "MobileNetV3Large",
    "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
    "mobilenet_v3_large", "DenseNet", "densenet121", "densenet161",
    "densenet169", "densenet201", "densenet264", "SqueezeNet",
    "squeezenet1_0", "squeezenet1_1", "ShuffleNetV2", "shufflenet_v2_x0_25",
    "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
    "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "shufflenet_v2_swish",
    "GoogLeNet", "googlenet", "InceptionV3", "inception_v3"})


def __getattr__(name):
    if name in LATER:
        raise NotImplementedError(
            f"paddle.vision.models.{name} is ROADMAP queue 1 item 6b2")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
