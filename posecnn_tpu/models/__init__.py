"""Model families.

The flagship PoseCNN (and its plain-JAX VGG16 trunk) import eagerly and
need nothing beyond JAX. The other families are still written in flax;
they load on first attribute access, so importing PoseCNN never
imports flax.
"""

import importlib

from posecnn_tpu.models.posecnn import PoseCNN, PoseCNNOutputs
from posecnn_tpu.models.vgg16 import VGG16Trunk, bilinear_upsample

_LAZY = {
    "PoseCNNDet": "detection",
    "detection_losses": "detection",
    "FUSION_CELLS": "recurrent",
    "Add2DCell": "recurrent",
    "FusionCell": "recurrent",
    "GRU3DCell": "recurrent",
    "GRUOriginalCell": "recurrent",
    "RecurrentSegNet": "recurrent",
    "Vanilla2DCell": "recurrent",
    "VideoState": "recurrent",
    "ResNet50Seg": "resnet50",
    "ResNet50Trunk": "resnet50",
    "FCN8": "fcn8",
    "DCGANDiscriminator": "gan",
    "DCGANGenerator": "gan",
    "FeatureDiscriminator": "gan",
    "gan_losses": "gan",
}


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f"posecnn_tpu.models.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module 'posecnn_tpu.models' has no attribute {name!r}")


__all__ = ["PoseCNN", "PoseCNNOutputs", "VGG16Trunk", "bilinear_upsample", *_LAZY]
