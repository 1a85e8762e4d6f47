"""vit_unet_tpu_torch — the PyTorch / CUDA port of vit_unet_tpu for NVIDIA
Hopper (H100).

So far it covers the torch-flavour ViT-UNet (with the Fourier block and
``remat``), the TF-flavour ``HViTUNetTF`` (``models/hvit_unet_tf.py``,
keras-style attention on the same kernels with an identity head mix) and
the hierarchical ViT classifier (``models/vit_classifier.py``, trained by
``python -m vit_unet_tpu_torch.cli.run_classification`` from PNG, JPEG or
BMP class folders); the
ViT-UNet's eval (serving) path with
model export (``serving.py``), its train step (``parallel/train_step.py``,
on one device or a mesh of processes: data parallelism, ZeRO-1 and
sequence parallelism, ``parallel/mesh.py`` and ``parallel/sequence.py``)
and trainer (``train/fitter.py::Fitter``)
with its data feed, image datasets and augmentations (``data/``), the
training CLI (``python -m vit_unet_tpu_torch.cli.run_denoising``) and the
utilities (``utils/``, ``ops/sparse.py``), with every
re-attention contraction of a shape the kernels take (``kernel_takes``: at
most 16 heads, head dim 384; every level of the presets) in hand-written
CUDA kernels (``kernels/csrc/flash_reattention.cu`` for eval,
``kernels/csrc/flash_reattention_train.cu`` for training) and wider ones in
plain PyTorch.  It imports torch
and never jax or the JAX package.  Entry points run on the card unless given
``device=``.
"""
__version__ = "0.1.0"

from vit_unet_tpu_torch.models.hvit_unet_tf import (  # noqa: E402
    HViTUNetTF, HViTUNetTFConfig, get_hvit_unet_tf,
)
from vit_unet_tpu_torch.models.vit_classifier import (  # noqa: E402
    ViTClassifier, ViTClassifierConfig, get_vit_classifier,
)
from vit_unet_tpu_torch.models.vit_unet import (      # noqa: E402
    ViTUNet, ViTUNetConfig, get_config, get_vit_unet,
)
from vit_unet_tpu_torch.serving import Predictor      # noqa: E402

__all__ = ["ViTUNet", "ViTUNetConfig", "get_config", "get_vit_unet",
           "HViTUNetTF", "HViTUNetTFConfig", "get_hvit_unet_tf",
           "ViTClassifier", "ViTClassifierConfig", "get_vit_classifier",
           "Predictor", "__version__"]
