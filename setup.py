"""Package build for vit_unet_tpu, including the native data-path extension.

    pip install -e .            # or:
    python setup.py build_ext --inplace

The C++ extension is optional at runtime — ``vit_unet_tpu.data.tfrecord``
falls back to pure Python when it is absent.
"""
from setuptools import Extension, find_packages, setup

setup(
    name="vit_unet_tpu",
    version="0.1.0",
    description=("TPU-native ViT-UNet framework: hierarchical vision-"
                 "transformer autoencoders on JAX/XLA/Pallas"),
    packages=find_packages(include=["vit_unet_tpu", "vit_unet_tpu.*",
                                    "vit_unet_tpu_torch", "vit_unet_tpu_torch.*"]),
    package_data={"vit_unet_tpu_torch.kernels": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    ext_modules=[
        Extension(
            "vit_unet_tpu.data._native",
            sources=["vit_unet_tpu/data/_native.cc"],
            extra_compile_args=["-O3", "-std=c++17"],
            optional=True,
        ),
    ],
)
