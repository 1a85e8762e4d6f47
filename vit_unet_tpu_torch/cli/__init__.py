"""Command-line entry points of the port (``python -m
vit_unet_tpu_torch.cli.run_denoising``, ``python -m
vit_unet_tpu_torch.cli.run_classification``)."""
