"""DynamicScaler panoramic video diffusion in PyTorch for NVIDIA Hopper.

The PyTorch counterpart of ``dynamicscaler_tpu``: the same file layout and
public names, VideoCrafter ``state_dict`` names inside the modules, the JAX
layout ``[B, F, H, W, C]`` at public functions, and hand-written CUDA
kernels (``csrc/``) for the UNet transformer sub-blocks.
"""
