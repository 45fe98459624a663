"""Tensor operations of the port: plain PyTorch functions and the wrappers of
the hand-written CUDA kernels (``splat``, ``splat_tiled``,
``fused_ln_attn_layer``, ``fused_ln_mlp``, ``fused_attn_layer`` and
``fused_mlp``, the last four with their backward), each beside its plain
version."""
