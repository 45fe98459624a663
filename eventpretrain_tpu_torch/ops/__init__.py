"""Tensor operations of the port: plain PyTorch functions and the wrappers of
the hand-written CUDA kernels (``splat``, ``fused_ln_attn_layer`` and
``fused_ln_mlp`` with their backward), each beside its plain version."""
