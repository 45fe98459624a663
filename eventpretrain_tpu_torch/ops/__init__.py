"""Tensor operations of the port: plain PyTorch functions and the wrappers of
the hand-written CUDA kernels (``splat``, ``fused_ln_attn_layer``,
``fused_ln_mlp``), each beside its plain version."""
