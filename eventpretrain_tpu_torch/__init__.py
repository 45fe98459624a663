"""PyTorch / CUDA (NVIDIA Hopper) port of ``eventpretrain_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and names (``eventpretrain_tpu/ops/events.py`` ->
``eventpretrain_tpu_torch/ops/events.py``) so each counterpart is easy to
find, and imports ``torch`` only — never ``jax``.

Layout decisions, made once for the whole port:

* Activations keep the JAX package's channels-last layout at every public
  function: event grids and images are ``(B, H, W, C)``, token streams
  ``(B, L, C)``. Modules convert to torch's NCHW only internally (the patch
  convolution) and convert back before returning.
* Parameters use the reference PyTorch key space and layout, the one
  ``eventpretrain_tpu/ckpt/torch_export.py::export_torch_state_dict``
  writes: ``nn.Linear`` weights ``(out, in)``, ``nn.Conv2d`` weights
  ``OIHW``, LayerNorm ``weight``/``bias``. A JAX-trained model therefore
  loads with ``load_state_dict(strict=True)``
  (:func:`eventpretrain_tpu_torch.ckpt.bridge.load_jax_state_dict`).
* Fixed tables (the sincos ``pos_embed``) are non-persistent buffers,
  recomputed at construction, as the exporter omits them.
* Randomness is explicit: callers pass ``torch.Generator`` objects; nothing
  reads a global seed.

Kernels: every Pallas kernel on a ported path has a hand-written CUDA C++
kernel for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``_build.py``) and bound with ``ctypes``. Each wrapper runs its plain
PyTorch version for CPU tensors only; for a CUDA tensor it launches the
kernel or raises.
"""
