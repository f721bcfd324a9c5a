"""Instant-3D in PyTorch with hand-written CUDA kernels for Hopper (H100).

The port of the JAX package `repro`, slice by slice; the JAX package stays as
the reference every part of this one is held against.  It serves
novel-view renders from published snapshots and trains both the Instant-3D
field and the Instant-NGP baseline:

    serve3d.RenderService -> core.trainer render fns -> core.pipeline
      -> core.field (hash encode + fused MLPs) -> volume_render composite
    core.trainer.Instant3DTrainer -> core.pipeline (dense or compacted)
      -> core.field: query (dense) | query_step (fused step, I3D)
         | query_fused (fused encode, NGP and the split route) -> AdamW

Conventions shared by every module:

* the device is explicit: entry points take ``device=`` and default to
  ``"cuda"``; tests pass ``device="cpu"``;
* random draws take an explicit ``torch.Generator``;
* params are plain dicts of tensors with the JAX package's keys and its
  ``(d_in, d_out)`` / ``x @ W`` layout (`bridge` converts between the two);
* kernels dispatch on the tensor's device (see `repro_torch.kernels`).

This package imports torch and numpy, never jax and nothing of `repro`.
"""
