"""PyTorch + CUDA port of point_cloud_reid_tpu.

The package mirrors the JAX package's layout (configs/, ops/, models/,
inference/, tracking/, train/, convert/, tools/) and runs three paths:

  the point tracker   per-box crops -> point backbone embedding -> track x
                      detection match scoring -> host association;
  the image tracker   camera crops of the boxes -> ViT tokens -> the same
                      match chain without positions -> host association;
  training            the flagship point model on pair batches.

Every Pallas kernel of the JAX package is a hand-written CUDA kernel for
Hopper here (kernels/ wraps csrc/*.cu). On CPU tensors every kernel wrapper
runs its plain PyTorch version instead, which is how the CPU tests hold the
port against the JAX package.

This package imports torch and never jax or flax.
"""
