"""gennbv-tpu-torch: the PyTorch / CUDA port of gennbv_tpu for one NVIDIA
H100.

Keeps the JAX package's module layout and names (``env/recon_env.py``,
``ops/splat.py``, ...), with PyTorch inside: ``nn.Module``s and plain
functions on batched tensors, an explicit device, explicit
``torch.Generator``s.  The JAX package's one Pallas kernel on the rollout
path, the per-point image gather, is the CUDA kernel
``csrc/gather_image.cu`` (``ops/gather.py``).  The package never imports
jax; the JAX package stays the reference its tests are held against.
"""
__version__ = "0.1.0"
