"""gennbv-tpu-torch: the PyTorch / CUDA port of gennbv_tpu for one NVIDIA
H100.

Keeps the JAX package's module layout and names (``env/recon_env.py``,
``ops/splat.py``, ...), with PyTorch inside: ``nn.Module``s and plain
functions on batched tensors, an explicit device, explicit
``torch.Generator``s.  The JAX package's three Pallas kernels are CUDA
kernels here: the per-point image gather (``csrc/gather_image.cu``,
``ops/gather.py``), the voxel hit scatter (``csrc/scatter_cells_any.cu``,
``ops/scatter.py``) and the fused splat z-buffer + visibility
(``csrc/zbuf_visible.cu``, ``ops/fused_splat.py``).  Training runs through
``algo/runner.py`` (rollout, GAE, the PPO update) from the CLIs under
``train/``.  The package never imports jax; the JAX package stays the
reference its tests are held against.
"""
__version__ = "0.1.0"
