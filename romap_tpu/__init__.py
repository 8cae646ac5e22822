"""romap_tpu — batched multi-object NeRF mapping in JAX.

A ground-up JAX/XLA rebuild of the capabilities of RO-MAP
(reference: /root/reference): an object-SLAM frontend discovers objects
(3D bbox + pose) in a monocular stream; a multi-object NeRF backend trains one
small instant-ngp-style NeRF per object, online and concurrently.

Where the reference trains thread-per-object with CUDA/tiny-cuda-nn
(reference: dependencies/Multi-Object-NeRF/Core), this framework batches every
object NeRF into one parameter table with a leading object axis, trains all of
them with a single jitted+vmapped train step and one shared optimizer update,
and shards the object axis across a device mesh (one GPU or several).

Layout:
  ops/      — geometry, hash-grid encoding, MLP, volume rendering, marching cubes
  models/   — the batched multi-object NeRF model and train/render steps
  data/     — dataset formats (reference-compatible), frame store, synthetic data
  parallel/ — device mesh + sharding of the object axis
  runtime/  — offline runner and the online manager (NerfManagerOnline-shaped API)
  utils/    — camera math, mesh IO, metrics, checkpointing
"""

__version__ = "0.1.0"
