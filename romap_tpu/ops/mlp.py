"""Tiny bias-free MLP head (tcnn FullyFusedMLP equivalent).

The reference uses tcnn's FullyFusedMLP with 64 neurons, 1 hidden layer, ReLU,
no output activation, input = 32 hash-grid features, output = 4 (rgb, sigma)
(ref base.json:30-38, nerf_model.cu:1318). tcnn MLPs have no bias terms.

These are plain matmuls; XLA fuses the ReLU. Batching over objects is an
outer vmap over the weight pytree.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from romap_tpu.config import NetworkConfig


def init_mlp(key: jax.Array, in_dim: int, cfg: NetworkConfig, dtype=jnp.float32):
    """He-uniform init (tcnn initializes its matrices similarly).

    Returns a dict of weight matrices: w0: [in, H], w1..: [H, H], w_out: [H, out].
    """
    n_mats = cfg.n_hidden_layers + 1
    keys = jax.random.split(key, n_mats)
    params = {}
    dims = [in_dim] + [cfg.n_neurons] * cfg.n_hidden_layers + [cfg.output_dims]
    for i in range(n_mats):
        fan_in = dims[i]
        bound = (6.0 / fan_in) ** 0.5
        params[f"w{i}"] = jax.random.uniform(
            keys[i], (dims[i], dims[i + 1]), dtype, minval=-bound, maxval=bound
        )
    return params


def apply_mlp(params: dict, x: jax.Array, cfg: NetworkConfig) -> jax.Array:
    """x: [..., in_dim] -> raw outputs [..., 4] (pre-activation rgb + sigma)."""
    n_mats = cfg.n_hidden_layers + 1
    h = x
    for i in range(n_mats - 1):
        h = jnp.maximum(
            jnp.dot(h, params[f"w{i}"], preferred_element_type=h.dtype), 0.0
        )
    return jnp.dot(h, params[f"w{n_mats - 1}"], preferred_element_type=jnp.float32)
