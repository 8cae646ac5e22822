"""Trace reduction: device time per jax.named_scope from a recorded
profiler trace (here the CPU's, whose kernels carry the same hlo_op stats
as the GPU's)."""

import glob

import jax
import jax.numpy as jnp

from romap_tpu.utils import profiling


def test_scope_times_attributes_forward_and_backward_to_scopes(tmp_path):
    def f(x, w):
        with jax.named_scope("encode"):
            y = jnp.tanh(x @ w)
        with jax.named_scope("mlp"):
            return jnp.sum(jnp.sin(y @ w))

    step = jax.jit(jax.grad(f, argnums=1)).lower(
        jnp.ones((128, 128)), jnp.ones((128, 128))).compile()
    x, w = jnp.ones((128, 128)), jnp.full((128, 128), 0.01)
    step(x, w).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        step(x, w).block_until_ready()
    (xplane,) = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)

    paths = profiling.hlo_op_paths(step.as_text())
    assert any("transpose(jvp(encode))" in p for ps in paths.values() for p in ps)

    st = profiling.scope_times(xplane, [step.as_text()], plane_prefix="/host:CPU")
    ker = st["kernel_ns"]
    assert ker["encode"] > 0 and ker["mlp"] > 0
    assert st["total_kernel_ns"] == sum(ker.values())
    assert 0 < st["busy_ns"] <= st["window_ns"]
    assert {t["scope"] for t in st["top_ops"]} <= {"encode", "mlp", "other"}
    assert profiling._union_ns([(0, 10), (5, 20), (30, 35)]) == 25
