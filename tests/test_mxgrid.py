"""MX-grid encoding: shapes, continuity, chunking equivalence, gradients,
a straight-line NumPy oracle, and the bf16 precision contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from romap_tpu.ops import mxgrid
from tests.oracles import mxgrid_encode_ref

RNG = np.random.default_rng(3)


def small_spec(chunk=4096):
    return mxgrid.make_mxspec(
        n_levels=3, base_resolution=4, max_resolution=32, features=8, chunk=chunk
    )


def test_shapes_and_layout():
    spec = small_spec()
    assert spec.resolutions == (4, 11, 32)
    assert spec.total_res == 47
    assert spec.offsets == (0, 4, 15)
    key = jax.random.PRNGKey(0)
    factors = mxgrid.init_mxgrid(key, spec)
    assert factors.shape == (3, 47, 8)
    x = jnp.asarray(RNG.uniform(0, 1, (5, 6, 3)), jnp.float32)
    out = mxgrid.encode(factors, x, spec)
    assert out.shape == (5, 6, 8)


def test_hat_basis_partition_of_unity_and_interp():
    spec = small_spec()
    x = jnp.asarray(RNG.uniform(0, 1, (64,)), jnp.float32)
    h = np.asarray(mxgrid.hat_basis(x, spec))
    # each level's rows sum to 1 (partition of unity of the tent basis)
    for lvl, (r, off) in enumerate(zip(spec.resolutions, spec.offsets)):
        np.testing.assert_allclose(h[:, off : off + r].sum(-1), 1.0, atol=1e-5)
        assert (np.sort(h[:, off : off + r], axis=-1)[:, :-2] < 1e-6).all()  # <=2 nnz


def test_encode_is_continuous_and_piecewise_linear_per_axis():
    spec = small_spec()
    factors = jnp.asarray(RNG.normal(size=(3, spec.total_res, 8)), jnp.float32)
    # epsilon pairs straddling every lattice point of every level: the jump
    # across a cell boundary must vanish with epsilon (C0 continuity)
    eps = 1e-6
    knots = np.concatenate([
        np.arange(1, r - 1) / (r - 1) for r in spec.resolutions
    ]).astype(np.float32)
    lo = jnp.stack([jnp.asarray(knots - eps), jnp.full_like(jnp.asarray(knots), 0.37),
                    jnp.full_like(jnp.asarray(knots), 0.61)], -1)
    hi = lo.at[:, 0].add(2 * eps)
    f_lo = np.asarray(mxgrid.encode(factors, lo, spec))
    f_hi = np.asarray(mxgrid.encode(factors, hi, spec))
    np.testing.assert_allclose(f_lo, f_hi, atol=1e-3)


def test_chunked_matches_unchunked():
    spec_small = small_spec(chunk=64)
    spec_big = small_spec(chunk=1 << 20)
    factors = jnp.asarray(RNG.normal(size=(3, spec_small.total_res, 8)), jnp.float32)
    x = jnp.asarray(RNG.uniform(0, 1, (333, 3)), jnp.float32)  # non-multiple of 64
    a = np.asarray(mxgrid.encode(factors, x, spec_small))
    b = np.asarray(mxgrid.encode(factors, x, spec_big))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_gradient_matches_finite_differences():
    spec = mxgrid.make_mxspec(n_levels=2, base_resolution=3, max_resolution=8,
                              features=4, chunk=128)
    factors = jnp.asarray(RNG.normal(size=(3, spec.total_res, 4)), jnp.float32)
    x = jnp.asarray(RNG.uniform(0.05, 0.95, (16, 3)), jnp.float32)

    def f(t):
        return jnp.sum(jnp.tanh(mxgrid.encode(t, x, spec)))

    g = np.asarray(jax.grad(f)(factors))
    eps = 1e-3
    for _ in range(12):
        d, r, k = (RNG.integers(0, s) for s in factors.shape)
        tp = factors.at[d, r, k].add(eps)
        tm = factors.at[d, r, k].add(-eps)
        fd = (float(f(tp)) - float(f(tm))) / (2 * eps)
        np.testing.assert_allclose(g[d, r, k], fd, rtol=2e-2, atol=2e-3)


def test_encoding_presets():
    """Named ladder presets resolve to valid configs; unknown names raise."""
    from romap_tpu.config import EncodingConfig

    flagship = EncodingConfig.preset("flagship")
    assert flagship == EncodingConfig()
    assert EncodingConfig.preset("fast").plane_specs == ()
    q = EncodingConfig.preset("quality")
    # single-level knobs normalize to (ru, rv, k) triple form
    assert q.plane_specs == ((128, 128, 8),) and q.n_output_dims == 88
    assert flagship.plane_specs == ((128, 64, 4),)  # rect flagship
    assert EncodingConfig.preset("tcnn").kind == "hashgrid"
    try:
        EncodingConfig.preset("nope")
        raise AssertionError("expected ValueError")
    except ValueError as e:
        assert "nope" in str(e)


ORACLE_SPECS = {
    "cp_only": dict(n_levels=3, base_resolution=4, max_resolution=32,
                    features=8),
    "square_plane": dict(n_levels=3, base_resolution=4, max_resolution=32,
                         features=8, plane_res=12, plane_features=4),
    "rect_plane": dict(n_levels=2, base_resolution=4, max_resolution=16,
                       features=8, plane_specs=((8, 24, 4),)),
    "balanced_axes": dict(n_levels=2, base_resolution=4, max_resolution=16,
                          features=8, plane_specs=((24, 8, 4),),
                          plane_axes="balanced"),
    "plane_ladder": dict(n_levels=2, base_resolution=4, max_resolution=16,
                         features=8, plane_specs=((8, 4), (16, 8, 3))),
    "snapped": dict(n_levels=3, base_resolution=4, max_resolution=32,
                    features=8, plane_specs=((12, 8, 4),),
                    plane_axes="balanced", snap_levels=True),
}


@pytest.mark.parametrize("name", sorted(ORACLE_SPECS))
def test_encode_matches_numpy_oracle(name):
    """encode (chunked, vectorized, checkpointed) == per-point loop oracle."""
    spec = mxgrid.make_mxspec(chunk=16, **ORACLE_SPECS[name])
    factors = mxgrid.init_mxgrid(jax.random.PRNGKey(21), spec)
    pts = RNG.uniform(0, 1, (37, 3)).astype(np.float32)  # 3 chunks, padded
    got = np.asarray(mxgrid.encode(factors, jnp.asarray(pts), spec))
    want = mxgrid_encode_ref(factors, pts, spec)
    assert got.shape == want.shape == (37, spec.n_output_dims)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _flagship_setup():
    from romap_tpu.config import NerfConfig
    from romap_tpu.models import nerf

    spec = nerf.make_field_spec(NerfConfig())  # resolution 192, snapped
    f32 = mxgrid.init_mxgrid(jax.random.PRNGKey(0), spec)
    f16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), f32)
    pts = jax.random.uniform(jax.random.PRNGKey(1), (2048, 3))
    return spec, f32, f16, pts


@pytest.mark.parametrize("part", ["forward", "gradient"])
def test_bf16_params_stay_within_parameter_rounding_of_fp32(part):
    """Precision contract: with bf16 parameters, points and tent bases stay
    fp32 and products accumulate in fp32, so the encode differs from fp32
    only by the parameters' bf16 rounding (~0.5% relative at flagship
    width). Rounding the points to bf16 instead puts them ~0.75 of a cell
    off at resolution 192 (tens of percent)."""
    spec, f32, f16, pts = _flagship_setup()
    if part == "forward":
        a = np.asarray(mxgrid.encode(f32, pts, spec))
        b = np.asarray(mxgrid.encode(f16, pts, spec), np.float32)
        assert np.mean(np.abs(a - b)) / np.mean(np.abs(a)) < 1e-2
        return
    tgt = jax.random.normal(jax.random.PRNGKey(2), (2048, spec.n_output_dims))
    loss = lambda f: jnp.sum(
        (mxgrid.encode(f, pts, spec).astype(jnp.float32) - tgt) ** 2)
    g32, g16 = jax.grad(loss)(f32), jax.grad(loss)(f16)
    for a, b in zip(jax.tree.leaves(g16), jax.tree.leaves(g32)):
        a, b = np.asarray(a, np.float32), np.asarray(b)
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 2e-2


def test_snap_levels_exact_when_knots_align():
    """When every (r_l - 1) divides (r_fine - 1) the folded basis IS the
    original basis: snap_levels must be numerically a no-op (resolutions
    3, 5, 9: coarse knots all land on fine nodes)."""
    mk = lambda snap: mxgrid.make_mxspec(
        n_levels=3, base_resolution=3, max_resolution=9, features=8,
        snap_levels=snap)
    s0, s1 = mk(False), mk(True)
    assert s0.resolutions == (3, 5, 9)
    factors = jnp.asarray(RNG.normal(size=(3, s0.total_res, 8)), jnp.float32)
    pts = jnp.asarray(RNG.uniform(0, 1, (410, 3)), jnp.float32)
    want = np.asarray(mxgrid.encode(factors, pts, s0))
    got = np.asarray(mxgrid.encode(factors, pts, s1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_vmap_over_objects_matches_per_object_loop():
    """The batched object table vmaps encode over objects: each row must
    equal encoding that object alone."""
    s = mxgrid.make_mxspec(n_levels=3, base_resolution=4, max_resolution=32,
                           features=16, plane_specs=((24, 16, 8),),
                           plane_axes="balanced", snap_levels=True, chunk=256)
    keys = jax.random.split(jax.random.PRNGKey(8), 4)
    factors = jax.vmap(lambda k: mxgrid.init_mxgrid(k, s))(keys)
    pts = jnp.asarray(RNG.uniform(0, 1, (4, 520, 3)), jnp.float32)
    got = np.asarray(jax.vmap(lambda f, p: mxgrid.encode(f, p, s))(factors, pts))
    for i in range(4):
        one = jax.tree.map(lambda a: a[i], factors)
        np.testing.assert_allclose(
            got[i], np.asarray(mxgrid.encode(one, pts[i], s)),
            rtol=1e-5, atol=1e-5)
