"""Exact data movement on the device path: the GS de/interleave, the HPCG
restriction and the AMG box pool/upsample are permutations, slices and
sums of three, so they must agree with numpy bit for bit.  Also the
wave-scheduled tile engine as an exact triangular solver."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from partitionedarrays_tpu.solvers.gs_dia import ColoredDIAGS


def _colored(offsets, R, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((2, len(offsets), R)).astype(np.float32)
    k0 = offsets.index(0)
    vals[:, k0, :] += 9.0
    return ColoredDIAGS(offsets, vals, vals[:, k0, :]), vals


@pytest.mark.parametrize(
    "offsets,R",
    [
        ((0, 1, -1), 1000),
        ((0, 1, -1, 40, -40, 1600, -1600), 6001),
        ((-65, -64, -63, -1, 0, 1, 63, 64, 65), 12345),
        ((0, 2, -2, 3, -3), 127),
    ],
)
def test_deinterleave_interleave_bit_exact(offsets, R):
    col, _ = _colored(offsets, R)
    assert col.m * col.Lq >= R
    x = np.random.default_rng(1).standard_normal(R).astype(np.float32)
    xd = np.asarray(jax.jit(col.deinterleave)(jnp.asarray(x)))
    xp = np.zeros(col.m * col.Lq, np.float32)
    xp[:R] = x
    np.testing.assert_array_equal(xd, xp.reshape(col.Lq, col.m).T)
    back = np.asarray(jax.jit(col.interleave_core)(jnp.asarray(xd)))
    np.testing.assert_array_equal(back, x)
    # the flat buffer is the core between two zero margins
    xf = np.asarray(col.to_flat(jnp.asarray(xd)))
    assert xf.shape == (col.n_flat,)
    assert not xf[: col.Kp].any() and not xf[col.Kp + xd.size :].any()
    np.testing.assert_array_equal(np.asarray(col.core_of_flat(jnp.asarray(xf))), xd)


@pytest.mark.parametrize("R", [1000, 6001])
def test_colored_dia_device_build_matches_host(R):
    """The device-resident sweep-state build equals the numpy build."""
    offsets = (0, 1, -1, 40, -40)
    host, vals = _colored(offsets, R)
    k0 = offsets.index(0)
    dev = ColoredDIAGS.from_device(
        offsets, jnp.asarray(vals), jnp.asarray(vals[:, k0, :])
    )
    assert (dev.m, dev.Lq, dev.Kp, dev.n_flat) == (host.m, host.Lq, host.Kp, host.n_flat)
    np.testing.assert_array_equal(np.asarray(dev.vals_d), np.asarray(host.vals_d))
    np.testing.assert_allclose(
        np.asarray(dev.invd_d), np.asarray(host.invd_d), rtol=1e-6
    )


@pytest.mark.parametrize(
    "shape,levels", [((8, 8, 8), 2), ((16, 8, 12), 2), ((8, 16, 8), 3)]
)
def test_hpcg_restriction_and_prolongation_match_numpy(shape, levels):
    from partitionedarrays_tpu.backends import SerialBackend
    from partitionedarrays_tpu.models.hpcg.mg import HPCGMGPreconditioner

    mg = HPCGMGPreconditioner(shape, (1, 1, 1), SerialBackend(1), n_levels=levels,
                              dtype=np.float32)
    l = levels - 1
    nx, ny, nz = mg.level_shapes[l]
    lay = mg.As[l].row_layout()
    rng = np.random.default_rng(2)
    r = rng.standard_normal((1, lay.n_own_pad)).astype(np.float32)
    rc = np.asarray(mg._restrict(l, jnp.asarray(r)).own)
    ref = r[:, : nx * ny * nz].reshape(1, nx, ny, nz)[:, ::2, ::2, ::2].reshape(1, -1)
    np.testing.assert_array_equal(rc[:, : ref.shape[1]], ref)
    assert not rc[:, ref.shape[1] :].any()
    # prolongation: injection back onto the even points, zero elsewhere
    corr = np.asarray(mg._prolong(l, jnp.asarray(rc), lay.n_own_pad))
    full = np.zeros((1, nx, ny, nz), np.float32)
    full[:, ::2, ::2, ::2] = ref.reshape(1, nx // 2, ny // 2, nz // 2)
    np.testing.assert_array_equal(corr[:, : nx * ny * nz], full.reshape(1, -1))


def _np_pool(v, shapes):
    (fx, fy, fz), (cx, cy, cz) = shapes
    f = v[:, : fx * fy * fz].reshape(-1, fx, fy, fz)
    f = np.pad(f, ((0, 0), (0, 3 * cx - fx), (0, 3 * cy - fy), (0, 3 * cz - fz)))
    f = f.reshape(-1, cx, 3, 3 * cy, 3 * cz)
    f = (f[:, :, 0] + f[:, :, 1]) + f[:, :, 2]
    f = f.reshape(-1, cx, cy, 3, 3 * cz)
    f = (f[:, :, :, 0] + f[:, :, :, 1]) + f[:, :, :, 2]
    f = f.reshape(-1, cx, cy, cz, 3)
    return ((f[..., 0] + f[..., 1]) + f[..., 2]).reshape(f.shape[0], -1)


@pytest.mark.parametrize(
    "fine", [(9, 9, 9), (10, 11, 13), (1, 9, 9), (7, 3, 128), (96, 96, 5)]
)
def test_amg_box_pool_and_upsample_match_numpy(fine):
    from partitionedarrays_tpu.solvers.amg import box_pool3, box_up3

    coarse = tuple(-(-f // 3) for f in fine)
    shapes = (fine, coarse)
    rng = np.random.default_rng(3)
    nf, nc = int(np.prod(fine)), int(np.prod(coarse))
    v = rng.standard_normal((2, nf + 5)).astype(np.float32)
    c = rng.standard_normal((2, nc)).astype(np.float32)
    pool = np.asarray(jax.jit(lambda a: box_pool3(a, shapes))(jnp.asarray(v)))
    np.testing.assert_array_equal(pool, _np_pool(v, shapes))
    up = np.asarray(jax.jit(lambda a: box_up3(a, shapes))(jnp.asarray(c)))
    ref = c.reshape(2, *coarse)
    for ax in (1, 2, 3):
        ref = ref.repeat(3, ax)
    ref = ref[:, : fine[0], : fine[1], : fine[2]].reshape(2, -1)
    np.testing.assert_array_equal(up, ref)
    # P0^T is the adjoint of P0: <pool(v), c> == <v, up(c)>
    np.testing.assert_allclose(
        (pool.astype(np.float64) * c).sum(),
        (v[:, :nf].astype(np.float64) * up).sum(), rtol=1e-5,
    )


def _triangular_psparse(T, backend):
    from partitionedarrays_tpu import PRange, psparse
    from partitionedarrays_tpu.parallel.p_range import uniform_partition

    n = T.shape[0]
    coo = T.tocoo()
    rows = PRange(uniform_partition(1, n))
    cols = PRange(uniform_partition(1, n))
    return psparse([coo.row], [coo.col], [coo.data.astype(np.float32)], rows, cols,
                   backend, assembled=True)


@pytest.mark.parametrize("direction", ["f", "b"])
@pytest.mark.parametrize("n,bw", [(700, 200), (1500, 40)])
def test_wave_engine_is_exact_triangular_solve(direction, n, bw):
    """With a level (topological) schedule, a zero-guess forward wave
    sweep on a lower-triangular matrix is the forward substitution and the
    backward sweep on an upper-triangular one the backward substitution:
    the fori_loop over waves against scipy's spsolve_triangular."""
    from scipy.sparse.linalg import spsolve_triangular

    from partitionedarrays_tpu.backends import SerialBackend
    from partitionedarrays_tpu.solvers.gs_slot import NaturalTileGS

    rng = np.random.default_rng(n + bw)
    r, c = np.nonzero(rng.random((n, n)) < 8.0 / bw)
    keep = np.abs(r - c) < bw
    M = sp.csr_matrix((rng.standard_normal(keep.sum()) * 0.1, (r[keep], c[keep])), (n, n))
    T = (sp.tril(M, -1) if direction == "f" else sp.triu(M, 1)) + sp.diags(
        1.0 + rng.random(n)
    )
    T = T.tocsr()
    backend = SerialBackend(1)
    A = _triangular_psparse(T, backend)
    eng = NaturalTileGS.build(A, topo=True, directions=(direction,))
    assert eng is not None and eng.directions == (direction,)
    b = rng.standard_normal(n).astype(np.float32)
    lay = A.row_layout()
    bo = np.zeros((1, lay.n_own_pad), np.float32)
    bo[0, :n] = b
    f = jax.jit(jax.vmap(lambda arrs, bb: eng.sweeps(None, bb, arrs, (direction,))))
    x = np.asarray(f(eng.arrs, jnp.asarray(bo)))[0, :n]
    ref = spsolve_triangular(T.astype(np.float64), b.astype(np.float64),
                             lower=direction == "f")
    assert np.abs(x - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    # the compiled sweep is one loop over waves, not one step per wave
    text = f.lower(eng.arrs, jnp.asarray(bo)).as_text()
    assert text.count("stablehlo.while") == 1


def test_wave_engine_rejects_unpacked_direction():
    from partitionedarrays_tpu.backends import SerialBackend
    from partitionedarrays_tpu.solvers.gs_slot import NaturalTileGS

    T = sp.diags(np.arange(1.0, 301.0)).tocsr()
    A = _triangular_psparse(T, SerialBackend(1))
    eng = NaturalTileGS.build(A, topo=True, directions=("f",))
    with pytest.raises(ValueError):
        eng.sweeps(None, jnp.zeros((A.row_layout().n_own_pad,)),
                   jax.tree.map(lambda a: a[0], eng.arrs), ("b",))
