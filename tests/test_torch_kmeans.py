"""Parity of the port's K-Means path with the JAX reference.

The same numpy inputs (``np.random.default_rng``) go through
``repro`` and ``repro_torch``.  On the CPU the port's kernel wrapper runs
its plain version; the reference runs its jnp oracle and its Pallas
kernel in interpret mode.  Reference meshes come from
``repro.compat.make_mesh`` (Auto axes), never ``jax.make_mesh``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analytics import kmeans as jkm
from repro.analytics.engine import AnalyticsEngine as JEngine
from repro.compat import make_mesh
from repro.core.dataplane import DataPlane as JDataPlane
from repro.kernels.kmeans import ops as jops
from repro.kernels.kmeans import ref as jref

from repro_torch import convert
from repro_torch.analytics import kmeans as tkm
from repro_torch.analytics.engine import AnalyticsEngine as TEngine
from repro_torch.core.dataplane import DataPlane as TDataPlane, DeviceGrid
from repro_torch.kernels import autotune
from repro_torch.kernels.kmeans import kmeans as kernel
from repro_torch.kernels.kmeans import ops as tops
from repro_torch.kernels.kmeans import ref as tref

CPU = torch.device("cpu")


def _inputs(n, k, d, dtype, seed):
    """Reference arrays and the port's tensors holding the same values."""
    rng = np.random.default_rng(seed)
    jp = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32), dtype)
    jc = jnp.asarray(rng.normal(size=(k, d)).astype(np.float32), dtype)
    return (jp, jc, convert.to_tensor(np.asarray(jp)),
            convert.to_tensor(np.asarray(jc)))


# ---------------------------------------------------------- kernel level
# the sweep of tests/test_kernels.py; tolerances are the reference's own:
# f32 distances to 1e-4, bf16 inputs (upcast to f32 after rounding) to
# 2e-2, atol 1e-3 for the |p|^2 - 2 p.c + |c|^2 cancellation, and >= 99 %
# index agreement (near-ties may flip with the summation order)
@pytest.mark.parametrize("n,k,d", [(64, 8, 3), (256, 16, 3), (1000, 37, 3),
                                   (128, 5, 8), (512, 50, 16)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_assign_matches_reference_and_pallas(n, k, d, dtype):
    jp, jc, tp, tc = _inputs(n, k, d, dtype, seed=n + k)
    ti, td = tops.assign(tp, tc)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    rtol = 2e-2 if dtype == jnp.bfloat16 else 1e-4
    for oi, od in (jref.assign(jp, jc), jops.assign(jp, jc)):
        np.testing.assert_allclose(td.numpy(), np.asarray(od), rtol=rtol,
                                   atol=1e-3)
        same = np.mean(ti.numpy() == np.asarray(oi))
        assert same > 0.99, f"assignment mismatch rate {1 - same:.3f}"


def test_assign_plain_version_is_the_cpu_path():
    _, _, tp, tc = _inputs(300, 20, 3, jnp.float32, seed=5)
    for a, b in zip(tops.assign(tp, tc), tref.assign(tp, tc)):
        assert torch.equal(a, b)


def test_duplicate_centroids_resolve_to_first_index():
    rng = np.random.default_rng(11)
    base = rng.normal(size=(5, 3)).astype(np.float32)
    c = np.concatenate([base, base, base])
    p = rng.normal(size=(400, 3)).astype(np.float32)
    ti, _ = tops.assign(torch.from_numpy(p), torch.from_numpy(c))
    ri, _ = jref.assign(jnp.asarray(p), jnp.asarray(c))
    assert (ti.numpy() < len(base)).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))


# ------------------------------------------- around the Hopper kernels
# The scan and merge kernels run only on the card; what surrounds them
# (block and split choice, the split ranges, the packed layout, the merge
# rule) is plain Python and PyTorch, held here against the reference.
H100_SMS = 132


@pytest.mark.parametrize("n,k,d", [(10_000, 5_000, 3), (100_000, 500, 3),
                                   (1_000_000, 50, 3), (7, 3, 3),
                                   (2_000, 100, 16), (0, 9, 32)])
def test_split_count_fills_the_card_within_the_tiles(n, k, d):
    bn, bk = (autotune.DEFAULTS["kmeans"][x] for x in ("bn", "bk"))
    r = kernel.rows(d)
    splits = tops.split_count(n, k, bn, bk, r, H100_SMS)
    assert 1 <= splits <= -(-k // bk)
    blocks = -(-n // (bn * r))
    if (n, k) == (10_000, 5_000):       # 10 point blocks alone: ~8 % of 132
        assert blocks * splits >= H100_SMS
    if blocks >= tops.BLOCKS_PER_SM * H100_SMS:
        assert splits == 1
    # every candidate block size gets a count the scan takes
    for cfg in autotune.candidates_kmeans(max(n, 1), k, d):
        s = tops.split_count(n, k, cfg["bn"], cfg["bk"], r, H100_SMS)
        assert 1 <= s <= tops.max_splits(k, cfg["bk"])


@pytest.mark.parametrize("k", [1, 4, 5, 29, 50, 5_000])
def test_split_ranges_cover_k_in_group_steps(k):
    for splits in range(1, -(-k // kernel.GROUP) + 1):
        ranges = tops.split_ranges(k, splits)
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2 and lo % kernel.GROUP == 0
        assert all(lo < hi for lo, hi in ranges)       # none is empty


def _tie_inputs(k, seed):
    """Small integer coordinates: every distance is exact in f32, so ties
    are real and do not depend on summation order.  For each split count
    of the test, the centroid after every split boundary duplicates the
    one before it."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-3, 4, size=(k, 3)).astype(np.float32)
    for splits in (2, 3, 7):
        for lo, _ in tops.split_ranges(k, splits)[1:]:
            c[lo] = c[lo - 1]
    p = rng.integers(-4, 5, size=(600, 3)).astype(np.float32)
    p[:k] = c                                # points exactly on centroids
    return torch.from_numpy(p), torch.from_numpy(c)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_merge_rule_keeps_the_first_index(splits):
    """ref.assign per contiguous centroid range, merged in split order
    with a strict `<`, gives ref.assign's result bitwise, and a duplicate
    across a split boundary resolves to the lower index."""
    p, c = _tie_inputs(29, seed=splits)
    ranges = tops.split_ranges(c.shape[0], splits)
    parts = [tref.assign(p, c[lo:hi]) for lo, hi in ranges]
    idx, dist = tref.merge_partials(
        torch.stack([i + lo for (i, _), (lo, _) in zip(parts, ranges)]),
        torch.stack([m for _, m in parts]))
    want_idx, want_dist = tref.assign(p, c)
    assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)
    ri, _ = jref.assign(jnp.asarray(p.numpy()), jnp.asarray(c.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    for lo, _ in ranges[1:]:
        assert torch.equal(c[lo], c[lo - 1])
        assert not (idx == lo).any()


@pytest.mark.parametrize("n,k,d", [(300, 37, 1), (500, 50, 3), (256, 9, 4),
                                   (200, 21, 16), (100, 8, 32)])
def test_packed_layout_scores_match_the_reference(n, k, d):
    jp, jc, tp, tc = _inputs(n, k, d, jnp.float32, seed=7 * n + d)
    packed = tref.pack(tc)
    assert packed.shape == (k, 4 * ((d + 4) // 4))
    assert torch.equal(packed[:, :d], -2.0 * tc)        # exact scaling
    assert not packed[:, d + 1:].any()                  # zero padding
    dist = tref.packed_scores(tp, packed) + tref.sq_norm(tp)[:, None]
    mn, idx = dist.min(dim=1)
    for oi, od in (tref.assign(tp, tc), jref.assign(jp, jc)):
        np.testing.assert_allclose(mn.numpy(), np.asarray(od), rtol=1e-4,
                                   atol=1e-3)
        assert np.mean(idx.numpy() == np.asarray(oi)) > 0.99


def _group_argmin(scores):
    """The scan's argmin rule over one centroid range: the min of each
    group of GROUP scores (the tail padded with +inf), the first group
    reaching the least (a strict `<` across groups), then the first
    centroid of that group whose score equals it."""
    n, m = scores.shape
    g = kernel.GROUP
    padded = torch.full((n, -(-m // g) * g), float("inf"))
    padded[:, :m] = scores
    grouped = padded.view(n, -1, g)
    best, group = grouped.amin(dim=2).min(dim=1)
    rows = grouped[torch.arange(n), group]
    first = (rows == best[:, None]).int().argmax(dim=1)
    return best, (g * group + first).to(torch.int32)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_plain_split_path_matches_reference(splits):
    """The kernels' path in plain PyTorch: packed scores per split range,
    the scan's group argmin, partial minima without |p|^2, then the merge
    kernel's plain version adds it; held against the JAX reference on
    tie-heavy inputs."""
    p, c = _tie_inputs(29, seed=10 + splits)
    packed = tref.pack(c)
    part_min, part_idx = [], []
    for lo, hi in tops.split_ranges(c.shape[0], splits):
        mn, i = _group_argmin(tref.packed_scores(p, packed[lo:hi]))
        part_min.append(mn)
        part_idx.append(i + lo)
    idx, dist = tref.merge(p, torch.stack(part_idx), torch.stack(part_min))
    ri, rd = jref.assign(jnp.asarray(p.numpy()), jnp.asarray(c.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(dist.numpy(), np.asarray(rd), rtol=1e-4,
                               atol=1e-3)


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    p = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.assign(p, p)


# --------------------------------------------------------------- map phase
@pytest.mark.parametrize("use_kernel", [False, True])
def test_assign_partials_matches_reference(use_kernel):
    jp, jc, tp, tc = _inputs(777, 9, 3, jnp.float32, seed=3)
    ref = jkm.assign_partials(jp, jc, use_kernel=use_kernel)
    out = tkm.assign_partials(tp, tc, use_kernel=use_kernel)
    # same arithmetic, different summation order: f32 sums to 1e-5
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_map_reduce_matches_numpy(n_blocks):
    eng = TEngine(DeviceGrid([CPU] * n_blocks), TDataPlane())
    x = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    eng.put("x", x)
    assert len(eng.get("x").row_blocks()) == n_blocks
    total = eng.map_reduce(lambda blk: blk.sum(dim=0), "x")
    np.testing.assert_allclose(total.numpy(), x.sum(0), rtol=1e-5)


def test_map_blocks_and_ensure_local_match_reference():
    """A dataset registered off the engine's placement is re-blocked once
    (ledgered as 'ensure-local' on ICI), then mapped block-locally."""
    from repro.core.dataplane import replicated_sharding as j_rep
    from repro_torch.core.dataplane import place, replicated_sharding
    x = np.random.default_rng(4).normal(size=(12, 3)).astype(np.float32)
    jeng = JEngine(make_mesh((1, 1), ("data", "model")), JDataPlane())
    jeng.data.put("x", jax.device_put(jnp.asarray(x), j_rep(jax.devices())))
    jy = jeng.map_blocks(lambda b: b * 2.0, "x", "y")
    teng = TEngine(DeviceGrid([CPU] * 2), TDataPlane())
    teng.data.put("x", place(x, replicated_sharding([CPU])))
    ty = teng.map_blocks(lambda b: b * 2.0, "x", "y")
    assert ty.placement == teng.block_sharding()
    assert len(ty.row_blocks()) == 2
    np.testing.assert_array_equal(teng.get("y").to_numpy(), np.asarray(jy))
    assert teng.data.ledger() == jeng.data.ledger()
    assert teng.data.ledger()["by_reason"] == {"ensure-local": x.nbytes}


# -------------------------------------------------------------- kmeans_fit
def _reference_draw(pts, k, seed):
    """The reference's centroid draw (kmeans.py:59-61), fed to the port."""
    idx = np.asarray(jax.random.choice(jax.random.key(seed), pts.shape[0],
                                       (k,), replace=False))
    return pts.full()[torch.from_numpy(idx.astype(np.int64))]


@pytest.mark.parametrize("data_path", ["local", "global"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_kmeans_fit_matches_reference(monkeypatch, data_path, use_kernel):
    pts = np.asarray(jkm.make_dataset(1024, 3, n_clusters=4, seed=3))
    jeng = JEngine(make_mesh((1, 1), ("data", "model")), JDataPlane())
    jeng.put("p", pts)
    jc, jcost = jkm.kmeans_fit(jeng, "p", 4, iters=2, data_path=data_path,
                               use_kernel=use_kernel, seed=1)

    monkeypatch.setattr(tkm, "_init_centroids", _reference_draw)
    teng = TEngine(DeviceGrid([CPU]), TDataPlane())
    convert.load_numpy_state(teng, {"p": pts})
    tc, tcost = tkm.kmeans_fit(teng, "p", 4, iters=2, data_path=data_path,
                               use_kernel=use_kernel, seed=1)
    # same arithmetic, different summation order (f32 sums of 1024 rows)
    assert tcost == pytest.approx(jcost, rel=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-5)
    # the global path spools through the 'GFS' in both, byte for byte
    assert teng.data.ledger() == jeng.data.ledger()
    if data_path == "global":
        reasons = teng.data.ledger()["by_reason"]
        assert reasons["gfs-spool-write"] == reasons["gfs-spool-read"] \
            == 2 * pts.nbytes
    np.testing.assert_array_equal(convert.state_to_numpy(teng)["p"], pts)


def test_init_centroids_draws_distinct_points_per_seed():
    eng = TEngine(DeviceGrid([CPU] * 2), TDataPlane())
    x = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    eng.put("x", x)
    c0 = tkm._init_centroids(eng.get("x"), 7, 0)
    assert torch.equal(c0, tkm._init_centroids(eng.get("x"), 7, 0))
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in c0.tolist())
    assert len({tuple(r) for r in c0.tolist()}) == 7


def test_kmeans_cost_decreases_with_iters():
    eng = TEngine(DeviceGrid([CPU]), TDataPlane())
    eng.put("p", tkm.make_dataset(4096, 3, n_clusters=6, seed=0, device=CPU))
    _, cost1 = tkm.kmeans_fit(eng, "p", 6, iters=1, seed=0)
    _, cost4 = tkm.kmeans_fit(eng, "p", 6, iters=4, seed=0)
    assert cost4 <= cost1 * 1.001


def test_state_round_trip_keeps_dtype_and_homes():
    import ml_dtypes
    data = TDataPlane()
    arrays = {"f": np.arange(12, dtype=np.float32).reshape(4, 3),
              "h": np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16)}
    convert.load_numpy_state(data, arrays, homes={"f": {"pB", "pA"}},
                             placement=DeviceGrid([CPU]).block_placement())
    assert data.home_pilots("f") == {"pA", "pB"}
    assert data.home_pilots("h") == set()
    back = convert.state_to_numpy(data)
    for name, arr in arrays.items():
        assert back[name].dtype == arr.dtype
        np.testing.assert_array_equal(back[name], arr)
