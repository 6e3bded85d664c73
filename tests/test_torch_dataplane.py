"""Parity of the port's DataPlane and int8 wire compression with the
JAX reference: one sequence of puts and moves runs on both packages, and
their ledgers, replica homes and landed values must agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from repro.core import dataplane as jdp
from repro.optim import compression as jcomp

from repro_torch import convert
from repro_torch.core import (DataRef, PilotDescription, PilotManager,
                              ResourceManager)
from repro_torch.core import dataplane as tdp
from repro_torch.optim.compression import (dequantize_int8, ef_quantize,
                                           init_residuals, quantize_int8)

CPU = torch.device("cpu")


class _Ref:
    """The reference DataPlane over an aliased one-device CPU pool."""
    dp = jdp

    def __init__(self):
        self.devs = jax.devices() * 4

    def rep(self, devs):
        return jdp.replicated_sharding(devs)

    def block(self):
        mesh = Mesh(np.array(self.devs[:1]).reshape(1, 1), ("data", "model"))
        return NamedSharding(mesh, PartitionSpec("data"))

    def arr(self, x, sharding):
        return jax.device_put(jnp.asarray(x), sharding)

    @staticmethod
    def host(a):
        return np.asarray(a)


class _Port:
    """The port's DataPlane over an aliased one-device CPU pool."""
    dp = tdp

    def __init__(self):
        self.devs = [CPU] * 4

    def rep(self, devs):
        return tdp.replicated_sharding(devs)

    def block(self):
        return tdp.DeviceGrid(self.devs[:1]).block_placement()

    def arr(self, x, placement):
        return tdp.place(x, placement)

    @staticmethod
    def host(a):
        return a.to_numpy()


def _run_sequence(pkg):
    """put / reshard_to / move_to_pilot / replicate_to (plain and int8) /
    spool_out / put_virtual / evict_devices, in that order."""
    rng = np.random.default_rng(0)
    big = rng.normal(size=(64 * 1024,)).astype(np.float32)      # 256 KiB
    small = rng.normal(size=(64,)).astype(np.float32)
    data = pkg.dp.DataPlane()
    a_dev, b_dev = pkg.devs[:2], pkg.devs[2:]
    data.put("a", pkg.arr(big, pkg.rep(a_dev)), pilot="pA")
    data.put("b", pkg.arr(small, pkg.rep(a_dev)), pilot="pA")
    data.put("c", pkg.arr(small.reshape(16, 4), pkg.block()))  # no home
    data.reshard_to("c", pkg.rep(a_dev))
    data.reshard_to("c", pkg.rep(a_dev))                 # already there
    data.move_to_pilot("b", "pB", pkg.rep(b_dev))
    data.replicate_to("a", "pB", pkg.rep(b_dev))
    data.put("d", pkg.arr(big * 3, pkg.rep(a_dev)), pilot="pA")
    data.replicate_to("d", "pB", pkg.rep(b_dev), compress="int8")
    data.put("e", pkg.arr(small, pkg.rep(a_dev)), pilot="pA")
    data.replicate_to("e", "pB", pkg.rep(b_dev), compress="int8")  # < 64 KiB
    data.replicate_to("a", "pB", pkg.rep(b_dev))         # resident: free
    data.spool_out("a")
    data.put_virtual("v", 1 << 20, pilot="pA")
    data.move_to_pilot("v", "pB", None)
    data.replicate_to("v", "pC", None, compress="int8")
    touched = data.datasets_on_devices(pkg.devs[:1], pilot="pA")
    evicted = data.evict_devices(pkg.devs[:1], pkg.rep(pkg.devs[3:]),
                                 pilot="pA")
    homes = {n: data.home_pilots(n) for n in data.names()}
    values = {n: pkg.host(data.get(n).array) for n in data.names()
              if not data.get(n).is_virtual}
    nbytes = {n: data.get(n).nbytes for n in data.names()}
    return data.ledger(), homes, values, nbytes, touched, evicted


def test_dataplane_sequence_matches_reference():
    ref = _run_sequence(_Ref())
    out = _run_sequence(_Port())
    assert out[0] == ref[0]                      # ledger, byte for byte
    assert ref[0]["compressed_bytes_saved"] > 0
    assert ref[0]["by_reason"]["drain-evict"] > 0
    assert out[1] == ref[1]                      # replica homes
    assert out[3] == ref[3]                      # nbytes
    assert out[4] == ref[4] and out[5] == ref[5]
    assert set(out[2]) == set(ref[2])
    for name, arr in ref[2].items():
        # the int8 landing is the same rounding of the same f32 division
        np.testing.assert_allclose(out[2][name], arr, rtol=1e-6, atol=0)


def test_placement_equality_is_by_device_identity():
    """A rebuilt torch.device equals the pool's but is not the same
    object: placements, locality and eviction must not match it."""
    pool = [torch.device("cuda", 0), torch.device("cuda", 1)]
    rebuilt = torch.device("cuda", 0)
    assert rebuilt == pool[0] and rebuilt is not pool[0]
    assert tdp.Placement(pool[:1]) == tdp.Placement(pool[:1])
    assert tdp.Placement(pool[:1]) != tdp.Placement([rebuilt])
    assert tdp.Placement(pool, "block") != tdp.Placement(pool)
    cpu = [torch.device("cpu")] * 2
    data = tdp.DataPlane()
    data.put("x", tdp.place(np.ones((4, 2), np.float32),
                            tdp.replicated_sharding(cpu)))
    assert data.datasets_on_devices(cpu[:1]) == ["x"]
    assert data.datasets_on_devices([torch.device("cpu")]) == []


def test_replicated_sharding_dedupes_aliased_devices():
    cpu = torch.device("cpu")
    other = torch.device("cpu")
    pl = tdp.replicated_sharding([cpu, cpu, other, cpu])
    assert pl.devices == (cpu, other)
    assert pl.devices[0] is cpu and pl.devices[1] is other
    with pytest.raises(ValueError, match="empty"):
        tdp.replicated_sharding([])


def test_block_placement_splits_rows_and_reassembles():
    grid = tdp.DeviceGrid([CPU] * 6, tp=2)
    assert grid.devices.shape == (3, 2) and grid.shape == {"data": 3,
                                                          "model": 2}
    x = np.arange(21, dtype=np.float32).reshape(7, 3)
    st = tdp.place(x, grid.block_placement())
    assert st.shape == (7, 3) and st.nbytes == x.nbytes
    assert [b.shape[0] for b, _ in st.row_blocks()] == [3, 2, 2]
    assert torch.equal(st.blocks[0], st.blocks[1])    # replicated over tp
    np.testing.assert_array_equal(st.to_numpy(), x)


def test_put_refuses_a_bare_tensor():
    with pytest.raises(TypeError, match="ShardedTensor"):
        tdp.DataPlane().put("x", torch.ones(3))


def test_staged_int8_replicate_ledgers_quarter_bytes():
    """DataRef(compress='int8') through a port Pilot's prefetcher, as in
    tests/test_staging.py."""
    pm = PilotManager(ResourceManager(devices=[CPU] * 4))
    try:
        shared = tdp.DataPlane()
        p0, p1 = [pm.submit(PilotDescription(n_chips=2, name=f"p{i}",
                                             enable_speculation=False),
                            data_registry=shared) for i in range(2)]
        arr = tdp.place(np.ones((64 * 1024,), np.float32),
                        tdp.replicated_sharding(p0.devices))
        shared.put("big", arr, pilot=p0.uid)
        (req,) = p1.stage_in([DataRef("big", compress="int8")])
        wire = req.wait(10.0)
        assert wire == pytest.approx(arr.nbytes / 4, rel=0.01)
        assert shared.compressed_bytes_saved == arr.nbytes - wire
        assert shared.moved_by_link(tdp.Link.DCN) == wire
        landed = shared.get("big").array.to_numpy()
        np.testing.assert_allclose(landed, np.ones_like(landed), atol=0.01)
    finally:
        pm.shutdown()


# ------------------------------------------------------------ compression
def test_quantize_matches_reference_bitwise():
    x = np.random.default_rng(3).normal(size=(999,)).astype(np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)


def test_quantize_roundtrip_error_bounded():
    """Round-trip error is at most half a quantization step (scale/2)."""
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(512,)).astype(np.float32))
    q, scale = quantize_int8(x)
    back = dequantize_int8(q, scale)
    assert back.dtype == torch.float32
    assert float((back - x).abs().max()) <= float(scale) / 2 + 1e-7


def test_quantize_uses_full_int8_range():
    q, scale = quantize_int8(torch.tensor([-4.0, -1.0, 0.0, 2.0, 4.0]))
    assert int(q.abs().max()) == 127 and int(q[2]) == 0
    np.testing.assert_allclose(float(scale), 4.0 / 127.0, rtol=1e-6)


def test_quantize_zero_tensor_safe():
    q, scale = quantize_int8(torch.zeros(16))
    back = dequantize_int8(q, scale)
    assert torch.isfinite(back).all() and not back.any()


def test_ef_quantize_matches_reference_and_carries_residual():
    x = np.random.default_rng(1).normal(size=(256,)).astype(np.float32)
    tq, ts, tr = ef_quantize(torch.from_numpy(x), torch.zeros(256))
    jq, js, jr = jcomp.ef_quantize(jnp.asarray(x), jnp.zeros(256))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-7)
    np.testing.assert_allclose(
        tr.numpy(), x - dequantize_int8(tq, ts).numpy(), atol=1e-6)
    # a sub-step value accumulates in the residual until it transmits
    v, r = torch.tensor([127.0, 0.3]), torch.zeros(2)
    sent = np.zeros(2)
    for _ in range(4):
        q, s, r = ef_quantize(v, r)
        sent += dequantize_int8(q, s).double().numpy()
    np.testing.assert_allclose(sent, 4 * v.double().numpy(),
                               atol=float(s) + 1e-6)
    assert sent[1] > 0.0


def test_init_residuals_zero_tree():
    res = init_residuals({"a": torch.ones(4, 4, dtype=torch.bfloat16),
                          "b": [torch.ones(3)]})
    assert res["a"].dtype == torch.float32 and res["a"].shape == (4, 4)
    assert not res["a"].any() and not res["b"][0].any()


def test_wire_bytes_quarter_of_float32():
    x = torch.ones(1024)
    q, _ = quantize_int8(x)
    assert q.numel() * q.element_size() * 4 == x.numel() * x.element_size()


def test_convert_reads_back_what_it_placed():
    data = tdp.DataPlane()
    x = np.random.default_rng(2).normal(size=(10, 3)).astype(np.float32)
    convert.load_numpy_state(data, {"x": x}, homes={"x": ["pA"]},
                             placement=tdp.replicated_sharding([CPU]))
    assert data.home_pilots("x") == {"pA"}
    np.testing.assert_array_equal(convert.state_to_numpy(data)["x"], x)
    with pytest.raises(ValueError, match="placement"):
        convert.load_numpy_state(data, {"y": x})
