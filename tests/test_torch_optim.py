"""Parity of the port's optimizer modules with the JAX reference.

``schedule.warmup_cosine`` on Python steps and on tensors; ``adamw``
(``init``, ``global_norm``, ``update``) on one tree of f32, bf16 and
stacked leaves, f32 and bf16 moments, against the reference from the
same numpy values (f32 leaves at rtol 1e-5; a bf16 leaf may round to
the neighbouring bf16 value where the two packages' f32 results differ
in the last bit, so bf16 leaves are held at one bf16 ulp, rtol 2**-7);
the layer-by-layer path (``_SCANNED_UPDATE_BYTES`` made small in both
packages by monkeypatching) against the reference's ``lax.map`` path,
and equal bit for bit to the port's whole-leaf path; and
``compression.compressed_psum`` over a 4-rank gloo group against the
reference's on a 4-device ``compat.make_mesh`` (in a subprocess, as
``tests/test_multidevice.py`` runs it).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule

from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcompression
from repro_torch.optim import schedule as tschedule
from repro_torch.util import tree_map, tree_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-5, atol=1e-7)
BF16 = dict(rtol=2.0 ** -7, atol=1e-7)


@pytest.mark.parametrize("kw", [dict(), dict(warmup=10, total=200),
                                dict(warmup=0, total=50, floor=0.0)])
def test_warmup_cosine_matches_reference(kw):
    steps = np.arange(0, 201)
    want = np.array([float(jschedule.warmup_cosine(int(s), **kw))
                     for s in steps])
    want_t = np.asarray(jschedule.warmup_cosine(jnp.asarray(steps), **kw))
    got_f = np.array([tschedule.warmup_cosine(int(s), **kw) for s in steps])
    got_t = tschedule.warmup_cosine(torch.as_tensor(steps, dtype=torch.int32),
                                    **kw)
    assert got_t.dtype == torch.float32
    np.testing.assert_allclose(got_f, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-6, atol=1e-7)


def _tree(seed):
    """params and grads: f32 matrix and vector, a bf16 matrix, a stacked
    (layers, d, d) f32 leaf and a stacked bf16 one, nested like a model."""
    rng = np.random.default_rng(seed)

    def leaf(shape, dtype=np.float32, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(dtype)

    def tree(scale):
        return {"embed": leaf((16, 8), scale=scale),
                "final_norm": {"scale": leaf((8,), scale=scale)},
                "head": leaf((8, 12), ml_dtypes.bfloat16, scale),
                "segments": [{"w": leaf((3, 8, 8), scale=scale),
                              "wb": leaf((3, 4, 8), ml_dtypes.bfloat16,
                                         scale)}]}
    return tree(0.5), tree(0.1)


def _ref_update(params, grads, steps, hyper, moment_dtype):
    p = jax.tree.map(jnp.asarray, params)
    opt = jadamw.init(p, moment_dtype)
    norms = []
    for s in range(steps):
        g = jax.tree.map(lambda x: jnp.asarray(x) * (1.0 + 0.5 * s), grads)
        p, opt, m = jadamw.update(p, g, opt, jnp.asarray(s, jnp.int32),
                                  hyper, lr_scale=jnp.float32(0.5 + 0.1 * s))
        norms.append(float(m["grad_norm"]))
    return jax.tree.map(np.asarray, (p, opt)), norms


def _port_update(params, grads, steps, hyper, moment_dtype):
    # copies: the port updates in place, and a CPU tensor from numpy
    # shares the array's memory
    p = params_from_numpy(jax.tree.map(np.copy, params), "cpu")
    g0 = params_from_numpy(grads, "cpu")
    opt = tadamw.init(p, moment_dtype)
    norms = []
    for s in range(steps):
        g = tree_map(lambda x: x * (1.0 + 0.5 * s), g0)
        p, opt, m = tadamw.update(p, g, opt,
                                  torch.tensor(s, dtype=torch.int32), hyper,
                                  lr_scale=torch.tensor(0.5 + 0.1 * s))
        norms.append(float(m["grad_norm"]))
    return params_to_numpy((p, opt)), norms


def _assert_trees_close(got, want):
    want = dict(tree_paths(want))
    for path, g in tree_paths(got):
        w = want[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        tol = BF16 if w.dtype == ml_dtypes.bfloat16 else F32
        np.testing.assert_allclose(g.astype(np.float32),
                                   w.astype(np.float32),
                                   err_msg=str(path), **tol)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_adamw_update_matches_reference(moments):
    params, grads = _tree(0)
    hyper_j = jadamw.Hyper(lr=1e-2, clip_norm=2.0)
    hyper_t = tadamw.Hyper(lr=1e-2, clip_norm=2.0)
    jdt, tdt = ((jnp.float32, torch.float32) if moments == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    (pw, ow), nw = _ref_update(params, grads, 4, hyper_j, jdt)
    (pg, og), ng = _port_update(params, grads, 4, hyper_t, tdt)
    np.testing.assert_allclose(ng, nw, rtol=1e-6)
    _assert_trees_close(pg, pw)
    _assert_trees_close(og, ow)


def test_global_norm_matches_reference():
    params, grads = _tree(1)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, grads)))
    got = tadamw.global_norm(params_from_numpy(grads, "cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_layer_by_layer_update(monkeypatch):
    """Stacked leaves over _SCANNED_UPDATE_BYTES go layer by layer: the
    reference's lax.map path and the port's loop agree, and the loop
    equals the port's whole-leaf update bit for bit."""
    params, grads = _tree(2)
    hyper_j, hyper_t = jadamw.Hyper(lr=3e-3), tadamw.Hyper(lr=3e-3)
    (pw, ow), _ = _ref_update(params, grads, 3, hyper_j, jnp.float32)
    (p_whole, o_whole), _ = _port_update(params, grads, 3, hyper_t,
                                         torch.float32)
    monkeypatch.setattr(jadamw, "_SCANNED_UPDATE_BYTES", 64)
    monkeypatch.setattr(tadamw, "_SCANNED_UPDATE_BYTES", 64)
    (pw_scan, ow_scan), _ = _ref_update(params, grads, 3, hyper_j,
                                        jnp.float32)
    (p_scan, o_scan), _ = _port_update(params, grads, 3, hyper_t,
                                       torch.float32)
    _assert_trees_close(p_scan, pw_scan)
    _assert_trees_close(o_scan, ow_scan)
    _assert_trees_close(p_scan, pw)
    for (path, a), (_, b) in zip(tree_paths((p_scan, o_scan)),
                                 tree_paths((p_whole, o_whole))):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def test_update_is_in_place_and_returns_the_same_trees():
    params, grads = _tree(3)
    p = params_from_numpy(params, "cpu")
    g = params_from_numpy(grads, "cpu")
    opt = tadamw.init(p)
    embed = p["embed"]
    before = embed.clone()
    p2, opt2, _ = tadamw.update(p, g, opt, 0, tadamw.Hyper())
    assert p2 is p and opt2 is opt and p2["embed"] is embed
    assert not torch.equal(embed, before)


# ------------------------------------------------------ compressed_psum
WORLD = 4


def _psum_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(WORLD, 256)).astype(np.float32)
    res = (rng.normal(size=(WORLD, 256)) * 1e-3).astype(np.float32)
    return x, res


def _gloo_rank(rank, port, out_dir):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    try:
        x, res = _psum_inputs()
        out, nr = tcompression.compressed_psum(torch.from_numpy(x[rank]),
                                               torch.from_numpy(res[rank]))
        np.save(os.path.join(out_dir, f"out{rank}.npy"), out.numpy())
        np.save(os.path.join(out_dir, f"res{rank}.npy"), nr.numpy())
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reference_psum():
    """The reference's compressed_psum on a 4-device host mesh, run in a
    subprocess (XLA's device count is fixed at start-up)."""
    prog = textwrap.dedent("""
    import os, json
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    import sys; sys.path.insert(0, 'src')
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.optim import compression
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 256)).astype(np.float32)
    res = (rng.normal(size=(4, 256)) * 1e-3).astype(np.float32)
    mesh = compat.make_mesh((4,), ("pod",))
    f = lambda xs, rs: compression.compressed_psum(xs[0], rs[0], "pod")
    g = jax.jit(compat.shard_map(
        lambda xs, rs: tuple(o[None] for o in f(xs, rs)), mesh=mesh,
        in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")),
        check_vma=False))
    out, nr = g(jnp.asarray(x), jnp.asarray(res))
    print(json.dumps({"out": np.asarray(out).tolist(),
                      "res": np.asarray(nr).tolist()}))
    """)
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, cwd=ROOT, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    return (np.asarray(rec["out"], np.float32),
            np.asarray(rec["res"], np.float32))


def test_compressed_psum_matches_reference(tmp_path):
    import torch.multiprocessing as mp
    mp.spawn(_gloo_rank, args=(_free_port(), str(tmp_path)), nprocs=WORLD,
             join=True)
    out = np.stack([np.load(tmp_path / f"out{r}.npy") for r in range(WORLD)])
    res = np.stack([np.load(tmp_path / f"res{r}.npy") for r in range(WORLD)])
    want_out, want_res = _reference_psum()
    np.testing.assert_allclose(out, want_out, rtol=1e-6, atol=1e-7)
    # the residual target - q * scale cancels to ~1e-3 of |target| (~3):
    # XLA contracts it into one FMA, PyTorch rounds the product first, so
    # they differ by up to an ulp of |target|, 2.4e-7
    np.testing.assert_allclose(res, want_res, rtol=1e-6, atol=5e-7)
    x, r0 = _psum_inputs()
    exact = np.broadcast_to((x + r0).sum(axis=0, keepdims=True), x.shape)
    rel = np.abs(out - exact).max() / np.abs(exact).max()
    assert rel < 0.05, rel
    # every rank holds the same sum; the residual is what int8 dropped
    assert all(np.array_equal(out[0], o) for o in out)
    assert np.abs(res).max() <= np.abs(x + r0).max() / 127.0
