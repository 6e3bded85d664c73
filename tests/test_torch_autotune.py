"""The port's autotune registry, block-size resolution and platform set-up.

Ported from ``tests/test_autotune.py`` against ``repro_torch``: cache
hits skip re-timing, keys discriminate backend/dtype, corrupt registries
degrade to defaults, candidates respect each kernel's shared-memory
formula, and the ops wrappers resolve explicit > registry > default
without snapping.  One test holds a registry written by ``repro``
against the port's reader.
"""
import json
import os

import jax.numpy as jnp
import pytest
import torch

from repro.kernels import autotune as jat

from repro_torch.kernels import autotune as at
from repro_torch.kernels.flash_attention import flash_attention as fa_ker
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.kmeans import kmeans as km_ker
from repro_torch.kernels.kmeans import ops as km
from repro_torch.kernels.mamba_scan import mamba_scan as ms_ker
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.launch import platform

CUDA = torch.device("cuda")   # a key axis only: nothing here runs on it


@pytest.fixture
def registry_env(tmp_path, monkeypatch):
    """The process-wide registry at a fresh path, restored afterwards."""
    monkeypatch.setenv("REPRO_AUTOTUNE_REGISTRY",
                       str(tmp_path / "autotune.json"))
    yield at.default_registry(reload=True)
    monkeypatch.delenv("REPRO_AUTOTUNE_REGISTRY")
    at.default_registry(reload=True)


def _put(reg, kernel, shape, config, dtype=torch.float32, device=CUDA):
    key = at.Registry.key(kernel, at.shape_bucket(kernel, shape),
                          at.backend_tag(device), at.dtype_name(dtype))
    reg.put(key, {"config": config})


# ------------------------------------------------------------- snapping
def test_snap_block_divides():
    assert at.snap_block(1024, 256) == 256
    assert at.snap_block(384, 256) == 192
    assert at.snap_block(100, 64) == 50
    assert at.snap_block(7, 512) == 7
    assert at.snap_block(13, 4) == 1
    for n in (48, 384, 1000, 4096):
        for cap in (8, 64, 256, 2048):
            b = at.snap_block(n, cap)
            assert n % b == 0 and 1 <= b <= min(cap, n)
            assert b == jat.snap_block(n, cap)


def test_shape_bucket_pow2_rounds():
    b1 = at.shape_bucket("flash_attention", {"S_q": 1000, "hd": 64})
    b2 = at.shape_bucket("flash_attention", {"S_q": 1024, "hd": 64})
    b3 = at.shape_bucket("flash_attention", {"S_q": 2048, "hd": 64})
    assert b1 == b2 != b3
    assert b1 == jat.shape_bucket("flash_attention", {"S_q": 1000, "hd": 64})


# ------------------------------------------------------------- registry
def test_corrupt_registry_falls_back_to_defaults(tmp_path):
    bad = tmp_path / "autotune.json"
    bad.write_text("{not json")
    reg = at.Registry(str(bad))
    assert reg.corrupt and len(reg) == 0
    bad.write_text(json.dumps({"k": "not-a-dict"}))
    assert at.Registry(str(bad)).corrupt


def test_missing_registry_is_empty_not_error(tmp_path):
    reg = at.Registry(str(tmp_path / "nope" / "autotune.json"))
    assert not reg.corrupt and len(reg) == 0


def test_registry_roundtrip(tmp_path):
    path = str(tmp_path / "autotune.json")
    reg = at.Registry(path)
    reg.put("k", {"config": {"bq": 128}})
    reg.save()
    assert at.Registry(path).get("k") == {"config": {"bq": 128}}
    assert not any(".tmp." in f for f in os.listdir(tmp_path))  # atomic


def test_key_includes_backend_and_dtype():
    keys = {at.Registry.key("flash_attention", "S1024",
                            at.backend_tag(dev), at.dtype_name(dt))
            for dev in ("cpu", "cuda")
            for dt in (torch.float32, torch.bfloat16)}
    assert len(keys) == 4
    assert at.backend_tag("cuda:0") == "cuda"
    assert at.backend_tag(torch.device("cpu")) == "cpu+plain"
    with pytest.raises(ValueError):
        at.backend_tag("meta")
    assert at.dtype_name(torch.bfloat16) == "bfloat16"


def test_lookup_respects_dtype_and_device_axes(registry_env):
    shape = {"S_q": 1024, "S_k": 1024, "hd": 64}
    _put(registry_env, "flash_attention", shape, {"bq": 64, "bk": 64})
    assert at.lookup("flash_attention", shape, torch.float32, CUDA) == \
        {"bq": 64, "bk": 64}
    # same shape, other dtype or the plain version's backend: miss
    assert at.lookup("flash_attention", shape, torch.bfloat16, CUDA) is None
    assert at.lookup("flash_attention", shape, torch.float32, "cpu") is None


# ---------------------------------------------------------- cache skips
def test_cache_hit_skips_retiming(tmp_path, monkeypatch):
    reg = at.Registry(str(tmp_path / "autotune.json"))
    calls = {"n": 0}
    real = at._time_call

    def counting(fn, reps, device):
        calls["n"] += 1
        return real(fn, reps, device)

    monkeypatch.setattr(at, "_time_call", counting)
    shape = {"n": 256, "k": 8, "d": 3}
    first = at.autotune("kmeans", shape, device="cpu", reps=1, registry=reg)
    assert first["trials"] > 0 and not first["cached"]
    assert first["key"].split("|")[2] == "cpu+plain"
    n_after_first = calls["n"]
    assert n_after_first == first["trials"]

    second = at.autotune("kmeans", shape, device="cpu", reps=1,
                         registry=reg)
    assert second["cached"] and second["trials"] == 0
    assert calls["n"] == n_after_first
    assert second["config"] == first["config"]

    forced = at.autotune("kmeans", shape, device="cpu", reps=1,
                         registry=reg, force=True)
    assert not forced["cached"] and calls["n"] > n_after_first


def test_autotune_winner_never_worse_than_default(tmp_path):
    reg = at.Registry(str(tmp_path / "autotune.json"))
    rec = at.autotune("kmeans", {"n": 256, "k": 8, "d": 3}, device="cpu",
                      reps=1, registry=reg)
    assert rec["speedup_vs_default"] >= 1.0 - 1e-9
    assert rec["default_config"] == at.DEFAULTS["kmeans"]


@pytest.mark.parametrize("kernel,shape,dims", [
    ("flash_attention", {"B": 1, "H": 1, "S_q": 40, "S_k": 40, "hd": 32,
                         "window": 8}, ("S_q", "S_k", "hd")),
    ("mamba_scan", {"B": 1, "S": 24, "di": 6, "st": 4}, ("S", "di", "st")),
])
def test_tuned_entry_is_found_by_the_wrapper(registry_env, kernel, shape,
                                             dims):
    """The key is bucketed over the dims the ops wrapper looks up, not
    over B, H or the mask, so the wrapper finds what the tuner wrote."""
    rec = at.autotune(kernel, shape, device="cpu", reps=1,
                      max_candidates=3)
    assert not rec["cached"]
    assert rec["key"].split("|")[1] == at.shape_bucket(
        kernel, {d: shape[d] for d in dims})
    mod = fa if kernel == "flash_attention" else ms
    got = mod.resolve_blocks(*(shape[d] for d in dims), torch.float32,
                             torch.device("cpu"), None, None)
    assert got == tuple(rec["config"].values())


def test_main_cli_on_the_cpu(tmp_path, capsys):
    argv = ["kmeans", "--device", "cpu", "--reps", "1", "--registry",
            str(tmp_path / "r.json"), "--shapes",
            json.dumps({"n": 128, "k": 8, "d": 3})]
    first = at.main(argv)
    second = at.main(argv)
    assert first[0]["trials"] > 0 and second[0]["cached"]
    assert second[0]["trials"] == 0
    assert "kmeans:" in capsys.readouterr().out


# ----------------------------------------------------------- candidates
def test_candidates_respect_smem_budget():
    for hd in (32, 64, 128):
        cands = at.candidates_flash(4096, 4096, hd)
        assert cands and at.DEFAULTS["flash_attention"] in cands
        for c in cands:
            # the query tile + 2 stages of K and V, f32 rows padded 16 B
            smem = (c["bq"] + 4 * c["bk"]) * (4 * hd + 16)
            assert smem <= at.SMEM_OPTIN_MAX_BYTES <= 232_448
            assert c["bq"] % 16 == 0 and c["bq"] <= fa_ker.MAX_BQ
            assert c["bk"] in fa_ker.BK_BUILT
            assert fa_ker.accepts(c["bq"], c["bk"], hd)
    small = at.candidates_flash(4096, 4096, 64, budget=48 * 1024)
    assert small and all(fa_ker.smem_bytes(c["bq"], c["bk"], 64)
                         <= 48 * 1024 for c in small)
    assert not at.candidates_flash(4096, 4096, 128, budget=48 * 1024)
    for d in (3, 16, 32):
        for c in at.candidates_kmeans(100_000, 5_000, d):
            # bk packed centroids of ceil((d + 1) / 4) float4s each
            assert 16 * c["bk"] * ((d + 4) // 4) <= at.SMEM_DEFAULT_BYTES
            assert c["bn"] <= km_ker.MAX_THREADS
            assert km_ker.accepts(c["bn"], c["bk"], d)
        assert at.DEFAULTS["kmeans"] in at.candidates_kmeans(100_000,
                                                             5_000, d)
    assert max(c["bk"] for c in at.candidates_kmeans(10, 5_000, 32)) < \
        max(c["bk"] for c in at.candidates_kmeans(10, 5_000, 3))


def test_candidates_mamba_fit_the_block():
    for st_ in (2, 4, 8, 16, 32):
        cands = at.candidates_mamba(4096, 3200, st_)
        assert cands
        for c in cands:
            assert ms_ker.threads(c["bdi"], st_) <= ms_ker.MAX_THREADS
            assert c["bs"] in ms_ker.BS_BUILT


# --------------------------------------------------- ops wrapper consult
def test_ops_wrappers_consult_registry(registry_env):
    _put(registry_env, "flash_attention", {"S_q": 256, "S_k": 256, "hd": 64},
         {"bq": 64, "bk": 32})
    _put(registry_env, "mamba_scan", {"S": 256, "di": 512, "st": 16},
         {"bdi": 4, "bs": 16})
    _put(registry_env, "kmeans", {"n": 1000, "k": 50, "d": 3},
         {"bn": 128, "bk": 64})
    f32 = torch.float32
    assert fa.resolve_blocks(256, 256, 64, f32, CUDA, None, None) == (64, 32)
    assert fa.resolve_blocks(256, 256, 64, f32, CUDA, 32, None) == (32, 32)
    assert ms.resolve_blocks(256, 512, 16, f32, CUDA, None, None) == (4, 16)
    assert ms.resolve_blocks(256, 512, 16, f32, CUDA, None, 4) == (4, 4)
    assert km.resolve_blocks(1000, 50, 3, f32, CUDA, None, None) == (128, 64)
    assert km.resolve_blocks(1000, 50, 3, f32, CUDA, 512, None) == (512, 64)


@pytest.mark.parametrize("config", [{"bq": 256, "bk": 32},
                                    {"bq": 128, "bk": 16},
                                    {"bq": 40, "bk": 64}, {"bq": 128}],
                         ids=["bq256", "bk16", "bq40", "no-bk"])
def test_flash_registry_entry_the_kernel_cannot_take_is_a_miss(
        registry_env, config):
    """An entry tuned for an older kernel (a 256-thread bq, a 16-key
    tile) resolves to DEFAULTS instead of raising at launch; explicit
    arguments still win."""
    _put(registry_env, "flash_attention", {"S_q": 4096, "S_k": 4096,
                                           "hd": 64}, config)
    f32, d = torch.float32, at.DEFAULTS["flash_attention"]
    assert at.lookup("flash_attention", {"S_q": 4096, "S_k": 4096,
                                         "hd": 64}, f32, CUDA) == config
    assert fa.resolve_blocks(4096, 4096, 64, f32, CUDA, None, None) == \
        (d["bq"], d["bk"])
    assert fa.resolve_blocks(4096, 4096, 64, f32, CUDA, 32, None) == \
        (32, d["bk"])


@pytest.mark.parametrize("config", [{"bn": 1024, "bk": 64},
                                    {"bn": 100, "bk": 64},
                                    {"bn": 128, "bk": 30},
                                    {"bn": 128, "bk": 4096}, {"bn": 128}],
                         ids=["bn1024", "bn100", "bk30", "bk4096", "no-bk"])
def test_kmeans_registry_entry_the_kernel_cannot_take_is_a_miss(
        registry_env, config):
    """An entry the scan does not take (more than 512 threads, a part
    warp, bk off the 4-centroid groups, a tile over 48 KB) resolves to
    DEFAULTS instead of raising at launch; explicit arguments still win."""
    shape = {"n": 10_000, "k": 5_000, "d": 3}
    _put(registry_env, "kmeans", shape, config)
    f32, d = torch.float32, at.DEFAULTS["kmeans"]
    assert at.lookup("kmeans", shape, f32, CUDA) == config
    assert not km_ker.accepts(config["bn"], config.get("bk", 0), 3)
    assert km.resolve_blocks(10_000, 5_000, 3, f32, CUDA, None, None) == \
        (d["bn"], d["bk"])
    assert km.resolve_blocks(10_000, 5_000, 3, f32, CUDA, 64, None) == \
        (64, d["bk"])


def test_ops_wrappers_default_without_registry(registry_env):
    f32 = torch.float32
    d = at.DEFAULTS
    assert fa.resolve_blocks(1024, 1024, 64, f32, CUDA, None, None) == \
        (d["flash_attention"]["bq"], d["flash_attention"]["bk"])
    assert ms.resolve_blocks(256, 512, 16, f32, CUDA, None, None) == \
        (d["mamba_scan"]["bdi"], d["mamba_scan"]["bs"])
    assert km.resolve_blocks(10_000, 5_000, 3, f32, CUDA, None, None) == \
        (d["kmeans"]["bn"], d["kmeans"]["bk"])  # the K-Means main path's


def test_resolve_blocks_does_not_snap(registry_env):
    """A prime S keeps the default blocks; the reference snaps to 1."""
    f32 = torch.float32
    assert fa.resolve_blocks(1021, 1021, 64, f32, CUDA, None, None) == \
        tuple(at.DEFAULTS["flash_attention"].values())
    assert ms.resolve_blocks(1021, 1021, 16, f32, CUDA, None, None) == \
        tuple(at.DEFAULTS["mamba_scan"].values())
    assert jat.snap_block(1021, 256) == 1


# ------------------------------------------------------- cross-package
def test_registry_written_by_the_reference_loads_in_the_port(tmp_path):
    path = str(tmp_path / "autotune.json")
    shape = {"n": 128, "k": 8, "d": 3}
    rec = jat.autotune("kmeans", shape, dtype=jnp.float32, reps=1,
                       registry=jat.Registry(path), max_candidates=2)
    on_disk = json.loads(open(path).read())
    reg = at.Registry(path)
    assert not reg.corrupt and len(reg) == len(on_disk) == 1
    assert reg.get(rec["key"]) == on_disk[rec["key"]]
    # the same key format: the port forms the reference's key exactly
    kernel, bucket, backend, dtype = rec["key"].split("|")
    assert backend == "cpu+interpret"
    assert at.Registry.key("kmeans", at.shape_bucket("kmeans", shape),
                           backend, dtype) == rec["key"]


def test_port_ignores_reference_interpret_entries(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    shape = {"n": 1000, "k": 50, "d": 3}
    key = jat.Registry.key("kmeans", jat.shape_bucket("kmeans", shape),
                           "cpu+interpret", "float32")
    path.write_text(json.dumps({key: {"config": {"bn": 64, "bk": 64}}}))
    monkeypatch.setenv("REPRO_AUTOTUNE_REGISTRY", str(path))
    try:
        at.default_registry(reload=True)
        for dev in ("cpu", "cuda"):
            assert at.lookup("kmeans", shape, torch.float32, dev) is None
            assert km.resolve_blocks(1000, 50, 3, torch.float32,
                                     torch.device(dev), None, None) == \
                tuple(at.DEFAULTS["kmeans"].values())
    finally:
        monkeypatch.delenv("REPRO_AUTOTUNE_REGISTRY")
        at.default_registry(reload=True)


# ------------------------------------------------------------ platform
@pytest.fixture
def clean_platform(monkeypatch):
    monkeypatch.delenv("REPRO_PLATFORM", raising=False)
    monkeypatch.delenv("CUDA_MODULE_LOADING", raising=False)
    monkeypatch.setattr(platform, "_configured", None)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32


def test_backend_defaults_to_cuda(clean_platform, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")   # read by the reference only
    assert platform.backend() == "cuda"
    monkeypatch.setenv("REPRO_PLATFORM", "CPU")
    assert platform.backend() == "cpu"


def test_configure_is_idempotent(clean_platform, monkeypatch):
    torch.backends.cudnn.allow_tf32 = True
    assert platform.configure() == "cuda"
    assert os.environ["CUDA_MODULE_LOADING"] == "LAZY"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    monkeypatch.setenv("CUDA_MODULE_LOADING", "EAGER")
    assert platform.configure() == "cuda"          # second call: no-op
    assert torch.backends.cudnn.allow_tf32
    assert os.environ["CUDA_MODULE_LOADING"] == "EAGER"
    platform.configure(force=True)                 # a user's value wins
    assert os.environ["CUDA_MODULE_LOADING"] == "EAGER"
    assert not torch.backends.cudnn.allow_tf32
    assert platform.configure("cpu") == "cpu"


# ------------------------------------------------- K3's fused mode blocks
def test_fused_mode_has_its_own_key_and_defaults(registry_env):
    """Blocks tuned for K3's (a, b) mode are never applied to the fused
    mode: it reads its own ``mamba_scan_fused`` entry, else its own
    defaults; explicit arguments still win."""
    f32, d = torch.float32, at.DEFAULTS["mamba_scan_fused"]
    shape = {"S": 2048, "di": 3200, "st": 16}
    _put(registry_env, "mamba_scan", shape, {"bdi": 4, "bs": 4})
    assert ms.resolve_blocks(2048, 3200, 16, f32, CUDA, None, None) == (4, 4)
    assert ms.resolve_fused_blocks(2048, 3200, 16, CUDA, None, None) == \
        (d["bdi"], d["bs"])
    _put(registry_env, "mamba_scan_fused", shape, {"bdi": 32, "bs": 64})
    assert ms.resolve_fused_blocks(2048, 3200, 16, CUDA, None, None) == \
        (32, 64)
    assert ms.resolve_fused_blocks(2048, 3200, 16, CUDA, 64, None) == \
        (64, 64)
    assert ms.resolve_blocks(2048, 3200, 16, f32, CUDA, None, None) == (4, 4)
    assert at.KEY_DIMS["mamba_scan_fused"] == at.KEY_DIMS["mamba_scan"]


@pytest.mark.parametrize("config", [{"bdi": 200, "bs": 16},
                                    {"bdi": 16, "bs": 8},
                                    {"bdi": 0, "bs": 4},
                                    {"bdi": -4, "bs": 32}, {"bdi": 16}],
                         ids=["bdi200", "bs8", "auto-bs4", "bdi-4", "no-bs"])
def test_fused_registry_entry_the_kernel_cannot_take_is_a_miss(
        registry_env, config):
    """An entry the fused mode is not built for (over 512 threads, a
    chunk it has no instance of, a negative row count, a missing key)
    resolves to its defaults instead of raising at launch."""
    _put(registry_env, "mamba_scan_fused", {"S": 2048, "di": 3200,
                                            "st": 16}, config)
    d = at.DEFAULTS["mamba_scan_fused"]
    assert ms.resolve_fused_blocks(2048, 3200, 16, CUDA, None, None) == \
        (d["bdi"], d["bs"])


def test_candidates_mamba_fused_fit_the_kernel():
    for st_ in (1, 2, 4, 5, 8, 16, 32):
        cands = at.candidates_mamba_fused(2048, 3200, st_)
        assert at.DEFAULTS["mamba_scan_fused"] in cands
        for c in cands:
            if c["bdi"] == 0:           # balanced rows, worked out later
                assert c["bs"] in ms_ker.FUSED_BS_BUILT
                continue
            assert ms_ker.fused_accepts(c["bdi"], st_, c["bs"])
            assert ms_ker.fused_threads(c["bdi"], st_) <= ms_ker.MAX_THREADS
            assert ms_ker.fused_smem_bytes(c["bdi"], st_, c["bs"]) <= \
                ms_ker.FUSED_MAX_SMEM
    # rows capped at the bucketed d_inner
    assert max(c["bdi"] for c in at.candidates_mamba_fused(64, 6, 16)) == 8


def test_fused_family_tunes_into_its_own_key(registry_env):
    """``autotune("mamba_scan_fused")`` on the CPU (the plain versions):
    its key is the fused family's, bucketed over (S, di, st), f32 even
    when asked for bf16, and the fused wrapper resolves the winner."""
    shape = {"B": 1, "S": 24, "di": 6, "st": 4}
    rec = at.autotune("mamba_scan_fused", shape, device="cpu", reps=1,
                      max_candidates=3, dtype=torch.bfloat16)
    assert not rec["cached"] and rec["trials"] > 0
    kernel, bucket, backend, dtype = rec["key"].split("|")
    assert (kernel, backend, dtype) == ("mamba_scan_fused", "cpu+plain",
                                        "float32")
    assert bucket == at.shape_bucket("mamba_scan_fused",
                                     {"S": 24, "di": 6, "st": 4})
    assert ms.resolve_fused_blocks(24, 6, 4, torch.device("cpu"), None,
                                   None) == tuple(rec["config"].values())
    assert "mamba_scan_fused" in at.KERNELS
