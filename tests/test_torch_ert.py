"""The ERT micro-kernels' plain versions against the reference's jnp
oracles (``repro.kernels.ert.ref``), the analytic byte/FLOP models against
the reference's, and the CPU side of the wrappers and the ERT driver.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each one against these plain versions there.

Tolerances: f32 rtol 1e-5 (both sides round the same ops in f32; XLA may
contract a multiply-add into one rounding); bf16 is compared in f32 with
rtol 1e-2 (bf16 keeps 8 mantissa bits, and the two frameworks may round
an intermediate at different places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import config as r_config
from repro.kernels.ert import bandwidth as r_bw
from repro.kernels.ert import flops as r_flops
from repro.kernels.ert import gemm as r_gemm
from repro.kernels.ert import ref as r_ref
from repro_torch.kernels import config as p_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ert import bandwidth, flops, gemm, ops, ref

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 1e-2)}


def _pair(arr: np.ndarray, dtype: str):
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(arr).to(tdt), jnp.asarray(arr, dtype=jdt)


def _close(t: torch.Tensor, j, rtol: float, atol: float = 0.0) -> None:
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, dtype=np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1000, 16385])
def test_triad_plain_matches_reference(dtype, n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    (ta, ja), (tb, jb) = _pair(a, dtype), _pair(b, dtype)
    rtol = DTYPES[dtype][2]
    _close(ref.triad_ref(ta, tb), r_ref.triad_ref(ja, jb), rtol, atol=rtol)
    _close(ref.triad_ref(ta, tb, 0.5), r_ref.triad_ref(ja, jb, 0.5), rtol,
           atol=rtol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ilp", [1, 4, 8])
@pytest.mark.parametrize("n", [1000, 16385])
def test_fma_chain_plain_matches_reference(dtype, ilp, n):
    rng = np.random.default_rng(ilp * n)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    tx, jx = _pair(x, dtype)
    _close(ref.fma_chain_ref(tx, 16, ilp), r_ref.fma_chain_ref(jx, 16, ilp),
           DTYPES[dtype][2], atol=DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("size", [128, 256])
def test_matmul_plain_matches_reference(dtype, size):
    rng = np.random.default_rng(size)
    a = rng.standard_normal((size, size)).astype(np.float32)
    b = rng.standard_normal((size, size)).astype(np.float32)
    (ta, ja), (tb, jb) = _pair(a, dtype), _pair(b, dtype)
    rtol = DTYPES[dtype][2]
    # the accumulator is f32 on both sides; only the summation order differs
    _close(ref.matmul_ref(ta, tb), r_ref.matmul_ref(ja, jb), rtol,
           atol=rtol * np.sqrt(size))
    _close(ref.matmul_ref(ta, tb, torch.float32),
           r_ref.matmul_ref(ja, jb, jnp.float32), 1e-5,
           atol=1e-4 * np.sqrt(size))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,n,k", [(1000, 1000, 1000), (200, 264, 72),
                                   (130, 8, 520)])
def test_matmul_plain_matches_reference_ragged(dtype, m, n, k):
    # shapes off the kernel's 128 x 256 x 64 tile, as the CUDA kernel takes
    rng = np.random.default_rng(m * n + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    (ta, ja), (tb, jb) = _pair(a, dtype), _pair(b, dtype)
    rtol = DTYPES[dtype][2]
    got = ref.matmul_ref(ta, tb)
    assert got.shape == (m, n) and got.dtype == ta.dtype
    _close(got, r_ref.matmul_ref(ja, jb), rtol, atol=rtol * np.sqrt(k))
    _close(ref.matmul_ref(ta, tb, torch.float32),
           r_ref.matmul_ref(ja, jb, jnp.float32), 1e-5,
           atol=1e-4 * np.sqrt(k))


#: the fp32 kernel's compiled tile (``csrc/ert.cu``, ``ert_gemm_tile(3..5)``)
F32_TILE = (128, 128, 32)


@pytest.mark.parametrize("m,n,k,dtype", [
    (8192, 8192, 8192, torch.bfloat16), (1000, 1000, 1000, torch.bfloat16),
    (256, 384, 96, torch.float16), (1, 8, 8, torch.bfloat16),
    (2048, 2048, 2048, torch.float32), (128, 256, 64, torch.float32)])
def test_gemm_launch_rules_accept(m, n, k, dtype):
    gemm.check_launch(m, n, k, dtype, F32_TILE,
                      (0x7F0000000000, 0x7F0000100000))


@pytest.mark.parametrize("m,n,k,dtype,match", [
    (1000, 1004, 1000, torch.bfloat16, "16-byte rows"),     # N % 8
    (1000, 1000, 1001, torch.float16, "16-byte rows"),      # K % 8
    (0, 8, 8, torch.bfloat16, "non-empty"),
    (1000, 1000, 1000, torch.float32, "fp32 needs"),        # off its tile
    (128, 256, 48, torch.float32, "fp32 needs")])
def test_gemm_launch_rules_refuse(m, n, k, dtype, match):
    with pytest.raises(ValueError, match=match):
        gemm.check_launch(m, n, k, dtype, F32_TILE)


def test_gemm_launch_rules_refuse_a_misaligned_view():
    # a contiguous view one element into its storage: rows of 16 bytes,
    # but a base TMA cannot read
    flat = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16)
    a, b = flat[1:].view(64, 64), flat[:-1].view(64, 64)
    assert a.is_contiguous() and a.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="aligned"):
        gemm.check_launch(64, 64, 64, a.dtype, F32_TILE,
                          (a.data_ptr(), b.data_ptr()))
    gemm.check_launch(64, 64, 64, b.dtype, F32_TILE,
                      (b.data_ptr(), b.data_ptr()))


@pytest.mark.parametrize("n,itemsize,iters,ilp,m,k", [
    (1000, 4, 64, 4, 128, 256), (1 << 26, 2, 1024, 8, 8192, 8192),
    (16385, 4, 1, 1, 512, 96)])
def test_analytic_models_equal_reference(n, itemsize, iters, ilp, m, k):
    assert bandwidth.triad_bytes(n, itemsize) == r_bw.triad_bytes(n, itemsize)
    assert bandwidth.triad_flops(n) == r_bw.triad_flops(n)
    assert flops.fma_flops(n, iters, ilp) == r_flops.fma_flops(n, iters, ilp)
    assert gemm.gemm_flops(m, m, k) == r_gemm.gemm_flops(m, m, k)


def test_cpu_wrappers_take_plain_path_without_counting():
    reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand(999, generator=g), torch.rand(999, generator=g)
    assert torch.equal(bandwidth.triad(a, b, reps=3, block=8,
                                       double_buffer=True),
                       ref.triad_ref(a, b))
    x = torch.rand(1001, generator=g, dtype=torch.float32)
    assert torch.equal(flops.fma_chain(x, 8, 2, block=64),
                       ref.fma_chain_ref(x, 8, 2))
    m = torch.rand(64, 32, generator=g).to(torch.bfloat16)
    w = torch.rand(32, 48, generator=g).to(torch.bfloat16)
    assert torch.equal(gemm.matmul(m, w, out_dtype=torch.float32),
                       ref.matmul_ref(m, w, torch.float32))
    counts = launch_counts()
    assert {k: counts[k] for k in ("triad", "fma_chain", "ert_gemm")} == \
        {"triad": 0, "fma_chain": 0, "ert_gemm": 0}


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    a = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bandwidth.triad(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        flops.fma_chain(a, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        gemm.matmul(a.view(8, 8), a.view(8, 8))


def test_wrappers_validate_operands():
    with pytest.raises(ValueError, match="differ"):
        bandwidth.triad(torch.zeros(4), torch.zeros(5))
    with pytest.raises(ValueError, match="shapes"):
        gemm.matmul(torch.zeros(4, 3), torch.zeros(4, 3))
    with pytest.raises(ValueError, match="not compiled"):
        flops.fma_chain(torch.empty(8, device="meta"), 4, 3)


def test_kernel_names_line_up_with_reference():
    assert p_config.KERNELS == r_config.KERNELS
    assert set(p_config.DEFAULTS) == set(r_config.KERNELS)
    cfg = p_config.resolve("ert_gemm", None, block_m=64)
    assert cfg.get("block_m") == 64 and cfg.get("block_k") == 64
    assert p_config.resolve("ert_gemm", cfg) == cfg
    assert p_config.resolve("ssd_scan", None).get("chunk") == \
        r_config.DEFAULTS["ssd_scan"].get("chunk") == 128
    with pytest.raises(KeyError, match="unknown kernel"):
        p_config.resolve("fused_layernorm", None)
    with pytest.raises(ValueError, match="passed to"):
        p_config.resolve("triad", p_config.DEFAULTS["fma_chain"])


def test_characterize_on_host_returns_measured_spec():
    spec = ops.characterize(device="cpu", smoke=True)
    assert spec.empirical and spec.name == "cpu-host"
    assert set(spec.peak_flops) == {"f32", "bf16", "int8"}
    assert all(v > 0 for v in spec.peak_flops.values())
    assert [lv.name for lv in spec.mem_levels] == ["vmem", "hbm"]
    assert all(lv.bytes_per_s > 0 for lv in spec.mem_levels)


def test_characterize_tuned_needs_the_tune_store(tmp_path):
    # tuned=True takes every ceiling from the store's winners; with every
    # ceiling point stored it times nothing
    from repro_torch.tune.search import ceiling_shapes
    from repro_torch.tune.store import TuneStore, make_record
    store = TuneStore(str(tmp_path / "tune.json"))
    shapes = ceiling_shapes(smoke=True)
    for kernel, shape, dtype, metric in (
            ("fma_chain", shapes["flops_n"], "float32", 7e9),
            ("fma_chain", shapes["flops_n"], "bfloat16", 5e9),
            ("ert_gemm", shapes["gemm"], "bfloat16", 9e9),
            ("triad", shapes["bw_hbm"], "float32", 2e10),
            ("triad", shapes["bw_vmem"], "float32", 8e10)):
        store.put(make_record(kernel, shape, dtype, "cpu-host", "torch", {},
                              1e-3, metric, "x", 1e-3, metric, 1))
    spec = ops.characterize(device="cpu", tuned=True, smoke=True,
                            store=store)
    assert spec.empirical and spec.peak_flops["f32"] == 7e9
    assert spec.peak_flops["bf16"] == 9e9
    assert (spec.hbm.bytes_per_s, spec.vmem.bytes_per_s) == (2e10, 8e10)


def test_ladder_and_sweep_on_host():
    lad = ops.ladder("cpu", ops.SMOKE)
    assert list(lad) == ["v1 fp32 chain (ilp=1)", "v2 fp32 chain (ilp=8)",
                         "v3 bf16 packed chain (ilp=8)",
                         "v4 tensor-core gemm 128", "v5 tensor-core gemm 256"]
    assert all(v > 0 for v in lad.values())
    sweep = ops.gemm_size_sweep(ops.SMOKE.gemm_sweep, device="cpu")
    assert list(sweep) == [128, 256] and all(v > 0 for v in sweep.values())


def test_full_sizes_give_each_launch_real_work():
    full = ops.FULL
    # HBM triad: 3 arrays well past the 50 MB L2; L2 triad inside it
    assert 3 * full.hbm_n * 4 >= 3 * 64 * 2**20
    assert 3 * full.l2_n * 4 <= 25 * 2**20
    # ~1 ms or more at the datasheet rates
    assert flops.fma_flops(full.chain_n, full.chain_iters, 8) / 67e12 > 1e-3
    assert bandwidth.triad_bytes(full.hbm_n, 4) * full.hbm_reps / 3.35e12 > 1e-3
    assert gemm.gemm_flops(*(full.gemm_ceiling,) * 3) / 989e12 > 1e-3


def test_the_triad_takes_a_counter_a_launch_and_a_grid_that_fits():
    """The bulk-copy triad claims its chunks from a counter the wrapper
    zeroes for each call (no module-global state shared by launches on
    different streams), and the default grid is one the SMs hold at once:
    ``ert_triad`` refuses a larger one rather than cutting it."""
    import re

    from repro_torch.kernels import build
    from repro_torch.tune import space
    src = (build.CSRC / "ert.cu").read_text()
    assert "__device__ unsigned long long" not in src
    assert re.search(r"int ert_triad\([^)]*void\* next,\s*void\* stream\)",
                     src)
    assert len(build._SIGNATURES["ert"]["ert_triad"]) == 11
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (kTriadStages|kTriadChunk) = (\d+);", src)}
    ring = consts["kTriadStages"] * 2 * consts["kTriadChunk"] + 64
    # an H100 SM has 228 KiB of shared memory, 1 KiB of it reserved a block
    fit = (228 * 1024) // (ring + 1024)
    assert fit == 2 == p_config.DEFAULTS["triad"].get("blocks_per_sm") == \
        max(space.TRIAD_BLOCKS_PER_SM)
    assert "blocks > sms * per_sm" in src
