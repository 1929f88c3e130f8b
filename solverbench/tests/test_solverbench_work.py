"""The frozen work counts of Algorithm 2, against figures worked by hand."""
from sbtest import spec

work = spec.work_counter("bakp_stream")
H100 = spec.peaks("NVIDIA H100 80GB HBM3")
L2 = H100["l2_bytes"]
GIB = 1 << 30


def test_p2_group_of_16_in_11_sweeps():
    # x = 262,144 x 1,024 fp32 = 1 GiB, over the L2: read every sweep.
    # y and the residual 2 x 16 x 262,144 x 4 = 32 MiB, coef 16 x 1,024 x 4.
    nbytes, flops = work(262144, 1024, 16, 11, 4, L2)
    assert nbytes == 11 * GIB + 2 * 16 * 262144 * 4 + 16 * 1024 * 4
    assert flops == 11 * 4 * 1024 * 262144 * 16
    t_bytes = nbytes / 3.35e12        # 3.5358 ms
    t_flops = flops / 67e12           # 2.8206 ms: bytes bound it
    assert abs(t_bytes - 3.5358e-3) < 1e-7
    assert abs(t_flops - 2.8206e-3) < 1e-7


def test_tall_group_of_16_in_7_sweeps():
    # The configuration's own system, unpadded: x = 1e6 x 1,000 fp32 = 4 GB,
    # over the L2. The engine's padding to 2^20 x 1,024 is not the
    # algorithm's work, so it counts as a loss against this bound.
    nbytes, flops = work(1_000_000, 1000, 16, 7, 4, L2)
    assert nbytes == 7 * 4_000_000_000 + 2 * 16 * 1_000_000 * 4 + 16 * 1000 * 4
    assert flops == 7 * 4 * 1000 * 1_000_000 * 16
    assert abs(nbytes / 3.35e12 - 8.3964e-3) < 1e-7   # bytes bound it
    assert abs(flops / 67e12 - 6.6866e-3) < 1e-7


def test_p3_group_of_16_in_35_sweeps():
    # x = 16,384 x 4,096 fp32 = 256 MiB, over the L2.
    nbytes, flops = work(16384, 4096, 16, 35, 4, L2)
    assert nbytes == 35 * (GIB // 4) + 2 * 16 * 16384 * 4 + 16 * 4096 * 4
    assert flops == 35 * 4 * 4096 * 16384 * 16
    assert abs(nbytes / 3.35e12 - 2.8058e-3) < 1e-6   # bytes bound it
    assert abs(flops / 67e12 - 2.2439e-3) < 1e-6


def test_x_within_l2_read_once():
    # 4,096 x 256 fp32 = 4 MiB stays in the L2 between sweeps.
    nbytes, _ = work(4096, 256, 1, 20, 4, L2)
    assert nbytes == 4096 * 256 * 4 + 4 * (2 * 4096 + 256)


def test_one_sweep_matches_bound_ms():
    import importlib.util
    s = importlib.util.spec_from_file_location(
        "alg2", spec.BENCH_DIR / "work" / "algorithm2.py")
    alg2 = importlib.util.module_from_spec(s)
    s.loader.exec_module(alg2)
    # PERF.md's bakp_sweep row: p2 k 8 bound 0.326 ms (bytes).
    nb = alg2.sweep_bytes(262144, 1024, 8, 4)
    flops = alg2.sweep_flops(262144, 1024, 8)
    ms = max(nb / H100["hbm_bytes_per_s"], flops / H100["fp32_flops_per_s"])
    assert abs(ms * 1e3 - 0.326) < 0.001
