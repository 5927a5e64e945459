"""Smoke run of the PyTorch / CUDA port (periodicity_tpu_torch) on one GPU.

Drives the GLS main path, ``GLS()(TSeries(t, y))`` and ``gls_power`` at
the benchmark shape (N = 1e5 samples over a 1000-day baseline, 1e6 trial
frequencies), through the hand-written CUDA spreading kernel, and checks
every phase:

1. a CUDA device is present; the card's name and power limit;
2. the kernel library builds from ``periodicity_tpu_torch/csrc``;
3. the kernel agrees with its plain PyTorch version at the main-path
   shapes (2^23 and 2^22 cells), and on a clustered draw;
4. ``GLS()(TSeries(t, y))`` on the card finds the injected 7.7-day period,
   through exactly two kernel launches;
5. float32 ``gls_power`` with the kernel agrees with float64 on the card
   at the benchmark shape; on a small input, float32 agrees with float64
   and the fast path with the exact direct method;
6. times: kernel vs plain, chained periodograms, peak device memory.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (one GPU).
Any failure raises and the exit code is non-zero. The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import statistics
import subprocess
import sys

import numpy as np

N = 100_000
NF = 1_000_000
BASELINE = 1000.0
PERIOD = 7.7
TAPS = 4
TILE = 2048  # cells per block of the CUDA kernel


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bench_draw():
    """The benchmark light curve (bench.py): f32 times, values and errors."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, BASELINE, N)).astype(np.float32)
    y = (np.sin(2 * np.pi * t / PERIOD) + 0.3 * rng.standard_normal(N)).astype(np.float32)
    err = np.full(N, 0.3, np.float32)
    return t, y, err


def grid_draw(nfft, occupied, seed, cluster_tile=None):
    """Sorted bases over the first ``occupied`` share of the grid, unit-ish
    complex weights and 4-tap Lagrange weights, as the pipelines make
    them. With ``cluster_tile``, half the samples fall in that tile."""
    rng = np.random.default_rng(seed)
    hi = int(occupied * nfft) - TAPS
    ilo = rng.integers(0, hi, N)
    if cluster_tile is not None:
        ilo[: N // 2] = cluster_tile * TILE + rng.integers(0, TILE - TAPS, N // 2)
    ilo = np.sort(ilo).astype(np.int32)
    phase = rng.uniform(0, 2 * np.pi, N)
    w = rng.uniform(0.5, 1.5, N) / N
    d = rng.uniform(1.0, 2.0, N)[:, None] - np.arange(TAPS)[None, :]
    denom = np.array([(-1.0) ** (TAPS - 1 - j) * math.factorial(j) * math.factorial(TAPS - 1 - j)
                      for j in range(TAPS)])
    lag = np.prod(d, axis=1)[:, None] / (denom[None, :] * d)
    return (ilo, (w * np.cos(phase)).astype(np.float32), (w * np.sin(phase)).astype(np.float32),
            lag.astype(np.float32))


def event_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch

    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.ops import _kernels
    from periodicity_tpu_torch.ops.grid2 import (
        extirpolate_grid_factored,
        extirpolate_grid_factored_plain,
    )
    from periodicity_tpu_torch.ops.trig_sum import grid_size
    from periodicity_tpu_torch.spectral import GLS, default_frequency_grid, gls_power

    # full float32 matrix products for the direct method (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # phase 2: build the kernel library from source
    info = _kernels.build()
    print(f"build: {info['seconds']:.2f} s -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"ptxas: {line.strip()}")
    _kernels.load()

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # phase 3: kernel vs plain at the main-path shapes
    cases = {
        "pair 2^23": grid_draw(1 << 23, 0.5, seed=1),
        "2f 2^22": grid_draw(1 << 22, 1.0, seed=2),
        "clustered 2^23": grid_draw(1 << 23, 0.5, seed=3, cluster_tile=1000),
    }
    args = {}
    max_abs_err = 0.0
    for label, (ilo, ure, uim, lag) in cases.items():
        nfft = 1 << 23 if "2^23" in label else 1 << 22
        a = (cuda(ilo), cuda(ure), cuda(uim), cuda(lag), nfft)
        args[label] = a
        kre, kim = extirpolate_grid_factored(*a)
        pre, pim = extirpolate_grid_factored_plain(*a)
        a64 = (a[0], a[1].double(), a[2].double(), a[3].double(), nfft)
        dre, dim_ = extirpolate_grid_factored_plain(*a64)
        torch.cuda.synchronize()
        scale = float(torch.maximum(dre.abs().max(), dim_.abs().max()))
        err_plain = float(torch.maximum((kre - pre).abs().max(), (kim - pim).abs().max()))
        err_f64 = float(torch.maximum((kre.double() - dre).abs().max(),
                                      (kim.double() - dim_).abs().max()))
        print(f"kernel vs plain [{label}]: max|d| {err_plain:.3e} (f32 plain), "
              f"{err_f64:.3e} (f64 plain), max|grid| {scale:.3e}")
        check(err_plain <= 1e-5 * scale, f"{label}: kernel vs f32 plain {err_plain} > 1e-5*{scale}")
        check(err_f64 <= 1e-6 * scale, f"{label}: kernel vs f64 plain {err_f64} > 1e-6*{scale}")
        max_abs_err = max(max_abs_err, err_plain)

    # phase 4: the estimator surface on the card, counted
    t, y, err = bench_draw()
    ts = TSeries(cuda(t), cuda(y))
    torch.cuda.synchronize()
    extirpolate_grid_factored.launches = 0
    gls = GLS()
    pgram = gls(ts)
    best = float(pgram.period_at_highest_peak)
    torch.cuda.synchronize()
    launches = extirpolate_grid_factored.launches
    power = pgram.values
    print(f"GLS()(TSeries) on card: nf {power.shape[0]}, gridder {gls._gridder_resolved}, "
          f"best period {best:.6f} (injected {PERIOD}), kernel launches {launches}")
    check(gls._gridder_resolved == "kernel", "GLS picked the kernel gridder")
    check(launches == 2, f"two kernel launches per periodogram, got {launches}")
    check(power.dtype == torch.float32 and power.shape == (len(gls.frequency),),
          "power dtype and shape")
    check(bool(torch.isfinite(power).all()), "finite power")
    check(abs(best - PERIOD) <= 0.005 * PERIOD, f"best period {best} within 0.5% of {PERIOD}")
    _, df_g, fmin_g = default_frequency_grid(ts)
    ref = gls_power(cuda(t).double(), cuda(y).double(), torch.ones_like(ts.values).double(),
                    df_g, fmin_g, power.shape[0], pair_q=1, gridder="scatter")
    d_gls = float((power.double() - ref).abs().max() / ref.max())
    print(f"GLS f32 kernel vs f64 scatter on card: max|dp|/peak {d_gls:.3e}")
    check(d_gls <= 1e-4, f"GLS f32 vs f64 {d_gls} > 1e-4 of peak")

    # phase 5: gls_power at the benchmark shape, f32 kernel vs f64 plain.
    # The bench grid reaches f = 500, ten times the pseudo-Nyquist 0.5/median_dt;
    # there the f32 rounding of t - tmin alone (ulp(1000)/2 = 3e-5 days) turns
    # phases by up to 2*pi*500*3e-5 = 0.1 rad, which shows on noise-level bins
    # (the JAX package's f32 path carries the same error), so the whole grid
    # is held at 5e-4 of peak and the band below pseudo-Nyquist at 1e-4.
    df = float(np.float32(0.5 / BASELINE))
    fmin = float(np.float32(df / 2))
    tc, yc, ec = cuda(t), cuda(y), cuda(err)
    p32 = gls_power(tc, yc, ec, df, fmin, NF, pair_q=1, gridder="kernel")
    p64 = gls_power(tc.double(), yc.double(), ec.double(), df, fmin, NF, pair_q=1,
                    gridder="scatter")
    dp = (p32.double() - p64).abs() / p64.max()
    k_nyq = int((0.5 / float(ts.median_dt) - fmin) / df) + 1
    d_band = float(dp[:k_nyq].max())
    d_bench = float(dp.max())
    print(f"gls_power bench shape f32 kernel vs f64 scatter on card: max|dp|/peak "
          f"{d_band:.3e} below pseudo-Nyquist (first {k_nyq} bins), {d_bench:.3e} on all "
          f"{NF} (at bin {int(dp.argmax())})")
    check(p32.shape == (NF,) and bool(torch.isfinite(p32).all()), "bench power finite, [nf]")
    check(d_band <= 1e-4, f"bench f32 vs f64 below pseudo-Nyquist {d_band} > 1e-4 of peak")
    check(d_bench <= 5e-4, f"bench f32 vs f64 on the whole grid {d_bench} > 5e-4 of peak")
    # small input: the f32 kernel path against f64 with the same algorithm
    # (precision), and the f64 fast path with 12 taps on a doubled grid
    # against the exact direct method (algorithm)
    rng = np.random.default_rng(1)
    ts_small = np.sort(rng.uniform(0, 100, 2000))
    ys_small = np.sin(2 * np.pi * ts_small / PERIOD) + 0.3 * rng.standard_normal(2000)
    small_ts = TSeries(cuda(ts_small.astype(np.float32)), cuda(ys_small.astype(np.float32)))
    small = GLS()(small_ts).values
    _, df_s, fmin_s = default_frequency_grid(small_ts)
    nf_s = small.shape[0]
    t64, y64 = small_ts.time.double(), small_ts.values.double()
    ones = torch.ones_like(t64)
    fast64 = gls_power(t64, y64, ones, df_s, fmin_s, nf_s, pair_q=1, gridder="scatter")
    oracle = gls_power(t64, y64, ones, df_s, fmin_s, nf_s, pair_q=1, taps=12,
                       nfft=2 * grid_size(nf_s))
    exact = gls_power(t64, y64, ones, df_s, fmin_s, nf_s, method="direct")
    d_prec = float((small.double() - fast64).abs().max() / fast64.max())
    d_alg = float((oracle - exact).abs().max() / exact.max())
    print(f"GLS N=2000 on card: f32 kernel vs f64 scatter max|dp|/peak {d_prec:.3e}; "
          f"f64 12-tap 2x-grid vs f64 direct {d_alg:.3e}")
    check(d_prec <= 1e-4, f"small f32 kernel vs f64 scatter {d_prec} > 1e-4 of peak")
    check(d_alg <= 1e-8, f"small f64 oracle vs direct {d_alg} > 1e-8 of peak")

    # phase 6: times (CUDA events, warmed, alternating plain/kernel)
    times = {}
    for label in ("pair 2^23", "2f 2^22"):
        a = args[label]
        for fn in (extirpolate_grid_factored, extirpolate_grid_factored_plain):
            fn(*a)
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = extirpolate_grid_factored if which == "kernel" else extirpolate_grid_factored_plain
            runs[which].append(event_ms(lambda: fn(*a), 50))
        times[label] = {k: statistics.mean(v) for k, v in runs.items()}
        print(f"spreading [{label}, N={N}]: kernel {times[label]['kernel']:.4f} ms, "
              f"plain index_add_ {times[label]['plain']:.4f} ms  ({card})")

    def chained(gridder, k=20):
        yk = yc
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(k):
            p = gls_power(tc, yk, ec, df, fmin, NF, pair_q=1, gridder=gridder)
            yk = yk + p[:N] * 1e-9
            acc = acc + p[0]
        return acc

    rates = {}
    for gridder in ("kernel", "scatter"):
        chained(gridder, 2)
    for gridder in ("kernel", "scatter", "scatter", "kernel"):
        rates.setdefault(gridder, []).append(NF / (event_ms(lambda: chained(gridder), 1) / 20 / 1e3))
    for gridder, r in rates.items():
        print(f"chained bench-shape periodograms (K=20, gridder={gridder}): "
              f"{statistics.mean(r):.4e} trial-freqs/s, runs {[f'{x:.4e}' for x in r]}  ({card})")
    torch.cuda.reset_peak_memory_stats()
    chained("kernel", 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory, one bench-shape periodogram: {peak / 2**20:.1f} MiB  ({card})")

    record = {"kernels": [{
        "name": "extirpolate_grid_factored",
        "route": "cuda",
        "source": "periodicity_tpu_torch/csrc/extirpolate_grid.cu",
        "replaces": "periodicity_tpu/ops/pallas_grid2.py:142",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": times["pair 2^23"]["kernel"],
        "plain_ms": times["pair 2^23"]["plain"],
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
