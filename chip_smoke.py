"""Smoke run of the PyTorch / CUDA port (periodicity_tpu_torch) on one GPU.

Drives the port's paths on the card, through the hand-written CUDA
kernels, and checks every phase:

1. a CUDA device is present; the card's name and power limit;
2. the kernel library builds from ``periodicity_tpu_torch/csrc`` (one
   nvcc per source, all started together);
3. the spreading kernel, through its factored entry point, agrees with its
   plain PyTorch version at the GLS main-path shapes (2^23 and 2^22
   cells), on a clustered draw and at 16 taps, in both output layouts
   (complex64 and two planes, bit-equal to each other and between calls);
4. ``GLS()(TSeries(t, y))`` on the card finds the injected 7.7-day period,
   through exactly two spreading launches;
5. float32 ``gls_power`` with the kernel agrees with float64 on the card
   at the benchmark shape, and no grid-sized ``torch.complex`` runs on its
   path (the kernel writes the complex grid the IFFT reads); on a small
   input, float32 agrees with float64 and the fast path with the exact
   direct method;
6. GLS times: the spreading kernel vs plain and vs one ``index_add_``
   call, by events and by the profiler's device time, and on the clustered
   draw; chained periodograms; the device time of one periodogram by
   kernel family with the device's idle share; the peak device memory of
   one periodogram;
7. the phase-fold kernel agrees with its plain version at the BLS
   benchmark shape (config 11: N = 2000, 1e5 trial periods, 2 rows of 256
   bins), the AoV and conditional-entropy shapes, each in one launch and at
   the chunk of periods the scans launch, and an edge draw (counts
   bit-equal); the spreading kernel, through its unfactored entry point,
   agrees with its plain version at N = 1e5, 2^23 cells and on a clustered
   draw;
8. ``BLS()(TSeries(t, y))`` at config 11 on the card goes through the fold
   kernel (one launch per chunk of periods), finds the 7.7-day transit
   period and agrees with the float64 scatter scan;
9. ``AoV``, ``ConditionalEntropy`` and ``GregoryLoredo`` on the card find
   their injected periods through the fold kernel;
10. phase-slice times: fold and unfactored spreading kernels vs plain; the
   fold at the shape the scan launches it (one 512-period config-11
   chunk) by CUDA events over back-to-back launches and by the profiler's
   device time per launch, and the wrapper's host time per launch; the
   chained config-11 BLS rate with the device-busy share and the fold's
   device time per scan from one profiler window; the peak device memory
   of one scan.

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
import time

import numpy as np

N = 100_000
NF = 1_000_000
BASELINE = 1000.0
PERIOD = 7.7
TAPS = 4
TILE = 2048  # cells per step of a block of the spreading kernel


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


def grid_draw(nfft, occupied, seed, cluster_tile=None, taps=TAPS):
    """Sorted bases over the first ``occupied`` share of the grid, unit-ish
    complex weights and ``taps``-point Lagrange weights, as the pipelines
    make them. With ``cluster_tile``, half the samples fall in that tile."""
    rng = np.random.default_rng(seed)
    hi = int(occupied * nfft) - taps
    ilo = rng.integers(0, hi, N)
    if cluster_tile is not None:
        ilo[: N // 2] = cluster_tile * TILE + rng.integers(0, TILE - taps, N // 2)
    ilo = np.sort(ilo).astype(np.int32)
    phase = rng.uniform(0, 2 * np.pi, N)
    w = rng.uniform(0.5, 1.5, N) / N
    # the sample's offset from its base, in [taps/2 - 1, taps/2) as the
    # pipelines place it
    d = rng.uniform(taps // 2 - 1, taps // 2, N)[:, None] - np.arange(taps)[None, :]
    denom = np.array([(-1.0) ** (taps - 1 - j) * math.factorial(j) * math.factorial(taps - 1 - j)
                      for j in range(taps)])
    lag = np.prod(d, axis=1)[:, None] / (denom[None, :] * d)
    return (ilo, (w * np.cos(phase)).astype(np.float32), (w * np.sin(phase)).astype(np.float32),
            lag.astype(np.float32))


# config 11 (benchmarks/run_benchmarks.py:613-659): BLS over 1e5 trial
# periods x 4 durations, N = 2000, 256 bins, 512 periods per chunk
BLS_N = 2000
BLS_P = 100_000
BLS_NBINS = 256
BLS_WIDTHS = (3, 6, 13, 26)
BLS_DURATIONS = tuple(w / BLS_NBINS for w in BLS_WIDTHS)
BLS_BATCH = 512
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bls_draw():
    """Config 11's light curve: f32 times over 200 days, a 7.7-day box
    transit of depth 0.02 over 5% of the phase, noise 0.005."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 200.0, BLS_N)).astype(np.float32)
    phi = (t / PERIOD) % 1.0
    y = (np.where(phi < 0.05, -0.02, 0.0) + 0.005 * rng.standard_normal(BLS_N)).astype(np.float32)
    return t, y


def host_us(fn, reps=200):
    """Mean host time in microseconds of ``fn`` over ``reps`` back-to-back
    calls that enqueue work without waiting for it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e6


def device_us(fn, name, reps):
    """Device time in microseconds per call of ``fn`` of the kernels whose
    name holds ``name`` (every kernel for ``""``), over ``reps`` calls in
    one profiler window. A named kernel is launched once a call: a window
    whose count of it is not ``reps`` is taken again, up to three windows,
    since the profiler has been seen to miss some of a window's launches
    (22 of 50 once); the last window must have them all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name]
        if not name or len(times) == reps:
            break
        print(f"profiler window saw {len(times)} of {reps} {name} launches; taken again")
    check(not name or len(times) == reps,
          f"the profiler saw {reps} {name} launches, got {len(times)}")
    return sum(times) / reps


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


def kernel_family(name):
    """The family a device kernel's name belongs to, for the breakdowns."""
    low = name.lower()
    if "spread" in low:  # spread_walk_kernel; spread_kernel before it
        return "spreading"
    if "fft" in low:
        return "cuFFT"
    if "reduce" in low:
        return "reductions"
    if any(k in low for k in ("memcpy", "memset", "copy", "fill")):
        return "copies and fills"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def gls_breakdown(chained, card, k=3):
    """Device time of one bench-shape periodogram by kernel family, and the
    device's idle share, from one profiler window over ``k`` chained
    periodograms through the kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    chained("kernel", 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chained("kernel", k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    spread_launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:  # kernels, copies and fills on the card
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            spread_launches += kernel_family(e.name) == "spreading"
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw device work")
    check(spread_launches == 2 * k, f"{2 * k} spreading launches in the window, got "
          f"{spread_launches}")
    families = {}
    for name, us in by_name.items():
        families[kernel_family(name)] = families.get(kernel_family(name), 0.0) + us
    print(f"profiler, {k} chained bench-shape periodograms (kernel gridder), per periodogram: "
          f"wall {wall * 1e3 / k:.3f} ms, device busy {busy / 1e3 / k:.4f} ms, idle "
          f"{1 - busy / 1e6 / wall:.1%}  ({card})")
    for fam, us in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:18s} {us / 1e3 / k:8.4f} ms per periodogram ({us / busy:.1%})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device {us / 1e3 / k:8.4f} ms  {name[:90]}")


def gls_chain(gls_power, tc, yc, ec, dev):
    """``chained(gridder, k)``: k bench-shape periodograms, each feeding
    the next (bench.py's loop); returns a 0-d sum that depends on all."""
    import torch

    df = float(np.float32(0.5 / BASELINE))
    fmin = float(np.float32(df / 2))

    def chained(gridder, k=20):
        yk = yc
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(k):
            p = gls_power(tc, yk, ec, df, fmin, NF, pair_q=1, gridder=gridder)
            yk = yk + p[:N] * 1e-9
            acc = acc + p[0]
        return acc

    return chained


def gls_peak(chained, card):
    """Peak device memory of one bench-shape periodogram through the
    kernel, above what is already held; in bytes."""
    import torch

    chained("kernel", 1)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    chained("kernel", 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    print(f"peak device memory of one bench-shape periodogram, above the {held / 2**20:.1f} MiB "
          f"already held: {peak / 2**20:.1f} MiB  ({card})")
    return peak


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
    from torch.profiler import ProfilerActivity, profile

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
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    _kernels.load()

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # phase 3: kernel vs plain at the main-path shapes, in both layouts
    cases = {
        "pair 2^23": grid_draw(1 << 23, 0.5, seed=1),
        "2f 2^22": grid_draw(1 << 22, 1.0, seed=2),
        "clustered 2^23": grid_draw(1 << 23, 0.5, seed=3, cluster_tile=1000),
        "16 taps 2^23": grid_draw(1 << 23, 0.5, seed=4, taps=16),
    }
    args = {}
    max_abs_err = 0.0
    for label, (ilo, ure, uim, lag) in cases.items():
        nfft = 1 << 23 if "2^23" in label else 1 << 22
        a = (cuda(ilo), cuda(ure), cuda(uim), cuda(lag), nfft)
        args[label] = a
        kc = extirpolate_grid_factored(*a, as_complex=True)
        kre, kim = extirpolate_grid_factored(*a)
        again = extirpolate_grid_factored(*a, as_complex=True)
        pc = extirpolate_grid_factored_plain(*a, as_complex=True)
        dc = extirpolate_grid_factored_plain(a[0], a[1].double(), a[2].double(), a[3].double(),
                                             nfft, as_complex=True)
        torch.cuda.synchronize()
        check(kc.dtype == torch.complex64 and kc.shape == (nfft,), f"{label}: complex64 [nfft]")
        check(torch.equal(kc.real, kre) and torch.equal(kc.imag, kim),
              f"{label}: the complex grid and the planes bit-equal")
        check(torch.equal(kc, again), f"{label}: two calls bit-equal")
        k, d = torch.view_as_real(kc), torch.view_as_real(dc)
        scale = float(d.abs().max())
        err_plain = float((k - torch.view_as_real(pc)).abs().max())
        err_f64 = float((k.double() - d).abs().max())
        print(f"kernel vs plain [{label}]: max|d| {err_plain:.3e} (f32 plain), "
              f"{err_f64:.3e} (f64 plain), max|grid| {scale:.3e}; both layouts and two calls "
              f"bit-equal")
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
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        p32 = gls_power(tc, yc, ec, df, fmin, NF, pair_q=1, gridder="kernel")
        torch.cuda.synchronize()
    grid_sizes = (grid_size(NF), grid_size(NF) // 2)
    joins = [e.input_shapes for e in prof.events() if e.name == "aten::complex"]
    grid_joins = [sh for sh in joins if sh and sh[0] and sh[0][0] in grid_sizes]
    print(f"gls_power bench shape, kernel path: {len(joins)} torch.complex calls, "
          f"{len(grid_joins)} of them on a grid of {grid_sizes} cells")
    check(joins and not grid_joins, f"no torch.complex of grid planes: {grid_joins}")
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

    # phase 6: times of the kernel, its plain version and the yardstick
    # (CUDA events, warmed, in turns; and the profiler's device time per
    # call), in the layout the pipelines ask for: the complex64 grid. The
    # yardstick is a zero-fill and one index_add_ of the products u * lag
    # (made outside the timed call) on the flat indices. The bound: ilo,
    # u_re, u_im and lag read once, the complex64 grid written once.
    times = {}
    for label in ("pair 2^23", "2f 2^22", "clustered 2^23"):
        ilo, ure, uim, lag, nfft = a = args[label]
        taps = lag.shape[1]
        flat = (ilo.long()[:, None] + torch.arange(taps, device=dev)).reshape(-1)
        prods = torch.stack([ure[:, None] * lag, uim[:, None] * lag], dim=-1).reshape(-1, 2)
        fns = {
            "kernel": lambda: extirpolate_grid_factored(*a, as_complex=True),
            "plain": lambda: extirpolate_grid_factored_plain(*a, as_complex=True),
            "library": lambda: torch.zeros(nfft, 2, device=dev).index_add_(0, flat, prods),
        }
        for fn in fns.values():
            fn()
        runs = {k: [] for k in fns}
        for which in ("plain", "kernel", "library", "library", "kernel", "plain"):
            runs[which].append(event_ms(fns[which], 50))
        got = {k: statistics.mean(v) for k, v in runs.items()}
        got["device"] = device_us(fns["kernel"], "spread_walk", 20) / 1e3
        got["library_device"] = device_us(fns["library"], "", 20) / 1e3
        n = ilo.shape[0]
        got["bound"] = bound(n * (4 + 4 + 4 + 4 * taps) + nfft * 8, n * taps * 2 * 2)
        times[label] = got
        print(f"spreading [{label}, N={n}]: by events back to back, kernel {got['kernel']:.4f} "
              f"ms, one index_add_ {got['library']:.4f} ms, plain {got['plain']:.4f} ms; device "
              f"time per call (profiler), kernel {got['device']:.4f} ms, one index_add_ "
              f"{got['library_device']:.4f} ms (zero-fill and index_add_); bound "
              f"{got['bound'][0]:.4f} ms ({got['bound'][1]})  ({card})")

    chained = gls_chain(gls_power, tc, yc, ec, dev)
    rates = {}
    for gridder in ("kernel", "scatter"):
        chained(gridder, 2)
    for gridder in ("kernel", "scatter", "scatter", "kernel"):
        rates.setdefault(gridder, []).append(NF / (event_ms(lambda: chained(gridder), 1) / 20 / 1e3))
    for gridder, r in rates.items():
        print(f"chained bench-shape periodograms (K=20, gridder={gridder}): "
              f"{statistics.mean(r):.4e} trial-freqs/s, runs {[f'{x:.4e}' for x in r]}  ({card})")
    gls_breakdown(chained, card)
    peak = gls_peak(chained, card)

    # the pair pipeline's launch unprefixed; the 2f pipeline's launch and
    # the clustered draw under prefixes. device_ms is the profiler's
    # device time per call, for the kernel and the index_add_ call alike.
    b1_record = {
        "name": "extirpolate_grid_factored",
        "route": "cuda",
        "source": "periodicity_tpu_torch/csrc/extirpolate_grid_walk.cu",
        "replaces": "periodicity_tpu/ops/pallas_grid2.py:194",
        "launches": launches,
        "max_abs_err": max_abs_err,
    }
    for prefix, label in (("", "pair 2^23"), ("2f_", "2f 2^22"),
                          ("clustered_", "clustered 2^23")):
        got = times[label]
        b1_record.update({
            f"{prefix}ms": got["kernel"],
            f"{prefix}plain_ms": got["plain"],
            f"{prefix}bound_ms": got["bound"][0],
            f"{prefix}bound_by": got["bound"][1],
            f"{prefix}library_ms": got["library"],
            f"{prefix}device_ms": got["device"],
            f"{prefix}library_device_ms": got["library_device"],
        })
    b1_record["peak_mib_per_periodogram"] = peak / 2**20
    kernels = [b1_record]
    kernels += phase_slice(dev, card, cuda)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def phase_slice(dev, card, cuda):
    """Phases 7-10: the fold kernel (B2) and the unfactored spreading
    kernel (B3) against their plain versions, the phase estimators on the
    card, and their times. Returns the two kernels' JSON records."""
    import torch

    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.ops.fold import fold_onehot, fold_onehot_plain
    from periodicity_tpu_torch.ops.grid import extirpolate_grid, extirpolate_grid_plain
    from periodicity_tpu_torch.phase import (
        BLS,
        AoV,
        ConditionalEntropy,
        GregoryLoredo,
        bls_scan,
    )

    # phase 7a: fold kernel vs plain. Counts (rows of ones) are integers
    # below 2^24 and must be bit-equal; weighted rows are f32 sums in
    # another order and must agree within 1e-6 of the row's max |value|.
    # The rounding of such a sum grows with the square root of the samples
    # in a bin: the AoV shape puts ~220 samples in each of its 9 bins (the
    # BLS shape ~8 in each of 256) and is held at 1e-5.
    t, y = bls_draw()
    w = np.full(BLS_N, 1.0 / BLS_N, np.float32)
    wyc = (w * (y - np.sum(w * y))).astype(np.float32)
    rng = np.random.default_rng(11)
    x = np.sin(2 * np.pi * t / PERIOD) + 0.2 * rng.standard_normal(BLS_N)
    xb = np.clip(((x - x.min()) / np.ptp(x) * 5).astype(np.int32), 0, 4)
    bls_periods = np.linspace(0.5, 100.0, BLS_P)
    aov_vals = np.stack([np.ones_like(x), x, x * x]).astype(np.float32)
    aov_periods = np.linspace(2.0, 20.0, 10_000)
    ce_vals = np.ones((1, BLS_N), np.float32)
    ce_periods = np.linspace(2.0, 12.0, 10_000)
    t_edge = np.sort(rng.uniform(0, 1400.0, 1999)) + 2.45e6  # BJD epoch, float64
    # The chunk cases are the launches the scans make (the first chunk of
    # each period grid: 512 periods for BLS, 128 for the other estimators),
    # which take the kernel's 512-thread blocks; the one-launch cases take
    # its 256-thread blocks.
    fold_cases = {
        # label: (t, values [nv, N], periods, n_phi, stride, offsets, count rows)
        "config 11 (N=2000, P=1e5, 2x256)": (t, np.stack([w, wyc]), bls_periods, 256, 1,
                                            None, []),
        "config 11 chunk (512 periods)": (t, np.stack([w, wyc]), bls_periods[:BLS_BATCH], 256,
                                          1, None, []),
        "AoV (3 rows x 9)": (t, aov_vals, aov_periods, 9, 1, None, [0]),
        "AoV chunk (128 periods)": (t, aov_vals, aov_periods[:128], 9, 1, None, [0]),
        "CE (10 x 5, offsets)": (t, ce_vals, ce_periods, 10, 5, xb, [0]),
        "CE chunk (128 periods, offsets)": (t, ce_vals, ce_periods[:128], 10, 5, xb, [0]),
        "edge (N=1999, P=9999, BJD f64)": (
            t_edge, np.stack([np.ones(1999), rng.standard_normal(1999)]).astype(np.float32),
            np.linspace(0.5, 100.0, 9999), 64, 1, None, [0]),
    }
    fold_args = {}
    fold_err = 0.0
    for label, (tt, vals, periods, n_phi, stride, off, counts) in fold_cases.items():
        a = (cuda(tt), cuda(vals), 1.0 / cuda(periods), n_phi, stride,
             None if off is None else cuda(off))
        fold_args[label] = a
        got = fold_onehot(*a)
        ref = fold_onehot_plain(*a)
        torch.cuda.synchronize()
        check(got.shape == ref.shape == (len(periods), vals.shape[0], n_phi * stride),
              f"fold {label}: shape")
        for r in counts:
            check(torch.equal(got[:, r], ref[:, r]), f"fold {label}: count row {r} bit-equal")
            check(bool((got[:, r].sum(-1) == len(tt)).all()), f"fold {label}: counts sum to N")
        tol = 1e-5 if len(tt) / (n_phi * stride) > 64 else 1e-6
        worst = 0.0
        for r in range(vals.shape[0]):
            if r in counts:
                continue
            err = float((got[:, r] - ref[:, r]).abs().max())
            scale = float(ref[:, r].abs().max())
            check(err <= tol * scale, f"fold {label}: row {r} {err} > {tol}*{scale}")
            worst = max(worst, err / scale)
            fold_err = max(fold_err, err)
        print(f"fold kernel vs plain [{label}]: count rows {counts} bit-equal, "
              f"weighted rows max|d|/max|row| {worst:.3e} (tolerance {tol:g})")

    # phase 7b: unfactored spreading kernel vs plain, as for B1
    grid_cases = {
        "N=1e5 2^23": grid_draw(1 << 23, 0.5, seed=21),
        "clustered 2^23": grid_draw(1 << 23, 0.5, seed=22, cluster_tile=1000),
    }
    grid_args = {}
    grid_err = 0.0
    for label, (ilo, ure, uim, lag) in grid_cases.items():
        vals = cuda((ure + 1j * uim)[:, None] * lag).to(torch.complex64)
        a = (cuda(ilo), vals, 1 << 23)
        grid_args[label] = a
        got = extirpolate_grid(*a)
        ref = extirpolate_grid_plain(*a)
        ref64 = extirpolate_grid_plain(a[0], vals.to(torch.complex128), a[2])
        torch.cuda.synchronize()
        scale = float(ref64.abs().max())
        err = float((got - ref).abs().max())
        err64 = float((got.to(torch.complex128) - ref64).abs().max())
        print(f"unfactored spreading vs plain [{label}]: max|d| {err:.3e} (f32 plain), "
              f"{err64:.3e} (f64 plain), max|grid| {scale:.3e}")
        check(err <= 1e-5 * scale, f"{label}: unfactored vs f32 plain {err} > 1e-5*{scale}")
        check(err64 <= 1e-6 * scale, f"{label}: unfactored vs f64 plain {err64} > 1e-6*{scale}")
        grid_err = max(grid_err, err)
    # its path is its own public entry point, at the main-path shape
    extirpolate_grid.launches = 0
    b3_out = extirpolate_grid(*grid_args["N=1e5 2^23"])
    torch.cuda.synchronize()
    b3_launches = extirpolate_grid.launches
    check(b3_launches == 1 and bool(torch.isfinite(torch.view_as_real(b3_out)).all()),
          "extirpolate_grid: one launch, finite grid")

    # phase 8: BLS()(TSeries) at config 11 through the fold kernel
    ts = TSeries(cuda(t), cuda(y))
    kw = dict(p_min=0.5, p_max=100.0, n_periods=BLS_P, durations=BLS_DURATIONS,
              nbins=BLS_NBINS, batch_size=BLS_BATCH)
    torch.cuda.synchronize()
    fold_onehot.launches = 0
    bls = BLS(**kw)
    pg = bls(ts)
    torch.cuda.synchronize()
    bls_launches = fold_onehot.launches
    chunks = -(-BLS_P // BLS_BATCH)
    print(f"BLS()(TSeries) config 11 on card: binner {bls._binner_resolved}, fold launches "
          f"{bls_launches} ({chunks} chunks), best period {bls.best_period:.6f} (injected "
          f"{PERIOD}), depth {bls.best_depth:.5f}, duration {bls.best_duration:.5f}, "
          f"snr {bls.best_snr:.2f}")
    check(bls._binner_resolved == "kernel", "BLS picked the kernel binner")
    check(bls_launches == chunks, f"one fold launch per chunk: {bls_launches} != {chunks}")
    check(abs(bls.best_period - PERIOD) <= 0.001 * PERIOD, f"best period {bls.best_period}")
    power = pg.values
    check(power.shape == (BLS_P,) and power.dtype == torch.float32
          and bool(torch.isfinite(power).all()), "BLS power finite, [P] float32")
    ref_bls = BLS(binner="scatter", **kw)
    ref_pg = ref_bls(TSeries(cuda(t).double(), cuda(y).double()))
    peak = float(ref_pg.values.max())
    close = float(((power.double() - ref_pg.values).abs() <= 1e-4 * peak).double().mean())
    print(f"BLS f32 kernel vs f64 scatter on card: best periods {bls.best_period:.6f} / "
          f"{ref_bls.best_period:.6f}, share of periods within 1e-4 of peak {close:.5f}")
    check(bls.best_period == ref_bls.best_period, "same best period as the f64 scatter scan")
    check(close >= 0.95, f"only {close} of periods within 1e-4 of peak")

    # phase 9: AoV, conditional entropy and Gregory-Loredo on the card
    rng = np.random.default_rng(5)
    tx = np.sort(rng.uniform(0, 200.0, BLS_N))
    xs = np.sin(2 * np.pi * tx / PERIOD) + 0.2 * rng.standard_normal(BLS_N)
    base = np.sort(rng.uniform(0, 1500.0, 9000))
    keep = rng.random(9000) < 0.15 + 0.8 * np.exp(-0.5 * ((((base / 5.0) % 1) - 0.3) / 0.08) ** 2)
    events = base[keep][:BLS_N]
    check(events.size == BLS_N, "event draw holds N events")
    for est, series, want, pick in (
        (AoV(p_min=2.0, p_max=20.0, n_periods=10_000), TSeries(cuda(tx), cuda(xs)), PERIOD,
         torch.argmax),
        (ConditionalEntropy(p_min=2.0, p_max=12.0, n_periods=10_000),
         TSeries(cuda(tx), cuda(xs)), PERIOD, torch.argmin),
        (GregoryLoredo(p_min=2.0, p_max=10.0, n_periods=10_000),
         TSeries(cuda(events), cuda(np.ones(BLS_N))), 5.0, torch.argmax),
    ):
        fold_onehot.launches = 0
        out = est(series)
        best = float(out.period[int(pick(out.values))])
        torch.cuda.synchronize()
        name = type(est).__name__
        print(f"{name} on card: binner {est._binner_resolved}, fold launches "
              f"{fold_onehot.launches}, best period {best:.5f} (injected {want})")
        check(est._binner_resolved == "kernel" and fold_onehot.launches == -(-10_000 // 128),
              f"{name} through the fold kernel")
        check(abs(best - want) <= 0.01 * want, f"{name} best period {best}")

    # phase 10: times (CUDA events, warmed, interleaved plain/kernel)
    def timed(kernel, plain, args, reps_kernel, reps_plain):
        kernel(*args)
        plain(*args)
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn, reps = (kernel, reps_kernel) if which == "kernel" else (plain, reps_plain)
            runs[which].append(event_ms(lambda: fn(*args), reps))
        return {k: statistics.mean(v) for k, v in runs.items()}

    fold_times = {}
    for label in ("config 11 (N=2000, P=1e5, 2x256)", "AoV (3 rows x 9)",
                  "CE (10 x 5, offsets)"):
        fold_times[label] = timed(fold_onehot, fold_onehot_plain, fold_args[label], 20, 3)
        print(f"fold [{label}]: kernel {fold_times[label]['kernel']:.4f} ms, plain "
              f"{fold_times[label]['plain']:.4f} ms  ({card})")
    a11 = fold_args["config 11 (N=2000, P=1e5, 2x256)"]
    chunk_args = fold_args["config 11 chunk (512 periods)"]
    chunk_times = timed(fold_onehot, fold_onehot_plain, chunk_args, 200, 50)
    chunk_dev_us = device_us(lambda: fold_onehot(*chunk_args), "fold_kernel", 50)
    chunk_host = [host_us(lambda: fold_onehot(*chunk_args)) for _ in range(2)]
    print(f"fold [config 11, one chunk of {BLS_BATCH} periods]: kernel "
          f"{chunk_times['kernel'] * 1e3:.2f} us per launch by events back to back, "
          f"{chunk_dev_us:.2f} us of device time per launch by the profiler, plain "
          f"{chunk_times['plain']:.4f} ms; wrapper host time {statistics.mean(chunk_host):.2f} "
          f"us per launch ({card})")
    grid_times = timed(extirpolate_grid, extirpolate_grid_plain, grid_args["N=1e5 2^23"], 50, 20)
    ilo3, vals3, nfft3 = grid_args["N=1e5 2^23"]
    flat3 = (ilo3.long()[:, None] + torch.arange(4, device=dev)).reshape(-1)
    vals3_re = torch.view_as_real(vals3).reshape(-1, 2)

    def library_grid():
        return torch.zeros(nfft3, 2, device=dev).index_add_(0, flat3, vals3_re)

    library_grid()
    library_events = statistics.mean(event_ms(library_grid, 20) for _ in range(2))
    # and device time per call from the profiler: the wrapper's host time
    # per call comes near the kernel's device time, so back-to-back events
    # through the wrapper can measure the host
    b3_dev_us = device_us(lambda: extirpolate_grid(*grid_args["N=1e5 2^23"]), "spread_walk", 20)
    library_dev_us = device_us(library_grid, "", 20)
    print(f"unfactored spreading [N=1e5, 2^23]: by events back to back, kernel "
          f"{grid_times['kernel']:.4f} ms, one index_add_ {library_events:.4f} ms, plain "
          f"{grid_times['plain']:.4f} ms; device time per call (profiler), kernel "
          f"{b3_dev_us / 1e3:.4f} ms, one index_add_ {library_dev_us / 1e3:.4f} ms (zero-fill "
          f"and index_add_)  ({card})")

    # a heavily clustered draw (half the samples in one 2048-cell tile),
    # whose samples overflow the kernel's ring of staged samples
    def b3_clustered():
        return extirpolate_grid(*grid_args["clustered 2^23"])

    b3_clustered()
    clustered_ms = event_ms(b3_clustered, 20)
    clustered_dev_us = device_us(b3_clustered, "spread_walk", 5)
    print(f"unfactored spreading [clustered 2^23, half the samples in one 2048-cell tile]: "
          f"kernel {clustered_ms:.4f} ms by events, {clustered_dev_us / 1e3:.4f} ms of device "
          f"time  ({card})")

    tc, yc, wc = cuda(t), cuda(y), cuda(w)
    pc = cuda(bls_periods.astype(np.float32))

    def chained(binner, k=3):
        # K scans, each feeding the next (run_benchmarks.py:640-652)
        yk = yc
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(k):
            p, _, _, _ = bls_scan(tc, yk, wc, pc, widths=BLS_WIDTHS, nbins=BLS_NBINS,
                                  batch_size=BLS_BATCH, binner=binner)
            yk = yk + p[0] * 1e-9
            acc = acc + p[:8].sum()
        return acc

    for binner in ("kernel", "scatter"):
        chained(binner, 1)
    rates = {}
    for binner in ("kernel", "scatter", "scatter", "kernel"):
        rates.setdefault(binner, []).append(BLS_P / (event_ms(lambda: chained(binner), 1) / 3 / 1e3))
    for binner, r in rates.items():
        print(f"chained config-11 BLS scans (K=3, binner={binner}): {statistics.mean(r):.4e} "
              f"trial-periods/s, runs {[f'{v:.4e}' for v in r]}  ({card})")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chained("kernel")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:  # kernels, copies and fills on the card
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_kernel.values())
    check(busy > 0, "the profiler saw device work")
    fold_us = sum(v for k, v in by_kernel.items() if "fold_kernel" in k)
    print(f"profiler, chained K=3 config-11 scans (kernel binner): wall {wall * 1e3:.2f} ms, "
          f"device busy {busy / 1e3:.2f} ms ({busy / 1e6 / wall:.1%}), fold kernel "
          f"{fold_us / 1e3:.3f} ms ({fold_us / max(busy, 1e-9):.1%} of device time; "
          f"{fold_us / 3e3:.3f} ms per scan), {len(by_kernel)} kernel names  ({card})")
    for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  device {v / 1e3:9.3f} ms  {k[:90]}")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    chained("kernel", 1)
    torch.cuda.synchronize()
    peak_mem = torch.cuda.max_memory_allocated() - held
    print(f"peak device memory of one config-11 BLS scan, above the {held / 2**20:.1f} MiB "
          f"already held: {peak_mem / 2**20:.1f} MiB  ({card})")

    # bounds, from this run's inputs: each input read once, each output
    # written once; the fold's operations are 5 per (period, sample) for
    # the bin plus one add per value row
    nv11 = a11[1].shape[0]
    b2_bound = bound(BLS_N * 4 * (1 + nv11) + BLS_P * 4 + BLS_P * nv11 * BLS_NBINS * 4,
                     BLS_P * BLS_N * (5 + nv11))
    b2_chunk_bound = bound(BLS_N * 4 * (1 + nv11) + BLS_BATCH * 4
                           + BLS_BATCH * nv11 * BLS_NBINS * 4, BLS_BATCH * BLS_N * (5 + nv11))
    n3 = ilo3.shape[0]
    b3_bound = bound(n3 * (4 + 4 * 8) + nfft3 * 8, n3 * 4 * 2)
    return [
        {
            "name": "fold_onehot",
            "route": "cuda",
            "source": "periodicity_tpu_torch/csrc/fold.cu",
            "replaces": "periodicity_tpu/ops/pallas_bls.py:126",
            "launches": bls_launches,
            "max_abs_err": fold_err,
            "ms": fold_times["config 11 (N=2000, P=1e5, 2x256)"]["kernel"],
            "plain_ms": fold_times["config 11 (N=2000, P=1e5, 2x256)"]["plain"],
            "bound_ms": b2_bound[0],
            "bound_by": b2_bound[1],
            "library_ms": None,
            # the shape the scan launches: one 512-period chunk
            "chunk_ms": chunk_times["kernel"],
            "chunk_device_ms": chunk_dev_us / 1e3,
            "chunk_plain_ms": chunk_times["plain"],
            "chunk_bound_ms": b2_chunk_bound[0],
            "chunk_bound_by": b2_chunk_bound[1],
            "chunk_host_ms": statistics.mean(chunk_host) / 1e3,
            "scan_device_ms": fold_us / 3e3,
        },
        {
            "name": "extirpolate_grid",
            "route": "cuda",
            "source": "periodicity_tpu_torch/csrc/extirpolate_grid_walk.cu",
            "replaces": "periodicity_tpu/ops/pallas_grid.py:132",
            "launches": b3_launches,
            "max_abs_err": grid_err,
            "ms": grid_times["kernel"],
            "plain_ms": grid_times["plain"],
            "bound_ms": b3_bound[0],
            "bound_by": b3_bound[1],
            "library_ms": library_events,
            # device time per call from the profiler, for the kernel and
            # for the one index_add_ call alike
            "device_ms": b3_dev_us / 1e3,
            "library_device_ms": library_dev_us / 1e3,
            "clustered_ms": clustered_ms,
        },
    ]


if __name__ == "__main__":
    sys.exit(main())
