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
7. the phase-fold kernel agrees with its plain version on the CPU copies
   of its inputs, every row bit for bit, at the BLS benchmark shape (config
   11: N = 2000, 1e5 trial periods, 2 rows of 256 bins), the AoV and
   conditional-entropy shapes, each in one launch and at the chunk of
   periods the scans launch, and an edge draw, and two launches agree bit
   for bit; the spreading kernel, through its unfactored entry point,
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
   device time per launch, and the wrapper's host time per launch, beside
   its yardstick (a zero-fill and one ``index_add_`` of the values on flat
   (period, row, bin) indices computed beforehand, also under
   ``torch.use_deterministic_algorithms(True)``); the
   chained config-11 BLS rate with the device-busy share and the fold's
   device time per scan from one profiler window; the peak device memory
   of one scan;
11. config 1 (N = 1e4, nf = 25,000): the GLS rate over 50 chained
   periodograms through the spreading kernel;
12. config 6 (32 light curves, N = 1e5, nf = 1e6): ``gls_power_batch`` in
   both layouts, the loop of kernel periodograms (two spreading launches a
   row, counted) and the row spreading; two rows of each against float64
   on the card, every row's best frequency; each layout's aggregate rate,
   peak memory and device busy share;
13. config 12 (K = 3, N = 1e4): ``gls_power_multiterm`` float32 fast
   against float64 direct on the card, within twice the JAX package's own
   float32 error plus eps32 * cond(G) per bin; its rate; the unrolled
   Cholesky against one ``torch.linalg.solve`` of the same batch;
14. config 14 (N = 1e6, nf = 1e5): the spreading kernel against its plain
   version at both pipeline shapes, where every tile is dense; GLS float32
   against float64; the rate; the kernel's times there against plain, one
   ``index_add_`` call and its bound;
15. ``GLS().bootstrap`` of 64 replicates at N = 2000 on the card: two
   spreading launches a replicate (counted), the replicates against the
   row-spreading layout on the same indices, the rate;
16. the rest of the surface on the card: ``refine``, ``window``, ``model``,
   ``fap``/``fal`` by bootstrap and Baluev, ``GLS(nterms=3)``, ``BGLST``
   fast against direct and ``MultibandGLS`` fast against direct, each
   finding its injected period;
17. the recursion kernels (``csrc/recursions.cu``) against their plain
   versions on the card, bit for bit: ``sosfilt`` in float64 over
   SpottedStar's Butterworth pass (the GP prior's band for p_max = 32),
   the pentadiagonal solve at m = 2146 in float64 and float32; their event,
   device and plain times, a dense ``torch.linalg.solve`` of the same
   system, and their bounds (bytes or the dependency chain); the filter at
   1, 5 and 16 sections over 1, 7 and 64 rows, the solve held in shared
   memory and past it (up to m = 1e5) and on its zero-pivot system, the
   solve's checked quotient against the division on the card (hashed,
   binade-edge, special and the system's own operand pairs), and both
   kernels' local memory (0 bytes);
18. config 2 on SpottedStar (N = 2148, float32): ``TSeries.acf()`` then a
   boxcar smooth, and B = 256 rows through rfft/irfft and ``convolve1d``:
   acfs/s, device busy share, peak memory, card against CPU;
19. the GP prior's ACF ladder (``acf_period_quality`` at every default
   cutoff) in float64 and float32 (both through the sosfilt kernel in
   float64, counted), card against CPU, with its wall time;
20. the rest of the container surface once each on the card against the
   CPU: interpolation (the smoothing spline through the pentadiagonal
   kernel, counted), ``find_peaks`` with every criterion, zero crossings,
   noise, Butterworth in float64 and float32, ``polyfit``, ``curvefit``,
   ``TFSeries.downsample`` and 2-D smoothing, and the data generators.
   Phases 18-20 are this slice's main path: the recursion kernels' counts
   are zeroed before it and each must have launched in it.
21. the EMD sift kernel (``csrc/sift.cu``) against its plain version on the
   card, to the bit pattern (modes, residue, mode counts, sift counts, the
   last sifted series; signed zeros count): config 10's noise
   pre-decomposition (50 realizations, N = 1024, float64, 12 mode slots)
   and first ensemble stage, config 9's sift shape (N = 2048, float32, 4
   modes, B = 8, 32, 64), and edge draws (too short, monotonic, plateaus,
   pad widths 1 and 3, max_iter reached, the Thomas size, N = 2048, float64
   at N = 2400 in global scratch, envelopes of 64 and 65 valid knots and
   of 303 at capacity 308) in both dtypes; events and profiler times, the
   plain version's wall time, the bound from the plain run's envelope
   counts (ceil(log2 cnt) PCR levels a sift's larger envelope);
22. config 10 on the card: ``CEEMDAN(ensemble_size=50, random_seed=42)``
   over 3 perturbed inputs (seconds per decomposition, n_modes, sift
   launches, busy share, peak memory) against the CPU port within 1e-9 of
   max|x|; then ``EMD``, ``LMD`` (first product function, with its device
   operations and host reads) and ``VMD(n_modes=3)`` on the card against
   the CPU. Phase 22 is this slice's main path: the sift kernel's count is
   zeroed before it and must be non-zero after it;
23. two cells of earlier slices: config 4 (PDM, StringLength and its fast
   variant, N = 2000, 1e5 periods, float32) and config 6's batch curve
   (B = 4, 8, 16, both layouts, with peak memory);
24. the AM/FM normalization kernel (``csrc/amfm.cu``, N1) against its plain
   version on the card, to the bit pattern (A, F, passes): config 9's rows (the
   modes ``emd_pool`` returns at B = 8, 32, 64, N = 2048, float32, dead
   slots replaced by the dummy cosine), the B = 8 rows in float64, and
   edge draws (the constant envelope, unit amplitude, rows finishing at
   different passes, pad widths 1 and 3, n_iter reached, the Thomas size,
   float64 at N = 4096 in global scratch) in both dtypes; events and
   profiler times, the plain version's wall time at B = 8, the bound (every
   PCR level the plain version runs, though the kernel's vote ends float32
   solves once their couplings are all zero); both instances' local memory
   (0 bytes) and registers, the launch at B = 64, and its float32 quotient
   against ``__fdiv_rn``;
25. config 9 on the card: ``hht_batch(t, Y, grid, max_modes=4)`` at B = 8,
   32, 64 (transforms/s, median of 3 perturbed inputs; S1 and N1 launches;
   busy share and the device-time shares of S1, N1 and the rest; peak
   memory; each member's dominant mode's instantaneous frequency against
   its tone), pure tones (the first mode's median frequency within 2%),
   and a float64 B = 8 batch against the CPU port;
26. config 3 (N = 4096, 64 scales, float32): single-series latency over 20
   chained CWTs and ``wps_batch`` at B = 32; then WPS with its band
   averages, CompositeSpectrum, denoise, denoise_batch, reconstruct, EMD
   and HHT with every method and normalization on the card against the
   CPU port in float64, with LMD's host reads. Phases 25-26 are this
   slice's main path: the counts of N1 and S1 are zeroed before it and
   both must have launched in it.
27. the celerite kernels (``csrc/celerite.cu``: G1 the fused factor and
   forward substitution, G2 its adjoint, G3 the two-sweep solve) against
   their plain versions on the card, bit for bit: config 5's shape (64
   walkers, N = 2148, the masked BrownianTerm, R = 6) in float32 and
   float64, G3 at K = 1, 65 and 2148, and edge draws (a live SHO, R = 2; a
   masked RotationTerm, R = 8; N = 2; a row whose D goes non-positive),
   G2 also at 8 walkers in float64 and config 13's 4 in float32, its
   outputs held to the bit pattern (signed zeros too), and its local
   memory held at 0 up to R = 8 (both dtypes; the instantiations to
   R = 16 printed);
   events and profiler times, the plain versions' wall times, the chain
   bounds, one dense ``torch.cholesky_solve`` of G3's system, and for G2
   autograd's backward through the batched dense Cholesky;
28. config 5 (k = 10 chained batched evaluations, float32 and float64:
   evals/s, launches an evaluation, busy share, peak memory) and config 7's
   scan points (N = 1e4, 1e5, float32);
29. config 8 (``run_ensemble`` on config 5's log-probability, 64 walkers x
   50 steps, float32: walker-steps/s, busy share, launches a step), then 5
   float64 steps on the card and on the CPU port from the same draws;
30. ``BrownianGP`` and ``HarmonicGP`` on SpottedStar: ``minimize`` and
   ``mcmc(16 walkers, 1000 steps)`` against the reference's thresholds, nll
   and its gradient, predictions, PSDs and loocv against the CPU port;
   ``QuasiPeriodicGP`` on tests/test_gp.py's draw against the CPU. Phase 30
   is this slice's main path: the counts of G1, G2 and G3 are zeroed before
   it and each must have launched in it.
31. the blocked Kalman composition (``csrc/kalman.cu``, K1) against its
   plain version on the card, bit for bit: R = 1..8, 12 and 16 in float32 and
   float64, from the identity and from an incoming carry, block counts that
   divide N and that do not; at config 7's blocked shapes (one row, the
   live BrownianTerm, R = 4, f32, N = 1e4 and 1e5) and at its chunked
   shape (65536 samples over 512 blocks, from a carry) its events and
   profiler times by stage (elements, prefixes, the scan's levels, stitch
   and innovations), the plain version's wall time, the chain bound and, at
   N = 1e4, one dense ``cholesky_ex`` + ``solve_triangular`` of K;
32. config 7's solver points in f32 (scan, pscan and blocked at N = 1e4
   and 1e5, chunked at N = 1e6): ms an evaluation over k = 3 chained
   evaluations, launches, busy share, peak memory, the log-likelihood
   against the f64 scan on the card; every solver in f64 at N = 1e4 within
   1e-10 of the scan, and the gradients of blocked and chunked equal to
   the scan's;
33. config 13 (``run_nuts`` on SpottedStar's BrownianTerm posterior, f32, 4
   chains, depth 6, 40 steps after 60 warmup: grad-evals/s, divergences,
   min ESS, max R-hat, launches a leapfrog, busy share; 2, 8 and 16 chains
   at depth 4), ``BrownianGP.nuts`` on the JAX package's synthetic rotator
   with its assertions (2 chains of 110 steps after 200 of warmup, cut
   from its 300 + 300 for time), the modelers' pscan, blocked and chunked solvers
   against the scan on SpottedStar, and ``QuasiPeriodicGP.nuts``. Phases
   32-33 are this slice's main path: the counts of K1, G1 and G2 are
   zeroed before it and each must have launched in it.
34. the parallel package at world size 1 through NCCL (``default_mesh``
   starts a group of one): ``sharded_gls`` at the bench shape through the
   spreading kernel, ``sharded_bls`` at config 11 and ``sharded_aov``
   through the fold kernel, ``sharded_pdm`` at config 4, each timed beside
   its unsharded call, each bit-equal to it (the fold kernel sums in a
   fixed order, so two of its launches agree); ``distributed_fft``,
   ``distributed_ifft`` and ``distributed_acf`` of one series of 2^24
   samples in float32 and 2^22 in float64 against the float64 FFT, cuFFT
   and the container's ACF;
35. ``log_likelihood_sharded`` at config 7's points (N = 1e4, 1e5, 1e6,
   f32 and f64) against the f64 scan within phase 32's limits, and timed
   beside one K1 call; ``run_ensemble_sharded`` at config 8's size, 5
   float64 steps on injected draws card against CPU, and JAX's 2-D
   Gaussian moments; ``BrownianGP(solver="sharded")`` on SpottedStar,
   nll and gradient against ``solver="scan"``;
36. ``utils.trace`` around one bench-shape periodogram (the exported trace
   names the spreading kernel) and ``utils.timer``. Phases 34-36 are this
   slice's main path: the counts of B1, B2 and K1 are zeroed before it, each
   sharded call's launches are counted around it and held (3 B1 a
   ``sharded_gls``, one B2 a chunk, one K1 a likelihood at world size 1),
   and their sums, which must be above 0, are the path's launches;
37. D = 4 ranks' stages of ``sharded_gls``, ``sharded_bls``,
   ``distributed_fft`` and ``log_likelihood_sharded``, each rank in turn on
   the card (the collectives done by the join), against the same stages on
   the CPU, with each rank's stage times; the 4-rank likelihood against the
   one-rank value;
38. GP terms wider than 8 slots, after phase 37: every width's compiled
   local memory and registers (R = 1..16, both dtypes; 0 bytes of local
   memory up to R = 8 but G3's 8 bytes of stack in float64 at R = 5); on
   SpottedStar at config 5's shape (64 walkers, N = 2148, f64) a
   RotationTerm plus a granulation SHOTerm (Q = 1/sqrt(2), R = 12) and a
   BrownianTerm plus a RotationTerm (R = 14), every parameter a tensor:
   the likelihood and its gradient (G1, G2) and ``predict`` (G3) against
   the CPU port within 1e-10; one row of the R = 12 term blocked at N =
   1e5 and chunked at 1e6 (K1) against the f64 scan within phase 32's
   limits; G1, G2, G3 and K1 launched in the phase (counted from zero);
   the rates of config 5's batched likelihood at R = 6, 12, 14 and of
   config 7's blocked point at R = 4 and 12 (evaluations a second, device
   ms of G1 or K1, launches, busy share); G1-G3 at R = 12 and 16 at config
   5's shape and K1 at config 7's N = 1e5, bit-equal to plain, with events,
   device, plain and bound times (a ``{"wide": ...}`` line).

Usage: ``python3 chip_smoke.py`` from the root of a checkout (one GPU).
Any failure raises and the exit code is non-zero. Phases 11-16 print
their rates as one JSON line, phases 17-20 theirs as another, phases 21-22
a ``{"decomposition": ...}`` line, phase 23 a ``{"cells": ...}`` line,
phases 24-26 a ``{"timefrequency": ...}`` line, phases 27-30 a
``{"gp": ...}`` line, phases 31-33 a ``{"kalman": ...}`` line, phases
34-37 a ``{"parallel": ...}`` line and phase 38 a ``{"wide": ...}`` line; the
line
before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
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


def json_line(obj):
    """``obj`` as one JSON line, with NaN (a time not measured) as null."""
    def clean(x):
        if isinstance(x, float) and math.isnan(x):
            return None
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        return x

    return json.dumps(clean(obj))


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
PROFILER_PAD = 4  # untimed calls that open a profiler window


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


def profiled(fn, reps=1, pad=PROFILER_PAD):
    """The device work of ``reps`` calls of ``fn`` as ``[(name, us)]`` (kernels,
    copies and fills), and the wall seconds the calls took to a
    synchronise, from one profiler window.

    Late in a long process the profiler (torch 2.11, CUPTI, on the H100)
    drops the first two kernel launches of every window: their runtime
    launch calls are recorded, their kernels are not, and sleeping before or
    after the calls does not change it. So a window opens with
    ``pad`` untimed calls and a synchronise, the timed calls run
    in a ``record_function`` range, and their device work is found by the
    correlation ids of the runtime calls made in that range. Every kernel
    launched there must be in the window; a window that misses one is taken
    again, opened with 4, 16 and then twice 64 times as many untimed calls
    (a window has dropped all of a 25-launch call after one such call; in
    phase 38 three windows in a row have each missed one of three
    launches), up to five windows, and the run fails if the last misses
    any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for opening in (pad, *(k * max(pad, 1) for k in (4, 16, 64, 64))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(opening):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function("chip_smoke.timed"):
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.profiler.kineto_results.events()
        # the range is on the host; its copy on the device's timeline is no work
        spans = [e for e in events if e.name() == "chip_smoke.timed"]
        host = [e for e in spans if e.device_type() != DeviceType.CUDA]
        check(len(host) == 1, f"one timed range on the host, got {len(host)}")
        lo, hi = host[0].start_ns(), host[0].start_ns() + host[0].duration_ns()
        calls = [e for e in events if e.device_type() != DeviceType.CUDA
                 and e.name().startswith("cu") and lo <= e.start_ns() <= hi]
        ids = {c.correlation_id() for c in calls}
        work = [e for e in events if e.device_type() == DeviceType.CUDA
                and e.correlation_id() in ids and e.name() != "chip_smoke.timed"]
        launched = {c.correlation_id() for c in calls if "LaunchKernel" in c.name()}
        missed = len(launched - {e.correlation_id() for e in work})
        if not missed:
            return [(e.name(), e.duration_ns() / 1e3) for e in work], wall
        print(f"profiler window missed {missed} of {len(launched)} kernel launches; taken again")
    check(False, "the profiler saw every kernel launch in one of five windows")


def device_us(fn, name, reps, pad=PROFILER_PAD):
    """Device time in microseconds per call of ``fn`` of the kernels whose
    name holds ``name`` (every kernel, copy and fill for ``""``), over
    ``reps`` calls in one profiler window (:func:`profiled`, opened with
    ``pad`` untimed calls). A named kernel must run once a call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = [us for n, us in profiled(fn, reps, pad)[0] if name in n]
    check(not name or len(times) == reps, f"{name}: {len(times)} launches in {reps} calls")
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


def check_spreading(label, a):
    """The factored spreading kernel on ``a = (ilo, u_re, u_im, lag, nfft)``
    (CUDA tensors) against its plain version: within 1e-5 of the grid's
    largest value from the float32 plain version and 1e-6 from the float64
    one, the complex grid and the planes bit-equal, two calls bit-equal.
    Returns the largest difference from the float32 plain version."""
    import torch

    from periodicity_tpu_torch.ops.grid2 import (
        extirpolate_grid_factored,
        extirpolate_grid_factored_plain,
    )

    nfft = a[4]
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
    print(f"kernel vs plain [{label}, N={a[0].shape[0]}]: max|d| {err_plain:.3e} (f32 plain), "
          f"{err_f64:.3e} (f64 plain), max|grid| {scale:.3e}; both layouts and two calls "
          f"bit-equal")
    check(err_plain <= 1e-5 * scale, f"{label}: kernel vs f32 plain {err_plain} > 1e-5*{scale}")
    check(err_f64 <= 1e-6 * scale, f"{label}: kernel vs f64 plain {err_f64} > 1e-6*{scale}")
    return err_plain


def time_spreading(label, a, dev, card):
    """Times of the factored spreading kernel on ``a``, its plain version
    and the yardstick (CUDA events, warmed, in turns; and the profiler's
    device time per call), in the layout the pipelines ask for: the
    complex64 grid. The yardstick is a zero-fill and one index_add_ of the
    products u * lag (made outside the timed call) on the flat indices.
    The bound: ilo, u_re, u_im and lag read once, the complex64 grid
    written once."""
    import torch

    from periodicity_tpu_torch.ops.grid2 import (
        extirpolate_grid_factored,
        extirpolate_grid_factored_plain,
    )

    ilo, ure, uim, lag, nfft = a
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
    print(f"spreading [{label}, N={n}]: by events back to back, kernel {got['kernel']:.4f} "
          f"ms, one index_add_ {got['library']:.4f} ms, plain {got['plain']:.4f} ms; device "
          f"time per call (profiler), kernel {got['device']:.4f} ms, one index_add_ "
          f"{got['library_device']:.4f} ms (zero-fill and index_add_); bound "
          f"{got['bound'][0]:.4f} ms ({got['bound'][1]})  ({card})")
    return got


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

    chained("kernel", 1)
    torch.cuda.synchronize()
    work, wall = profiled(lambda: chained("kernel", k), pad=1)
    by_name = {}
    spread_launches = 0
    for name, us in work:  # kernels, copies and fills on the card
        by_name[name] = by_name.get(name, 0.0) + us
        spread_launches += kernel_family(name) == "spreading"
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


def peak_bytes(fn):
    """Peak device memory of one call of ``fn``, above what is held."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def gls_peak(chained, card):
    """Peak device memory of one bench-shape periodogram through the
    kernel, above what is already held; in bytes."""
    import torch

    chained("kernel", 1)
    held = torch.cuda.memory_allocated()
    peak = peak_bytes(lambda: chained("kernel", 1))
    print(f"peak device memory of one bench-shape periodogram, above the {held / 2**20:.1f} MiB "
          f"already held: {peak / 2**20:.1f} MiB  ({card})")
    return peak


def main():
    import torch

    start = time.perf_counter()
    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.ops import _kernels
    from periodicity_tpu_torch.ops.grid2 import extirpolate_grid_factored
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
        args[label] = a = (cuda(ilo), cuda(ure), cuda(uim), cuda(lag), nfft)
        max_abs_err = max(max_abs_err, check_spreading(label, a))

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

    # phase 6: times of the kernel, its plain version and one index_add_
    # call at the main-path shapes and on the clustered draw
    times = {label: time_spreading(label, args[label], dev, card)
             for label in ("pair 2^23", "2f 2^22", "clustered 2^23")}

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
    t0 = time.perf_counter()
    kernels += phase_slice(dev, card, cuda)
    t1 = time.perf_counter()
    b1_record.update(spectral_slice(dev, card, cuda))
    t2 = time.perf_counter()
    kernels += container_slice(dev, card, cuda)
    t3 = time.perf_counter()
    kernels += decomposition_slice(dev, card, cuda)
    t4 = time.perf_counter()
    extra_cells(dev, card, cuda)
    t5 = time.perf_counter()
    kernels += timefrequency_slice(dev, card, cuda)
    t6 = time.perf_counter()
    kernels += gp_slice(dev, card, cuda)
    t7 = time.perf_counter()
    kernels += kalman_slice(dev, card, cuda)
    t8 = time.perf_counter()
    sharded = parallel_slice(dev, card, cuda)
    t9 = time.perf_counter()
    wide_slice(dev, card, cuda, kernels)
    t10 = time.perf_counter()
    adjoint_slice(dev, card, cuda, kernels)
    t11 = time.perf_counter()
    for rec in kernels:
        if rec["name"] in sharded:
            rec["sharded_launches"] = sharded[rec["name"]]
    print(f"wall time: phases 1-6 {t0 - start:.1f} s, 7-10 {t1 - t0:.1f} s, 11-16 "
          f"{t2 - t1:.1f} s, 17-20 {t3 - t2:.1f} s, 21-22 {t4 - t3:.1f} s, 23 {t5 - t4:.1f} s, "
          f"24-26 {t6 - t5:.1f} s, 27-30 {t7 - t6:.1f} s, 31-33 {t8 - t7:.1f} s, 34-37 "
          f"{t9 - t8:.1f} s, 38 {t10 - t9:.1f} s, 39 {t11 - t10:.1f} s")
    print(json_line({"kernels": kernels}))
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

    # phase 7a: fold kernel vs plain, every row (weighted ones too) bit for
    # bit against the plain version on the CPU copies of the inputs, which
    # sums each cell from +0 in ascending sample order as the kernel does
    # (the AoV shape puts ~220 samples in each of its 9 bins, the BLS shape
    # ~8 in each of 256); two launches bit-equal.
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
        again = fold_onehot(*a)
        check(got.shape == (len(periods), vals.shape[0], n_phi * stride), f"fold {label}: shape")
        # the CPU plain version at every period up to 10,000, then at an even
        # spread of them (each period's histogram depends on no other)
        step = max(1, len(periods) // 10_000)
        ref = fold_onehot_plain(a[0].cpu(), a[1].cpu(), a[2][::step].cpu(), *a[3:5],
                                None if a[5] is None else a[5].cpu())
        check(same_bits(got[::step], ref), f"fold {label}: every row bit-equal to the CPU plain "
                                            f"version")
        check(same_bits(again, got), f"fold {label}: two launches bit-equal")
        for r in counts:
            check(bool((got[:, r].sum(-1) == len(tt)).all()), f"fold {label}: counts sum to N")
        print(f"fold kernel vs plain [{label}]: every row bit-equal to the CPU plain version at "
              f"{len(range(0, len(periods), step))} periods ({vals.shape[0]} rows, counts "
              f"{counts}); two launches bit-equal")

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
    # B2's yardstick, as B1's: a zero-fill and one index_add_ of the values
    # on flat (period, row, bin) indices computed beforehand by the float32
    # bin formula (fold_onehot_plain's), at the chunk; also under
    # torch.use_deterministic_algorithms(True), as B2 is deterministic
    from periodicity_tpu_torch.ops.fold import _f32_inputs

    t32c, vals_c, freqs_c = _f32_inputs(*chunk_args[:3])
    nphi_c = chunk_args[3]
    phi_c = t32c[None, :] * freqs_c[:, None]
    phi_c = phi_c - torch.floor(phi_c)
    bins_c = (phi_c * nphi_c).to(torch.int32).clamp_(0, nphi_c - 1).to(torch.int64)
    nv_c = vals_c.shape[0]
    rows_c = (torch.arange(freqs_c.shape[0], device=dev)[:, None, None] * nv_c
              + torch.arange(nv_c, device=dev)[None, :, None])
    flat_c = (rows_c * nphi_c + bins_c[:, None, :]).reshape(-1)
    src_c = vals_c.expand(freqs_c.shape[0], -1, -1).reshape(-1).contiguous()
    out_c = freqs_c.shape[0] * nv_c * nphi_c

    def chunk_library():
        return torch.zeros(out_c, device=dev).index_add_(0, flat_c, src_c)
    b2_yard = {}
    for mode, det in (("", False), ("deterministic_", True)):
        torch.use_deterministic_algorithms(det)
        try:
            chunk_library()
            b2_yard[f"chunk_{mode}library_ms"] = event_ms(chunk_library, 200)
            b2_yard[f"chunk_{mode}library_device_ms"] = device_us(chunk_library, "", 50) / 1e3
            note = (f"{b2_yard[f'chunk_{mode}library_device_ms'] * 1e3:.2f} us device, "
                    f"{b2_yard[f'chunk_{mode}library_ms'] * 1e3:.2f} us events")
        except RuntimeError as err:  # no deterministic index_add_ in this torch
            b2_yard[f"chunk_{mode}library_ms"] = b2_yard[f"chunk_{mode}library_device_ms"] = None
            note = f"not run ({err})"
        finally:
            torch.use_deterministic_algorithms(False)
        print(f"fold [config 11 chunk]: yardstick zero-fill + one index_add_ on flat (period, "
              f"row, bin) indices{' (deterministic)' if det else ''}: {note}  ({card})")
    check(float((chunk_library().reshape(-1, nv_c, nphi_c) - fold_onehot(*chunk_args)).abs().max())
          <= 1e-6, "B2's index_add_ yardstick computes the chunk's histograms")
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
    # whose samples overflow the kernel's ring of staged samples; with its
    # plain version and one index_add_ call on the same draw
    def b3_clustered():
        return extirpolate_grid(*grid_args["clustered 2^23"])

    clustered_times = timed(extirpolate_grid, extirpolate_grid_plain,
                            grid_args["clustered 2^23"], 20, 20)
    clustered_ms = clustered_times["kernel"]
    clustered_dev_us = device_us(b3_clustered, "spread_walk", 5)
    ilo_c, vals_c, _ = grid_args["clustered 2^23"]
    flat_c = (ilo_c.long()[:, None] + torch.arange(4, device=dev)).reshape(-1)
    vals_c_re = torch.view_as_real(vals_c).reshape(-1, 2)

    def library_clustered():
        return torch.zeros(nfft3, 2, device=dev).index_add_(0, flat_c, vals_c_re)

    library_clustered()
    clustered_library = statistics.mean(event_ms(library_clustered, 20) for _ in range(2))
    clustered_library_dev_us = device_us(library_clustered, "", 20)
    print(f"unfactored spreading [clustered 2^23, half the samples in one 2048-cell tile]: "
          f"kernel {clustered_ms:.4f} ms by events, {clustered_dev_us / 1e3:.4f} ms of device "
          f"time; plain {clustered_times['plain']:.4f} ms; one index_add_ "
          f"{clustered_library:.4f} ms by events, {clustered_library_dev_us / 1e3:.4f} ms of "
          f"device time  ({card})")

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

    work, wall = profiled(lambda: chained("kernel"), pad=1)
    by_kernel = {}
    for name, us in work:  # kernels, copies and fills on the card
        by_kernel[name] = by_kernel.get(name, 0.0) + us
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
    peak_mem = peak_bytes(lambda: chained("kernel", 1))
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
            "held": "bit-equal to the CPU plain version, every row",
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
            **b2_yard,
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
            "clustered_device_ms": clustered_dev_us / 1e3,
            "clustered_plain_ms": clustered_times["plain"],
            "clustered_library_ms": clustered_library,
            "clustered_library_device_ms": clustered_library_dev_us / 1e3,
        },
    ]


# the spectral slice's shapes (benchmarks/run_benchmarks.py): configs 1
# (:33-67), 6 (:303-351), 12 (:662-703) and 14 (:814-880), and the
# bootstrap at the verify drive's shape
C1_N = 10_000
C6_B, C6_N, C6_NF = 32, 100_000, 1_000_000
C6_PERIODS = (5.0, 7.7, 11.0, 17.0, 23.0, 31.0, 43.0, 59.0) * 4
C12_N = 10_000
C14_N, C14_NF = 1_000_000, 100_000
# the JAX package's float32 multi-term fast path against its float64 direct
# method, at config 12 reduced to N = 2000 (same grid and signal model), as
# a share of the peak, over the bins where cond(G) <= 1e4; pinned by
# tests/test_torch_spectral.py::test_config12_tolerance_is_jax_float32_error
C12_JAX_F32_ERR = 2.6e-5
BOOT_N = 2000
BOOT_R = 64


def light_curve(n, baseline, seed=0, harmonic=False):
    """A benchmark light curve: sorted uniform float32 times, a 7.7-day
    sinusoid (plus its half-amplitude second harmonic for config 12) and
    noise 0.3, errors 0.3."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, baseline, n)).astype(np.float32)
    y = np.sin(2 * np.pi * t / PERIOD)
    if harmonic:
        y = y + 0.5 * np.sin(4 * np.pi * t / PERIOD + 0.4)
    y = (y + 0.3 * rng.standard_normal(n)).astype(np.float32)
    return t, y, np.full(n, 0.3, np.float32)


def gram_cond(t, w, freqs, nterms):
    """Condition number per frequency of the exact weighted Gram matrix
    X^T W X + 1e-12 I of the harmonic design [1, cos(m w t), sin(m w t)]
    (m <= nterms), float64, 256 frequencies at a time. Rounding in
    any implementation of a scan over that design moves its power by up to
    about eps * cond of the peak."""
    import torch

    t = t.double()
    w = w.double() / w.double().sum()
    eye = 1e-12 * torch.eye(2 * nterms + 1, dtype=torch.float64, device=t.device)
    out = []
    for s in range(0, freqs.shape[0], 256):
        ph = (2 * math.pi) * freqs[s:s + 256, None].double() * t[None, :]
        X = torch.stack([torch.ones_like(ph)] + [fn(m * ph) for m in range(1, nterms + 1)
                                                  for fn in (torch.cos, torch.sin)], dim=-1)
        out.append(torch.linalg.cond(X.transpose(-1, -2) @ (X * w[None, :, None]) + eye))
    return torch.cat(out)


def pipeline_spreading_inputs(t, w1, w2, df, fmin, nfft):
    """What a float32 pipeline hands the spreading kernel for the sums of
    (w1, w2) at (df, fmin) on ``nfft`` cells (ops/trig_sum.py): sorted
    bases, the rotated weights and the Lagrange weights."""
    import torch

    from periodicity_tpu_torch.ops import trig_sum as ts

    trel = t - t.min()
    u = torch.complex(w1, w2) * ts._phase_factor(fmin, trel, torch.float32, torch.complex64)
    inds, lag = ts._extirpolate_weights(trel, df, nfft, torch.float32)
    return (inds[:, 0].to(torch.int32).contiguous(), u.real.contiguous(),
            u.imag.contiguous(), lag.contiguous(), nfft)


def profile_window(fn):
    """(device busy ms, wall ms) of one call of ``fn`` in a profiler
    window, ending in a synchronise. Each ``fn`` here launches many kernels,
    so one untimed call opens the window."""
    import torch

    fn()
    torch.cuda.synchronize()
    work, wall = profiled(fn, pad=1)
    busy = sum(us for _, us in work)
    check(busy > 0, "the profiler saw device work")
    return busy / 1e3, wall * 1e3


def spectral_slice(dev, card, cuda):
    """Phases 11-16: the rest of spectral on the card. Returns B1's added
    record: its launches on the batched and bootstrap paths and at config
    14, and its times at config 14's two pipeline shapes."""
    import torch

    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.models.spectral import _bootstrap_powers, _pair_q, _solve_spd_small
    from periodicity_tpu_torch.ops.grid2 import extirpolate_grid_factored
    from periodicity_tpu_torch.ops.trig_sum import grid_size
    from periodicity_tpu_torch.spectral import (
        BGLST,
        GLS,
        MultibandGLS,
        bglst_log_ml,
        default_frequency_grid,
        gls_power,
        gls_power_batch,
        gls_power_multiband,
        gls_power_multiterm,
    )

    record = {}
    spectral = {}

    # phase 11: config 1, the GLS rate at N = 1e4 (50 chained periodograms)
    t, y, e = light_curve(C1_N, 100.0)
    tc, yc, ec = cuda(t), cuda(y), cuda(e)
    df = float(np.float32(1.0 / 500.0))
    fmin = float(np.float32(df / 2))
    nf1 = int((0.5 * C1_N / 100.0) / df)

    def chain1(k=50):
        yk, acc = yc, torch.zeros((), device=dev)
        for _ in range(k):
            p = gls_power(tc, yk, ec, df, fmin, nf1, pair_q=1, gridder="kernel")
            yk = yk + p[:yk.shape[0]] * 1e-9
            acc = acc + p[0]
        return acc

    chain1(2)
    runs = [50 / (event_ms(chain1, 1) / 1e3) for _ in range(3)]
    busy, wall = profile_window(lambda: chain1(5))
    spectral["config1_periodograms_per_s"] = statistics.mean(runs)
    spectral["config1_busy"] = busy / wall
    print(f"config 1 (N={C1_N}, nf={nf1}): {statistics.mean(runs):.1f} periodograms/s over 50 "
          f"chained, runs {[f'{r:.1f}' for r in runs]}; device busy {busy / 5:.4f} ms per "
          f"periodogram ({busy / wall:.1%} of the wall time of 5)  ({card})")

    # phase 12: config 6, gls_power_batch in both layouts
    b, n6, nf6 = C6_B, C6_N, C6_NF
    rng = np.random.default_rng(0)
    t6 = np.sort(rng.uniform(0, 1000.0, n6)).astype(np.float32)
    ys6 = np.stack([np.sin(2 * np.pi * t6 / p) for p in C6_PERIODS[:b]]).astype(np.float32)
    t6c, ys6c, es6c = cuda(t6), cuda(ys6), cuda(np.full((b, n6), 0.3, np.float32))
    df6 = float(np.float32(0.5 / 1000.0))
    fmin6 = float(np.float32(df6 / 2))

    def batch(layout, ys=ys6c):
        gridder = "kernel" if layout == "kernel loop" else "scatter"
        return gls_power_batch(t6c, ys, es6c, df6, fmin6, nf6, pair_q=1, gridder=gridder)

    extirpolate_grid_factored.launches = 0
    pk = batch("kernel loop")
    torch.cuda.synchronize()
    record["batch_launches"] = extirpolate_grid_factored.launches
    print(f"config 6 (B={b}, N={n6}, nf={nf6}) kernel loop: {record['batch_launches']} spreading "
          f"launches")
    check(record["batch_launches"] == 2 * b, f"{2 * b} launches per batch, got "
          f"{record['batch_launches']}")
    ps = batch("row spreading")
    k_nyq = int((0.5 / float(TSeries(t6c, ys6c[0]).median_dt) - fmin6) / df6) + 1
    for layout, pw in (("kernel loop", pk), ("row spreading", ps)):
        check(pw.shape == (b, nf6) and pw.dtype == torch.float32
              and bool(torch.isfinite(pw).all()), f"{layout}: finite [B, nf] float32")
        f_best = fmin6 + df6 * torch.argmax(pw, dim=1).double().cpu().numpy()
        off = np.abs(f_best - 1 / np.array(C6_PERIODS[:b]))
        # df6 is a 0.5%-wide period cell only up to P = 20 d: each row's
        # best frequency is held to the cell of its injected one
        check((off <= df6).all(), f"{layout}: best frequencies within one cell, off {off.max()}")
        for i in (1, b - 1):
            ref = gls_power(t6c.double(), ys6c[i].double(), es6c[i].double(), df6, fmin6, nf6,
                            pair_q=1, gridder="scatter")
            dp = (pw[i].double() - ref).abs() / ref.max()
            d_band, d_all = float(dp[:k_nyq].max()), float(dp.max())
            print(f"config 6 {layout}, row {i} (P={C6_PERIODS[i]}): f32 vs f64 max|dp|/peak "
                  f"{d_band:.3e} below pseudo-Nyquist ({k_nyq} bins), {d_all:.3e} on all; best "
                  f"period {1 / f_best[i]:.4f}")
            check(d_band <= 1e-4 and d_all <= 5e-4, f"config 6 {layout} row {i}: {d_band}, "
                  f"{d_all}")
        print(f"config 6 {layout}: every row's best frequency within one cell of its injected "
              f"one (largest offset {off.max():.3e}, cell {df6:.1e})")
    del pk, ps

    def chain6(layout, k=5):
        ys, acc = ys6c, torch.zeros((), device=dev)
        for _ in range(k):
            p = batch(layout, ys)
            ys = ys + p[:, :n6] * 1e-9
            acc = acc + p[:, 0].sum()
        return acc

    rates = {}
    for layout in ("kernel loop", "row spreading", "row spreading", "kernel loop"):
        ms = event_ms(lambda: chain6(layout), 1)
        rates.setdefault(layout, []).append(b * nf6 * 5 / (ms / 1e3))
    for layout, r in rates.items():
        key = layout.split()[0]
        busy, wall = profile_window(lambda: batch(layout))
        mem = peak_bytes(lambda: batch(layout))
        spectral[f"config6_{key}_freqs_per_s"] = statistics.mean(r)
        spectral[f"config6_{key}_peak_mib"] = mem / 2**20
        spectral[f"config6_{key}_busy"] = busy / wall
        print(f"config 6 {layout}: {statistics.mean(r):.4e} aggregate trial-freqs/s (K=5 chained "
              f"batches), runs {[f'{x:.4e}' for x in r]}; one batch: device busy {busy:.2f} ms of "
              f"{wall:.2f} ms wall ({busy / wall:.1%}), peak memory {mem / 2**20:.1f} MiB  "
              f"({card})")
    del ys6c, es6c

    # phase 13: config 12, the multi-term scan (K = 3), f32 fast vs f64 direct
    t, y, e = light_curve(C12_N, 100.0, harmonic=True)
    tc, yc, ec = cuda(t), cuda(y), cuda(e)
    nf12 = int((0.5 * C12_N / 100.0) / df)
    p32 = gls_power_multiterm(tc, yc, ec, df, fmin, nf12, 3)
    p64 = gls_power_multiterm(tc.double(), yc.double(), ec.double(), df, fmin, nf12, 3,
                              method="direct")
    freqs = fmin + df * torch.arange(nf12, dtype=torch.float64, device=dev)
    cond = gram_cond(tc, ec ** -2.0, freqs, 3)
    peak = float(p64.max())
    eps32 = float(torch.finfo(torch.float32).eps)
    tol = (2 * C12_JAX_F32_ERR + 1e-6 + eps32 * cond) * peak
    err12 = (p32.double() - p64).abs()
    conditioned = eps32 * cond < 1
    check(p32.shape == (nf12,) and bool(torch.isfinite(p32[conditioned]).all()),
          "config 12: finite power wherever float32 keeps a digit of the normal equations")
    ok = (err12 <= tol) | ~torch.isfinite(p32)
    worst = float((err12 / tol)[torch.isfinite(p32)].max())
    well = cond <= 1e4
    print(f"config 12 (K=3, N={C12_N}, nf={nf12}): f32 fast vs f64 direct max|dp|/peak "
          f"{float(err12[well].max()) / peak:.3e} where cond(G) <= 1e4 ({int(well.sum())} bins; "
          f"JAX at reduced N: {C12_JAX_F32_ERR:.1e}), largest share of the per-bin tolerance "
          f"{worst:.3f}; cond(G) of the first bins {[f'{c:.2e}' for c in cond[:3].tolist()]}")
    check(bool(ok.all()), "config 12: f32 fast vs f64 direct within the per-bin tolerance")
    f_best = fmin + df * int(torch.argmax(torch.nan_to_num(p32, nan=-1.0)))
    print(f"config 12: best period {1 / f_best:.4f} (injected {PERIOD}; cell {df:.1e})")
    check(abs(f_best - 1 / PERIOD) <= df, f"config 12 best frequency {f_best} within one cell")

    def chain12(k=10):
        yk, acc = yc, torch.zeros((), device=dev)
        for _ in range(k):
            p = gls_power_multiterm(tc, yk, ec, df, fmin, nf12, 3)
            yk = yk + p[:yk.shape[0]] * 1e-9
            acc = acc + p[0]
        return acc

    chain12(1)
    runs = [nf12 * 10 / (event_ms(chain12, 1) / 1e3) for _ in range(2)]
    busy12, wall12 = profile_window(lambda: chain12(2))
    spectral["config12_freqs_per_s"] = statistics.mean(runs)
    spectral["config12_busy"] = busy12 / wall12
    # the unrolled Cholesky of the scan against one torch.linalg.solve of
    # the same [nf, 7, 7] float32 batch (a well-conditioned random one)
    rng = np.random.default_rng(12)
    a = cuda(rng.standard_normal((nf12, 10, 7)).astype(np.float32))
    G = a.transpose(-1, -2) @ a + 1e-3 * torch.eye(7, device=dev)
    bvec = cuda(rng.standard_normal((nf12, 7)).astype(np.float32))
    solve_runs = {"unrolled": [], "library": []}
    fns = {"unrolled": lambda: _solve_spd_small(G, bvec),
           "library": lambda: torch.linalg.solve(G, bvec[..., None])[..., 0]}
    x_un, x_lib = fns["unrolled"](), fns["library"]()
    rel = float((x_un - x_lib).abs().max() / x_lib.abs().max())
    check(rel <= 1e-3, f"unrolled solve vs torch.linalg.solve {rel}")
    for which in ("unrolled", "library", "library", "unrolled"):
        solve_runs[which].append(event_ms(fns[which], 20))
    solve = {k: statistics.mean(v) for k, v in solve_runs.items()}
    solve_dev = {k: device_us(fn, "", 5) / 1e3 for k, fn in fns.items()}
    spectral["config12_solve_ms"] = solve["unrolled"]
    spectral["config12_solve_device_ms"] = solve_dev["unrolled"]
    spectral["config12_linalg_solve_ms"] = solve["library"]
    spectral["config12_linalg_solve_device_ms"] = solve_dev["library"]
    print(f"config 12: {statistics.mean(runs):.4e} trial-freqs/s (K=10 chained), runs "
          f"{[f'{r:.4e}' for r in runs]}; device busy {busy12 / 2:.3f} ms per scan "
          f"({busy12 / wall12:.1%}); the [{nf12}, 7, 7] f32 solve: unrolled Cholesky "
          f"{solve['unrolled']:.3f} ms by events ({solve_dev['unrolled']:.3f} ms device), one "
          f"torch.linalg.solve {solve['library']:.3f} ms ({solve_dev['library']:.3f} ms device); "
          f"agree to {rel:.1e}  ({card})")

    # phase 14: config 14, N = 1e6 onto 2^19 and 2^18 cells: every tile dense
    n14, nf14 = C14_N, C14_NF
    t, y, e = light_curve(n14, 1000.0)
    tc, yc, ec = cuda(t), cuda(y), cuda(e)
    df14 = float(np.float32(1.0 / 5000.0))
    fmin14 = float(np.float32(df14 / 2))
    w = ec ** -2.0
    w = w / w.sum()
    wy = w * (yc - torch.dot(w, yc))
    nfft14 = grid_size(nf14)
    log2 = nfft14.bit_length() - 1
    pair_label, f2_label = f"config 14 pair 2^{log2}", f"config 14 2f 2^{log2 - 1}"
    shapes = {
        pair_label: pipeline_spreading_inputs(tc, wy, w, df14, fmin14, nfft14),
        f2_label: pipeline_spreading_inputs(tc, w, torch.zeros_like(w), 2 * df14, 2 * fmin14,
                                            nfft14 // 2),
    }
    c14_err = 0.0
    for label, a in shapes.items():
        per_tile = a[0].shape[0] / (int(a[0].max()) // TILE + 1)
        print(f"{label}: {per_tile:.0f} samples per occupied 2048-cell tile on average "
              f"(the ring holds 512)")
        c14_err = max(c14_err, check_spreading(label, a))
    extirpolate_grid_factored.launches = 0
    p32 = gls_power(tc, yc, ec, df14, fmin14, nf14, pair_q=1, gridder="kernel")
    torch.cuda.synchronize()
    record["config14_launches"] = extirpolate_grid_factored.launches
    check(record["config14_launches"] == 2, "config 14: two spreading launches")
    p64 = gls_power(tc.double(), yc.double(), ec.double(), df14, fmin14, nf14, pair_q=1,
                    gridder="scatter")
    d14 = float((p32.double() - p64).abs().max() / p64.max())
    best = 1 / (fmin14 + df14 * int(torch.argmax(p32)))
    print(f"config 14 (N={n14}, nf={nf14}): f32 kernel vs f64 scatter max|dp|/peak {d14:.3e} "
          f"(the whole grid lies below pseudo-Nyquist); best period {best:.5f}")
    check(bool(torch.isfinite(p32).all()) and d14 <= 1e-4, f"config 14 f32 vs f64 {d14}")
    check(abs(best - PERIOD) <= 0.005 * PERIOD, f"config 14 best period {best}")

    def chain14(k=10):
        yk, acc = yc, torch.zeros((), device=dev)
        for _ in range(k):
            p = gls_power(tc, yk, ec, df14, fmin14, nf14, pair_q=1, gridder="kernel")
            yk = torch.cat([yk[:nf14] + p * 1e-9, yk[nf14:]])
            acc = acc + p[0]
        return acc

    chain14(1)
    runs = [10 / (event_ms(chain14, 1) / 1e3) for _ in range(2)]
    busy, wall = profile_window(lambda: chain14(3))
    spectral["config14_periodograms_per_s"] = statistics.mean(runs)
    spectral["config14_busy"] = busy / wall
    print(f"config 14: {statistics.mean(runs):.2f} periodograms/s (K=10 chained), runs "
          f"{[f'{r:.2f}' for r in runs]}; device busy {busy / 3:.4f} ms per periodogram "
          f"({busy / wall:.1%})  ({card})")
    for prefix, label in (("c14_", pair_label), ("c14_2f_", f2_label)):
        got = time_spreading(label, shapes[label], dev, card)
        record.update({
            f"{prefix}ms": got["kernel"],
            f"{prefix}plain_ms": got["plain"],
            f"{prefix}bound_ms": got["bound"][0],
            f"{prefix}bound_by": got["bound"][1],
            f"{prefix}library_ms": got["library"],
            f"{prefix}device_ms": got["device"],
            f"{prefix}library_device_ms": got["library_device"],
        })
    record["c14_max_abs_err"] = c14_err
    del shapes, tc, yc, ec, w, wy

    # phase 15: bootstrap at the verify drive's shape through the kernel
    rng = np.random.default_rng(1)
    tb = np.sort(rng.uniform(0, 100, BOOT_N)).astype(np.float32)
    yb = (np.sin(2 * np.pi * tb / PERIOD) + 0.3 * rng.standard_normal(BOOT_N)).astype(np.float32)
    ts = TSeries(cuda(tb), cuda(yb))
    gls = GLS()
    pg = gls(ts)
    check(gls._gridder_resolved == "kernel", "bootstrap: the estimator picked the kernel")
    extirpolate_grid_factored.launches = 0
    reps = gls.bootstrap(BOOT_R, random_seed=0)
    record["bootstrap_launches"] = extirpolate_grid_factored.launches
    check(record["bootstrap_launches"] == 2 * BOOT_R,
          f"two launches per replicate, got {record['bootstrap_launches']}")
    check(reps.shape == (BOOT_R,) and np.isfinite(reps).all(), "bootstrap replicates finite")
    freq = gls.frequency
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, BOOT_N, (BOOT_R, BOOT_N), generator=gen, device=dev)
    kw = dict(pair_q=_pair_q(freq[1] - freq[0], freq[0], freq.size))
    args = (idx, ts.time, ts.values, gls.err, float(freq[1] - freq[0]), float(freq[0]),
            freq.size)
    again = _bootstrap_powers(*args, gridder="kernel", **kw).cpu().numpy()
    rows = _bootstrap_powers(*args, gridder="scatter", **kw).cpu().numpy()
    d_boot = float(np.abs(rows - reps).max() / reps.max())
    print(f"bootstrap ({BOOT_R} replicates, N={BOOT_N}, nf={freq.size}): "
          f"{record['bootstrap_launches']} spreading launches; replicates vs the row-spreading "
          f"layout on the same indices max|d|/max {d_boot:.3e}")
    check(np.array_equal(again, reps), "the estimator's replicates are those of its indices")
    check(d_boot <= 1e-4, f"bootstrap kernel vs row spreading {d_boot}")
    gls.bootstrap(BOOT_R)
    runs = [BOOT_R / (event_ms(lambda: gls.bootstrap(BOOT_R), 1) / 1e3) for _ in range(2)]
    busy, wall = profile_window(lambda: gls.bootstrap(BOOT_R))
    spectral["bootstrap_replicates_per_s"] = statistics.mean(runs)
    spectral["bootstrap_busy"] = busy / wall
    print(f"bootstrap: {statistics.mean(runs):.1f} replicates/s, runs "
          f"{[f'{r:.1f}' for r in runs]}; device busy {busy / BOOT_R:.4f} ms per replicate "
          f"({busy / wall:.1%})  ({card})")

    # phase 16: the rest of the surface, once each on the card
    peak_power = float(pg.values.max())
    check(gls.fap(peak_power) == 0.0 and 0 < gls.fal(0.5) < peak_power, "bootstrap FAP/FAL")
    z = gls.fal(0.05, method="baluev")
    check(abs(float(gls.fap(z, method="baluev")) - 0.05) <= 1e-6 * 0.05, "Baluev FAP/FAL")
    gls.refine(n_peaks=2)
    g64 = GLS()
    g64(TSeries(ts.time.double(), ts.values.double()))
    g64.refine(n_peaks=2)
    check(abs(gls.refined_fbest - g64.refined_fbest) <= 1e-6,
          f"refine: {gls.refined_fbest} vs the f64 direct {g64.refined_fbest}")
    win = gls.window().values
    check(win.shape == pg.values.shape and bool(torch.isfinite(win).all()), "window")
    fit = gls.model(tb, 1 / PERIOD).values.cpu().numpy()
    corr = float(np.corrcoef(fit, np.sin(2 * np.pi * tb / PERIOD))[0, 1])
    check(corr > 0.99, f"model correlates with the injected sinusoid: {corr}")
    # the 3-harmonic model nests the sinusoid: its largest power is at least
    # the single-term peak (on a pure sinusoid it is reached at P and at 2P)
    # (float32 gives NaN or noise where it keeps no digit of the normal
    # equations, at the lowest bins, as the JAX package does)
    g3 = GLS(nterms=3)
    p3 = g3(ts).values
    cond3 = gram_cond(ts.time, g3.err ** -2.0, torch.from_numpy(g3.frequency).to(dev), 3)
    best3 = float(torch.nan_to_num(p3, nan=-1.0).max())
    check(bool(torch.isfinite(p3[eps32 * cond3 < 1]).all()) and best3 >= peak_power - 1e-3,
          f"GLS(nterms=3) peak {best3} vs the single-term {peak_power}")
    print(f"surface on card: refine {gls.refined_fbest:.8f} (f64 {g64.refined_fbest:.8f}); "
          f"window finite; model corr {corr:.5f}; Baluev FAL(0.05) {z:.5f}; bootstrap FAL(0.5) "
          f"{gls.fal(0.5):.5f}; GLS(nterms=3) peak power {best3:.5f} (single-term "
          f"{peak_power:.5f})")

    rng = np.random.default_rng(5)
    tg = np.sort(rng.uniform(0, 60, 400))
    yg = np.sin(2 * np.pi * tg / 6.1) + 0.05 * tg + 0.2 * rng.standard_normal(400)
    bts = TSeries(cuda(tg), cuda(yg))
    fs = BGLST()(bts, err=np.full(400, 0.2))  # the fast method
    _, dfb, fminb = default_frequency_grid(bts)
    direct = bglst_log_ml(bts.time, bts.values, cuda(np.full(400, 0.2)) ** -2.0, dfb, fminb,
                          fs.values.shape[0])
    fast = fs.values
    bad = ((fast - direct).abs() > 5e-8 + 1e-7 * direct.abs()).sum()
    best_b = float(1 / fs.frequency[int(torch.argmax(fs.values))])
    print(f"BGLST on card (f64): fast vs direct max|d| {float((fast - direct).abs().max()):.3e} "
          f"(JAX's bound: atol 5e-8, rtol 1e-7); best period {best_b:.4f} (injected 6.1)")
    check(int(bad) == 0, "BGLST fast vs direct")
    check(abs(best_b - 6.1) <= 0.1, f"BGLST best period {best_b}")

    rng = np.random.default_rng(7)
    parts = []
    for s in range(3):
        tm = np.sort(rng.uniform(0, 40, 180))
        ym = ((0.0, 5.0, -4.0)[s] + (1.0, 0.7, 1.3)[s]
              * np.sin(2 * np.pi * tm / 2.3 + 2 * np.pi * s / 3) + 0.05 * rng.standard_normal(180))
        parts.append((tm, ym))
    mb = MultibandGLS(fmax=2.0)
    mfs = mb({s: TSeries(cuda(tm), cuda(ym)) for s, (tm, ym) in enumerate(parts)},
             err={s: np.full(180, 0.05) for s in range(3)})
    freq = mb.frequency
    args = (mb.signal.time, mb.signal.values, mb.err, mb.bands, 3, float(freq[1] - freq[0]),
            float(freq[0]), freq.size)
    mdirect = gls_power_multiband(*args, method="direct")
    bad = ((mfs.values - mdirect).abs() > 5e-6 + 1e-7 * mdirect.abs()).sum()
    best_m = float(mfs.period_at_highest_peak)
    print(f"MultibandGLS on card (f64): fast vs direct max|d| "
          f"{float((mfs.values - mdirect).abs().max()):.3e} (JAX's bound: atol 5e-6); best "
          f"period {best_m:.4f} (injected 2.3)")
    check(int(bad) == 0, "MultibandGLS fast vs direct")
    check(abs(best_m - 2.3) <= 0.05 * 2.3, f"MultibandGLS best period {best_m}")

    print(json_line({"spectral": spectral}))
    return record


# the container slice (phases 17-20): SpottedStar (periodicity_tpu/data,
# N = 2148), config 2 (benchmarks/run_benchmarks.py:70-137) and the GP
# prior's ACF ladder, make_gaussian_prior's defaults a = 1, b = 2, n = 8
# (periodicity_tpu/models/gp/priors.py:63-67), copied as constants
C2_B = 256
C2_WIDTH = 5
LADDER = 1.0 * 2.0 ** np.arange(8)
# dependent-operation latency of one Hopper SM in cycles (published
# microbenchmarks of the Volta-to-Hopper SMs: 4 for a float32 add or
# multiply, 8 for float64), and a correctly rounded division counted as 5
# dependent operations (the reciprocal estimate and four Newton and
# correction steps), for the recursions' chain bound
DEP_CYCLES = {"float32": 4, "float64": 8}
DIV_OPS = 5


def sm_clock_hz():
    """The card's maximum SM clock, from nvidia-smi."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()
    return float(smi[0]) * 1e6


def chain_bound(bytes_moved, chain_ops, dtype, clock_hz):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and a
    chain of ``chain_ops`` dependent operations at one operation's latency
    (``DEP_CYCLES`` at ``clock_hz``)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_chain = chain_ops * DEP_CYCLES[dtype] / clock_hz * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_chain else (t_chain, "operations")


def held(kernel, plain, dtype):
    """'bit-equal' where the kernel's result equals its plain version's bit
    for bit, else '1e-12 relative' in float64 where it is that close;
    fails otherwise."""
    import torch

    kernel = kernel.cpu()
    if torch.equal(kernel, plain.cpu()):
        return "bit-equal"
    rel = float((kernel - plain.cpu()).abs().max() / plain.abs().max())
    check(dtype == torch.float64 and rel <= 1e-12,
          f"kernel vs plain {rel:.3e} relative ({dtype}): neither bit-equal nor within 1e-12")
    return "1e-12 relative"


def penta_quotient_pairs(main, off1, off2, rhs, dtype):
    """The (numerator, divisor) pairs the pentadiagonal factor divides, in
    ``dtype``, in the plain version's order (``ops/spline.py``'s
    ``_pentadiagonal_rows``): each row's beta and alpha over a nonzero
    pivot and its z over its own pivot. Two CPU tensors."""
    import torch

    np_t = np.float64 if dtype == torch.float64 else np.float32
    a, r = main.cpu().numpy().astype(np_t), rhs.cpu().numpy().astype(np_t)
    b = np.concatenate([[0], off1.cpu().numpy()]).astype(np_t)
    c = np.concatenate([[0, 0], off2.cpu().numpy()]).astype(np_t)
    zero = np_t(0)
    nums, dens = [], []
    D1 = D2 = al1 = z1 = z2 = zero
    with np.errstate(all="ignore"):
        for i in range(a.shape[0]):
            be = c[i] / D2 if D2 != 0 else zero
            num = b[i] - be * al1 * D2
            al = num / D1 if D1 != 0 else zero
            D = a[i] - al * al * D1 - be * be * D2
            z = r[i] - al * z1 - be * z2
            nums += [c[i], num, z] if D2 != 0 and D1 != 0 else [z]
            dens += [D2, D1, D] if D2 != 0 and D1 != 0 else [D]
            D1, D2, al1, z1, z2 = D, D1, al, z, z1
    return torch.from_numpy(np.array(nums, np_t)), torch.from_numpy(np.array(dens, np_t))


def plain_wall_ms(fn):
    """Wall time of one call of a plain version on card tensors (the host
    loop and its copies), synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def recursion_shapes(dev, n_ext, sos5, system):
    """Phase 17's shapes past the main path's: R1 at 1, 5 and 16 sections
    over 1, 7 and 64 rows, R2 held in shared memory and streamed past it
    and on its zero-pivot system, both bit-equal to their plain versions;
    the checked quotient against the division; the kernels' resources."""
    import torch

    from periodicity_tpu_torch.ops import _kernels, filters, spline

    rng = np.random.default_rng(17)
    out = {"sosfilt": {}, "pentadiagonal": {}}
    sos16 = filters.butter_sos(16, [0.02, 0.4], "bandpass")
    for ns in (1, 5, 16):
        sos = sos5 if ns == 5 else sos16[:ns]
        for rows in (1, 7, 64):
            n = n_ext if rows < 64 or ns == 5 else 400
            x = torch.from_numpy(rng.standard_normal((rows, n))).to(dev)
            zi = torch.from_numpy(rng.standard_normal((rows, ns, 2))).to(dev)
            y, zf = filters.sosfilt(sos, x, zi)
            yp, zp = filters.sosfilt_plain(sos, x, zi)
            torch.cuda.synchronize()
            check(torch.equal(y, yp) and torch.equal(zf, zp),
                  f"sosfilt kernel bit-equal at {ns} sections, {rows} rows x {n}")
            ms = event_ms(lambda: filters.sosfilt(sos, x, zi), 10)
            out["sosfilt"][f"ns{ns}_rows{rows}_n{n}_ms"] = ms
            if ns == 5 and rows == 64:
                out["sosfilt_b64_ms"] = ms
    caps = {dt: spline.pentadiagonal_capacity(dt) for dt in (torch.float64, torch.float32)}
    out["pentadiagonal"]["capacity_rows"] = {"float64": caps[torch.float64],
                                             "float32": caps[torch.float32]}
    for dt, ms_ in ((torch.float64, (5000, caps[torch.float64] + 1, 100_000)),
                    (torch.float32, (9000, caps[torch.float32] + 1))):
        for m in ms_:
            bands = [torch.from_numpy(v).to(dev, dt) for v in (
                4.0 + rng.uniform(0, 1, m), rng.uniform(-1, 1, m - 1),
                rng.uniform(-0.5, 0.5, m - 2), rng.standard_normal(m))]
            got = spline._pentadiagonal_solve(*bands)
            ref = spline.pentadiagonal_solve_plain(*bands)
            torch.cuda.synchronize()
            where = "shared memory" if m <= caps[dt] else "streamed"
            check(torch.equal(got, ref),
                  f"pentadiagonal kernel bit-equal at m = {m} ({dt}, {where})")
            key = f"{'f32_' if dt == torch.float32 else ''}m{m}_ms"
            out["pentadiagonal"][key] = event_ms(lambda: spline._pentadiagonal_solve(*bands), 5)
    zp = [[0.0, 2.0, 3.0, 4.0, 0.0, 5.0], [1.0, 0.5, 0.25, 0.5, 1.0], [0.5, 0.25, 0.5, 0.1],
          [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]]
    for dt in (torch.float64, torch.float32):
        bands = [torch.tensor(v, dtype=dt, device=dev) for v in zp]
        got = spline._pentadiagonal_solve(*bands).cpu()
        ref = spline.pentadiagonal_solve_plain(*bands).cpu()
        check(not bool(torch.isfinite(ref).all()) and torch.equal(got.nan_to_num(7.0),
                                                                  ref.nan_to_num(7.0)),
              f"pentadiagonal kernel on the zero-pivot system ({dt})")
    lib = _kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out["quotient"] = {}
    for dt, fn in ((torch.float32, lib.recursions_quot_check_f32),
                   (torch.float64, lib.recursions_quot_check_f64)):
        a, d = (v.to(dev) for v in penta_quotient_pairs(*system, dt))
        counts = {}
        for mode, n in ((0, 1 << 30), (1, 1 << 30), (2, 6 * 2046 * 256), (3, 6 * 2046 * 4),
                        (4, 1 << 26), (5, a.numel())):
            cnt = torch.zeros(2, dtype=torch.int64, device=dev)
            check(fn(n, mode, a.data_ptr(), d.data_ptr(), cnt.data_ptr(), stream) == 0,
                  "quotient check launch")
            bad, fast = cnt.tolist()
            check(bad == 0, f"checked quotient {dt} mode {mode}: {bad} of {n} pairs differ")
            counts[mode] = {"pairs": n, "fast": fast}
        out["quotient"][str(dt).split(".")[1]] = counts
    out["attributes"] = {}
    for dt in (torch.float64, torch.float32):
        attrs = {"pentadiagonal": spline.kernel_attributes(dt),
                 **{f"sosfilt_w{w}": a for w, a in filters.kernel_attributes(dt).items()}}
        check(all(a["local_bytes"] == 0 for a in attrs.values()),
              f"recursion kernels' local memory {dt}: {attrs}")
        out["attributes"][str(dt).split(".")[1]] = {k: a["registers"] for k, a in attrs.items()}
    print(f"phase 17 redesign shapes: sosfilt bit-equal at 1/5/16 sections x 1/7/64 rows "
          f"(B = 64, 5 sections: {out['sosfilt_b64_ms']:.4f} ms); pentadiagonal bit-equal in "
          f"shared memory and streamed (capacity {caps[torch.float64]} / "
          f"{caps[torch.float32]} rows; m = 1e5 f64 "
          f"{out['pentadiagonal']['m100000_ms']:.3f} ms) and on the zero-pivot system; "
          f"checked quotient = division on every pair; 0 B local memory, registers "
          f"{out['attributes']}")
    return out


def container_slice(dev, card, cuda):
    """Phases 17-20: the recursion kernels against their plain versions,
    config 2, the GP prior's ACF ladder and the rest of the container
    surface on the card. Prints the ``{"containers": ...}`` line and
    returns the recursion kernels' JSON records."""
    import torch

    from periodicity_tpu_torch import TFSeries, TSeries
    from periodicity_tpu_torch import data as pdata
    from periodicity_tpu_torch.ops import filters, spline

    clock_hz = sm_clock_hz()
    start = time.perf_counter()
    out = {"card": card, "sm_clock_max_mhz": clock_hz / 1e6}

    # phase 17: the recursion kernels against their plain versions, at the
    # shapes the slice launches them. sosfilt: the first pass of
    # sosfiltfilt over SpottedStar's float64 odd extension, in the GP
    # prior's band for p_max = 32 (order 5, 5 sections). The pentadiagonal
    # solve: SpottedStar's smoothing-spline system (m = 2146) at lam = 1, the
    # first step of the s-bisection, in float64 and float32.
    t, y, dy = pdata.SpottedStar()
    median_dt = float(np.median(np.diff(t)))
    p_min = max(LADDER.min() / 10, 3 * median_dt)  # the prior's p_min
    nyq = 0.5 / median_dt
    sos = filters.butter_sos(5, [(1 / 32) / nyq, (1 / p_min) / nyq], "bandpass")
    edge = filters._padlen(sos)
    x = cuda(y)
    ext = torch.cat([2 * x[0] - torch.flip(x[1:edge + 1], (0,)), x,
                     2 * x[-1] - torch.flip(x[-(edge + 1):-1], (0,))])
    zi = torch.from_numpy(filters.sosfilt_zi(sos)).to(dev) * ext[0]
    n_ext, ns = ext.shape[0], sos.shape[0]
    yk, zk = filters.sosfilt(sos, ext, zi)
    yp, zp = filters.sosfilt_plain(sos, ext, zi)
    torch.cuda.synchronize()
    sos_held = held(torch.cat([yk, zk.reshape(-1)]), torch.cat([yp, zp.reshape(-1)]),
                    torch.float64)
    sos_rec = {
        "name": "sosfilt",
        "route": "cuda",
        "source": "periodicity_tpu_torch/csrc/recursions.cu",
        "replaces": "periodicity_tpu/ops/filters.py:298",
        "shape": f"float64, {n_ext} steps (SpottedStar's odd extension), {ns} sections, 1 row",
        "held": sos_held,
        "max_abs_err": float((yk - yp).abs().max()),
        "ms": event_ms(lambda: filters.sosfilt(sos, ext, zi), 20),
        "device_ms": device_us(lambda: filters.sosfilt(sos, ext, zi), "sosfilt_kernel", 10) / 1e3,
        "plain_ms": plain_wall_ms(lambda: filters.sosfilt_plain(sos, ext, zi)),
        "library_ms": None,
    }
    # bytes: x in, y out, zi in, zf out, the coefficients in; chain: 4
    # dependent operations a step through the state recurrence, plus the
    # cascade's depth of 2 a section
    sos_rec["bound_ms"], sos_rec["bound_by"] = chain_bound(
        8 * (2 * n_ext + 4 * ns + 5 * ns), 4 * n_ext + 2 * ns, "float64", clock_hz)
    print(f"phase 17 sosfilt f64, {n_ext} steps x {ns} sections: kernel {sos_held}; events "
          f"{sos_rec['ms']:.4f} ms, device {sos_rec['device_ms']:.4f} ms, plain "
          f"{sos_rec['plain_ms']:.3f} ms, bound {sos_rec['bound_ms']:.4f} ms "
          f"({sos_rec['bound_by']})  ({card})")

    (main64, off1, off2), (q0, q1, q2), _ = spline._reinsch_system(cuda(t), 1.0)
    rhs64 = spline._qt_apply(q0, q1, q2, cuda(y))
    m = main64.shape[0]
    penta_rec = {
        "name": "pentadiagonal_solve",
        "route": "cuda",
        "source": "periodicity_tpu_torch/csrc/recursions.cu",
        "replaces": "periodicity_tpu/ops/spline.py:401",
        "shape": f"m = {m} (SpottedStar's smoothing spline at lam = 1), float64; float32 "
                 "under f32_",
    }
    for dtype, prefix in ((torch.float64, ""), (torch.float32, "f32_")):
        bands = [v.to(dtype) for v in (main64, off1, off2, rhs64)]
        xk = spline._pentadiagonal_solve(*bands)
        xp = spline.pentadiagonal_solve_plain(*bands)
        torch.cuda.synchronize()
        how = held(xk, xp, dtype)
        check(bool(torch.isfinite(xk).all()), "finite pentadiagonal solution")
        dense = (torch.diag(bands[0]) + torch.diag(bands[1], 1) + torch.diag(bands[1], -1)
                 + torch.diag(bands[2], 2) + torch.diag(bands[2], -2))
        lib = torch.linalg.solve(dense, bands[3])
        torch.cuda.synchronize()
        rel = float((lib - xk).abs().max() / xk.abs().max())
        check(rel <= (1e-9 if dtype == torch.float64 else 1e-3),
              f"dense solve vs the kernel {rel:.3e} ({dtype})")
        name = "float64" if dtype == torch.float64 else "float32"
        rec = {
            f"{prefix}held": how,
            f"{prefix}max_abs_err": float((xk - xp).abs().max()),
            f"{prefix}ms": event_ms(lambda: spline._pentadiagonal_solve(*bands), 20),
            f"{prefix}device_ms": device_us(lambda: spline._pentadiagonal_solve(*bands),
                                            "pentadiagonal_kernel", 10) / 1e3,
            f"{prefix}plain_ms": plain_wall_ms(lambda: spline.pentadiagonal_solve_plain(*bands)),
            # one torch.linalg.solve of the same system assembled dense
            f"{prefix}library_ms": event_ms(lambda: torch.linalg.solve(dense, bands[3]), 5),
        }
        # bytes: the three bands and the right-hand side in, x out; chain:
        # the factor's step (a division and 4 operations) and the backward
        # substitution's 3 a row
        rec[f"{prefix}bound_ms"], rec[f"{prefix}bound_by"] = chain_bound(
            bands[0].element_size() * (4 * m - 3 + m), m * (DIV_OPS + 4 + 3), name, clock_hz)
        penta_rec.update(rec)
        print(f"phase 17 pentadiagonal {name}, m = {m}: kernel {how}; events "
              f"{rec[prefix + 'ms']:.4f} ms, device {rec[prefix + 'device_ms']:.4f} ms, plain "
              f"{rec[prefix + 'plain_ms']:.3f} ms, dense torch.linalg.solve "
              f"{rec[prefix + 'library_ms']:.4f} ms, bound {rec[prefix + 'bound_ms']:.4f} ms "
              f"({rec[prefix + 'bound_by']})  ({card})")
    out["recursions"] = recursion_shapes(dev, n_ext, sos, (main64, off1, off2, rhs64))
    sos_rec["redesigned"] = penta_rec["redesigned"] = 17
    sos_rec["b64_ms"] = out["recursions"]["sosfilt_b64_ms"]
    t17 = time.perf_counter()

    # the main path of this slice: phases 18-20, counted from zero
    filters.sosfilt.launches = 0
    spline._pentadiagonal_solve.launches = 0

    # phase 18: config 2 on SpottedStar in float32. Single series:
    # TSeries.acf() then a width-5 boxcar; the batch: B = 256 rows through
    # rfft/irfft with n = 2N and the port's convolve1d, as the JAX loop
    t32, y32 = t.astype(np.float32), y.astype(np.float32)
    n = y32.size
    ts = TSeries(cuda(t32), cuda(y32))

    def single(series):
        return series.acf().smooth(C2_WIDTH, kernel="boxcar").values

    ref = single(TSeries(t32, y32, device="cpu"))
    got = single(ts)
    d_single = float((got.cpu() - ref).abs().max() / ref.abs().max())
    check(got.dtype == torch.float32 and got.shape == ref.shape, "config 2 single dtype, shape")
    check(d_single <= 1e-5, f"config 2 single series card vs CPU {d_single:.3e} of max |r|")
    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        single(ts)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) / reps * 1e3
    busy_single, wall_single = profile_window(lambda: single(ts))

    # the kernel made once, on the card, as the JAX loop keeps it a constant
    kern = filters.boxcar_kernel1d(C2_WIDTH, dtype=torch.float32).to(dev)
    rng = np.random.default_rng(0)
    ys = (y[None, :] + 1e-4 * rng.standard_normal((C2_B, n))).astype(np.float32)

    def batch(rows):
        yc = rows - rows.mean(dim=1, keepdim=True)
        ps = torch.fft.rfft(yc, n=2 * n, dim=1).abs() ** 2
        r = torch.fft.irfft(ps, dim=1)[:, :n]
        return filters.convolve1d(r / r[:, :1], kern)

    rb = batch(cuda(ys))
    kern = kern.cpu()
    rb_cpu = batch(torch.from_numpy(ys))
    kern = kern.to(dev)
    d_batch = float((rb.cpu() - rb_cpu).abs().max() / rb_cpu.abs().max())
    check(rb.shape == (C2_B, n) and bool(torch.isfinite(rb).all()), "config 2 batch shape")
    check(d_batch <= 1e-5, f"config 2 batch card vs CPU {d_batch:.3e} of max |r|")
    ysd = cuda(ys)

    def chained(k=10):
        rows = ysd
        for _ in range(k):
            rows = rows + batch(rows) * 1e-9
        return rows

    chained(2)
    batch_ms = event_ms(chained, 3) / 10
    busy_batch, wall_batch = profile_window(lambda: batch(ysd))
    peak = peak_bytes(lambda: batch(ysd))
    out["config2"] = {
        "single_ms": single_ms, "single_acfs_per_s": 1e3 / single_ms,
        "single_busy": busy_single / wall_single, "batch_ms": batch_ms,
        "batch_acfs_per_s": C2_B / batch_ms * 1e3, "batch_busy": busy_batch / wall_batch,
        "batch_peak_mib": peak / 2**20, "single_vs_cpu": d_single, "batch_vs_cpu": d_batch,
    }
    print(f"phase 18 config 2 (N = {n}, f32): single series {single_ms:.3f} ms "
          f"({1e3 / single_ms:.1f} acfs/s, busy {busy_single / wall_single:.1%}); B = {C2_B} "
          f"{batch_ms:.3f} ms a batch ({C2_B / batch_ms * 1e3:.4e} acfs/s, busy "
          f"{busy_batch / wall_batch:.1%}, peak {peak / 2**20:.1f} MiB); card vs CPU "
          f"{d_single:.2e} / {d_batch:.2e} of max |r|  ({card})")
    t18 = time.perf_counter()

    # phase 19: the GP prior's ACF ladder on SpottedStar in float64 and
    # float32, card against CPU; both filter in float64 (as the JAX package
    # does), through the recursion kernel, two launches a cutoff
    cutoffs = [p for p in LADDER if p_min < p < (t[-1] - t[0]) / 2]
    out["ladder"] = {"cutoffs": [float(p) for p in cutoffs], "p_min": p_min}
    for dtype in (np.float64, np.float32):
        name = np.dtype(dtype).name
        card_ts = TSeries(cuda(t.astype(dtype)), cuda(y.astype(dtype)))
        cpu_ts = TSeries(t.astype(dtype), y.astype(dtype), device="cpu")
        before = filters.sosfilt.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits = [card_ts.acf_period_quality(p_min, p) for p in cutoffs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = filters.sosfilt.launches - before
        refs = [cpu_ts.acf_period_quality(p_min, p) for p in cutoffs]
        # the quality comes from a Nelder-Mead fit that stops once its
        # simplex spans 1e-4 in log(amplitude) and log(tau): float64 inputs
        # that agree to the last bits take the same path, but a float32 ACF
        # (cuFFT against the CPU's FFT) may take another to anywhere in that
        # box, so the float32 quality is held at 1e-3
        q_tol = 1e-6 if dtype == np.float64 else 1e-3
        for p, (bp, h, q), (rp, rh, rq) in zip(cutoffs, fits, refs):
            check(bp == rp, f"ladder {name} p_max {p}: best period {bp} vs the CPU's {rp}")
            check(abs(h - rh) <= 1e-6 * abs(rh) and abs(q - rq) <= q_tol * abs(rq),
                  f"ladder {name} p_max {p}: height {h} vs {rh}, quality {q} vs {rq}")
        dq = max(abs(f[2] - r[2]) / abs(r[2]) for f, r in zip(fits, refs))
        busy, one_wall = profile_window(lambda: card_ts.acf_period_quality(p_min, 16.0))
        check(launched == 2 * len(cutoffs),
              f"ladder {name}: {launched} sosfilt launches")
        out["ladder"][name] = {"wall_s": wall, "sosfilt_launches": launched,
                               "best_periods": [f[0] for f in fits], "quality_vs_cpu": dq,
                               "busy_p16": busy / one_wall, "wall_ms_p16": one_wall}
        print(f"phase 19 ACF ladder {name} ({len(cutoffs)} cutoffs): {wall:.3f} s, "
              f"{launched} sosfilt launches; best periods {[round(f[0], 4) for f in fits]} "
              f"(equal to the CPU's), quality within {dq:.2e} of the CPU's; one cutoff "
              f"(p_max 16) {one_wall:.1f} ms, device busy {busy / one_wall:.1%}  ({card})")
    t19 = time.perf_counter()

    # phase 20: the rest of the surface, once each on the card against the CPU
    dev_ts = TSeries(cuda(t), cuda(y))
    cpu_ts = TSeries(t, y, device="cpu")
    scale = float(np.abs(y).max())

    def same(a, b, what, tol=1e-9):
        a = a if isinstance(a, (torch.Tensor, np.ndarray)) else a.values
        b = b if isinstance(b, (torch.Tensor, np.ndarray)) else b.values
        a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
        check(a.shape == b.shape, f"{what}: shapes {tuple(a.shape)} vs {tuple(b.shape)}")
        ok = torch.isfinite(b)
        d = float((a[ok] - b[ok]).abs().max()) if bool(ok.any()) else 0.0
        check(bool((torch.isfinite(a) == ok).all()) and d <= tol * max(1.0, scale),
              f"{what}: card vs CPU {d:.3e}")

    new_t = np.linspace(t[0] - 0.5, t[-1] + 0.5, 3001)
    for method in ("linear", "cubic", "quadratic"):
        same(dev_ts.interp(new_t, method=method), cpu_ts.interp(new_t, method=method),
             f"interp {method}")
    s_val = float(np.sum(dy**2))
    before = spline._pentadiagonal_solve.launches
    smooth_card = dev_ts.interp(new_t, method="spline", s=s_val)
    penta_launches = spline._pentadiagonal_solve.launches - before
    same(smooth_card, cpu_ts.interp(new_t, method="spline", s=s_val), "interp spline s > 0",
         tol=1e-8)
    check(penta_launches >= 60, f"smoothing interp: {penta_launches} pentadiagonal launches")
    crit = {"height": 0.0, "threshold": 1e-4, "distance": 5, "prominence": 1e-3, "width": 2.0}
    pk, pk_cpu = dev_ts.find_peaks(**crit), cpu_ts.find_peaks(**crit)
    check(torch.equal(pk.attrs["indices"].cpu(), pk_cpu.attrs["indices"]), "find_peaks indices")
    for key in pk_cpu.attrs:
        same(pk.attrs[key], pk_cpu.attrs[key], f"find_peaks {key}")
    zc = dev_ts - dev_ts.mean()
    check(torch.equal(zc.find_zero_crossings().cpu(),
                      (cpu_ts - cpu_ts.mean()).find_zero_crossings()), "find_zero_crossings")
    check(dev_ts.estimate_noise() == cpu_ts.estimate_noise(), "estimate_noise")
    band = {"fmin": 1 / 16, "fmax": 1 / p_min}
    before = filters.sosfilt.launches
    same(dev_ts.butterworth(**band), cpu_ts.butterworth(**band), "butterworth f64 (kernel)")
    check(filters.sosfilt.launches - before == 2, "butterworth f64: two sosfilt launches")
    ts32 = TSeries(cuda(t32), cuda(y32))
    before = filters.sosfilt.launches
    check(torch.equal(ts32.butterworth(**band).values.cpu(),
                      TSeries(t32, y32, device="cpu").butterworth(**band).values),
          "butterworth f32 (the kernel in float64)")
    check(filters.sosfilt.launches - before == 2, "butterworth f32: two sosfilt launches")
    same(dev_ts.polyfit(3), cpu_ts.polyfit(3), "polyfit")

    def model(tt, a, b, c):
        return a * torch.sin(2 * math.pi * tt / b) + c

    # a sinusoid on SpottedStar's times, so that the fit converges
    yfit = 0.02 * np.sin(2 * np.pi * t / 10.7) + 0.001 * rng.standard_normal(t.size)
    fit = TSeries(cuda(t), cuda(yfit)).curvefit(model, p0=[0.015, 10.69, 0.0])
    fit_cpu = TSeries(t, yfit, device="cpu").curvefit(model, p0=[0.015, 10.69, 0.0])
    check(abs(float(fit_cpu.attrs["coefficients"][1]) - 10.7) <= 0.01, "curvefit period")
    same(fit.attrs["coefficients"], fit_cpu.attrs["coefficients"], "curvefit", tol=1e-8)
    img = np.random.default_rng(3).standard_normal((64, 256))
    tf = TFSeries(cuda(np.arange(256.0)), cuda(np.linspace(0.1, 2.0, 64)), cuda(img))
    tf_cpu = TFSeries(np.arange(256.0), np.linspace(0.1, 2.0, 64), img, device="cpu")
    for kw in ({"dt": 4.0}, {"df": 0.1}, {"dt": 8.0, "dp": 1.0}):
        same(tf.downsample(**kw), tf_cpu.downsample(**kw), f"TFSeries.downsample {kw}")
    for kernel in ("gaussian", "boxcar", "triangle"):
        same(tf.smooth(3, kernel=kernel), tf_cpu.smooth(3, kernel=kernel), f"2-D smooth {kernel}")
    gens = {
        "BPSK": pdata.BPSK(t_bit=10, n_bits=400, f_c=0.05, n0_db=-3.0, seed=0).real,
        "SustainedPlusGappedPureTones": pdata.SustainedPlusGappedPureTones(),
        "GaussianAtomsPlusFMSinusoid": pdata.GaussianAtomsPlusFMSinusoid(),
        "DuffingWave": pdata.DuffingWave(),
    }
    for name, gy in gens.items():
        same(TSeries(values=cuda(gy)).acf(), TSeries(values=gy, device="cpu").acf(),
             f"data.{name} ACF")
    launches = {"sosfilt": filters.sosfilt.launches,
                "pentadiagonal_solve": spline._pentadiagonal_solve.launches}
    check(all(v > 0 for v in launches.values()), f"recursion kernels on the main path: {launches}")
    t20 = time.perf_counter()
    out["surface"] = {"smoothing_interp_pentadiagonal_launches": penta_launches}
    out["main_path_launches"] = launches
    out["wall_s"] = {"17": t17 - start, "18": t18 - t17, "19": t19 - t18, "20": t20 - t19}
    print(f"phase 20 surface on card: interp (4 methods; smoothing: {penta_launches} "
          f"pentadiagonal launches), find_peaks with 5 criteria, zero crossings, noise, "
          f"butterworth f64/f32, polyfit, curvefit, TFSeries downsample and 2-D smooth, "
          f"{len(gens)} generators: all agree with the CPU")
    sos_rec["launches"] = launches["sosfilt"]
    penta_rec["launches"] = launches["pentadiagonal_solve"]
    print(json_line({"containers": out}))
    return [sos_rec, penta_rec]

# the decomposition slice (phases 21-23): config 10 (CEEMDAN, N = 1024,
# E = 50, benchmarks/run_benchmarks.py:575-610), config 9's sift shape
# (N = 2048 float32, B = 8, 32, 64, max_modes = 4, :519-530), config 4
# (:203-257) and config 6's batch curve
C10_N, C10_E, C10_SEED = 1024, 50, 42
C9_N, C9_MODES = 2048, 4
SIFT_THREADS = 512  # threads of a block of the sift kernel (csrc/sift.cu)


def c10_signal():
    """Config 10's two tones on linspace(0, 2, 1024) and its perturbation
    generator (run_benchmarks.py:586-598)."""
    t = np.linspace(0.0, 2.0, C10_N)
    return np.sin(2 * np.pi * 40.0 * t) + 0.6 * np.sin(2 * np.pi * 5.0 * t), \
        np.random.default_rng(0)


def c9_series():
    """Config 9's batches, drawn in the script's order from one generator."""
    t = np.linspace(0.0, 20.0, C9_N).astype(np.float32)
    rng = np.random.default_rng(0)

    def series(b):
        return np.stack([np.sin(2 * np.pi * t * f) + 0.4 * np.sin(2 * np.pi * t * f / 6.0)
                         + 0.05 * rng.standard_normal(C9_N)
                         for f in np.linspace(2.0, 4.0, b)]).astype(np.float32)

    return t, {b: series(b) for b in (8, 32, 64)}


def pcr_levels(c):
    """ceil(log2 c): the PCR levels of a system of c valid rows."""
    return max(int(c) - 1, 0).bit_length()


def solve_chain_ops(k, cnt, levels=None):
    """Dependent operations of one envelope solve of cnt valid knots at
    capacity k: the boundary row (two divisions), ``levels`` PCR levels
    (ceil(log2 cnt) unless given; a division and 3 operations each) and
    the final division, or below 32 the Thomas recursion over the capacity
    (two passes over k)."""
    if k < 32:
        solve = k * (2 * DIV_OPS + 2) + 2 * k
    else:
        solve = (pcr_levels(cnt) if levels is None else levels) * (DIV_OPS + 3) + DIV_OPS
    return (2 * DIV_OPS + 6) + solve


def sift_chain_ops(n, pad_width, cnt):
    """Dependent operations of one sift on the kernel's critical path, cnt
    the larger envelope's valid knots (0 where the sift finds too few
    extrema and builds no envelope): two block scans (each thread's chunk,
    5 warp and 5 cross-warp levels, the offset), the extrema flags and
    knots, the update, and with envelopes their solve, the Hermite
    evaluation with mu and sigma (two divisions) and the block reduction of
    the counts (5 shuffles, 16 warp sums)."""
    k = n // 2 + 4 + 2 * pad_width
    per = -(-n // SIFT_THREADS)
    ops = 2 * (per + 12) + 5 + 2
    if cnt:
        ops += solve_chain_ops(k, cnt) + (2 * DIV_OPS + 12) + 21
    return ops


def pcr_dead(lower, diag, upper, rhs):
    """The plain PCR solve's rows (ops/spline.py::tridiagonal_solve_pcr,
    the same operations) after each level: [levels, ..., n] masks of the
    rows that no later level can change but for a zero's sign (a = c = 0,
    b finite and nonzero, d finite: amfm.cu::live's complement)."""
    import torch

    n = diag.shape[-1]
    z = torch.zeros_like(diag[..., :1])
    a, c = torch.cat([z, lower[..., 1:]], -1), torch.cat([upper[..., :-1], z], -1)
    b, d = diag, rhs

    def up(v, s, fill):
        return torch.cat([torch.full_like(v[..., :s], fill), v[..., : n - s]], -1)

    def dn(v, s, fill):
        return torch.cat([v[..., s:], torch.full_like(v[..., :s], fill)], -1)

    dead, s = [], 1
    while s < n:
        alpha, beta = -a / up(b, s, 1.0), -c / dn(b, s, 1.0)
        a, c, b, d = (alpha * up(a, s, 0.0), beta * dn(c, s, 0.0),
                      b + alpha * up(c, s, 0.0) + beta * dn(a, s, 0.0),
                      d + alpha * up(d, s, 0.0) + beta * dn(d, s, 0.0))
        dead.append((a == 0) & (c == 0) & torch.isfinite(b) & (b != 0) & torch.isfinite(d))
        s *= 2
    return torch.stack(dead)


def n1_levels(cnt, dead, t, pad_width):
    """The PCR levels N1's block solve (amfm.cu::solve_block) runs for each
    envelope of cnt [rows] valid knots: ceil(log2 cnt); or, in float32
    where pad_width >= 1 and t rises strictly, the first level from the
    fifth on after which every valid row is dead (pcr_dead over the plain
    solve's capacity, ``dead`` [levels, rows, k]; None where the plain
    version took no PCR solve), where the kernel's vote ends them."""
    import torch

    full = [pcr_levels(c) for c in cnt.tolist()]
    if dead is None or dead.dtype != torch.bool or pad_width < 1 \
            or not bool((t[1:] > t[:-1]).all()):
        return full
    valid = torch.arange(dead.shape[-1], device=dead.device) < cnt[:, None]
    ended = (dead | ~valid).all(-1).cpu().numpy()  # [levels, rows]
    out = []
    for r, lv in enumerate(full):
        hits = [lvl for lvl in range(5, lv + 1) if ended[lvl - 1, r]]
        out.append(hits[0] if hits else lv)
    return out


@contextlib.contextmanager
def envelope_counts(levels=False):
    """Record the padded knot counts [rows, envelopes] of every envelope
    the plain versions build (ops/emd.py::_envelope), one array a call: a
    plain sift-machine step, or a plain normalization pass, is one call
    over the rows still running, in order. With ``levels`` (one envelope a
    row, as N1 builds them) each array is [rows, 2]: the count and the PCR
    levels N1 runs for it (n1_levels)."""
    import torch

    from periodicity_tpu_torch.ops import emd, spline

    calls = []
    envelope, pcr = emd._envelope, spline.tridiagonal_solve_pcr
    dead = []

    def recording_pcr(lower, diag, upper, rhs):
        if diag.dtype == torch.float32:
            dead.append(pcr_dead(lower, diag, upper, rhs))
        return pcr(lower, diag, upper, rhs)

    def recording(t, x, mask, pad_width):
        dead.clear()
        env, cnt = envelope(t, x, mask, pad_width)
        rec = cnt.reshape(cnt.shape[0], -1)
        if levels:
            lv = n1_levels(rec[:, 0], dead[0].reshape(dead[0].shape[0], rec.shape[0], -1)
                           if dead else None, t, pad_width)
            rec = torch.stack([rec[:, 0], torch.as_tensor(lv, device=rec.device)], 1)
        calls.append(rec.cpu().numpy())
        return env, cnt
    emd._envelope = recording
    if levels:
        spline.tridiagonal_solve_pcr = recording_pcr
    try:
        yield calls
    finally:
        emd._envelope, spline.tridiagonal_solve_pcr = envelope, pcr


def member_chains(calls, steps, chain_ops):
    """Each member's chain of dependent operations from the recorded
    counts: step s ran the members with steps[b] > s, in order, and costs
    chain_ops(counts of that member's envelopes)."""
    steps = np.asarray(steps)
    chains = np.zeros(steps.shape[0], dtype=np.int64)
    for s, cnt in enumerate(calls):
        live = np.nonzero(steps > s)[0]
        check(len(live) == cnt.shape[0], f"step {s}: {cnt.shape[0]} envelopes recorded for "
              f"{len(live)} running members")
        chains[live] += [chain_ops(c) for c in cnt]
    return chains


def sift_bound(n, b, kmode, chains, dtype, clock_hz):
    """(bound_ms, bound_by) of one sift-kernel launch: t and the series
    read once, the accepted modes, residue and final series written once,
    against the longest member's chain of dependent sifts (``chains``,
    from member_chains)."""
    elem = 8 if dtype == "float64" else 4
    bytes_moved = elem * (n + b * n + int(kmode.sum()) * n + 2 * b * n) + 8 * b
    return chain_bound(bytes_moved, int(chains.max()), dtype, clock_hz)


def sift_chains(calls, units, n, pad_width):
    """member_chains of a sift-machine run: a sift builds envelopes where
    both have at least pad_width interior extrema and 4 knots, and its solve
    runs ceil(log2 cnt) levels of the larger one."""
    def ops(c):
        ok = all(ci - 2 * pad_width >= pad_width and ci >= 4 for ci in c)
        return sift_chain_ops(n, pad_width, int(max(c)) if ok else 0)
    return member_chains(calls, units, ops)


def decomposition_slice(dev, card, cuda):
    """Phases 21-22: the sift kernel against its plain version, and the
    decompositions on the card (config 10's CEEMDAN, EMD, LMD, VMD) against
    the CPU. Prints the ``{"decomposition": ...}`` line and returns the
    sift kernel's JSON record."""
    import torch

    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.decomposition import CEEMDAN, EMD, LMD, VMD
    from periodicity_tpu_torch.ops import _kernels, emd, lmd

    clock_hz = sm_clock_hz()
    start = time.perf_counter()
    out = {"card": card, "sm_clock_max_mhz": clock_hz / 1e6}

    def both(t, Y, **kw):
        """The kernel and the plain version on the same card tensors, to
        the bit pattern, with the kernel's outputs and the plain run's
        envelope counts (envelope_counts)."""
        got = emd.sift_machine(t, Y, **kw)
        with envelope_counts() as calls:
            want = emd.sift_machine_plain(t, Y, **kw)
        torch.cuda.synchronize()
        names = ("modes", "residue", "kmode", "units", "cur")
        for name, a, b in zip(names, got, want):
            check(same_bits(a, b), f"sift kernel vs plain, {name} not bit-equal "
                  f"(B={Y.shape[0]}, N={Y.shape[1]}, {Y.dtype}, {kw})")
        return got, calls

    # phase 21: S1 against plain. Config 10's noise pre-decomposition:
    # E = 50 realizations of default_rng(42) noise, N = 1024, float64, 12
    # mode slots (log2(N) + 2)
    base, _ = c10_signal()
    t10 = cuda(np.arange(float(C10_N)))
    noise = cuda(np.random.default_rng(C10_SEED).standard_normal((C10_E, C10_N)))
    cap = int(np.log2(C10_N)) + 2
    pre, calls = both(t10, noise, max_modes=cap)
    rec = {
        "name": "emd_sift",
        "route": "cuda",
        "source": "periodicity_tpu_torch/csrc/sift.cu",
        "replaces": "periodicity_tpu/ops/emd.py:238",
        "redesigned": 14,
        "held": "bit-equal",
        "max_abs_err": 0.0,
        "library_ms": None,
    }
    kmode, units = pre[2].cpu().numpy(), pre[3].cpu().numpy()
    run_pre = lambda: emd.sift_machine(t10, noise, max_modes=cap)  # noqa: E731
    rec["predecomp_units_max"], rec["predecomp_units_sum"] = int(units.max()), int(units.sum())
    rec["predecomp_ms"] = event_ms(run_pre, 3)
    rec["predecomp_device_ms"] = device_us(run_pre, "emd_sift_kernel", 2) / 1e3
    rec["predecomp_bound_ms"], rec["predecomp_bound_by"] = sift_bound(
        C10_N, C10_E, kmode, sift_chains(calls, units, C10_N, 2), "float64", clock_hz)
    print(f"phase 21 S1, config 10 noise pre-decomposition (E={C10_E}, N={C10_N}, f64, "
          f"{cap} slots): bit-equal to plain; modes {int(kmode.min())}-{int(kmode.max())}, sifts "
          f"max {rec['predecomp_units_max']} sum {rec['predecomp_units_sum']}; events "
          f"{rec['predecomp_ms']:.3f} ms, device {rec['predecomp_device_ms']:.3f} ms, bound "
          f"{rec['predecomp_bound_ms']:.3f} ms ({rec['predecomp_bound_by']})  ({card})")

    # config 10's first ensemble stage (CEEMDAN's k = 0 noisy residues, one
    # IMF each): the kernel against the plain version's wall time
    sig = TSeries(t10, cuda(base))
    sigma_x = float(np.std(sig))
    rv = (sig / sigma_x).values
    noise0 = pre[0][:, 0, :]
    has0 = (pre[2] > 0)[:, None]
    beta = 0.2 * torch.std(rv, correction=0) / torch.where(
        (s0 := torch.std(noise0, dim=1, keepdim=True, correction=0)) > 0, s0, 1.0)
    stage0 = (rv[None, :] + torch.where(has0, beta * noise0, 0.0)).contiguous()
    got0, calls = both(t10, stage0, max_modes=1)
    kmode0, units0 = got0[2].cpu().numpy(), got0[3].cpu().numpy()
    run0 = lambda: emd.sift_machine(t10, stage0, max_modes=1)  # noqa: E731
    rec["shape"] = (f"config 10's first ensemble stage: E = {C10_E}, N = {C10_N}, float64, one "
                    "IMF each; predecomp_ the noise pre-decomposition (12 slots), c9_ config "
                    "9's sift shape (N = 2048, float32, 4 modes)")
    rec["units_max"], rec["units_sum"] = int(units0.max()), int(units0.sum())
    rec["ms"] = event_ms(run0, 5)
    rec["device_ms"] = device_us(run0, "emd_sift_kernel", 3) / 1e3
    rec["plain_ms"] = plain_wall_ms(lambda: emd.sift_machine_plain(t10, stage0, max_modes=1))
    rec["bound_ms"], rec["bound_by"] = sift_bound(
        C10_N, C10_E, kmode0, sift_chains(calls, units0, C10_N, 2), "float64", clock_hz)
    print(f"phase 21 S1, config 10 first stage (E={C10_E}, one IMF): bit-equal; sifts max "
          f"{rec['units_max']} sum {rec['units_sum']}; events {rec['ms']:.3f} ms, device "
          f"{rec['device_ms']:.3f} ms, plain {rec['plain_ms']:.1f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})  ({card})")

    # config 9's sift shape: N = 2048, float32, 4 modes, B = 8, 32, 64
    t9, c9 = c9_series()
    t9c = cuda(t9)
    for b, ys in c9.items():
        Y = cuda(ys)
        got, calls = both(t9c, Y, max_modes=C9_MODES)
        km, un = got[2].cpu().numpy(), got[3].cpu().numpy()
        run9 = lambda: emd.sift_machine(t9c, Y, max_modes=C9_MODES)  # noqa: E731
        ms = event_ms(run9, 5)
        dev_ms = device_us(run9, "emd_sift_kernel", 3) / 1e3
        bnd, by = sift_bound(C9_N, b, km, sift_chains(calls, un, C9_N, 2), "float32", clock_hz)
        rec.update({f"c9_b{b}_ms": ms, f"c9_b{b}_device_ms": dev_ms, f"c9_b{b}_bound_ms": bnd,
                    f"c9_b{b}_bound_by": by, f"c9_b{b}_units_max": int(un.max()),
                    f"c9_b{b}_units_sum": int(un.sum())})
        print(f"phase 21 S1, config 9 sift shape B={b} (N={C9_N}, f32, {C9_MODES} modes): "
              f"bit-equal; sifts max {int(un.max())} sum {int(un.sum())}; events {ms:.3f} ms, "
              f"device {dev_ms:.3f} ms, bound {bnd:.4f} ms ({by})  ({card})")

    # edge draws: too short to sift, monotonic, plateaus, pad widths 1 and
    # 3, max_iter reached, the Thomas size (K < 32), N = 2048 and, above
    # the shared-memory line in float64, N = 2400 (global scratch); then
    # envelopes of 64 and 65 valid knots (either side of the warp-resident
    # solve) and of 303 at capacity 308 (an alternating series)
    rng = np.random.default_rng(21)
    tt = np.arange(200.0)
    t600 = np.arange(600.0)
    wavy = np.sin(tt[None] / np.array([[4.0], [7.0]])) + 0.3 * rng.standard_normal((2, 200))
    edges = [
        ("short", np.arange(3.0), np.ones((2, 3)), {}),
        ("ramp", tt, np.stack([np.linspace(0, 1, 200), np.linspace(0, 1, 200) ** 2]), {}),
        ("plateau", tt, np.stack([np.round(3 * np.sin(tt / 5.0)),
                                  np.round(2 * np.sin(tt / 3.0) + np.cos(tt / 11.0))]), {}),
        ("pad 1", tt, wavy, {"pad_width": 1}),
        ("pad 3", tt, wavy, {"pad_width": 3}),
        ("max_iter 3", tt, wavy, {"max_iter": 3}),
        ("Thomas, N = 20", np.arange(20.0), rng.standard_normal((3, 20)), {}),
        ("N = 2048", np.arange(2048.0), rng.standard_normal((2, 2048)), {}),
        ("global scratch, N = 2400", np.arange(2400.0), rng.standard_normal((1, 2400)),
         {"max_modes": 2}),
        *((f"{m + 4} knots", t600, np.sin(2 * np.pi * m * t600 / 600 + 0.3)[None], {})
          for m in (60, 61)),
        ("alternating", t600, ((-1.0) ** t600 * (1 + 0.01 * rng.standard_normal(600)))[None], {}),
    ]
    for dtype in (torch.float64, torch.float32):
        for label, te, ye, kw in edges:
            both(cuda(te).to(dtype), cuda(ye).to(dtype), **{"max_modes": 3, **kw})
    check(_kernels.load().emd_sift_scratch_bytes(2400, 2, 8) > 0,
          "float64 at N = 2400 should run in global scratch")
    print(f"phase 21 S1 edge draws ({', '.join(e[0] for e in edges)}), float64 and float32: "
          f"bit-equal to plain")
    t21 = time.perf_counter()

    # the main path of this slice: phase 22, counted from zero
    emd.sift_machine.launches = 0
    lmd_reads = lmd.host_reads

    # phase 22: config 10, CEEMDAN(ensemble_size=50, random_seed=42) on
    # the two tones (float64 on the card), timed over 3 perturbed inputs
    base, prng = c10_signal()

    def ceemdan(y, device=None):
        dec = CEEMDAN(ensemble_size=C10_E, random_seed=C10_SEED)
        dec(TSeries(values=y, device=device))
        return dec

    ceemdan(cuda(base))
    torch.cuda.synchronize()
    secs, decs, inputs = [], [], []
    for i in range(3):
        yi = base + 1e-4 * (i + 1) * prng.standard_normal(C10_N)
        inputs.append(yi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decs.append(ceemdan(cuda(yi)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    before = emd.sift_machine.launches
    ceemdan(cuda(inputs[0]))
    launches_per = emd.sift_machine.launches - before
    work, wall = profiled(lambda: ceemdan(cuda(inputs[0])), pad=1)
    wall *= 1e3
    busy = sum(us for _, us in work) / 1e3
    sift_ms = sum(us for name, us in work if "emd_sift_kernel" in name) / 1e3
    check(busy > 0 and sift_ms > 0, "the profiler saw the sift kernel")
    mem = peak_bytes(lambda: ceemdan(cuda(inputs[0])))
    t_cpu = time.perf_counter()
    cpu = ceemdan(inputs[0], device="cpu")
    cpu_s = time.perf_counter() - t_cpu
    card_dec = decs[0]
    scale = float(np.abs(inputs[0]).max())
    check(card_dec.n_modes == cpu.n_modes, f"CEEMDAN n_modes card {card_dec.n_modes} vs CPU "
          f"{cpu.n_modes}")
    d_modes = max(float((a.values.cpu() - b.values).abs().max())
                  for a, b in zip(card_dec.modes + [card_dec.residue], cpu.modes + [cpu.residue]))
    check(d_modes <= 1e-9 * scale, f"CEEMDAN card vs CPU {d_modes:.3e} > 1e-9 of max|x|")
    for dec, yi in zip(decs, inputs):
        m = [x.values.cpu().numpy() for x in dec.modes]
        check(all(np.isfinite(x).all() and x.shape == (C10_N,) for x in m),
              "CEEMDAN modes finite, [N]")
        err = np.linalg.norm(sum(m) + dec.residue.values.cpu().numpy() - yi) / np.linalg.norm(yi)
        check(err < 1e-10, f"CEEMDAN modes + residue reconstruct the input ({err:.2e})")
    out["config10"] = {
        "seconds_per_decomposition": statistics.median(secs),
        "seconds_runs": secs,
        "n_modes": [d.n_modes for d in decs],
        "sift_launches_per_decomposition": launches_per,
        "busy_ms": busy,
        "wall_ms": wall,
        "busy_share": busy / wall,
        "sift_device_ms": sift_ms,
        "other_device_ms": busy - sift_ms,
        "other_device_ops": sum(1 for name, _ in work if "emd_sift_kernel" not in name),
        "peak_mib": mem / 2**20,
        "cpu_port_seconds": cpu_s,
        "card_vs_cpu_max_abs": d_modes,
    }
    print(f"phase 22 config 10 CEEMDAN (N={C10_N}, E={C10_E}, f64): "
          f"{statistics.median(secs):.4f} s per decomposition (median of "
          f"{[round(x, 4) for x in secs]}), n_modes {[d.n_modes for d in decs]}, "
          f"{launches_per} sift launches each; device busy {busy:.2f} ms of {wall:.2f} ms "
          f"({busy / wall:.1%}; the sift kernel {sift_ms:.2f} ms, "
          f"{out['config10']['other_device_ops']} other device ops "
          f"{busy - sift_ms:.2f} ms); peak memory {mem / 2**20:.2f} MiB; card vs CPU port "
          f"{d_modes:.3e} (CPU {cpu_s:.1f} s)  ({card})")

    # EMD, LMD (uniform two tones) and VMD(n_modes=3) once each, card
    # against the CPU; LMD's launches and host reads counted
    tl = np.arange(1000.0)
    y2 = np.sin(2 * np.pi * 0.01 * tl) + 0.4 * np.sin(2 * np.pi * 0.1 * tl)
    rows = {}

    def wall_of(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    imfs, rows["emd_s"] = wall_of(lambda: EMD()(TSeries(cuda(tl), cuda(y2))))
    imfs_cpu = EMD()(TSeries(tl, y2, device="cpu"))
    check(len(imfs) == len(imfs_cpu) >= 2, f"EMD modes card {len(imfs)} vs CPU {len(imfs_cpu)}")
    d = max(float((a.values.cpu() - b.values).abs().max()) for a, b in zip(imfs, imfs_cpu))
    check(d <= 1e-9 * 1.4, f"EMD card vs CPU {d:.3e}")
    reads0 = lmd.host_reads
    pfs, rows["lmd_s"] = wall_of(lambda: LMD()(TSeries(cuda(tl), cuda(y2)), max_modes=1))
    rows["lmd_host_reads"] = lmd.host_reads - reads0
    work, _ = profiled(lambda: LMD()(TSeries(cuda(tl), cuda(y2)), max_modes=1), pad=1)
    rows["lmd_device_ops"] = len(work)
    pfs_cpu = LMD()(TSeries(tl, y2, device="cpu"), max_modes=1)
    d_l = float(((pfs[0][0] * pfs[0][1]).values.cpu() - (pfs_cpu[0][0] * pfs_cpu[0][1]).values)
                .abs().max())
    check(len(pfs) == len(pfs_cpu) == 1 and d_l <= 1e-9, f"LMD first product function card vs "
          f"CPU {d_l:.3e}")
    modes, rows["vmd_s"] = wall_of(lambda: VMD(n_modes=3)(TSeries(cuda(tl), cuda(y2))))
    modes_cpu = VMD(n_modes=3)(TSeries(tl, y2, device="cpu"))
    d_v = max(float((a.values.cpu() - b.values).abs().max()) for a, b in zip(modes, modes_cpu))
    check(len(modes) == 3 and d_v <= 1e-9, f"VMD card vs CPU {d_v:.3e}")
    launches = emd.sift_machine.launches
    check(launches > 0, "the sift kernel launched on the main path")
    out["surface"] = dict(rows, emd_modes=len(imfs), emd_vs_cpu=d, lmd_vs_cpu=d_l, vmd_vs_cpu=d_v)
    out["main_path_launches"] = {"emd_sift": launches}
    out["lmd_host_reads_total"] = lmd.host_reads - lmd_reads
    t22 = time.perf_counter()
    out["wall_s"] = {"21": t21 - start, "22": t22 - t21}
    rec["launches"] = launches
    print(f"phase 22 EMD {rows['emd_s']:.3f} s ({len(imfs)} modes), LMD first PF "
          f"{rows['lmd_s']:.3f} s ({rows['lmd_device_ops']} device ops, "
          f"{rows['lmd_host_reads']} host reads), VMD(3) {rows['vmd_s']:.3f} s on the card: "
          f"all agree with the CPU; {launches} sift launches on the main path  ({card})")
    print(json_line({"decomposition": out}))
    return [rec]


def extra_cells(dev, card, cuda):
    """Phase 23: two cells of code ported earlier, timed here: config 4
    (PDM, StringLength and its fast variant at N = 2000 over 1e5 trial
    periods, float32) and config 6's batch curve at B = 4, 8 and 16 in both
    layouts. Prints the ``{"cells": ...}`` line."""
    import torch

    from periodicity_tpu_torch.models.phase import pdm_scan, string_length_scan, \
        string_length_scan_fast
    from periodicity_tpu_torch.spectral import gls_power_batch

    start = time.perf_counter()
    out = {"card": card}
    n4, p4 = 2000, 100_000
    rng = np.random.default_rng(0)
    t4 = np.sort(rng.uniform(0, 200.0, n4)).astype(np.float32)
    y4 = (np.sin(2 * np.pi * t4 / 7.7) + 0.2 * rng.standard_normal(n4)).astype(np.float32)
    periods = cuda(np.linspace(0.5, 100.0, p4).astype(np.float32))
    t4c, y4c = cuda(t4), cuda(y4)
    scans = {
        "pdm": lambda: pdm_scan(t4c, y4c, periods, batch_size=512),
        "stringlength": lambda: string_length_scan(t4c, y4c, periods, batch_size=512),
        "stringlength_fast": lambda: string_length_scan_fast(t4c, y4c, periods, batch_size=512),
    }
    config4 = {}
    for name, fn in scans.items():
        first = fn()
        torch.cuda.synchronize()
        check(first.shape == (p4,) and bool(torch.isfinite(first).all()), f"{name}: finite [P]")
        best = float(periods[torch.argmin(first)])
        # a fold at a multiple of the period is as ordered as at the period
        check(abs(best / PERIOD - round(best / PERIOD)) <= 0.005 * round(best / PERIOD),
              f"{name}: best period {best} not a multiple of {PERIOD}")
        ms = event_ms(fn, 2)
        config4[f"{name}_s"] = ms / 1e3
        config4[f"{name}_periods_per_s"] = p4 / (ms / 1e3)
        config4[f"{name}_best_period"] = best
        print(f"phase 23 config 4 {name} (N={n4}, {p4} periods, f32): {ms:.2f} ms, "
              f"{p4 / (ms / 1e3):.4e} trial periods/s, best period {best:.4f}  ({card})")
    out["config4"] = config4

    rng = np.random.default_rng(0)
    t6 = np.sort(rng.uniform(0, 1000.0, C6_N)).astype(np.float32)
    df6 = float(np.float32(0.5 / 1000.0))
    fmin6 = float(np.float32(df6 / 2))
    t6c = cuda(t6)
    curve = {}
    for b in (4, 8, 16):
        ys = cuda(np.stack([np.sin(2 * np.pi * t6 / p) for p in C6_PERIODS[:b]])
                  .astype(np.float32))
        es = cuda(np.full((b, C6_N), 0.3, np.float32))
        for layout in ("kernel", "scatter"):
            def batch():
                return gls_power_batch(t6c, ys, es, df6, fmin6, C6_NF, pair_q=1, gridder=layout)

            pw = batch()
            torch.cuda.synchronize()
            check(pw.shape == (b, C6_NF) and bool(torch.isfinite(pw).all()),
                  f"config 6 B={b} {layout}: finite [B, nf]")
            ms = event_ms(batch, 2)
            mem = peak_bytes(batch)
            key = f"b{b}_{'kernel_loop' if layout == 'kernel' else 'row_spreading'}"
            curve[f"{key}_freqs_per_s"] = b * C6_NF / (ms / 1e3)
            curve[f"{key}_peak_mib"] = mem / 2**20
            print(f"phase 23 config 6 B={b} {layout}: {b * C6_NF / (ms / 1e3):.4e} aggregate "
                  f"trial-freqs/s, peak memory {mem / 2**20:.1f} MiB  ({card})")
        del ys, es
    out["config6_curve"] = curve
    out["wall_s"] = time.perf_counter() - start
    print(json_line({"cells": out}))



# the time-frequency slice (phases 24-26): config 9 (hht_batch, N = 2048
# float32, 64 frequencies over [0.1, 8], max_modes = 4, B = 8, 32, 64,
# benchmarks/run_benchmarks.py:503-572) and config 3 (the Morlet WPS, N =
# 4096, 64 scales geomspace(8, 512), float32, :140-200)
C9_GRID = (0.1, 8.0, 64)
C3_N, C3_SCALES, C3_B = 4096, (8.0, 512.0, 64), 32


def amfm_chain_ops(n, pad_width, cnt, levels=None):
    """Dependent operations of one normalization pass on the kernel's
    critical path, cnt the envelope's valid knots (0 where the row has too
    few maxima and takes the constant max|F|): |F| (each thread's chunk),
    two block scans, the extrema flags and knots, the solve
    (solve_chain_ops, ``levels`` PCR levels) and the Hermite evaluation (a
    division and 12 operations), or the block max, then the division F /
    env, the block max (5 shuffles, 16 warp maxima) and the stop test."""
    k = n // 2 + 4 + 2 * pad_width
    per = -(-n // SIFT_THREADS)
    ops = per + 2 * (per + 12) + 5 + DIV_OPS + 21 + 2
    return ops + (solve_chain_ops(k, cnt, levels) + DIV_OPS + 12 if cnt else 21)


def amfm_bound(n, rows, calls, passes, pad_width, dtype, clock_hz):
    """(bound_ms, bound_by) of one normalization-kernel launch: t and the
    rows read once, A and F written once, against the longest row's chain of
    dependent passes, from the plain run's envelope counts (a pass solves
    where the row has at least max(pad_width, 1) interior maxima and 4
    knots), with the PCR levels the kernel needs where they were recorded
    (envelope_counts(levels=True): in float32 the levels after every
    coupling is zero are not needed)."""
    elem = 8 if dtype == "float64" else 4
    bytes_moved = elem * (n + 3 * rows * n) + 4 * rows

    def ops(c):
        ok = c[0] - 2 * pad_width >= max(pad_width, 1) and c[0] >= 4
        return amfm_chain_ops(n, pad_width, int(c[0]) if ok else 0,
                              int(c[1]) if len(c) > 1 else None)
    return chain_bound(bytes_moved, int(member_chains(calls, passes, ops).max()), dtype,
                       clock_hz)


def n1_level_counts(calls, pad_width):
    """(levels counted, ceil(log2 cnt) summed) over the passes that solve,
    from envelope_counts(levels=True)."""
    c = np.concatenate(calls)
    ok = (c[:, 0] - 2 * pad_width >= max(pad_width, 1)) & (c[:, 0] >= 4)
    return int(c[ok, 1].sum()), int(sum(pcr_levels(v) for v in c[ok, 0]))


def amfm_edges(rng):
    """Edge draws of the normalization: (label, t, X, keyword arguments)."""
    t = np.arange(0, 64, 0.25)
    env = 1 + 0.4 * np.sin(2 * np.pi * t / 30)
    tones = np.stack([env * np.sin(2 * np.pi * 0.5 * t),
                      np.sin(2 * np.pi * 0.13 * t) * (1 + 0.5 * np.cos(t / 9)),
                      np.round(3 * np.sin(t / 2.0)) + 0.1 * rng.standard_normal(t.size)])
    return [
        # too few maxima (the constant envelope), unit amplitude (done after
        # one pass), and rows that finish after 1-3 passes
        ("constant envelope, unit amplitude, mixed passes", t,
         np.stack([np.cos(2 * np.pi * t / 64 * 0.6), np.sign(np.sin(2 * np.pi * 0.25 * t)),
                   *tones]), {}),
        ("pad 1", t, tones, {"pad_width": 1}),
        ("pad 3", t, tones, {"pad_width": 3}),
        ("n_iter 2 reached", t, tones, {"n_iter": 2}),
        ("Thomas, N = 40", np.arange(40.0), rng.standard_normal((3, 40)), {}),
        ("global scratch, N = 4096", np.linspace(0.0, 40.0, 4096),
         rng.standard_normal((2, 4096)), {}),
    ]


def timefrequency_slice(dev, card, cuda):
    """Phases 24-26: the AM/FM normalization kernel against its plain
    version, config 9's hht_batch and config 3's WPS on the card, and the
    rest of the time-frequency surface against the CPU. Prints the
    ``{"timefrequency": ...}`` line and returns the kernel's JSON record."""
    import torch

    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.models.timefrequency import _normalization_rows
    from periodicity_tpu_torch.ops import emd, hht, lmd
    from periodicity_tpu_torch.ops.wavelet import cwt_morlet
    from periodicity_tpu_torch.timefrequency import (
        HHT,
        WPS,
        CompositeSpectrum,
        denoise,
        denoise_batch,
        hht_batch,
        reconstruct,
        wps_batch,
    )

    clock_hz = sm_clock_hz()
    start = time.perf_counter()
    out = {"card": card, "sm_clock_max_mhz": clock_hz / 1e6}

    def both(t, X, n_iter=10, pad_width=2):
        """N1 and the plain version on the same card tensors, bit for bit,
        with N1's outputs."""
        got = hht._am_fm_cuda(t, X, n_iter, pad_width, 1e-6)
        with envelope_counts(levels=True) as calls:
            want = hht.am_fm_normalize_plain(t, X, "spline", n_iter, pad_width, 1e-6)
        torch.cuda.synchronize()
        for name, a, b in zip(("A", "F", "passes"), got, want):
            check(same_bits(a, b), f"N1 vs plain, {name} not bit-equal ({tuple(X.shape)}, "
                  f"{X.dtype}, n_iter {n_iter}, pad_width {pad_width})")
        return got, calls

    # phase 24: N1 against plain at config 9's rows: the modes emd_pool
    # returns at B = 8, 32, 64, dead slots replaced by the dummy cosine
    rec = {
        "name": "am_fm_normalize",
        "route": "cuda",
        "source": "periodicity_tpu_torch/csrc/amfm.cu",
        "replaces": "periodicity_tpu/ops/hht.py:113",
        "redesigned": 18,
        "held": "bit-equal",
        "max_abs_err": 0.0,
        "library_ms": None,
        "shape": ("config 9's rows at B = 8 (32 rows: 8 members x 4 mode slots), N = 2048, "
                  "float32; b32_ and b64_ the same at B = 32 and 64; f64_ B = 8 in float64"),
    }
    t9, c9 = c9_series()
    t9c = cuda(t9)
    rows9 = {}
    for b, ys in c9.items():
        modes, _, n_modes = emd.emd_pool(t9c, cuda(ys), max_modes=C9_MODES)
        X, _ = _normalization_rows(t9c, modes, n_modes)
        X = rows9[b] = X.contiguous()
        got, calls = both(t9c, X)
        passes = got[2].cpu().numpy()
        run = lambda: hht._am_fm_cuda(t9c, X, 10, 2, 1e-6)  # noqa: E731
        ms = event_ms(run, 5)
        # one launch a call: late in the run a window drops more launches
        # than PROFILER_PAD such calls make, so the window opens with more
        dev_ms = device_us(run, "amfm_kernel", 3, pad=16) / 1e3
        bnd, by = amfm_bound(C9_N, X.shape[0], calls, passes, 2, "float32", clock_hz)
        pre = "" if b == 8 else f"b{b}_"
        lv = n1_level_counts(calls, 2)
        rec.update({f"{pre}ms": ms, f"{pre}device_ms": dev_ms, f"{pre}bound_ms": bnd,
                    f"{pre}bound_by": by, f"{pre}passes_max": int(passes.max()),
                    f"{pre}passes_sum": int(passes.sum()), f"{pre}pcr_levels": lv})
        if b == 8:
            rec["plain_ms"] = plain_wall_ms(
                lambda: hht.am_fm_normalize_plain(t9c, X, "spline", 10, 2, 1e-6))
        print(f"phase 24 N1, config 9 rows B={b} ({X.shape[0]} rows, N={C9_N}, f32): bit-equal "
              f"to plain; passes max {int(passes.max())} sum {int(passes.sum())}; events "
              f"{ms:.4f} ms, device {dev_ms:.4f} ms"
              + (f", plain {rec['plain_ms']:.1f} ms" if b == 8 else "")
              + f", bound {bnd:.4f} ms ({by}; PCR levels {lv[0]} of {lv[1]})  ({card})")
    # float64 at N = 2048 (in shared memory: one envelope, 147 KB a row)
    X64, t64 = rows9[8].double(), t9c.double()
    got, calls = both(t64, X64)
    passes = got[2].cpu().numpy()
    run = lambda: hht._am_fm_cuda(t64, X64, 10, 2, 1e-6)  # noqa: E731
    rec["f64_ms"] = event_ms(run, 5)
    rec["f64_device_ms"] = device_us(run, "amfm_kernel", 3, pad=16) / 1e3
    rec["f64_bound_ms"], rec["f64_bound_by"] = amfm_bound(C9_N, X64.shape[0], calls, passes,
                                                          2, "float64", clock_hz)
    rec["f64_passes_max"] = int(passes.max())
    print(f"phase 24 N1, config 9 rows B=8 in f64: bit-equal; passes max {int(passes.max())}; "
          f"events {rec['f64_ms']:.4f} ms, device {rec['f64_device_ms']:.4f} ms, bound "
          f"{rec['f64_bound_ms']:.4f} ms ({rec['f64_bound_by']})  ({card})")
    edges = amfm_edges(np.random.default_rng(24))
    for dtype in (torch.float64, torch.float32):
        for label, te, xe, kw in edges:
            both(cuda(te).to(dtype), cuda(xe).to(dtype).contiguous(), **kw)
    print(f"phase 24 N1 edge draws ({'; '.join(e[0] for e in edges)}), float64 and float32: "
          "bit-equal to plain")
    # its resources and launch: 0 bytes of local memory in both instances
    # (arrays in shared memory, in global scratch) and dtypes, one block a
    # row; its float32 quotient against __fdiv_rn
    for dtype, key in ((torch.float32, "f32"), (torch.float64, "f64")):
        attrs = hht.kernel_attributes(dtype)
        for inst, a in attrs.items():
            check(a["local_bytes"] == 0, f"N1 {key} {inst}: {a['local_bytes']} B of local memory")
        rec[f"{key}_attributes"] = attrs
        rec[f"{key}_geometry_b64"] = hht.kernel_geometry(C9_N, 4 * 64, dtype)
    from periodicity_tpu_torch.ops._kernels import load

    quot_bad = torch.zeros(2, dtype=torch.int64, device=dev)
    for mode in range(4):
        quot_bad.zero_()
        check(load().amfm_quot_check_f32(1 << 26, mode, quot_bad.data_ptr(),
                                          torch.cuda.current_stream(dev).cuda_stream) == 0,
              "amfm_quot_check_f32 launch")
        check(int(quot_bad[0]) == 0, f"N1's float32 quotient: {int(quot_bad[0])} pairs off "
              f"__fdiv_rn (mode {mode})")
    print(f"phase 24 N1 resources: f32 {rec['f32_attributes']}, f64 {rec['f64_attributes']}; "
          f"config 9 B=64 launch {rec['f32_geometry_b64']}; float32 quotient = __fdiv_rn on "
          f"4 x 2^26 pairs  ({card})")
    t24 = time.perf_counter()

    # the main path of this slice: phases 25-26, counted from zero
    hht.am_fm_normalize.launches = 0
    emd.sift_machine.launches = 0
    lmd_reads = lmd.host_reads

    # phase 25: config 9, hht_batch(t, Y, grid, max_modes=4), the median of
    # 3 perturbed inputs a batch size
    grid9 = np.linspace(*C9_GRID).astype(np.float32)
    config9 = {}
    for b, ys in c9.items():
        Y = cuda(ys)

        def transform(Yb):
            return hht_batch(t9c, Yb, grid9, max_modes=C9_MODES)

        power, modes, residue, n_modes = transform(Y)
        torch.cuda.synchronize()
        check(power.shape == (b, C9_GRID[2], C9_N) and bool(torch.isfinite(power).all()),
              f"config 9 B={b}: finite power [B, F, N]")
        check(float((Y - modes.sum(1) - residue).abs().max()) <= 1e-5,
              f"config 9 B={b}: modes + residue reconstruct the input")
        secs = []
        for i in range(3):
            Yi = Y + np.float32(1e-4 * (i + 1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            transform(Yi)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        s1_0, n1_0 = emd.sift_machine.launches, hht.am_fm_normalize.launches
        transform(Y)
        s1, n1 = emd.sift_machine.launches - s1_0, hht.am_fm_normalize.launches - n1_0
        work, wall = profiled(lambda: transform(Y), pad=1)
        wall *= 1e3
        busy = sum(us for _, us in work) / 1e3
        s1_ms = sum(us for name, us in work if "emd_sift_kernel" in name) / 1e3
        n1_ms = sum(us for name, us in work if "amfm_kernel" in name) / 1e3
        check(s1_ms > 0 and n1_ms > 0, "the profiler saw S1 and N1")
        mem = peak_bytes(lambda: transform(Y))
        # the dominant live mode (largest median amplitude) of each member:
        # its median instantaneous frequency against the injected tone (the
        # first mode is the 0.05 noise)
        rows, live = _normalization_rows(t9c, modes, n_modes)
        freq, amp = hht.instant_frequency(t9c, rows)
        med_f = np.median(freq.reshape(b, C9_MODES, -1)[..., 200:-200].cpu().numpy(), axis=-1)
        med_a = np.median(amp.reshape(b, C9_MODES, -1)[..., 200:-200].cpu().numpy(), axis=-1)
        dom = np.argmax(np.where(live.cpu().numpy(), med_a, -np.inf), axis=1)
        tone = np.linspace(2.0, 4.0, b)
        rel = np.abs(med_f[np.arange(b), dom] - tone) / tone
        check(np.isfinite(rel).all(), f"config 9 B={b}: finite instantaneous frequencies")
        config9[f"b{b}"] = {
            "transforms_per_s": b / statistics.median(secs),
            "seconds_runs": secs,
            "n_modes": n_modes.cpu().tolist(),
            "s1_launches": s1,
            "n1_launches": n1,
            "busy_ms": busy,
            "wall_ms": wall,
            "busy_share": busy / wall,
            "s1_share": s1_ms / busy,
            "n1_share": n1_ms / busy,
            "rest_share": (busy - s1_ms - n1_ms) / busy,
            "other_device_ops": sum(1 for name, _ in work
                                    if "emd_sift_kernel" not in name and "amfm_kernel" not in name),
            "peak_mib": mem / 2**20,
            "dominant_mode_if_rel_err_median": float(np.median(rel)),
            "dominant_mode_if_within_2pct": int((rel <= 0.02).sum()),
        }
        c = config9[f"b{b}"]
        print(f"phase 25 config 9 hht_batch B={b} (N={C9_N}, f32): "
              f"{c['transforms_per_s']:.2f} transforms/s (median of "
              f"{[round(x, 4) for x in secs]} s); S1 {s1} and N1 {n1} launches a batch; device "
              f"busy {busy:.2f} of {wall:.2f} ms ({busy / wall:.1%}: S1 {c['s1_share']:.1%}, N1 "
              f"{c['n1_share']:.1%}, {c['other_device_ops']} other ops {c['rest_share']:.1%}); "
              f"peak {mem / 2**20:.1f} MiB; dominant mode's median IF within 2% of the tone for "
              f"{c['dominant_mode_if_within_2pct']} of {b} members (median error "
              f"{c['dominant_mode_if_rel_err_median']:.2%})  ({card})")
    # pure tones through the same path: the first mode's median
    # instantaneous frequency within 2% of the injected tone
    tones = np.linspace(2.0, 4.0, 8)
    Yp = cuda(np.stack([np.sin(2 * np.pi * f * t9) for f in tones]).astype(np.float32))
    _, modes_p, _, nm_p = hht_batch(t9c, Yp, grid9, max_modes=C9_MODES)
    fp, _ = hht.instant_frequency(t9c, modes_p[:, 0])
    rel_p = np.abs(np.median(fp[:, 200:-200].cpu().numpy(), axis=1) - tones) / tones
    check(bool((nm_p >= 1).all()) and float(rel_p.max()) <= 0.02,
          f"pure tones: first mode's median IF within 2% ({rel_p.max():.3%})")
    config9["pure_tone_first_mode_if_rel_err_max"] = float(rel_p.max())
    # a B = 8 batch in float64 on the card against the CPU port
    t9d, y9d = t9.astype(np.float64), c9[8].astype(np.float64)
    p_card, _, _, nm_card = hht_batch(cuda(t9d), cuda(y9d), grid9, max_modes=C9_MODES)
    t_cpu = time.perf_counter()
    p_cpu, _, _, nm_cpu = hht_batch(torch.from_numpy(t9d), torch.from_numpy(y9d), grid9,
                                    max_modes=C9_MODES)
    cpu_s = time.perf_counter() - t_cpu
    d9 = float((p_card.cpu() - p_cpu).abs().max() / p_cpu.abs().max())
    check(torch.equal(nm_card.cpu(), nm_cpu), f"config 9 f64 n_modes card {nm_card.tolist()} "
          f"vs CPU {nm_cpu.tolist()}")
    check(d9 <= 1e-9, f"config 9 f64 power card vs CPU {d9:.3e} > 1e-9 of max power")
    config9["f64_b8_card_vs_cpu"] = d9
    config9["f64_b8_cpu_port_seconds"] = cpu_s
    print(f"phase 25 config 9 B=8 f64 card vs CPU port: max|dP|/max P {d9:.3e}, n_modes equal "
          f"{nm_card.cpu().tolist()} (CPU {cpu_s:.1f} s); pure tones' first-mode IF within "
          f"{rel_p.max():.3%}  ({card})")
    out["config9"] = config9
    t25 = time.perf_counter()

    # phase 26: config 3, the Morlet CWT + unbiasing: one series over k = 20
    # chained calls, then wps_batch at B = 32 (run_benchmarks.py:140-200)
    rng = np.random.default_rng(0)
    y3 = (np.sin(2 * np.pi * np.arange(C3_N) / 64.0)
          + 0.2 * rng.standard_normal(C3_N)).astype(np.float32)
    scales3 = cuda(np.geomspace(*C3_SCALES).astype(np.float32))
    y3c = cuda(y3)

    def chain3(k=20):
        y, acc = y3c, torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(k):
            co = cwt_morlet(y - torch.mean(y), scales3)
            g = torch.mean(torch.abs(co) ** 2 / scales3[:, None], dim=1)
            y, acc = y + g[:1] * 1e-9, acc + g[0]
        return acc

    check(bool(torch.isfinite(chain3(2))), "config 3: finite chained GWPS")
    single_ms = event_ms(chain3, 2) / 20
    busy, wall = profile_window(lambda: chain3(1))
    ys3 = cuda((y3[None, :] + 1e-3 * rng.standard_normal((C3_B, C3_N))).astype(np.float32))
    t3 = cuda(np.arange(C3_N, dtype=np.float32))
    periods3 = np.geomspace(*C3_SCALES)  # dt = 1 and cmor2.0-1.0's C = 1: period = scale

    def batch3(kb=10):
        ys, acc = ys3, torch.zeros((), dtype=torch.float64, device=dev)
        for _ in range(kb):
            spectra, _ = wps_batch(t3, ys, periods3)
            g = torch.mean(spectra, dim=2)
            ys, acc = ys + g[:, :1].float() * 1e-9, acc + g[:, 0].sum()
        return acc

    spectra3, cone3 = wps_batch(t3, ys3, periods3)
    torch.cuda.synchronize()
    check(spectra3.shape == (C3_B, C3_SCALES[2], C3_N) and bool(torch.isfinite(spectra3).all())
          and cone3.shape == (C3_SCALES[2], C3_N), "config 3: finite spectra [B, S, N]")
    batch_ms = event_ms(batch3, 2) / 10
    busy_b, wall_b = profile_window(lambda: batch3(1))
    mem3 = peak_bytes(lambda: wps_batch(t3, ys3, periods3))
    # the batch rows against the single-series WPS on the card
    w3 = WPS(periods3)
    w3(TSeries(t3, ys3[1]))
    d3 = float((spectra3[1] - w3.spectrum.values).abs().max() / w3.spectrum.values.abs().max())
    check(d3 <= 1e-5, f"config 3: wps_batch row vs WPS {d3:.3e}")
    out["config3"] = {
        "single_series_ms": single_ms,
        "single_series_per_s": 1e3 / single_ms,
        "single_busy_share": busy / wall,
        "b32_ms_per_batch": batch_ms,
        "b32_spectra_per_s": C3_B / (batch_ms / 1e3),
        "b32_busy_share": busy_b / wall_b,
        "b32_peak_mib": mem3 / 2**20,
        "batch_row_vs_wps": d3,
    }
    print(f"phase 26 config 3 (N={C3_N}, {C3_SCALES[2]} scales, f32): single series "
          f"{single_ms:.3f} ms ({1e3 / single_ms:.1f} spectra/s, {busy / wall:.1%} busy); "
          f"wps_batch B={C3_B} {batch_ms:.3f} ms a batch ({C3_B / (batch_ms / 1e3):.1f} aggregate "
          f"spectra/s, {busy_b / wall_b:.1%} busy, peak {mem3 / 2**20:.1f} MiB)  ({card})")

    # the rest of the surface once each on the card against the CPU port,
    # float64: WPS with its band averages and cone, CompositeSpectrum,
    # denoise (explicit and MAD sigma), denoise_batch, reconstruct, and HHT
    # with every method and normalization on one decomposition (EMD on the
    # card against the CPU first)
    rng = np.random.default_rng(26)
    ts = np.arange(512.0)
    ys = (np.sin(2 * np.pi * ts / 25.0) + 0.5 * np.sin(2 * np.pi * ts / 6.0)
          + 0.05 * rng.standard_normal(512))
    card_s, host_s = TSeries(cuda(ts), cuda(ys)), TSeries(ts, ys, device="cpu")
    diffs = {}

    def agree(name, a, b, tol=1e-9, held=True):
        """Card against CPU within tol of the CPU's largest value; with
        held=False the difference is recorded and only finiteness checked."""
        a, b = a.cpu(), b.cpu()
        scale = max(float(np.nanmax(np.abs(b.numpy()))), 1e-300)
        nan_a, nan_b = torch.isnan(a), torch.isnan(b)
        if not held:
            check(not nan_a.any() and a.shape == b.shape, f"{name}: finite, {tuple(b.shape)}")
        check(torch.equal(nan_a, nan_b), f"{name}: NaN positions differ")
        d = float(np.nanmax(np.abs((a - b).numpy()))) if (~nan_a).any() else 0.0
        diffs[name] = d / scale
        check(not held or d <= tol * scale, f"{name}: card vs CPU {d / scale:.3e} > {tol:g}")

    periods = np.geomspace(4.0, 100.0, 40)
    wc, wh = WPS(periods), WPS(periods)
    agree("wps", wc(card_s).values, wh(host_s).values)
    agree("wps_masked", wc.masked_spectrum.values, wh.masked_spectrum.values)
    for name in ("gwps", "masked_gwps"):
        agree(name, getattr(wc, name)().values, getattr(wh, name)().values)
    agree("sav", wc.sav(5, 30).values, wh.sav(5, 30).values)
    agree("masked_sav", wc.masked_sav(5, 30).values, wh.masked_sav(5, 30).values)
    check(np.array_equal(wc.mask_coi, wh.mask_coi), "WPS cone of influence card vs CPU")
    agree("composite", CompositeSpectrum(periods)(card_s).values,
          CompositeSpectrum(periods)(host_s).values)
    agree("denoise", denoise(cuda(ys), sigma=0.05), denoise(torch.from_numpy(ys), sigma=0.05))
    agree("denoise_mad", denoise(cuda(ys), family="sym5"),
          denoise(torch.from_numpy(ys), family="sym5"))
    yb = np.stack([ys, ys[::-1].copy(), 0.5 * ys])
    agree("denoise_batch", denoise_batch(cuda(yb)), denoise_batch(torch.from_numpy(yb)))
    agree("reconstruct", reconstruct(wc.coefs, periods, 1.0, WPS.FAMILY),
          reconstruct(wh.coefs, periods, 1.0, WPS.FAMILY))

    class Fixed:
        """A decomposition that returns given modes (HHT's pluggable emd)."""

        def __init__(self, modes):
            self.modes = modes

        def __call__(self, signal):
            return self.modes

    from periodicity_tpu_torch.decomposition import EMD

    imfs_card, imfs_host = EMD()(card_s), EMD()(host_s)
    check(len(imfs_card) == len(imfs_host), "EMD modes card vs CPU")
    for a, b in zip(imfs_card, imfs_host):
        agree("emd", a.values, b.values)
    grid = np.linspace(0.005, 0.3, 48)
    hht_rows = {}
    for method in ("DQ", "NHT", "TEO", "HT"):
        for norm in ("spline", "hilbert", "lmd"):
            r0 = lmd.host_reads
            n0 = hht.am_fm_normalize.launches
            kw = {"method": method, "norm_type": norm}
            hc = HHT(grid, emd=Fixed(imfs_card), **kw)
            tfc = hc(card_s)
            torch.cuda.synchronize()
            hht_rows[f"{method}_{norm}"] = {"lmd_host_reads": lmd.host_reads - r0,
                                            "n1_launches": hht.am_fm_normalize.launches - n0}
            if method in ("DQ", "NHT") and norm == "lmd":
                # LMD's device operations for the same normalization
                work, _ = profiled(lambda: hc(card_s), pad=1)
                hht_rows[f"{method}_{norm}"]["device_ops"] = len(work)
            hh = HHT(grid, emd=Fixed(imfs_host), **kw)
            # LMD's envelope smoothing stops on exact zero differences,
            # which the card's and the CPU's summation orders reach on
            # different passes (ROADMAP C4): recorded, not held
            agree(f"hht_{method}_{norm}", tfc.values, hh(host_s).values,
                  held=not (norm == "lmd" and method in ("DQ", "NHT")))
    out["surface"] = {"max_rel_diff": diffs, "hht": hht_rows}
    t26 = time.perf_counter()

    n1_launches = hht.am_fm_normalize.launches
    s1_launches = emd.sift_machine.launches
    check(n1_launches > 0 and s1_launches > 0,
          f"N1 ({n1_launches}) and S1 ({s1_launches}) launched on the main path")
    rec["launches"] = n1_launches
    out["main_path_launches"] = {"am_fm_normalize": n1_launches, "emd_sift": s1_launches}
    out["lmd_host_reads_total"] = lmd.host_reads - lmd_reads
    out["wall_s"] = {"24": t24 - start, "25": t25 - t24, "26": t26 - t25}
    lmd_dq = hht_rows["DQ_lmd"]
    held = {k: v for k, v in diffs.items() if not k.endswith(("DQ_lmd", "NHT_lmd"))}
    print(f"phase 26 surface on card vs CPU (f64): WPS, band averages, cone, CompositeSpectrum, "
          f"denoise, denoise_batch, reconstruct, EMD and HHT x 4 methods x 3 normalizations "
          f"agree (largest {max(held.values()):.2e}; DQ/NHT with LMD envelopes, not held: "
          f"{diffs['hht_DQ_lmd']:.2e} / {diffs['hht_NHT_lmd']:.2e}); HHT DQ lmd: "
          f"{lmd_dq['lmd_host_reads']} "
          f"host reads, {lmd_dq.get('device_ops')} device ops; main path: {n1_launches} N1 and "
          f"{s1_launches} S1 launches  ({card})")
    print(json_line({"timefrequency": out}))
    return [rec]



# the GP slice (phases 27-30): config 5 (benchmarks/run_benchmarks.py:260-
# 300: SpottedStar, 64 walkers drawn uniform(0.8, 1.2) from default_rng(0),
# BrownianTerm(0.01 w0, 20 w1, 10 w2, 0.3 w3), k = 10 chained batched
# evaluations), config 7's scan points (:354-410: N = 1e4 and 1e5, float32,
# BrownianTerm(0.01, 20, 10, 0.3), diag 0.01, k = 3) and config 8
# (:460-500: run_ensemble on config 5's log-probability, 64 walkers x 50
# steps, float32)
C5_WALKERS, C5_K = 64, 10
C7_NS, C7_K = (10_000, 100_000), 3
C8_WALKERS, C8_STEPS = 64, 50
# the reference's SpottedStar outcomes (tests/test_gp.py:108-142)
GP_MIN_THRESHOLDS = {"BrownianGP": -12890.0, "HarmonicGP": -13180.0}
GP_MCMC_PERIODS = {"BrownianGP": 10.0, "HarmonicGP": 11.0}


def g1_chain_ops(r):
    """Dependent operations of one step of the fused factor on its critical
    path: W_{n-1} W_{n-1}^T, times D_{n-1}, plus S, times p p^T (4), Su and
    u . Su (R each), D_n (1) and the division for W_n."""
    return 4 + 2 * r + 1 + DIV_OPS


def g2_chain_ops(r):
    """The adjoint step's longest dependency: W-bar . W (R), a division, the
    D-bar update, the Su-bar update (2), the S-bar update (3), times p p^T,
    the R-deep q, and W-bar's update (3)."""
    return r + DIV_OPS + 1 + 2 + 3 + 1 + r + 3


def g3_chain_ops(r):
    """One step of each sweep of the solve: the state update (3), the R-deep
    dot product and the difference."""
    return 2 * (3 + r + 1)


def bit_equal(a, b):
    """a and b equal bit for bit, NaN where the other is NaN."""
    import torch

    a, b = a.cpu(), b.cpu()
    return (a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a, 0.0), torch.nan_to_num(b, 0.0)))


def same_bits(a, b):
    """a and b hold the same bit patterns, signed zeros included; NaN where
    the other is NaN."""
    import torch

    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(view)[~nan], b.view(view)[~nan]))


def c5_inputs(dev, dtype, n_walkers=C5_WALKERS):
    """Config 5's (A, U, V, P, y) on the card: the walkers' BrownianTerm in
    its masked form (R = 6), SpottedStar's times and mean-subtracted
    values, dy^2 on the diagonal."""
    import torch

    from periodicity_tpu_torch import data as pdata
    from periodicity_tpu_torch.models.gp.solver import _rows, celerite_matrices
    from periodicity_tpu_torch.models.gp.terms import BrownianTerm

    t, y, dy = pdata.SpottedStar()
    w = torch.from_numpy(np.random.default_rng(0).uniform(0.8, 1.2, (n_walkers, 4))).to(dev, dtype)
    tt, yy, diag = (torch.from_numpy(a).to(dev, dtype) for a in (t, y - y.mean(), dy**2))
    term = BrownianTerm(0.01 * w[:, 0], 20.0 * w[:, 1], 10.0 * w[:, 2], 0.3 * w[:, 3])
    (A, U, V, P, yb), _ = _rows(*celerite_matrices(term, tt, diag), yy)
    return [x.contiguous() for x in (A, U, V, P, yb)], (w, tt, yy, diag)


def celerite_kernels(dev, card, cuda, clock_hz):
    """Phase 27: G1, G2 and G3 against their plain versions bit for bit
    (config 5 in both dtypes, its first 8 walkers, config 13's 4 for G2,
    edge draws), the launch geometry the library reports, G2's local memory,
    and the kernels' times beside their plain versions, chain bounds and
    library calls. Returns the three kernels' JSON records, keyed by
    name."""
    import torch

    from periodicity_tpu_torch.models.gp.solver import _rows, celerite_matrices
    from periodicity_tpu_torch.models.gp.terms import BrownianTerm, RotationTerm, SHOTerm
    from periodicity_tpu_torch.ops import celerite as C

    recs = {
        name: {"name": name, "route": "cuda", "source": "periodicity_tpu_torch/csrc/celerite.cuh",
               "replaces": rep, "held": "bit-equal", "max_abs_err": 0.0}
        for name, rep in (("celerite_forward", "periodicity_tpu/models/gp/solver.py:161"),
                          ("celerite_adjoint", "periodicity_tpu/models/gp/solver.py:161"),
                          ("celerite_solve", "periodicity_tpu/models/gp/solver.py:106"))
    }
    for name in ("celerite_forward", "celerite_solve"):
        recs[name]["redesigned"] = 12
    recs["celerite_adjoint"]["redesigned"] = 13
    g5, g3n = C.kernel_geometry(b=C5_WALKERS, r=6), C.kernel_geometry(k=2148, r=6)
    g2g = C.kernel_geometry(b=C5_WALKERS, r=6, adjoint=True)
    recs["celerite_forward"]["geometry_config5"] = g5
    recs["celerite_adjoint"]["geometry_config5"] = g2g
    recs["celerite_solve"]["geometry_k2148"] = g3n
    print(f"phase 27 launch geometry: G1 at config 5 {g5}; G2 at config 5 {g2g}; G3 at K = 2148 "
          f"{g3n}")
    # G2 keeps its rows in registers up to R = 8: no local memory there
    g2_attrs = {f"{'f64' if dt == torch.float64 else 'f32'}_r{r}":
                C.kernel_attributes(r, dt)["adjoint"]
                for dt in (torch.float64, torch.float32) for r in range(1, C.MAX_R + 1)}
    recs["celerite_adjoint"]["attributes"] = g2_attrs
    print("phase 27 G2 instantiations (local bytes / registers / shared bytes): "
          + ", ".join(f"{k} {a['local_bytes']}/{a['registers']}/{a['shared_bytes']}"
                      for k, a in g2_attrs.items()))

    def both_forward(A, U, V, P, y, label):
        # every output, with and without y, the saved state and W
        for yy, save, want_w in ((None, False, True), (y, False, False), (y, True, True)):
            got = C.celerite_forward(A, U, V, P, yy, save=save, want_w=want_w)
            want = C.celerite_forward_plain(A, U, V, P, yy, save=save)
            torch.cuda.synchronize()
            for name, a, b in zip(("D", "W", "z", "S_saved", "f_saved"), got, want):
                check((a is None) == (b is None or (name == "W" and not want_w)),
                      f"G1: {name} given as the plain version gives it ({label})")
                if a is not None:
                    check(bit_equal(a, b), f"G1 vs plain, {name} not bit-equal ({label}, "
                          f"y {yy is not None}, save {save}, want_w {want_w})")
        return got

    def both_adjoint(U, P, fwd, label):
        D, W, z, S_saved, f_saved = fwd
        # the adjoints the eager sums send back: ll = -(sum z^2/D + sum log D)/2
        dz, dD = -z / D, -0.5 * (1 / D - z * z / (D * D))
        got = C.celerite_adjoint(U, P, D, W, z, S_saved, f_saved, dD, dz)
        want = C.celerite_adjoint_plain(U, P, D, W, z, S_saved, f_saved, dD, dz)
        torch.cuda.synchronize()
        for name, a, b in zip(("dA", "dU", "dV", "dP", "dy"), got, want):
            check(same_bits(a, b), f"G2 vs plain, {name} not bit-equal ({label})")
        return (D, W, z, S_saved, f_saved, dD, dz)

    def both_solve(U, P, D, W, Y, label):
        got = C.celerite_solve(U, P, D, W, Y)
        want = C.celerite_solve_plain(U, P, D, W, Y)
        torch.cuda.synchronize()
        check(bit_equal(got, want), f"G3 vs plain not bit-equal ({label})")
        return got

    # phase 27: G1, G2, G3 against their plain versions, bit for bit, at
    # config 5's shape in float32 and float64 (the plain versions step
    # through numpy on the host: no FMA), G3 at K = 1, 65, 2148; edge draws
    rng = np.random.default_rng(27)
    timed = {}
    for dtype, pre in ((torch.float32, "f32_"), (torch.float64, "")):
        (A, U, V, P, y), _ = c5_inputs(dev, dtype)
        b, n, r = U.shape
        check(r == 6, f"config 5's masked BrownianTerm has R = 6, got {r}")
        fwd = both_forward(A, U, V, P, y, f"config 5, {dtype}")
        adj = both_adjoint(U, P, fwd, f"config 5, {dtype}")
        D, W = fwd[0], fwd[1]
        for k in (1, 31, 32, 33, 65, n):
            both_solve(U[0], P[0], D[0], W[0],
                       torch.from_numpy(rng.standard_normal((n, k))).to(dev, dtype),
                       f"config 5 row 0, K = {k}, {dtype}")
        timed[pre] = (A, U, V, P, y, adj, _)
    # mcmc(16)'s half-ensemble: 8 walkers, two blocks of four; config 13's
    # 4 chains in float32, one block
    (A8, U8, V8, P8, y8), rows8 = c5_inputs(dev, torch.float64, 8)
    fwd8 = both_forward(A8, U8, V8, P8, y8, "config 5's first 8 walkers, float64")
    adj8 = both_adjoint(U8, P8, fwd8, "config 5's first 8 walkers, float64")
    (A4, U4, V4, P4, y4), rows4 = c5_inputs(dev, torch.float32, 4)
    fwd4 = both_forward(A4, U4, V4, P4, y4, "config 13's 4 walkers, float32")
    adj4 = both_adjoint(U4, P4, fwd4, "config 13's 4 walkers, float32")
    edges = []
    # a live SHO (R = 2); a masked RotationTerm over 3 rows (R = 8); N = 2; a
    # row whose D goes non-positive (NaN for NaN)
    t = np.sort(rng.uniform(0, 40, 300))
    ys = rng.standard_normal(300)
    for dtype in (torch.float64, torch.float32):
        tt, yy = cuda(t).to(dtype), cuda(ys).to(dtype)
        diag = torch.full_like(tt, 0.05)
        per = torch.tensor([7.0, 3.0, 11.0], dtype=dtype, device=dev)
        cases = [("live SHO, R = 2", SHOTerm(S0=1.3, w0=2.1, Q=3.0), tt, diag, yy),
                 ("masked RotationTerm, R = 8, 3 rows",
                  RotationTerm(sigma=1.2, period=per, Q0=2.0, dQ=1.0, f=0.4), tt, diag, yy),
                 ("N = 2", SHOTerm(S0=1.3, w0=2.1, Q=3.0), tt[:2], diag[:2], yy[:2])]
        for label, term, t_, d_, y_ in cases:
            (A, U, V, P, y), _ = _rows(*celerite_matrices(term, t_, d_), y_)
            A, U, V, P, y = (x.contiguous() for x in (A, U, V, P, y))
            fwd = both_forward(A, U, V, P, y, f"{label}, {dtype}")
            both_adjoint(U, P, fwd, f"{label}, {dtype}")
            both_solve(U[0], P[0], fwd[0][0], fwd[1][0], y[0][:, None].contiguous(),
                       f"{label}, {dtype}")
            edges.append(label)
        (A, U, V, P, y), _ = _rows(*celerite_matrices(SHOTerm(S0=1.3, w0=2.1, Q=3.0), tt, diag),
                                   yy)
        A = A.clone()
        A[0, 40] = -1.0
        fwd = both_forward(A, U.contiguous(), V.contiguous(), P.contiguous(), y.contiguous(),
                           f"non-positive D, {dtype}")
        check(bool((fwd[0][0] <= 0).any()), "the edited row's D goes non-positive")
        both_adjoint(U.contiguous(), P.contiguous(), fwd, f"non-positive D, {dtype}")
    edges = list(dict.fromkeys(edges)) + ["a row whose D goes non-positive"]
    print(f"phase 27 G1/G2/G3 bit-equal to plain at config 5 (B={C5_WALKERS} and 8, N={n}, R=6, "
          f"f32 and f64; 4 walkers in f32; G1 with and without y, the saved state and W; G3 at "
          f"K = 1, 31, 32, 33, 65, {n}) and edge draws ({'; '.join(edges)})")

    def g1_library(rec, pre, w, tt, diag, y, g1):
        """G1's library yardstick: one batched dense Cholesky of the walkers'
        K and the triangular solve for z (D = diag(L)^2 and L^-1 y, scaled),
        held against G1 through the log-likelihood. Records its time, the
        rows it could not factor and the largest relative difference."""
        termb = BrownianTerm(0.01 * w[:, 0], 20.0 * w[:, 1], 10.0 * w[:, 2], 0.3 * w[:, 3])
        Kb = termb.get_value(tt[:, None] - tt[None, :]) + torch.diag(diag)
        yb = y[:, :, None]

        def lib1():
            Lb, info = torch.linalg.cholesky_ex(Kb)
            return Lb, info, torch.linalg.solve_triangular(Lb, yb, upper=False)

        Lb, info, zl = lib1()
        dl = torch.diagonal(Lb, dim1=-2, dim2=-1)
        ll_lib = -(zl[..., 0].square().sum(-1) + 2 * torch.log(dl).sum(-1))
        Dk, _, zk, _, _ = g1()
        ll_g1 = -(torch.sum(zk * zk / Dk, dim=-1) + torch.sum(torch.log(Dk), dim=-1))
        ok = info == 0
        rel = float(((ll_lib - ll_g1).abs() / ll_g1.abs())[ok].max())
        rec[f"{pre}library_ms"] = event_ms(lib1, 3)
        rec[f"{pre}library_failed_rows"] = int((~ok).sum())
        rec[f"{pre}library_vs_kernel_rel"] = rel
        return rel

    def g2_library(rec, pre, w, tt, diag, y):
        """G2's library yardstick: autograd's backward through G1's (the
        batched cholesky_ex + solve_triangular log-likelihood of the walkers'
        dense K), from K and y, timed alone on a kept graph. Both paths are
        built from the walkers' term parameters and y, so their gradients
        with respect to those are held against each other: the scan
        likelihood's through G1 and G2, the dense one's through K. Records
        the time and the largest relative difference of a walker's gradient
        (rows the dense Cholesky factors)."""
        from periodicity_tpu_torch.models.gp.solver import log_likelihood

        def grads(dense):
            # (d ll / d w, d ll / d y) and the rows the dense Cholesky factors
            wg = w.detach().clone().requires_grad_(True)
            yg = y.detach().clone().requires_grad_(True)
            term = BrownianTerm(0.01 * wg[:, 0], 20.0 * wg[:, 1], 10.0 * wg[:, 2],
                                0.3 * wg[:, 3])
            if not dense:
                return torch.autograd.grad(log_likelihood(term, tt, diag, yg).sum(), (wg, yg)), None
            Kb = term.get_value(tt[:, None] - tt[None, :]) + torch.diag(diag)
            Lb, info = torch.linalg.cholesky_ex(Kb)
            zl = torch.linalg.solve_triangular(Lb, yg[:, :, None], upper=False)
            dl = torch.diagonal(Lb, dim1=-2, dim2=-1)
            ll = -0.5 * (zl[..., 0].square().sum(-1) + 2 * torch.log(dl).sum(-1))
            total = torch.where(info == 0, ll, 0).sum()
            back = lambda: torch.autograd.grad(total, (Kb, yg), retain_graph=True)  # noqa: E731
            rec[f"{pre}library_ms"] = event_ms(back, 3)
            return torch.autograd.grad(total, (wg, yg)), info == 0

        (gw_l, gy_l), ok = grads(True)
        (gw_s, gy_s), _ = grads(False)
        rel = max(float(((a - b).abs().amax(-1) / b.abs().amax(-1))[ok].max())
                  for a, b in ((gw_s, gw_l), (gy_s, gy_l))) if bool(ok.any()) else float("nan")
        rec[f"{pre}library_grad_rel"] = rel
        torch.cuda.empty_cache()
        return rel

    def g2_times(rec, pre, U, P, adj, rows, name):
        """G2's events, device, plain and chain-bound times at U's shape,
        and its library yardstick."""
        D, W, z, S_saved, f_saved, dD, dz = adj
        b, n, r = U.shape
        kk = r * (r + 1) // 2
        g2 = lambda: C.celerite_adjoint(U, P, D, W, z, S_saved, f_saved, dD, dz)  # noqa: E731
        g2()  # untimed: after g2_library's empty_cache a first call allocates anew
        torch.cuda.synchronize()
        rec[f"{pre}ms"] = event_ms(g2, 10)
        rec[f"{pre}device_ms"] = device_us(g2, "celerite_adjoint_kernel", 5) / 1e3
        rec[f"{pre}plain_ms"] = plain_wall_ms(
            lambda: C.celerite_adjoint_plain(U, P, D, W, z, S_saved, f_saved, dD, dz))
        rec[f"{pre}bound_ms"], rec[f"{pre}bound_by"] = chain_bound(
            U.element_size() * b * (n * r + (n - 1) * r + 3 * n + n * r + (n - 1) * (kk + r)
                                    + 2 * n + n + 2 * n * r + (n - 1) * r + n),
            n * g2_chain_ops(r), name, clock_hz)
        w, tt, yy, diag = rows
        g2_library(rec, pre, w, tt, diag, yy.expand(b, n).contiguous())
        return (f"G2 {rec[pre + 'ms']:.4f} ms (device {rec[pre + 'device_ms']:.4f}, plain "
                f"{rec[pre + 'plain_ms']:.1f}, bound {rec[pre + 'bound_ms']:.4f} "
                f"{rec[pre + 'bound_by']}, autograd backward through the dense cholesky_ex + "
                f"solve_triangular {rec[pre + 'library_ms']:.4f} ms, gradient rel diff "
                f"{rec[pre + 'library_grad_rel']:.1e})")

    # times at config 5's shape: events over back-to-back calls, the
    # profiler's device time per call, the plain version's wall time (one
    # call), the chain bound; G3 at K = N against one dense cholesky_solve
    for pre, (A, U, V, P, y, adj, rows) in timed.items():
        name = "float32" if pre else "float64"
        elem = A.element_size()
        b, n, r = U.shape
        D, W, z, S_saved, f_saved, dD, dz = adj
        g1 = lambda: C.celerite_forward(A, U, V, P, y, want_w=False)  # noqa: E731
        g1s = lambda: C.celerite_forward(A, U, V, P, y, save=True)  # noqa: E731
        Y = torch.from_numpy(rng.standard_normal((n, n))).to(dev, A.dtype)
        g3 = lambda: C.celerite_solve(U[0], P[0], D[0], W[0], Y)  # noqa: E731
        # the same system of row 0, dense: the walker's kernel at every lag
        # plus the diagonal, factored once outside the timed call
        w0, tt, _, diag = rows
        term0 = BrownianTerm(0.01 * w0[0, 0], 20.0 * w0[0, 1], 10.0 * w0[0, 2], 0.3 * w0[0, 3])
        Kd = term0.get_value(tt[:, None] - tt[None, :]) + torch.diag(diag)
        Lc, _ = torch.linalg.cholesky_ex(Kd)
        lib = lambda: torch.cholesky_solve(Y, Lc)  # noqa: E731
        xs, xl = g3(), lib()
        torch.cuda.synchronize()
        rel3 = float((xs - xl).abs().max() / xl.abs().max())
        g1r, g2r, g3r = recs["celerite_forward"], recs["celerite_adjoint"], recs["celerite_solve"]
        g1r[f"{pre}ms"] = event_ms(g1, 20)
        g1r[f"{pre}device_ms"] = device_us(g1, "celerite_forward_kernel", 5) / 1e3
        g1r[f"{pre}save_ms"] = event_ms(g1s, 10)
        g1r[f"{pre}plain_ms"] = plain_wall_ms(lambda: C.celerite_forward_plain(A, U, V, P, y))
        rel1 = g1_library(g1r, pre, w0, tt, diag, y, g1)
        g1r[f"{pre}bound_ms"], g1r[f"{pre}bound_by"] = chain_bound(
            elem * b * (n + 2 * n * r + (n - 1) * r + n + 2 * n), n * g1_chain_ops(r), name,
            clock_hz)
        g2_line = g2_times(g2r, pre, U, P, adj, rows, name)
        g3r[f"{pre}ms"] = event_ms(g3, 5)
        g3r[f"{pre}device_ms"] = device_us(g3, "celerite_solve_kernel", 3) / 1e3
        g3r[f"{pre}plain_ms"] = plain_wall_ms(
            lambda: C.celerite_solve_plain(U[0], P[0], D[0], W[0], Y))
        g3r[f"{pre}library_ms"] = event_ms(lib, 5)
        g3r[f"{pre}library_vs_kernel_rel"] = rel3
        g3r[f"{pre}bound_ms"], g3r[f"{pre}bound_by"] = chain_bound(
            elem * (3 * n * r + n + 2 * n * n), n * g3_chain_ops(r), name, clock_hz)
        # G3 at K = 1 (predict's shape): one lane walks both sweeps
        y1 = Y[:, :1].contiguous()
        g31 = lambda: C.celerite_solve(U[0], P[0], D[0], W[0], y1)  # noqa: E731
        g3r[f"{pre}k1_ms"] = event_ms(g31, 20)
        g3r[f"{pre}k1_device_ms"] = device_us(g31, "celerite_solve_kernel", 5) / 1e3
        g3r[f"{pre}k1_plain_ms"] = plain_wall_ms(
            lambda: C.celerite_solve_plain(U[0], P[0], D[0], W[0], y1))
        lib31 = lambda: torch.cholesky_solve(y1, Lc)  # noqa: E731
        x1, xl1 = g31(), lib31()
        torch.cuda.synchronize()
        g3r[f"{pre}k1_library_ms"] = event_ms(lib31, 20)
        g3r[f"{pre}k1_library_vs_kernel_rel"] = float((x1 - xl1).abs().max() / xl1.abs().max())
        g3r[f"{pre}k1_bound_ms"], g3r[f"{pre}k1_bound_by"] = chain_bound(
            elem * (3 * n * r + n + 2 * n), n * g3_chain_ops(r), name, clock_hz)
        print(f"phase 27 {name}, config 5 (B={b}, N={n}, R={r}): G1 {g1r[pre + 'ms']:.4f} ms "
              f"(device {g1r[pre + 'device_ms']:.4f}, saving state {g1r[pre + 'save_ms']:.4f}, "
              f"plain {g1r[pre + 'plain_ms']:.1f}, bound {g1r[pre + 'bound_ms']:.4f} "
              f"{g1r[pre + 'bound_by']}, batched dense cholesky_ex + solve_triangular "
              f"{g1r[pre + 'library_ms']:.4f} ms, ll rel diff {rel1:.1e}, "
              f"{g1r[pre + 'library_failed_rows']} rows not positive definite); {g2_line}; "
              f"G3 K={n} {g3r[pre + 'ms']:.4f} ms (device "
              f"{g3r[pre + 'device_ms']:.4f}, plain {g3r[pre + 'plain_ms']:.1f}, dense "
              f"cholesky_solve {g3r[pre + 'library_ms']:.4f} ms, rel diff {rel3:.1e}, bound "
              f"{g3r[pre + 'bound_ms']:.4f}); G3 K=1 {g3r[pre + 'k1_ms']:.4f} ms (device "
              f"{g3r[pre + 'k1_device_ms']:.4f}, plain {g3r[pre + 'k1_plain_ms']:.1f}, dense "
              f"cholesky_solve {g3r[pre + 'k1_library_ms']:.4f} ms, rel diff "
              f"{g3r[pre + 'k1_library_vs_kernel_rel']:.1e}, bound "
              f"{g3r[pre + 'k1_bound_ms']:.4f})  ({card})")
    # G1 at mcmc(16)'s half-ensemble of 8 walkers (f64): 2 blocks
    g18 = lambda: C.celerite_forward(A8, U8, V8, P8, y8, want_w=False)  # noqa: E731
    g1r = recs["celerite_forward"]
    b8, n8, r8 = U8.shape
    g1r["b8_ms"] = event_ms(g18, 20)
    g1r["b8_device_ms"] = device_us(g18, "celerite_forward_kernel", 5) / 1e3
    g1r["b8_plain_ms"] = plain_wall_ms(lambda: C.celerite_forward_plain(A8, U8, V8, P8, y8))
    w8, tt8, _, diag8 = rows8
    g1_library(g1r, "b8_", w8, tt8, diag8, y8, g18)
    g1r["b8_bound_ms"], g1r["b8_bound_by"] = chain_bound(
        A8.element_size() * b8 * (n8 + 2 * n8 * r8 + (n8 - 1) * r8 + n8 + 2 * n8),
        n8 * g1_chain_ops(r8), "float64", clock_hz)
    g2r = recs["celerite_adjoint"]
    g2_b8 = g2_times(g2r, "b8_", U8, P8, adj8, rows8, "float64")
    print(f"phase 27 float64, G1 and G2 at 8 walkers (mcmc(16)'s half-ensemble, "
          f"{C.kernel_geometry(b=b8, r=r8)['blocks']} blocks): G1 {g1r['b8_ms']:.4f} ms (device "
          f"{g1r['b8_device_ms']:.4f}, plain {g1r['b8_plain_ms']:.1f}, batched dense "
          f"cholesky_ex + solve_triangular {g1r['b8_library_ms']:.4f} ms, ll rel diff "
          f"{g1r['b8_library_vs_kernel_rel']:.1e}, bound {g1r['b8_bound_ms']:.4f} "
          f"{g1r['b8_bound_by']}); {g2_b8}  ({card})")
    g2_b4 = g2_times(g2r, "f32_b4_", U4, P4, adj4, rows4, "float32")
    print(f"phase 27 float32, G2 at config 13's 4 walkers "
          f"({C.kernel_geometry(b=4, r=6, adjoint=True)['blocks']} block): {g2_b4}  ({card})")
    for rec in recs.values():
        rec["shape"] = ("config 5: 64 walkers x N = 2148, the masked BrownianTerm (R = 6), "
                        "float64 unprefixed and float32 under f32_; G3 one row with K = N "
                        "right-hand sides (k1_: K = 1); G1 and G2 b8_: 8 walkers, float64; G2 "
                        "f32_b4_: 4 walkers (config 13's chains), float32")
    check(all(a["local_bytes"] == 0 for k, a in g2_attrs.items() if int(k.split("_r")[1]) <= 8),
          "G2 uses no local memory at R = 1..8 in float32 and float64")
    return recs


def gp_slice(dev, card, cuda):
    """Phases 27-30: the celerite kernels against their plain versions,
    configs 5, 7 and 8, and the GP modelers on SpottedStar. Prints the
    ``{"gp": ...}`` line and returns the three kernels' JSON records."""
    import torch

    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch import data as pdata
    from periodicity_tpu_torch.gp import BrownianGP, HarmonicGP, QuasiPeriodicGP
    from periodicity_tpu_torch.models.gp import mcmc
    from periodicity_tpu_torch.models.gp.solver import log_likelihood
    from periodicity_tpu_torch.models.gp.terms import BrownianTerm
    from periodicity_tpu_torch.ops import celerite as C

    clock_hz = sm_clock_hz()
    start = time.perf_counter()
    out = {"card": card, "sm_clock_max_mhz": clock_hz / 1e6}
    recs = celerite_kernels(dev, card, cuda, clock_hz)
    t27 = time.perf_counter()

    # phase 28: config 5, k = 10 chained batched evaluations, each feeding
    # the next; f32 (as JAX's benchmark ran it) and f64. Config 7's scan
    # points: N = 1e4 and 1e5 in f32 (the pscan and blocked points wait for
    # slice A7b)
    c5 = {}
    for dtype, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        _, (w0, tt, yy, diag) = c5_inputs(dev, dtype)

        def evaluate(ws, tt=tt, yy=yy, diag=diag):
            term = BrownianTerm(0.01 * ws[:, 0], 20.0 * ws[:, 1], 10.0 * ws[:, 2],
                                0.3 * ws[:, 3])
            return log_likelihood(term, tt, diag, yy)

        def chained(k=C5_K, w0=w0, evaluate=evaluate):
            ws, acc = w0, torch.zeros((), dtype=w0.dtype, device=dev)
            for _ in range(k):
                lls = evaluate(ws)
                ws = ws + lls[:, None] * 1e-12
                acc = acc + lls[0]
            return acc

        with torch.no_grad():
            lls = evaluate(w0)
            check(bool(torch.isfinite(lls).all()), f"config 5 {name}: finite log-likelihoods")
            chained(1)
            ms = statistics.median(event_ms(chained, 1) for _ in range(3)) / C5_K
            work, wall = profiled(lambda: evaluate(w0), pad=2)
            busy = sum(us for _, us in work) / 1e6
            mem = peak_bytes(lambda: evaluate(w0))
        c5[name] = {"ms_per_batch": ms, "evals_per_s": C5_WALKERS / (ms / 1e3),
                    "launches_per_eval": len(work), "busy_share": busy / wall,
                    "peak_mib": mem / 2**20}
        print(f"phase 28 config 5 {name}: {c5[name]['evals_per_s']:.4e} evals/s ({ms:.3f} ms a "
              f"batch of {C5_WALKERS}), {len(work)} device launches an evaluation, busy "
              f"{busy / wall:.1%}, peak {mem / 2**20:.1f} MiB  ({card})")
    out["config5"] = c5
    c7 = {}
    rng7 = np.random.default_rng(0)
    with torch.no_grad():
        for n7 in C7_NS:
            t7 = np.sort(rng7.uniform(0, 1000.0, n7)).astype(np.float32)
            y7 = (np.sin(2 * np.pi * t7 / 20.0) + 0.1 * rng7.standard_normal(n7)).astype(
                np.float32)
            tt, yy = cuda(t7), cuda(y7 - y7.mean())
            diag = torch.full_like(tt, 0.01)
            term = BrownianTerm(0.01, 20.0, 10.0, 0.3)

            def chained7(tt=tt, yy=yy, diag=diag, term=term):
                y0, acc = yy, torch.zeros((), dtype=torch.float32, device=dev)
                for _ in range(C7_K):
                    ll = log_likelihood(term, tt, diag, y0)
                    y0 = y0 + ll * 1e-12
                    acc = acc + ll
                return acc

            ll7 = float(chained7())
            check(math.isfinite(ll7), f"config 7 N={n7}: finite")
            ms7 = statistics.median(event_ms(chained7, 1) for _ in range(2)) / C7_K
            ar, _, ac = term.coefficients()[:3]
            r7 = ar.shape[-1] + 2 * ac.shape[-1]
            c7[f"scan_N{n7}"] = {"ms": ms7, "evals_per_s": 1e3 / ms7, "R": r7,
                                 "chain_bound_ms": chain_bound(0, n7 * g1_chain_ops(r7),
                                                               "float32", clock_hz)[0]}
            print(f"phase 28 config 7 scan N={n7} (f32, R={r7}, live): {ms7:.3f} ms an "
                  f"evaluation, chain bound {c7[f'scan_N{n7}']['chain_bound_ms']:.3f} ms  "
                  f"({card})")
    out["config7"] = c7
    t28 = time.perf_counter()

    # phase 29: config 8, run_ensemble on config 5's log-probability in
    # float32 (64 walkers x 50 steps); then 5 steps in float64 on the card
    # and on the CPU port from the same draws
    def c8_log_prob(tt, yy, diag):
        def log_prob(ws):
            term = BrownianTerm(0.01 * ws[:, 0], 20.0 * ws[:, 1], 10.0 * ws[:, 2],
                                0.3 * ws[:, 3])
            ll = log_likelihood(term, tt, diag, yy)
            return torch.where(torch.isfinite(ll), ll, -1e25)
        return log_prob

    t, y, dy = pdata.SpottedStar()
    x8 = np.random.default_rng(0).uniform(0.9, 1.1, (C8_WALKERS, 4))
    with torch.no_grad():
        tt, yy, diag = (cuda(a).float() for a in (t, y - y.mean(), dy**2))
        lp8 = c8_log_prob(tt, yy, diag)
        x0 = cuda(x8).float()
        mcmc.run_ensemble(lp8, x0, 0, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lps8, acc8 = mcmc.run_ensemble(lp8, x0, 0, C8_STEPS)
        torch.cuda.synchronize()
        s8 = time.perf_counter() - t0
        check(bool(torch.isfinite(lps8).all()) and 0 < acc8 < 1, "config 8: finite, accepting")
        work, wall = profiled(lambda: mcmc.run_ensemble(lp8, x0, 0, 2), pad=1)
        busy8 = sum(us for _, us in work) / 1e6 / wall
        # 5 float64 steps on the card and on the CPU port, from one set of draws
        draws = []
        rng8 = np.random.default_rng(8)
        half = C8_WALKERS // 2
        for _ in range(5):
            draws.append([(rng8.random(half), rng8.integers(0, half, half), rng8.random(half))
                          for _ in range(2)])
        runs = {}
        for where in ("cuda", "cpu"):
            put = (lambda a: cuda(a)) if where == "cuda" else torch.from_numpy
            lp = c8_log_prob(*(put(a) for a in (t, y - y.mean(), dy**2)))
            x = put(x8)
            lpx = lp(x)
            xs, accs = [], []
            for d in draws:
                dd = tuple(tuple(put(np.asarray(a)) for a in h) for h in d)
                x, lpx, acc = mcmc.stretch_step(lp, x, lpx, dd)
                xs.append(x.cpu())
                accs.append(acc.cpu())
            runs[where] = (torch.stack(xs), torch.stack(accs))
    check(torch.equal(runs["cuda"][1], runs["cpu"][1]),
          "config 8 f64: accept decisions card vs CPU")
    rel8 = float(((runs["cuda"][0] - runs["cpu"][0]).abs() / runs["cpu"][0].abs()).max())
    check(rel8 <= 1e-12, f"config 8 f64: positions card vs CPU {rel8:.3e} > 1e-12")
    out["config8"] = {"walker_steps_per_s": C8_WALKERS * C8_STEPS / s8, "seconds": s8,
                      "acceptance": acc8, "busy_share": busy8,
                      "launches_per_step": len(work) / 2, "f64_cpu_rel": rel8}
    print(f"phase 29 config 8 (64 walkers x {C8_STEPS} steps, f32): "
          f"{out['config8']['walker_steps_per_s']:.4e} walker-steps/s ({s8:.3f} s), acceptance "
          f"{acc8:.3f}, busy {busy8:.1%}, {len(work) / 2:.0f} device launches a step; 5 f64 "
          f"steps card vs CPU: accepts equal, positions within {rel8:.1e}  ({card})")
    t29 = time.perf_counter()

    # phase 30, the slice's main path, counted from zero: BrownianGP and
    # HarmonicGP on SpottedStar (minimize, mcmc as the reference runs it),
    # nll and its gradient, predictions, loocv and PSDs against the CPU
    # port; QuasiPeriodicGP on tests/test_gp.py's draw
    C.celerite_forward.launches = 0
    C.celerite_adjoint.launches = 0
    C.celerite_solve.launches = 0
    modelers = {}
    rng30 = np.random.default_rng(30)
    for cls in (BrownianGP, HarmonicGP):
        name = cls.__name__
        m = cls(TSeries(cuda(t), cuda(y)), err=cuda(dy))
        mc = cls(TSeries(t, y, device="cpu"), err=torch.from_numpy(dy))
        t0 = time.perf_counter()
        soln, gp = m.minimize(m.gp)
        torch.cuda.synchronize()
        s_min = time.perf_counter() - t0
        check(soln.fun < GP_MIN_THRESHOLDS[name] and np.all((soln.x >= 0.01) & (soln.x <= 99.99)),
              f"{name}.minimize: fun {soln.fun} < {GP_MIN_THRESHOLDS[name]}, x in the box")
        t0 = time.perf_counter()
        trace, _ = m.mcmc(n_walkers=16, n_steps=1000, burn=200, random_seed=42)
        s_mcmc = time.perf_counter() - t0
        median = float(np.median(trace["period"]))
        check(trace["period"].shape == (16 * 800,) and round(median) == GP_MCMC_PERIODS[name],
              f"{name}.mcmc: median period {median} rounds to {GP_MCMC_PERIODS[name]}")
        # nll and its gradient at 5 hypercube points, card against CPU
        d_nll = d_grad = 0.0
        for u in rng30.uniform(5, 95, (5, m.ndim)):
            vals = []
            for mm, put in ((m, cuda), (mc, torch.from_numpy)):
                uu = put(u).requires_grad_(True)
                f = mm._nll_u(uu)
                (g,) = torch.autograd.grad(f, uu)
                vals.append((float(f.detach()), g.cpu()))
            d_nll = max(d_nll, abs(vals[0][0] - vals[1][0]) / abs(vals[1][0]))
            d_grad = max(d_grad, float((vals[0][1] - vals[1][1]).abs().max()
                                       / vals[1][1].abs().max()))
        check(d_nll <= 1e-10 and d_grad <= 1e-10,
              f"{name}: nll {d_nll:.2e} and gradient {d_grad:.2e} card vs CPU > 1e-10")
        params = m.prior_transform(soln.x)
        gpc = mc.set_params({k: v.cpu() for k, v in params.items()}, mc.gp)
        tn = np.linspace(t[0] - 2, t[-1] + 2, 200)
        f_psd = np.linspace(0.01, 2, 100)
        diffs = {}
        for label, a, b in (
                ("prediction", torch.stack(m.get_prediction(tn, gp)),
                 torch.stack(mc.get_prediction(tn, gpc))),
                ("psd", m.get_psd(f_psd, gp), mc.get_psd(f_psd, gpc)),
                ("loocv", m.loocv(gp), mc.loocv(gpc))):
            diffs[label] = float((a.cpu() - b).abs().max() / b.abs().max())
            # a sum of N terms each within an ulp or so of the CPU's
            check(diffs[label] <= 1e-9, f"{name} {label} card vs CPU {diffs[label]:.2e}")
        modelers[name] = {"minimize_fun": soln.fun, "minimize_s": s_min,
                          "mcmc_median_period": median, "mcmc_s": s_mcmc,
                          "mcmc_acceptance": m.acceptance, "nll_rel": d_nll, "grad_rel": d_grad,
                          **{f"{k}_rel": v for k, v in diffs.items()}}
        print(f"phase 30 {name}: minimize {soln.fun:.3f} ({s_min:.2f} s), mcmc 16 x 1000 median "
              f"period {median:.3f} ({s_mcmc:.2f} s, acceptance {m.acceptance:.3f}); card vs CPU "
              f"nll {d_nll:.1e}, gradient {d_grad:.1e}, "
              + ", ".join(f"{k} {v:.1e}" for k, v in diffs.items()) + f"  ({card})")
    rngq = np.random.default_rng(42)
    tq = np.linspace(0, 10, 120)
    yq = np.sin(np.pi * tq) + 0.1 * rngq.standard_normal(120)
    eq = np.full(120, 0.1)
    qc = QuasiPeriodicGP(TSeries(cuda(tq), cuda(yq)), cuda(eq))
    qh = QuasiPeriodicGP(TSeries(tq, yq, device="cpu"), torch.from_numpy(eq))
    nll0 = qc.nll(qc.theta0)
    d_q = abs(nll0 - qh.nll(qh.theta0)) / abs(qh.nll(qh.theta0))
    check(d_q <= 1e-10, f"QuasiPeriodicGP nll card vs CPU {d_q:.2e}")
    # the call users make, from the default theta0, with the reference's
    # checks (tests/test_gp.py:144-160); the card and the CPU port from that
    # start are recorded side by side, not held to each other
    s0c, _ = qc.minimize()
    s0h, _ = qh.minimize()
    mu0, sd0 = qc.predict(s0c.x, tq[:10])
    check(s0c.fun <= nll0 and bool(torch.isfinite(mu0).all()) and bool((sd0 >= 0).all()),
          f"QuasiPeriodicGP minimize from theta0: fun {s0c.fun} <= nll0 {nll0}, finite "
          f"prediction, sd >= 0")
    d0_fun = abs(s0c.fun - s0h.fun) / abs(s0h.fun)
    d0_x = float(np.abs(np.asarray(s0c.x) - np.asarray(s0h.x)).max())
    # from a start near the injected period
    theta = np.array([0.0, np.log(0.01), np.log(0.5), np.log(25.0), 2.0, np.log(2.0)])
    qc.set_params(theta)
    qh.set_params(theta)
    sq, _ = qc.minimize()
    sh, _ = qh.minimize()
    d_min = abs(sq.fun - sh.fun) / abs(sh.fun)
    check(sq.fun <= qc.nll(theta) and d_min <= 1e-8,
          f"QuasiPeriodicGP minimize card {sq.fun} vs CPU {sh.fun}")
    mu_c, sd_c = qc.predict(theta, tq[:10])
    mu_h, sd_h = qh.predict(theta, tq[:10])
    d_pred = float(max((mu_c.cpu() - mu_h).abs().max() / mu_h.abs().max(),
                       (sd_c.cpu() - sd_h).abs().max() / sd_h.abs().max()))
    check(bool(torch.isfinite(mu_c).all()) and d_pred <= 1e-9,
          f"QuasiPeriodicGP predict card vs CPU {d_pred:.2e}")
    modelers["QuasiPeriodicGP"] = {
        "nll_rel": d_q, "minimize_fun": sq.fun, "minimize_rel": d_min, "predict_rel": d_pred,
        "theta0_nll": nll0, "theta0_minimize_fun": s0c.fun, "theta0_minimize_fun_cpu": s0h.fun,
        "theta0_minimize_x": [float(v) for v in s0c.x],
        "theta0_minimize_x_cpu": [float(v) for v in s0h.x], "theta0_fun_rel": d0_fun,
        "theta0_x_max_abs": d0_x}
    print(f"phase 30 QuasiPeriodicGP: nll card vs CPU {d_q:.1e}; minimize from theta0 "
          f"{s0c.fun:.6f} (nll0 {nll0:.6f}; CPU {s0h.fun:.6f}, rel {d0_fun:.1e}, x max abs "
          f"diff {d0_x:.1e}); from near the period {sq.fun:.6f} (CPU within {d_min:.1e}); "
          f"predict card vs CPU {d_pred:.1e}  ({card})")
    t30 = time.perf_counter()
    launches = {"celerite_forward": C.celerite_forward.launches,
                "celerite_adjoint": C.celerite_adjoint.launches,
                "celerite_solve": C.celerite_solve.launches}
    check(all(v > 0 for v in launches.values()), f"G1, G2 and G3 launched on the main path: "
          f"{launches}")
    for name, rec in recs.items():
        rec["launches"] = launches[name]
    out["modelers"] = modelers
    out["main_path_launches"] = launches
    out["wall_s"] = {"27": t27 - start, "28": t28 - t27, "29": t29 - t28, "30": t30 - t29}
    print(f"phase 30 main path: {launches['celerite_forward']} G1, "
          f"{launches['celerite_adjoint']} G2 and {launches['celerite_solve']} G3 launches")
    print(json_line({"gp": out}))
    return list(recs.values())


# the Kalman slice (phases 31-33): config 7's solver points
# (benchmarks/run_benchmarks.py:354-457 and _gp1e6_probe.py: one row,
# BrownianTerm(0.01, 20, 10, 0.3) live (R = 4), float32, t uniform over 1000
# days, y = sin(2 pi t / 20) + 0.1 noise, diag 0.01, k = 3 chained
# evaluations; blocked with n_blocks = max(min(N // 256, 512), 16), chunked at
# N = 1e6 with chunk 65536 and 512 inner blocks) and config 13 (:705-805:
# run_nuts on SpottedStar's BrownianTerm posterior, float32, 4 chains, depth
# 6, 40 steps after 60 warmup; 2, 8 and 16 chains at depth 4, 10 + 20)
C7_SOLVER_NS = (10_000, 100_000)
C7_CHUNKED_N, C7_CHUNK, C7_INNER = 1_000_000, 65536, 512
C13_CHAINS, C13_DEPTH, C13_STEPS, C13_WARMUP = 4, 6, 40, 60
C13_SCALING = (2, 8, 16)
# the JAX package's NUTS checks on its synthetic rotator (tests/test_nuts.py:
# 76-129): BrownianGP.nuts and QuasiPeriodicGP.nuts on every third sample;
# the rotator's chains cut from 300 + 300 steps to 110 + 200 and the
# quasi-periodic model's from 100 + 150 to 75 + 150 (the runs are
# host-bound, ~0.4-0.9 s a step, and the smoke has 1200 s; the same warmup
# and seeds, so each chain is a prefix of the longer one), the checks
# unchanged
ROTATOR_NUTS = dict(n_chains=2, n_steps=110, n_warmup=200, burn=50, max_depth=6,
                    random_seed=42)
QP_NUTS = dict(n_chains=2, n_steps=75, n_warmup=150, burn=25, max_depth=5, random_seed=0)
# the JAX package's float32 characterization of the scan against float64
# (tests/test_gp.py:199-233, at N <= 8192), held at N = 1e4. Beyond it the
# float32 scan of either package exceeds it (ROADMAP C5), so a longer series
# holds every float32 solver within a fixed limit of the float64 scan: above
# the largest reading of the sound solvers over C7_F32_SEEDS and of the JAX
# package's own float32 scan (tests/test_torch_gp_float32.py), and below the
# control, one lost carry (c7_lost_carry), which the run also measures. Every
# solver is held in float64 as well.
F32_LL_REL = 1e-5
F32_LL_REL_LONG = {100_000: 1e-4, 1_000_000: 2e-3}
F64_LL_REL = 1e-10
C7_F32_SEEDS = (1, 2, 3, 4, 5)


def c7_blocks(n):
    return max(min(n // 256, 512), 16)


def c7_series(rng, n):
    """Config 7's float32 light curve of n samples from ``rng``: (t, y - mean)."""
    t = np.sort(rng.uniform(0, 1000.0, n)).astype(np.float32)
    y = (np.sin(2 * np.pi * t / 20.0) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return t, y - y.mean()


def c7_lost_carry(term, t, diag, y, bound, n_blocks):
    """The control of the float32 limits: the blocked likelihood of config
    7's series with the carry dropped at sample ``bound`` (K1 from the
    identity there, as if one chunk's carry were lost), the stretches on
    either side over ``n_blocks`` blocks; differentiable where the term
    needs a gradient (the control of phase 39's gradient limits)."""
    import torch

    from periodicity_tpu_torch.models.gp import pscan
    from periodicity_tpu_torch.utils.dtypes import full_float32

    coeffs, tt, dd, yy, batch = pscan._prepared(term, t, diag, y)
    with full_float32():
        dt = torch.cat([tt.new_zeros(1), torch.diff(tt)])
        lo, _ = pscan._k1(coeffs, dt[:bound], dd[..., :bound], yy[..., :bound], batch, n_blocks,
                          True, None)
        hi, _ = pscan._k1(coeffs, dt[bound:], dd[..., bound:], yy[..., bound:], batch, n_blocks,
                          False, None)
    return lo + hi


def k1_chain_ops(r):
    """Dependent operations of one composition on its critical path, from
    the carry's C to the next carry's C (csrc/kalman.cu::compose): the R-deep
    sums of I + J C and the identity (R + 1); the elimination's R - 1
    columns, a division, a product and a difference each; the back
    substitution, a division and then R - 1 rows of a product, a difference
    and a division; C's two R-deep products and its sum (2 R + 1)."""
    return (r + 1) + 2 * (r - 1) * (DIV_OPS + 2) + DIV_OPS + 2 * r + 1


K1_SLOTS = {1: (1, 0), 2: (0, 1), 3: (1, 1), 4: (2, 1), 5: (1, 2), 6: (2, 2), 7: (3, 2),
            8: (4, 2), 9: (1, 4), 10: (2, 4), 11: (3, 4), 12: (2, 5), 13: (3, 5), 14: (2, 6),
            15: (3, 6), 16: (4, 6)}


def k1_draw(rng, r, b, n, dtype):
    """K1's operands for b rows of n samples of a random SHO-family term
    with R = r states (K1_SLOTS real and complex slots, b = a c / d as an
    SHO's), step 0 the stationary prior: (coeffs, dt, A, Q, H, diag, y) on
    the CPU."""
    import torch

    from periodicity_tpu_torch.models.gp import pscan

    jr, jc = K1_SLOTS[r]
    u = lambda lo, hi, k: torch.from_numpy(rng.uniform(lo, hi, (b, k))).to(dtype)  # noqa: E731
    ar, cr, ac, cc, dc = u(0.2, 1.5, jr), u(0.05, 2.0, jr), u(0.2, 1.5, jc), u(0.05, 1.0, jc), \
        u(0.3, 3.0, jc)
    coeffs = (ar, cr, ac, ac * cc / dc, cc, dc)
    t = torch.from_numpy(np.sort(rng.uniform(0, 30, n))).to(dtype)
    dt = torch.cat([t.new_zeros(1), torch.diff(t)])
    A, Pinf, H = pscan._ssm_from_dt(coeffs, dt)
    A, Q = pscan._process_noise(A, Pinf)
    diag = torch.from_numpy(rng.uniform(0.01, 0.1, (b, n))).to(dtype)
    y = torch.from_numpy(rng.standard_normal((b, n))).to(dtype)
    return coeffs, dt, A, Q, H, diag, y


def config13(dev, card):
    """Config 13: ``run_nuts`` on SpottedStar's BrownianTerm posterior
    (float32, 4 chains, depth 6, 40 + 60 warmup): grad-evals/s (the chains'
    leapfrogs, warmup included, over the run's host-clock seconds),
    divergences, ESS, R-hat, launches a batched leapfrog and the busy share
    of a short run. Prints its line; returns the record and ``nuts_run(c,
    steps, warmup, depth) -> (result, seconds)`` for the chain scaling. It
    imports the package on the path, so a script run from another
    checkout's root measures that checkout's port."""
    import torch

    from periodicity_tpu_torch import data as pdata
    from periodicity_tpu_torch.gp import log_likelihood, run_nuts
    from periodicity_tpu_torch.models.gp import mcmc
    from periodicity_tpu_torch.models.gp.nuts import _value_and_grad
    from periodicity_tpu_torch.models.gp.terms import BrownianTerm

    ts, ys, dys = pdata.SpottedStar()
    tt, yy, diag = (torch.from_numpy(np.ascontiguousarray(a)).to(dev).float()
                    for a in (ts, ys - ys.mean(), dys**2))

    def c13_log_prob(w):
        c13_log_prob.calls += 1
        term = BrownianTerm(0.01 * torch.exp(w[:, 0]), 20.0 * torch.exp(w[:, 1]),
                            10.0 * torch.exp(w[:, 2]), 0.3 * torch.sigmoid(w[:, 3]))
        ll = log_likelihood(term, tt, diag, yy)
        return torch.where(torch.isfinite(ll), ll, -1e25) - 0.5 * torch.sum(w**2, dim=-1)

    def nuts_run(c, steps, warmup, depth):
        x0 = torch.zeros((c, 4), dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_nuts(c13_log_prob, x0, 0, steps, n_warmup=warmup, max_depth=depth)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    c13_log_prob.calls = 0
    res, s13 = nuts_run(C13_CHAINS, C13_STEPS, C13_WARMUP, C13_DEPTH)
    batched = c13_log_prob.calls
    leapfrogs = int(res["n_leapfrog"].sum() + res["n_leapfrog_warmup"].sum())
    chain = res["chain"].cpu().numpy()
    check(np.isfinite(chain).all(), "config 13: finite chains")
    ess13 = mcmc.ess(chain)
    rhat13 = mcmc.rhat(chain)
    vg = _value_and_grad(c13_log_prob)
    z13 = res["chain"][-1]
    work, _ = profiled(lambda: vg(z13), pad=2)
    grad_launches = len(work)
    last = {}

    def short_run():
        c13_log_prob.calls = 0
        run_nuts(c13_log_prob, z13, 1, 2, n_warmup=2, max_depth=4)
        last["calls"] = c13_log_prob.calls

    work, wall = profiled(short_run, pad=0)
    busy13 = sum(us for _, us in work) / 1e6 / wall
    # a batched leapfrog evaluates every chain's gradient in one call
    leap_launches = len(work) / last["calls"]
    c13 = {"seconds": s13, "leapfrogs": leapfrogs, "grad_evals_per_s": leapfrogs / s13,
           "batched_leapfrogs": batched, "batched_per_s": batched / s13,
           "divergences": int(res["divergences"].sum()), "min_ess": float(np.min(ess13)),
           "max_rhat": float(np.max(rhat13)), "launches_per_leapfrog": leap_launches,
           "launches_per_gradient": grad_launches,
           "busy_share": busy13, "mean_tree_depth": float(res["tree_depth"].float().mean()),
           "step_size": res["step_size"].tolist()}
    print(f"phase 33 config 13 (4 chains, depth 6, {C13_STEPS} + {C13_WARMUP} warmup, f32): "
          f"{leapfrogs / s13:.1f} grad-evals/s ({leapfrogs} leapfrogs of the chains in {batched} "
          f"batched calls, {s13:.2f} s), "
          f"divergences {c13['divergences']}, min ESS {c13['min_ess']:.1f}, max R-hat "
          f"{c13['max_rhat']:.3f}, {leap_launches:.0f} device launches a batched leapfrog "
          f"({grad_launches} of them the gradient), busy "
          f"{busy13:.1%} (with the one-thread G2, an earlier H100 run: 253.6 grad-evals/s, "
          f"25.6% busy)  ({card})")
    return c13, nuts_run


def kalman_slice(dev, card, cuda):
    """Phases 31-33: K1 against its plain version, config 7's solver points,
    config 13 and the NUTS and solver paths of the modelers. Prints the
    ``{"kalman": ...}`` line and returns K1's JSON record."""
    import torch

    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch import data as pdata
    from periodicity_tpu_torch.gp import (BrownianGP, QuasiPeriodicGP, log_likelihood,
                                          log_likelihood_blocked, log_likelihood_chunked,
                                          log_likelihood_pscan, run_nuts)
    from periodicity_tpu_torch.models.gp import mcmc, pscan
    from periodicity_tpu_torch.models.gp.nuts import _value_and_grad
    from periodicity_tpu_torch.models.gp.terms import BrownianTerm
    from periodicity_tpu_torch.ops import celerite as C
    from periodicity_tpu_torch.ops import kalman as K
    from periodicity_tpu_torch.utils.dtypes import full_float32

    clock_hz = sm_clock_hz()
    start = time.perf_counter()
    out = {"card": card, "sm_clock_max_mhz": clock_hz / 1e6}
    rec = {"name": "kalman_blocked", "route": "cuda",
           "source": "periodicity_tpu_torch/csrc/kalman.cuh",
           "replaces": "periodicity_tpu/models/gp/pscan.py:333", "held": "bit-equal",
           "max_abs_err": 0.0}

    def held(args, nb, carry, got, label):
        """K1's result ``got`` bit-equal to the plain version's on the CPU
        copies of its operands."""
        want = K.kalman_blocked_plain(*(x.cpu() for x in args), nb,
                                      None if carry is None else tuple(c.cpu() for c in carry))
        torch.cuda.synchronize()
        for name, a, w in zip(("mu", "s", "A", "b", "C", "eta", "J"),
                              (got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
            check(bit_equal(a, w), f"K1 vs plain, {name} not bit-equal ({label})")

    def both(args, nb, carry, label):
        got = K.kalman_blocked(*(x.to(dev) for x in args), nb,
                               None if carry is None else tuple(c.to(dev) for c in carry))
        held(args, nb, carry, got, label)

    # phase 31: K1 against its plain version, bit for bit, at R = 1..8, 12, 16 in
    # both dtypes, from the identity and from an incoming carry, at block
    # counts that divide N and that do not (and more blocks than samples)
    rng = np.random.default_rng(31)
    cases = 0
    # past R = 8 the widths of phase 38's terms, R = 12 and 16 (the card
    # tests hold every width), and draws of 257 samples at most: the plain
    # version takes seconds a call there
    for r in [r for r in K1_SLOTS if r <= 8 or r in (12, 16)]:
        for dtype in (torch.float64, torch.float32):
            for b, n, nb in ((3, 1001 if r <= 8 else 257, 7), (2, 64, 8), (1, 5, 16)):
                coeffs, dt, A, Q, H, diag, y = k1_draw(rng, r, b, n, dtype)
                args = [x.contiguous() for x in (A, Q, H, diag, y)]
                both(args, nb, None, f"R = {r}, {dtype}, B={b}, N={n}, {nb} blocks")
                # the same stretch continuing a series: the carry of a first
                # stretch, no stationary prior at step 0
                _, _, carry = K.kalman_blocked_plain(*args, 3)
                Ac = pscan._ssm_from_dt(coeffs, dt)[0]
                Qc = pscan._noise(Ac, pscan._ssm_from_dt(coeffs, dt)[1])
                both([x.contiguous() for x in (Ac, Qc, H, diag, y)], nb, carry,
                     f"R = {r}, {dtype}, B={b}, N={n}, {nb} blocks, with a carry")
                cases += 2
    print(f"phase 31 K1 bit-equal to plain in {cases} cases: R = 1..8, 12, 16, f32 and f64, "
          f"B = 1..3, N = 5, 64, 1001 (257 past R = 8) over 7, 8 and 16 blocks, from the "
          f"identity and from a carry")

    # K1 bit-equal to plain at the main path's own shapes, on the operands
    # that the solvers hand it: config 7's chunked point at N = 1e6 in f32
    # and f64 (one row; the first chunk, 65536 samples over 512 blocks; the
    # second, from the carry the first hands on; the last, 16960 samples),
    # and the modelers' blocked and chunked solvers on SpottedStar (f64;
    # BrownianTerm live, R = 4, under nll, and masked, R = 6, where u needs
    # a gradient, as in minimize and nuts: 2148 samples over 64 blocks;
    # chunks of 2048 and, from its carry, 100 samples over 512 blocks)
    calls = []

    def recorded(*args, **kw):
        got = K.kalman_blocked(*args, **kw)
        calls.append((args, got))
        return got

    ts, ys, dys = pdata.SpottedStar()
    t7, y7 = c7_series(np.random.default_rng(0), C7_CHUNKED_N)
    term = BrownianTerm(0.01, 20.0, 10.0, 0.3)
    main_shapes = []
    pscan.kalman_blocked = recorded
    try:
        for dtype in (torch.float32, torch.float64):
            tt, yy = cuda(t7).to(dtype), cuda(y7).to(dtype)
            calls.clear()
            log_likelihood_chunked(term, tt, torch.full_like(tt, 0.01), yy, chunk=C7_CHUNK,
                                   inner_blocks=C7_INNER)
            check(len(calls) == 16, f"config 7's chunked point makes 16 K1 calls: {len(calls)}")
            for i in (0, 1, len(calls) - 1):
                (A, Q, H, d, yb, nb, carry), got = calls[i]
                check((i == 0) == (carry is None), f"chunk {i} takes the carry of the one before")
                label = f"config 7 chunk {i}, {dtype}, N={A.shape[1]}, {nb} blocks"
                held((A, Q, H, d, yb), nb, carry, got, label)
                main_shapes.append(label)
        for solver in ("blocked", "chunked"):
            m = BrownianGP(TSeries(cuda(ts), cuda(ys)), err=cuda(dys), solver=solver)
            calls.clear()
            m.nll(np.full(6, 50.0))
            m._nll_u(torch.full((6,), 50.0, dtype=m.dtype, device=dev, requires_grad=True))
            check(len(calls) == (2 if solver == "blocked" else 4),
                  f"BrownianGP(SpottedStar, solver={solver!r}) K1 calls: {len(calls)}")
            for i, ((A, Q, H, d, yb, nb, carry), got) in enumerate(calls):
                label = (f"BrownianGP(SpottedStar, solver={solver!r}) call {i}, {A.dtype}, "
                         f"R={A.shape[-1]}, N={A.shape[1]}, {nb} blocks"
                         + (", from a carry" if carry is not None else ""))
                held((A, Q, H, d, yb), nb, carry, got, label)
                main_shapes.append(label)
    finally:
        pscan.kalman_blocked = K.kalman_blocked
    calls.clear()
    out["k1_main_path_shapes_bit_equal"] = main_shapes
    print("phase 31 K1 bit-equal to plain at the main path's shapes: " + "; ".join(main_shapes))

    # times at config 7's blocked shapes and at its chunked shape: events,
    # the profiler's device time by stage, the plain version's wall time,
    # the bound; at N = 1e4 one dense cholesky_ex + solve_triangular of the
    # same K
    def k1_timed(pre, A, Q, H, d, yb, nb, carry, label):
        """K1 at one call's operands: bit-equal to plain, its events, its
        device time by stage (elements, prefixes, the scan's levels, stitch
        and innovations), the plain version's wall time and the bound: a
        chain of L + ceil(log2(m + 1)) + 1 compositions, or the bytes."""
        n, r = A.shape[1], A.shape[-1]
        fn = lambda: K.kalman_blocked(A, Q, H, d, yb, nb, carry)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = K.kalman_blocked_plain(A, Q, H, d, yb, nb, carry)
        torch.cuda.synchronize()
        rec[f"{pre}plain_ms"] = (time.perf_counter() - t0) * 1e3
        for name, a, w in zip(("mu", "s", "A", "b", "C", "eta", "J"),
                              (got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
            check(bit_equal(a, w), f"K1 vs plain at {label}: {name} not bit-equal")
        rec[f"{pre}ms"] = event_ms(fn, 10)
        work, _ = profiled(fn, reps=3)
        geo = K.kernel_geometry(A.shape[0], n, r, nb, carry is not None, A.dtype)
        stages = {}
        for name, us in work:
            if "kalman" in name:
                stage = name.split("kalman_")[1].split("_kernel")[0]
                stages[stage] = stages.get(stage, 0.0) + us / 3 / 1e3
        launches = 3 + geo["tree_launches"]
        check(sorted(stages) == ["element", "innovation", "prefix", "tree"] and sum(
            1 for w_ in work if "kalman" in w_[0]) == 3 * launches,
            f"K1's four stages in {launches} launches a call: {work}")
        rec[f"{pre}device_ms"] = sum(stages.values())
        rec[f"{pre}stage_device_ms"] = stages
        length, m = geo["length"], geo["blocks"]
        rec[f"{pre}bound_ms"], rec[f"{pre}bound_by"] = chain_bound(
            A.element_size() * n * (2 * r * r + 4),
            (length + K.tree_levels(m + 1) + 1) * k1_chain_ops(r), str(A.dtype)[6:], clock_hz)
        rec[f"{pre}n_blocks"] = nb
        rec[f"{pre}launches_a_call"] = launches
        print(f"phase 31 K1 at {label}: events {rec[pre + 'ms']:.4f} ms, device "
              f"{rec[pre + 'device_ms']:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
              + f"), plain {rec[pre + 'plain_ms']:.1f} ms, bound {rec[pre + 'bound_ms']:.4f} ms "
              f"{rec[pre + 'bound_by']}  ({card})")
        return got

    rng7 = np.random.default_rng(0)
    for n in C7_SOLVER_NS:
        pre = f"N{n}_"
        t7, y7 = c7_series(rng7, n)
        tt, yy = cuda(t7), cuda(y7)
        diag = torch.full_like(tt, 0.01)
        nb = c7_blocks(n)
        with full_float32():
            coeffs, tc, dd, yc, batch = pscan._prepared(term, tt, diag, yy)
            dtc = torch.cat([tc.new_zeros(1), torch.diff(tc)])
            A, Q, H, d, yb = pscan._k1_inputs(coeffs, dtc, dd, yc, batch, True)
        r = H.shape[0]
        check(r == 4, f"config 7's live BrownianTerm has R = 4, got {r}")
        got = k1_timed(pre, A, Q, H, d, yb, nb, None,
                       f"config 7 N={n} (1 row, R=4, {nb} blocks, f32)")
        if n == C7_SOLVER_NS[0]:
            with full_float32():
                Kd = term.get_value(tt[:, None] - tt[None, :]) + torch.diag(diag)

                def lib(Kd=Kd, yy=yy):
                    L, info = torch.linalg.cholesky_ex(Kd)
                    return L, info, torch.linalg.solve_triangular(L, yy[:, None], upper=False)

                L, info, z = lib()
                ll_lib = -0.5 * (float(z.square().sum()) + 2 * float(torch.log(
                    torch.diagonal(L)).sum()) + n * math.log(2 * math.pi))
                ll_k1 = float(pscan._innovation_sum(yb, got[0], got[1])[0])
                rec[f"{pre}library_ms"] = event_ms(lib, 3)
                rec[f"{pre}library_info"] = int(info)
                rec[f"{pre}library_vs_kernel_rel"] = abs(ll_lib - ll_k1) / abs(ll_k1)
            del Kd, L, z
            print(f"phase 31 K1 at config 7 N={n}: dense cholesky_ex + solve_triangular "
                  f"{rec[pre + 'library_ms']:.3f} ms (ll rel "
                  f"{rec[pre + 'library_vs_kernel_rel']:.1e})  ({card})")
        else:
            rec[f"{pre}library_ms"] = None
            rec[f"{pre}library_note"] = "none (dense K does not fit: 40 GB in f32)"
    # config 7's chunked shape: the second chunk of the N = 1e6 series
    # (65536 samples over 512 blocks, L = 128) from the first chunk's carry
    t7, y7 = c7_series(np.random.default_rng(0), 2 * C7_CHUNK)
    tt, yy = cuda(t7), cuda(y7)
    with full_float32():
        coeffs, tc, dd, yc, batch = pscan._prepared(term, tt, torch.full_like(tt, 0.01), yy)
        dtc = torch.cat([tc.new_zeros(1), torch.diff(tc)])
        A, Q, H, d, yb = pscan._k1_inputs(coeffs, dtc[:C7_CHUNK], dd[..., :C7_CHUNK],
                                          yc[..., :C7_CHUNK], batch, True)
        _, _, carry = K.kalman_blocked(A, Q, H, d, yb, C7_INNER)
        A, Q, H, d, yb = pscan._k1_inputs(coeffs, dtc[C7_CHUNK:], dd[..., C7_CHUNK:],
                                          yc[..., C7_CHUNK:], batch, False)
    k1_timed("chunk_", A, Q, H, d, yb, C7_INNER, carry,
             f"config 7's chunk (1 row, R=4, N={C7_CHUNK}, {C7_INNER} blocks, from a carry, "
             "f32)")
    del A, Q, d, yb, carry
    # its yardstick: one dense cholesky_ex + solve_triangular of the chunk's
    # own K (65536 samples, 17 GB in f32; not conditioned on the carry),
    # built a band of rows at a time
    torch.cuda.empty_cache()
    with torch.no_grad(), full_float32():
        tc_, yc_ = tt[C7_CHUNK:], yy[C7_CHUNK:]
        Kd = torch.empty((C7_CHUNK, C7_CHUNK), dtype=tc_.dtype, device=dev)
        for i0 in range(0, C7_CHUNK, 4096):
            Kd[i0:i0 + 4096] = term.get_value(tc_[i0:i0 + 4096, None] - tc_[None, :])
        Kd.diagonal().add_(0.01)

        def chunk_lib():
            L, info = torch.linalg.cholesky_ex(Kd)
            return info, torch.linalg.solve_triangular(L, yc_[:, None], upper=False)

        info, _ = chunk_lib()
        torch.cuda.synchronize()
        rec["chunk_library_ms"] = event_ms(chunk_lib, 1)
        rec["chunk_library_info"] = int(info)
    del Kd
    torch.cuda.empty_cache()
    print(f"phase 31 K1 chunk yardstick: dense cholesky_ex + solve_triangular of the chunk's "
          f"own K ({C7_CHUNK} samples, f32) {rec['chunk_library_ms']:.1f} ms (info "
          f"{rec['chunk_library_info']})  ({card})")
    for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        rec[key] = rec[f"N{C7_SOLVER_NS[0]}_{key}"]
    rec["shape"] = ("config 7's blocked points, one row, live BrownianTerm (R = 4), f32: "
                    "unprefixed N = 1e4 (39 blocks), also under N10000_; N100000_ N = 1e5 "
                    "(390 blocks); chunk_ its chunked shape (65536 samples over 512 blocks, "
                    "from a carry)")
    t31 = time.perf_counter()

    solvers = {
        "scan": log_likelihood, "pscan": log_likelihood_pscan,
        "blocked": lambda term, t, d, y: log_likelihood_blocked(term, t, d, y,
                                                                n_blocks=c7_blocks(t.shape[0])),
        "chunked": lambda term, t, d, y: log_likelihood_chunked(term, t, d, y, chunk=C7_CHUNK,
                                                                inner_blocks=C7_INNER),
    }
    # phase 32 begins, before the main path's counts start, with config 7's
    # float32 accuracy over C7_F32_SEEDS: each solver of a fresh draw of
    # N = 1e5 and 1e6 samples against the float64 scan of the same draw,
    # and the control, one lost carry (at the middle of 1e5, at the first
    # chunk's end of 1e6), against the same scan
    f32_long = {C7_SOLVER_NS[1]: ("scan", "pscan", "blocked"), C7_CHUNKED_N: ("scan", "chunked")}
    readings, controls = {}, {}
    with torch.no_grad():
        for seed in C7_F32_SEEDS:
            for n, names in f32_long.items():
                t7, y7 = c7_series(np.random.default_rng(seed), n)
                tt, yy = cuda(t7), cuda(y7)
                diag = torch.full_like(tt, 0.01)
                ref = float(log_likelihood(term, tt.double(), diag.double(), yy.double()))
                for name in names:
                    ll = float(solvers[name](term, tt, diag, yy))
                    readings.setdefault(f"{name}_N{n}", []).append(abs(ll - ref) / abs(ref))
                bound, nb = (n // 2, c7_blocks(n)) if n != C7_CHUNKED_N else (C7_CHUNK, C7_INNER)
                ll = float(c7_lost_carry(term, tt, diag, yy, bound, nb))
                controls.setdefault(f"N{n}", []).append(abs(ll - ref) / abs(ref))
    out["config7_f32_seeds"] = {"seeds": list(C7_F32_SEEDS), "rel_vs_f64_scan": readings,
                                "lost_carry_rel": controls}
    for n in f32_long:
        worst = max(max(v) for k, v in readings.items() if k.endswith(f"_N{n}"))
        limit = F32_LL_REL_LONG[n]
        check(worst <= limit < min(controls[f"N{n}"]),
              f"config 7 f32 N={n} over seeds {C7_F32_SEEDS}: the limit {limit} lies above every "
              f"sound reading (largest {worst:.3e}) and below every lost carry "
              f"({min(controls[f'N{n}']):.3e})")
        print(f"phase 32 config 7 f32 N={n} over seeds {list(C7_F32_SEEDS)}, rel to the f64 scan: "
              + "; ".join(f"{k.split('_N')[0]} " + ", ".join(f"{x:.3e}" for x in v)
                          for k, v in readings.items() if k.endswith(f"_N{n}"))
              + "; one lost carry " + ", ".join(f"{x:.3e}" for x in controls[f"N{n}"])
              + f"; the limit {limit}  ({card})")

    # the slice's main path (K1, G1 and G2 counted from zero to the end of
    # phase 33): config 7's solver points in f32, k = 3 chained
    # evaluations, against the f64 scan on the card; f64 at N = 1e4 for
    # every solver; the gradient of blocked and chunked
    K.kalman_blocked.launches = 0
    C.celerite_forward.launches = 0
    C.celerite_adjoint.launches = 0
    c7 = {}
    rng7 = np.random.default_rng(0)
    points = [(n, name) for n in C7_SOLVER_NS for name in ("scan", "pscan", "blocked")]
    points += [(C7_CHUNKED_N, "scan"), (C7_CHUNKED_N, "chunked")]
    series = {}
    with torch.no_grad():
        for n, name in points:
            if n not in series:
                series[n] = c7_series(rng7 if n != C7_CHUNKED_N else np.random.default_rng(0), n)
            t7, y7 = series[n]
            tt, yy = cuda(t7), cuda(y7)
            diag = torch.full_like(tt, 0.01)
            fn = solvers[name]
            ref = float(log_likelihood(term, tt.double(), diag.double(), yy.double()))
            ll64 = float(fn(term, tt.double(), diag.double(), yy.double()))

            def chained(fn=fn, tt=tt, yy=yy, diag=diag):
                y0, acc = yy, torch.zeros((), dtype=torch.float32, device=dev)
                for _ in range(C7_K):
                    ll = fn(term, tt, diag, y0)
                    y0 = y0 + ll * 1e-12
                    acc = acc + ll
                return acc

            ll = float(fn(term, tt, diag, yy))
            rel = abs(ll - ref) / abs(ref)
            chained()
            ms = statistics.median(event_ms(chained, 1) for _ in range(2)) / C7_K
            work, wall = profiled(lambda fn=fn, tt=tt, diag=diag, yy=yy: fn(term, tt, diag, yy),
                                  pad=1)
            busy = sum(us for _, us in work) / 1e6 / wall
            mem = peak_bytes(lambda fn=fn, tt=tt, diag=diag, yy=yy: fn(term, tt, diag, yy))
            c7[f"{name}_N{n}"] = {"ms": ms, "evals_per_s": 1e3 / ms, "launches_per_eval": len(work),
                                  "busy_share": busy, "peak_mib": mem / 2**20, "ll": ll,
                                  "ll_f64_scan": ref, "rel_vs_f64_scan": rel, "ll_f64": ll64,
                                  "f64_rel_vs_f64_scan": abs(ll64 - ref) / abs(ref)}
            print(f"phase 32 config 7 {name} N={n} (f32): {ms:.3f} ms an evaluation, "
                  f"{len(work)} device launches, busy {busy:.1%}, peak {mem / 2**20:.1f} MiB; "
                  f"ll {ll:.2f} vs f64 scan {ref:.2f} (rel {rel:.2e}; the solver in f64 "
                  f"{c7[f'{name}_N{n}']['f64_rel_vs_f64_scan']:.1e})  ({card})")
    out["config7"] = c7
    # every solver in f64 within 1e-10 of the f64 scan at every N; in f32
    # within JAX's characterization at N = 1e4, within the fixed limits
    # beyond
    for key, v in c7.items():
        check(v["f64_rel_vs_f64_scan"] <= F64_LL_REL,
              f"config 7 {key} in f64: rel {v['f64_rel_vs_f64_scan']:.2e} to the f64 scan > "
              f"{F64_LL_REL}")
        n = int(key.split("_N")[1])
        limit = F32_LL_REL if n == C7_SOLVER_NS[0] else F32_LL_REL_LONG[n]
        check(v["rel_vs_f64_scan"] <= limit,
              f"config 7 {key}: f32 ll rel {v['rel_vs_f64_scan']:.2e} to the f64 scan > {limit}")
    # float64 at N = 1e4: every solver within 1e-10 of the scan; the
    # gradient of blocked and chunked is the scan's
    t7, y7 = series[C7_SOLVER_NS[0]]
    tt, yy = cuda(t7).double(), cuda(y7).double()
    diag = torch.full_like(tt, 0.01)
    p = torch.tensor([0.01, 20.0, 10.0, 0.3], dtype=torch.float64, device=dev)
    f64 = {}
    grads = {}
    for name, fn in solvers.items():
        pg = p.clone().requires_grad_(True)
        ll = fn(BrownianTerm(pg[0], pg[1], pg[2], pg[3]), tt, diag, yy)
        (grads[name],) = torch.autograd.grad(ll, pg)
        f64[name] = float(ll.detach())
    for name in solvers:
        rel = abs(f64[name] - f64["scan"]) / abs(f64["scan"])
        check(rel <= F64_LL_REL, f"config 7 f64 N=1e4: {name} {f64[name]} vs scan {f64['scan']}")
    g_rel = {name: float(((grads[name] - grads["scan"]).abs() / grads["scan"].abs()).max())
             for name in ("pscan", "blocked", "chunked")}
    for name in ("blocked", "chunked"):
        check(g_rel[name] <= 1e-6, f"the gradient of {name} (K2) within JAX's 1e-6 of the "
              f"scan's: {grads[name]} vs {grads['scan']}")
    out["config7_f64_N10000"] = {"ll": f64, "grad_rel_vs_scan": g_rel}
    print(f"phase 32 f64 N=1e4: pscan, blocked, chunked within "
          f"{max(abs(v - f64['scan']) / abs(f64['scan']) for v in f64.values()):.1e} of the scan; "
          f"gradients of blocked {g_rel['blocked']:.1e} and chunked {g_rel['chunked']:.1e} "
          f"(K2), pscan {g_rel['pscan']:.1e} (autograd) from the scan's")
    t32 = time.perf_counter()

    # phase 33: config 13, run_nuts on SpottedStar's BrownianTerm posterior
    # (f32, 4 chains, depth 6, 40 + 60 warmup), the chain-scaling block;
    # BrownianGP.nuts on JAX's synthetic rotator (tests/test_nuts.py:76-105)
    # with its assertions; the modelers' pscan, blocked and chunked solvers
    # against the scan on SpottedStar (f64); QuasiPeriodicGP.nuts
    # (tests/test_nuts.py:109-129)
    c13, nuts_run = config13(dev, card)
    scaling = {}
    for c in C13_SCALING:
        res_c, s_c = nuts_run(c, 10, 20, 4)
        n_c = int(res_c["n_leapfrog"].sum() + res_c["n_leapfrog_warmup"].sum())
        scaling[f"chains_{c}"] = {"leapfrogs": n_c, "seconds": s_c, "grad_evals_per_s": n_c / s_c}
    c13["chains_scaling"] = scaling
    print("phase 33 config 13 chain scaling (depth 4, 10 + 20 warmup): "
          + ", ".join(f"{k} {v['grad_evals_per_s']:.1f} grad-evals/s" for k, v in scaling.items())
          + f"  ({card})")
    out["config13"] = c13

    rngr = np.random.default_rng(7)
    tr = np.sort(rngr.uniform(0, 60, 300))
    yr = (np.sin(2 * np.pi * tr / 9.0) + 0.3 * np.sin(4 * np.pi * tr / 9.0 + 0.5)
          + 0.1 * rngr.standard_normal(tr.size))
    dyr = np.full_like(tr, 0.1)
    m = BrownianGP(TSeries(cuda(tr), cuda(yr)), err=cuda(dyr), init_period=8.0)
    t0 = time.perf_counter()
    trace, tau = m.nuts(**ROTATOR_NUTS)
    s_nuts = time.perf_counter() - t0
    med = float(np.median(trace["period"]))
    kept = ROTATOR_NUTS["n_chains"] * (ROTATOR_NUTS["n_steps"] - ROTATOR_NUTS["burn"])
    check(trace["period"].shape == (kept,) and abs(med - 9.0) / 9.0 < 0.15
          and 0.5 < m.acceptance <= 1.0 and np.all(np.isfinite(tau))
          and set(m.nuts_diagnostics) >= {"divergences", "step_size", "inv_mass", "tree_depth"},
          f"BrownianGP.nuts: median period {med}, acceptance {m.acceptance}, tau {tau}")
    out["browniangp_nuts"] = {"seconds": s_nuts, "median_period": med,
                              "acceptance": m.acceptance,
                              "min_ess": float(np.min(m.nuts_diagnostics["ess"])),
                              "max_rhat": float(np.nanmax(m.nuts_diagnostics["rhat"])),
                              "divergences": int(m.nuts_diagnostics["divergences"].sum())}
    print(f"phase 33 BrownianGP.nuts (2 chains, {ROTATOR_NUTS['n_steps']} + "
          f"{ROTATOR_NUTS['n_warmup']}, depth 6, synthetic rotator): median "
          f"period {med:.3f} ({s_nuts:.1f} s), acceptance {m.acceptance:.3f}, min ESS "
          f"{out['browniangp_nuts']['min_ess']:.1f}, max R-hat "
          f"{out['browniangp_nuts']['max_rhat']:.3f}  ({card})")

    u = np.full(6, 50.0)
    nll = {}
    for solver in ("scan", "pscan", "blocked", "chunked"):
        ms_ = BrownianGP(TSeries(cuda(ts), cuda(ys)), err=cuda(dys), solver=solver)
        nll[solver] = ms_.nll(u)
    for solver, v in nll.items():
        check(abs(v - nll["scan"]) <= 1e-8 * abs(nll["scan"]),
              f"BrownianGP(solver={solver!r}).nll {v} vs scan {nll['scan']}")
    out["modeler_solvers_nll"] = nll
    print(f"phase 33 BrownianGP(SpottedStar) nll(u=50) by solver (f64): "
          + ", ".join(f"{k} {v:.9f}" for k, v in nll.items()))

    sub_t, sub_y, sub_e = tr[::3], yr[::3], dyr[::3]
    q = QuasiPeriodicGP(TSeries(cuda(sub_t), cuda(sub_y)), err=cuda(sub_e), init_period=4.0)
    t0 = time.perf_counter()
    samples, _ = q.nuts(**QP_NUTS)
    s_q = time.perf_counter() - t0
    ratio = np.exp(samples[3] / 2) / np.exp(samples[5])
    kept = QP_NUTS["n_chains"] * (QP_NUTS["n_steps"] - QP_NUTS["burn"])
    check(samples.shape == (q.ndim, kept) and np.all(np.isfinite(samples))
          and 0.3 < q.acceptance <= 1.0 and np.all((ratio > 1.0) & (ratio < 10.0)),
          f"QuasiPeriodicGP.nuts: shape {samples.shape}, acceptance {q.acceptance}")
    out["qpgp_nuts"] = {"seconds": s_q, "acceptance": q.acceptance}
    print(f"phase 33 QuasiPeriodicGP.nuts (2 chains, {QP_NUTS['n_steps']} + "
          f"{QP_NUTS['n_warmup']}, depth 5): acceptance "
          f"{q.acceptance:.3f}, tau/period in (1, 10) ({s_q:.1f} s)  ({card})")
    t33 = time.perf_counter()
    launches = {"kalman_blocked": K.kalman_blocked.launches,
                "celerite_forward": C.celerite_forward.launches,
                "celerite_adjoint": C.celerite_adjoint.launches}
    check(all(v > 0 for v in launches.values()), f"K1, G1 and G2 launched on the main path: "
          f"{launches}")
    rec["launches"] = launches["kalman_blocked"]
    out["main_path_launches"] = launches
    out["wall_s"] = {"31": t31 - start, "32": t32 - t31, "33": t33 - t32}
    print(f"phase 33 main path (phases 32-33): {launches['kalman_blocked']} K1, "
          f"{launches['celerite_forward']} G1 and {launches['celerite_adjoint']} G2 launches")
    print(json_line({"kalman": out}))
    return [rec]


# the parallel slice (phases 34-37): the sharded scans at world size 1
# through NCCL against their unsharded calls at the GLS bench shape, config
# 11 (BLS) and config 4 (AoV, PDM); the distributed FFT and ACF of one
# series of 2^24 (f32) and 2^22 (f64) samples; config 7's likelihood points
# through log_likelihood_sharded; config 8's size through
# run_ensemble_sharded; the sharded modeler on SpottedStar; and D = 4 ranks'
# stages in turn on the card against the same stages on the CPU
PAR_D = 4
C4_N, C4_P = 2000, 100_000  # config 4 (benchmarks/run_benchmarks.py:203-257)
PAR_FFT_N = {"float32": 1 << 24, "float64": 1 << 22}
# f64: the JAX package's bounds (tests/test_parallel.py:160-193). f32: the
# FFT within PAR_F32_FFT_X times cuFFT's own f32 error against f64 on the
# same input (the radix-D split adds one unit-modulus twiddle product and
# a D-term sum an output to an L-point FFT, each a few f32 roundings, so
# its error stays of the order of the library's); the ACF within
# PAR_F32_FFT_X times the container's own f32 ACF error against f64
PAR_F64_FFT, PAR_F64_ACF = 1e-9, 1e-10
PAR_F32_FFT_X = 4.0
# card against the CPU: f64 1e-12 (of max|X|, of |ll|); f32 the port's
# card-vs-CPU bound of config 2's ACF (1e-5 of the largest value), and
# phase 5's f32 GLS bounds (1e-4 of the peak below pseudo-Nyquist, 5e-4 on
# the whole grid); BLS power within 1e-4 of the peak with the same best
# period (phase 8)
PAR_F64_CPU, PAR_F32_CPU = 1e-12, 1e-5
PAR_ONE_RANK = 1e-10


def in_turn_gls(t, y, err, df, fmin, nf, d, gridder):
    """sharded_gls's stage for ranks 0..d-1 in turn, joined: power [nf]."""
    import torch

    from periodicity_tpu_torch.parallel.sharded import _gls_stage

    return torch.cat([_gls_stage(t, y, err, df, fmin, nf // d, idx, True, False, gridder)
                      for idx in range(d)])


def in_turn_bls(t, y, w, periods, d, **kw):
    """sharded_bls's stage for ranks 0..d-1 in turn, joined: (power,
    depth, width_idx, bin_start)."""
    import torch

    from periodicity_tpu_torch.models.phase import bls_scan
    from periodicity_tpu_torch.parallel.sharded import _period_stage

    outs = [_period_stage(bls_scan, (t, y, w), periods, d, idx, **kw) for idx in range(d)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def in_turn_fft(x, d):
    """distributed_fft's stages for ranks 0..d-1 in turn, the all_to_all
    done by the join (rank r receives copy r of every rank): the cyclic
    spectrum [N], ordered [r, m] -> X[D m + r]."""
    import torch

    from periodicity_tpu_torch.parallel import dfft

    n = x.shape[-1]
    el = n // d
    cd = dfft._cdtype(x)
    copies = [dfft._fwd_copies(x[j * el:(j + 1) * el], j, d, cd) for j in range(d)]
    return torch.cat([dfft._fwd_finish(torch.stack([c[r] for c in copies]), r, n)
                      for r in range(d)])


def in_turn_ifft(X, d):
    """distributed_ifft's stages for ranks 0..d-1 in turn: the series [N]."""
    import torch

    from periodicity_tpu_torch.parallel import dfft

    n = X.shape[-1]
    el = n // d
    cd = dfft._cdtype(X)
    parts = [dfft._inv_copies(X[r * el:(r + 1) * el], r, d, n, cd) for r in range(d)]
    return torch.cat([dfft._inv_finish(torch.stack([p[j] for p in parts]), d)
                      for j in range(d)])


def in_turn_ll(term, t, diag, y, d):
    """log_likelihood_sharded's stages for ranks 0..d-1 in turn: each
    rank's first K1 pass, the all_gather of their summaries done by the
    join, each rank's exclusive carry and second pass, and the all_reduce
    as a sum in rank order. Returns (the total, each rank's share). Where
    the term's parameters need a gradient, autograd reverses the same
    stages: each pass through K2, the summaries' cotangents summed where
    the join stacked them."""
    import torch

    from periodicity_tpu_torch.models.gp import pscan
    from periodicity_tpu_torch.utils.dtypes import full_float32

    coeffs, tt, dd, yy, batch = pscan._prepared(term, t, diag, y)
    with full_float32():
        dt = torch.cat([tt.new_zeros(1), torch.diff(tt)])
        firsts = [pscan._shard_pass(coeffs, dt, dd, yy, batch, d, i, None) for i in range(d)]
        summaries = torch.stack([f[1] for f in firsts])
        shares = [firsts[0][0]] + [
            pscan._shard_pass(coeffs, dt, dd, yy, batch, d, i,
                              pscan._shard_carry(summaries, i, pscan._states(coeffs)))[0]
            for i in range(1, d)]
    total = shares[0]
    for s in shares[1:]:
        total = total + s
    return total, shares


def counted(tally, kernel, want, fn, label):
    """One call of the slice's main path: ``fn()``'s launches of ``kernel``
    (a wrapper with a ``launches`` count), held equal to ``want`` and added
    to ``tally`` under the kernel's name. Returns ``fn()``."""
    before = kernel.launches
    got = fn()
    n = kernel.launches - before
    check(n == want, f"{label}: {want} {kernel.__name__} launches, got {n}")
    tally[kernel.__name__] = tally.get(kernel.__name__, 0) + n
    return got


def turns_ms(sharded, unsharded, reps=3, before=None):
    """Event times (ms) of a sharded call and the unsharded call it stands
    beside: one warm-up each, then in turns unsharded, sharded, sharded,
    unsharded; ``before`` runs ahead of every turn (a barrier over ranks)."""
    sharded(), unsharded()
    runs = {"sharded": [], "unsharded": []}
    for which in ("unsharded", "sharded", "sharded", "unsharded"):
        if before is not None:
            before()
        runs[which].append(event_ms(sharded if which == "sharded" else unsharded, reps))
    return {k: statistics.mean(v) for k, v in runs.items()}


def sharded_ll_points(smesh, cuda, tally, timed):
    """Config 7's points (N = 1e4, 1e5, 1e6, live BrownianTerm) through
    ``log_likelihood_sharded`` over ``smesh``'s ranks, f32 and f64, against
    the f64 scan within phase 32's limits; over more than one rank also
    against the ranks' stages in turn on this card (``in_turn_ll``; f64
    1e-12, f32 1e-6: a sum of the ranks' shares in another order). Each
    call launches K1 once on rank 0 and twice elsewhere (held, added to
    ``tally``). ``timed(name, sharded, unsharded)`` times the f32 call
    beside ``log_likelihood_blocked`` at the same blocks. Returns the
    records by point."""
    import torch

    from periodicity_tpu_torch.gp import log_likelihood, log_likelihood_blocked
    from periodicity_tpu_torch.models.gp import pscan
    from periodicity_tpu_torch.models.gp.terms import BrownianTerm
    from periodicity_tpu_torch.ops import kalman as K

    term = BrownianTerm(0.01, 20.0, 10.0, 0.3)
    d, k1 = smesh.size(), 1 if smesh.get_local_rank() == 0 else 2
    recs = {}
    for n in C7_SOLVER_NS + (C7_CHUNKED_N,):
        t7, y7 = c7_series(np.random.default_rng(0), n)
        tt, yy = cuda(t7), cuda(y7)
        diag = torch.full_like(tt, 0.01)
        rec = {}
        with torch.no_grad():
            ref = float(log_likelihood(term, tt.double(), diag.double(), yy.double()))
            for dname, args in (("f32", (tt, diag, yy)),
                                ("f64", (tt.double(), diag.double(), yy.double()))):
                label = f"log_likelihood_sharded N={n} {dname}"
                ll = float(counted(tally, K.kalman_blocked, k1,
                                   lambda: pscan.log_likelihood_sharded(term, *args, smesh),
                                   label))
                rel = abs(ll - ref) / abs(ref)
                limit = (F64_LL_REL if dname == "f64" else F32_LL_REL if n == C7_SOLVER_NS[0]
                         else F32_LL_REL_LONG[n])
                check(rel <= limit, f"{label}: {rel:.2e} from the f64 scan (limit {limit})")
                rec[f"{dname}_rel"] = rel
                if d > 1:
                    stages = float(in_turn_ll(term, *args, d)[0])
                    rs = abs(ll - stages) / abs(stages)
                    check(rs <= (PAR_F64_CPU if dname == "f64" else 1e-6),
                          f"{label}: {rs:.2e} from the ranks' stages in turn")
                    rec[f"{dname}_rel_vs_stages"] = rs
            timed(f"log_likelihood_sharded_N{n}",
                  lambda: pscan.log_likelihood_sharded(term, tt, diag, yy, smesh),
                  lambda: log_likelihood_blocked(term, tt, diag, yy,
                                                 n_blocks=pscan._shard_blocks(n)))
        recs[f"N{n}"] = rec
    return recs


def sharded_moments(wmesh, dev):
    """JAX's moment test (tests/test_parallel.py:109-134) through
    ``run_ensemble_sharded`` over ``wmesh``'s ranks: 64 walkers x 1500
    steps on a 2-D Gaussian. Returns (acceptance, the means' largest
    absolute error, the deviations' largest relative error)."""
    import torch

    from periodicity_tpu_torch.models.gp import mcmc

    mu = torch.tensor([1.0, -2.0], device=dev)
    sd = torch.tensor([0.5, 2.0], device=dev)
    x0 = torch.randn(64, 2, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        chain, _, acc = mcmc.run_ensemble_sharded(
            lambda x: -0.5 * torch.sum(((x - mu) / sd) ** 2, dim=-1), x0, 1, 1500, wmesh)
    samples = chain.full_tensor()[500:].reshape(-1, 2).double()
    m_err = float((samples.mean(0) - mu.double()).abs().max())
    s_rel = float(((samples.std(0) - sd.double()).abs() / sd.double()).max())
    check(0.1 < acc < 0.95 and m_err <= 0.15 and s_rel <= 0.15,
          f"run_ensemble_sharded moments: acceptance {acc}, mean {m_err}, std {s_rel}")
    return acc, m_err, s_rel


def sharded_modeler(smesh, cuda, tally):
    """``BrownianGP(SpottedStar, solver="sharded")`` over ``smesh`` against
    ``solver="scan"`` at 3 draws of u: nll and its gradient within
    PAR_ONE_RANK. Each sharded nll launches K1 once on rank 0 and twice
    elsewhere, and its gradient K2 as often (held, added to ``tally``).
    Returns (nll relative error, gradient relative error)."""
    import torch

    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch import data as pdata
    from periodicity_tpu_torch.gp import BrownianGP
    from periodicity_tpu_torch.ops import kalman as K

    t5, y5, dy5 = pdata.SpottedStar()
    sig = TSeries(cuda(t5), cuda(y5))
    m_scan = BrownianGP(sig, err=cuda(dy5))
    m_shard = BrownianGP(sig, err=cuda(dy5), solver="sharded", mesh=smesh)
    k1 = 1 if smesh.get_local_rank() == 0 else 2
    d_nll = d_grad = 0.0
    for u in np.random.default_rng(35).uniform(5, 95, (3, m_scan.ndim)):
        uu = cuda(u).requires_grad_(True)
        f = counted(tally, K.kalman_blocked, k1, lambda: m_shard._nll_u(uu),
                    "BrownianGP(solver='sharded') nll")
        (g,) = counted(tally, K.kalman_blocked_adjoint, k1,
                       lambda: torch.autograd.grad(f, uu), "BrownianGP(solver='sharded') gradient")
        uu = cuda(u).requires_grad_(True)
        f_scan = m_scan._nll_u(uu)
        (g_scan,) = torch.autograd.grad(f_scan, uu)
        d_nll = max(d_nll, abs(float(f.detach()) - float(f_scan.detach()))
                    / abs(float(f_scan.detach())))
        d_grad = max(d_grad, float((g - g_scan).abs().max() / g_scan.abs().max()))
    check(d_nll <= PAR_ONE_RANK and d_grad <= PAR_ONE_RANK,
          f"BrownianGP(solver='sharded') vs scan: nll {d_nll:.2e}, gradient {d_grad:.2e}")
    return d_nll, d_grad


def parallel_slice(dev, card, cuda):
    """Phases 34-37: the parallel package and the sharded GP on the card.
    Phases 34-36 are the slice's main path at world size 1 through NCCL (B1,
    B2 and K1 counted from zero across them); phase 37 runs D = 4 ranks'
    stages in turn on the card against the CPU. Prints the ``{"parallel":
    ...}`` line and returns the main path's launches by kernel."""
    import glob
    import json as _json
    import tempfile

    import torch
    import torch.distributed as dist

    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch import data as pdata
    from periodicity_tpu_torch.gp import log_likelihood
    from periodicity_tpu_torch.models.gp import mcmc, pscan
    from periodicity_tpu_torch.models.gp.terms import BrownianTerm
    from periodicity_tpu_torch.models.phase import aov_scan, bls_scan, pdm_scan
    from periodicity_tpu_torch.ops import kalman as K
    from periodicity_tpu_torch.ops.fold import fold_onehot
    from periodicity_tpu_torch.ops.grid2 import extirpolate_grid_factored
    from periodicity_tpu_torch.parallel import (default_mesh, distributed_acf, distributed_fft,
                                                distributed_ifft, sharded_aov, sharded_bls,
                                                sharded_gls, sharded_pdm)
    from periodicity_tpu_torch.parallel import dfft as D
    from periodicity_tpu_torch.parallel.sharded import _gls_stage, _period_stage
    from periodicity_tpu_torch.spectral import gls_power
    from periodicity_tpu_torch.utils import timer, trace

    start = time.perf_counter()
    out = {"card": card}

    def overhead(name, sharded, plain, reps=3, phase=34):
        """Event times of the sharded call and its unsharded call, in turns."""
        got = turns_ms(sharded, plain, reps)
        out.setdefault("world1_ms", {})[name] = got
        print(f"phase {phase} world size 1 {name}: sharded {got['sharded']:.4f} ms, unsharded "
              f"{got['unsharded']:.4f} ms, overhead {got['sharded'] - got['unsharded']:+.4f} ms  "
              f"({card})")

    # phase 34: the sharded scans and transforms at world size 1 (NCCL,
    # a HashStore group the mesh starts itself) against the unsharded calls
    # through the kernels; the slice's main path starts here, and
    # ``tally`` sums the launches of its sharded calls alone
    mesh = default_mesh(("grid",))
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and mesh.device_type == "cuda", "default_mesh: a world of one on NCCL")
    extirpolate_grid_factored.launches = 0
    fold_onehot.launches = 0
    K.kalman_blocked.launches = 0
    tally = {}
    t, y, err = bench_draw()
    tc, yc, ec = cuda(t), cuda(y), cuda(err)
    df = float(np.float32(0.5 / BASELINE))
    fmin = float(np.float32(df / 2))
    got = counted(tally, extirpolate_grid_factored, 3,
                  lambda: sharded_gls(tc, yc, ec, df, fmin, NF, mesh, gridder="kernel"),
                  "sharded_gls (no pair_q, as JAX)")
    want = gls_power(tc, yc, ec, df, fmin, NF, gridder="kernel")
    check(bit_equal(got.full_tensor(), want) and got.to_local().shape == (NF,),
          "sharded_gls(gridder='kernel') bit-equal to gls_power at the bench shape")
    overhead("sharded_gls_bench", lambda: sharded_gls(tc, yc, ec, df, fmin, NF, mesh,
                                                      gridder="kernel"),
             lambda: gls_power(tc, yc, ec, df, fmin, NF, gridder="kernel"))

    tb, yb = bls_draw()
    tbc, ybc = cuda(tb), cuda(yb)
    wb = torch.full_like(tbc, 1.0 / BLS_N)
    pb = cuda(np.linspace(0.5, 100.0, BLS_P))
    kw = dict(widths=tuple(max(1, int(round(q * BLS_NBINS))) for q in BLS_DURATIONS),
              nbins=BLS_NBINS, batch_size=BLS_BATCH, binner="kernel")
    def fold_close(label, got, want, again):
        """A fold-kernel scan's sharded result against its unsharded call,
        bit for bit, as GLS and PDM are: B2 sums each bin in a fixed order,
        so two launches agree (``again``, a second unsharded call, shows
        it)."""
        got, want, again = (x if isinstance(x, tuple) else (x,) for x in (got, want, again))
        got = tuple(g.full_tensor() for g in got)
        bits = all(bit_equal(g, w) for g, w in zip(got, want))
        repeat = all(bit_equal(a, w) for a, w in zip(again, want))
        check(bits and repeat, f"{label}: sharded bit-equal to the unsharded scan ({bits}), two "
                               f"unsharded calls bit-equal ({repeat})")
        out.setdefault("fold_kernel_world1", {})[label] = {"bit_equal": bits,
                                                           "unsharded_repeat_bit_equal": repeat}
        print(f"phase 34 {label}: sharded bit-equal to the unsharded scan; two unsharded calls "
              f"bit-equal  ({card})")

    got = counted(tally, fold_onehot, -(-BLS_P // BLS_BATCH),
                  lambda: sharded_bls(tbc, ybc, wb, pb, mesh, **kw), "sharded_bls: one a chunk")
    fold_close("sharded_bls config 11", got, bls_scan(tbc, ybc, wb, pb, **kw),
               bls_scan(tbc, ybc, wb, pb, **kw))
    overhead("sharded_bls_config11", lambda: sharded_bls(tbc, ybc, wb, pb, mesh, **kw),
             lambda: bls_scan(tbc, ybc, wb, pb, **kw), reps=1)

    rng = np.random.default_rng(0)
    t4 = np.sort(rng.uniform(0, 200.0, C4_N)).astype(np.float32)
    y4 = (np.sin(2 * np.pi * t4 / 7.7) + 0.2 * rng.standard_normal(C4_N)).astype(np.float32)
    t4c, y4c = cuda(t4), cuda(y4)
    p4 = cuda(np.linspace(0.5, 100.0, C4_P).astype(np.float32))
    for name, sharded, plain in (
            ("sharded_aov_config4",
             lambda: sharded_aov(t4c, y4c, p4, mesh, batch_size=512, binner="kernel"),
             lambda: aov_scan(t4c, y4c, p4, batch_size=512, binner="kernel")),
            ("sharded_pdm_config4", lambda: sharded_pdm(t4c, y4c, p4, mesh, batch_size=512),
             lambda: pdm_scan(t4c, y4c, p4, batch_size=512))):
        if "aov" in name:
            got = counted(tally, fold_onehot, -(-C4_P // 512), sharded,
                          "sharded_aov: one a chunk")
            fold_close("sharded_aov config 4", got, plain(), plain())
        else:  # no kernel: the same eager operations
            check(bit_equal(sharded().full_tensor(), plain()), f"{name}: bit-equal to the scan")
        overhead(name, sharded, plain, reps=1)

    smesh = default_mesh(("seq",))
    fft_out = {}
    for dname, n in PAR_FFT_N.items():
        dtype = getattr(torch, dname)
        x = torch.randn(n, dtype=torch.float64, device=dev, generator=torch.Generator(
            device=dev).manual_seed(34)).to(dtype)
        X = distributed_fft(x, smesh).full_tensor()
        X64 = torch.fft.fft(x.double())
        lib = torch.fft.fft(x.to(X.dtype))
        scale = float(X64.abs().max())
        err_d = float((X.to(torch.complex128) - X64).abs().max()) / scale
        err_lib = float((lib.to(torch.complex128) - X64).abs().max()) / scale
        back = distributed_ifft(distributed_fft(x, smesh), smesh).full_tensor()
        err_back = float((back.real.double() - x.double()).abs().max())
        yv = (torch.sin(2 * math.pi * torch.arange(n, device=dev, dtype=torch.float64) / 64)
              + 0.2 * x.double()).to(dtype)
        acf = distributed_acf(yv, smesh).full_tensor()
        tl = torch.arange(n, dtype=torch.float64, device=dev)
        ref64 = TSeries(tl, yv.double()).acf(max_lag=n // 2).values
        err_acf = float((acf[: n // 2].double() - ref64).abs().max())
        rec = {"n": n, "rel_vs_f64_fft": err_d, "cufft_rel_vs_f64_fft": err_lib,
               "bit_equal_to_torch_fft": bool(torch.equal(X, lib)), "round_trip_abs": err_back,
               "acf_abs_vs_f64_container": err_acf}
        if dname == "float64":
            check(err_d <= PAR_F64_FFT and err_back <= 1e-10 and err_acf <= PAR_F64_ACF,
                  f"f64 dfft N={n}: {err_d:.2e} of max|X|, round trip {err_back:.2e}, ACF "
                  f"{err_acf:.2e}")
        else:
            ref32 = TSeries(tl.float(), yv).acf(max_lag=n // 2).values
            err_acf_lib = float((ref32.double() - ref64).abs().max())
            rec["container_f32_acf_abs_vs_f64"] = err_acf_lib
            check(err_d <= PAR_F32_FFT_X * err_lib and err_acf <= PAR_F32_FFT_X * err_acf_lib,
                  f"f32 dfft N={n}: {err_d:.2e} of max|X| (cuFFT {err_lib:.2e}), ACF "
                  f"{err_acf:.2e} (container f32 {err_acf_lib:.2e})")
        overhead(f"distributed_fft_{dname}_N{n}", lambda x=x: distributed_fft(x, smesh),
                 lambda x=x, cd=X.dtype: torch.fft.fft(x.to(cd)))
        fft_out[dname] = rec
        print(f"phase 34 dfft {dname} N={n} at world size 1: {err_d:.3e} of max|X| from the f64 "
              f"transform (cuFFT in {dname}: {err_lib:.3e}; bit-equal to torch.fft.fft "
              f"{rec['bit_equal_to_torch_fft']}), round trip {err_back:.2e}, ACF {err_acf:.3e} "
              f"from the f64 container ACF  ({card})")
    out["dfft"] = fft_out
    t34 = time.perf_counter()

    # phase 35: config 7's points through log_likelihood_sharded (world of
    # one: one K1 call over the series) against the f64 scan, C5's limits;
    # run_ensemble_sharded at config 8's size; the sharded modeler
    c7 = sharded_ll_points(smesh, cuda, tally,
                           lambda name, sh, un: overhead(name, sh, un, reps=1, phase=35))
    for n, rec in c7.items():
        print(f"phase 35 log_likelihood_sharded config 7 {n}: f32 {rec['f32_rel']:.3e}, f64 "
              f"{rec['f64_rel']:.2e} from the f64 scan  ({card})")
    out["config7"] = c7

    wmesh = default_mesh(("walkers",))
    t5, y5, dy5 = pdata.SpottedStar()
    x8 = np.random.default_rng(0).uniform(0.9, 1.1, (C8_WALKERS, 4))

    def c8_log_prob(tt, yy, diag):
        def log_prob(ws):
            term = BrownianTerm(0.01 * ws[:, 0], 20.0 * ws[:, 1], 10.0 * ws[:, 2],
                                0.3 * ws[:, 3])
            ll = log_likelihood(term, tt, diag, yy)
            return torch.where(torch.isfinite(ll), ll, -1e25)
        return log_prob

    with torch.no_grad():
        lp8 = c8_log_prob(*(cuda(a).float() for a in (t5, y5 - y5.mean(), dy5**2)))
        x0 = cuda(x8).float()
        mcmc.run_ensemble_sharded(lp8, x0, 0, 2, wmesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain, lps, acc = mcmc.run_ensemble_sharded(lp8, x0, 0, C8_STEPS, wmesh)
        torch.cuda.synchronize()
        s8 = time.perf_counter() - t0
        t0 = time.perf_counter()
        mcmc.run_ensemble(lp8, x0, 0, C8_STEPS)
        torch.cuda.synchronize()
        s8_plain = time.perf_counter() - t0
        check(tuple(chain.shape) == (C8_STEPS, C8_WALKERS, 4) and 0 < acc < 1
              and bool(torch.isfinite(lps.full_tensor()).all()),
              "run_ensemble_sharded config 8: [steps, W, D], finite, accepting")
        # 5 f64 steps card vs CPU on one set of injected draws
        rng8 = np.random.default_rng(8)
        half = C8_WALKERS // 2
        draws = [[(rng8.random(C8_WALKERS), rng8.integers(0, half, C8_WALKERS),
                   rng8.random(C8_WALKERS)) for _ in range(2)] for _ in range(5)]
        runs = {}
        for where, put in (("cuda", cuda), ("cpu", torch.from_numpy)):
            lp = c8_log_prob(*(put(a) for a in (t5, y5 - y5.mean(), dy5**2)))
            dd = [[tuple(put(np.asarray(a)) for a in h) for h in s] for s in draws]
            c, _, a = mcmc._sharded_chain(lp, put(x8), 0, half, 5, lambda s, k: dd[s][k],
                                          lambda x: x, 2.0)
            runs[where] = (c.cpu(), a.cpu())
        check(torch.equal(runs["cuda"][1], runs["cpu"][1]),
              "run_ensemble_sharded f64 on injected draws: accepts card vs CPU")
        rel8 = float(((runs["cuda"][0] - runs["cpu"][0]).abs() / runs["cpu"][0].abs()).max())
        check(rel8 <= PAR_F64_CPU, f"run_ensemble_sharded f64: card vs CPU {rel8:.2e}")
    accg, m_err, s_rel = sharded_moments(wmesh, dev)
    out["sampler"] = {"config8_walker_steps_per_s": C8_WALKERS * C8_STEPS / s8,
                      "config8_seconds": s8, "run_ensemble_seconds": s8_plain,
                      "acceptance": acc, "f64_cpu_rel": rel8, "moments_mean_abs": m_err,
                      "moments_std_rel": s_rel, "moments_acceptance": accg}
    print(f"phase 35 run_ensemble_sharded config 8 (64 x {C8_STEPS}, f32, world 1): {s8:.3f} s "
          f"({C8_WALKERS * C8_STEPS / s8:.4e} walker-steps/s; run_ensemble {s8_plain:.3f} s), "
          f"acceptance {acc:.3f}; f64 on injected draws card vs CPU {rel8:.1e}; 2-D Gaussian "
          f"mean within {m_err:.3f}, std within {s_rel:.3f}  ({card})")

    d_nll, d_grad = sharded_modeler(smesh, cuda, tally)
    out["modeler"] = {"nll_rel_vs_scan": d_nll, "grad_rel_vs_scan": d_grad}
    print(f"phase 35 BrownianGP(SpottedStar, solver='sharded'): nll within {d_nll:.1e} and its "
          f"gradient within {d_grad:.1e} of solver='scan'  ({card})")
    t35 = time.perf_counter()

    # phase 36: a trace around one bench-shape periodogram names B1's
    # kernel; the timer
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir):
            gls_power(tc, yc, ec, df, fmin, NF, pair_q=1, gridder="kernel")
            torch.cuda.synchronize()
        files = glob.glob(f"{logdir}/*.pt.trace.json")
        check(len(files) == 1, f"trace: one exported trace, got {files}")
        with open(files[0]) as f:
            names = {e.get("name", "") for e in _json.load(f)["traceEvents"]}
    spread = sorted(n for n in names if "spread_walk" in n)
    check(bool(spread), "the exported trace names the spreading kernel")
    with timer("bench periodogram") as tm:
        gls_power(tc, yc, ec, df, fmin, NF, pair_q=1, gridder="kernel")
    check(tm["seconds"] > 0, f"timer: {tm}")
    out["profiling"] = {"trace_kernels": spread, "timer_s": tm["seconds"]}
    print(f"phase 36 trace: {len(names)} event names, the spreading kernel as {spread[:1]}; "
          f"timer {tm['seconds'] * 1e3:.3f} ms a bench-shape periodogram  ({card})")
    launches = {k.__name__: tally.get(k.__name__, 0)
                for k in (extirpolate_grid_factored, fold_onehot, K.kalman_blocked,
                          K.kalman_blocked_adjoint)}
    check(all(v > 0 for v in launches.values()),
          f"B1, B2, K1 and K2 launched by the slice's sharded calls: {launches}")
    out["main_path_launches"] = launches
    print(f"phase 36 main path (phases 34-36, the sharded calls): "
          f"{launches['extirpolate_grid_factored']} B1, {launches['fold_onehot']} B2, "
          f"{launches['kalman_blocked']} K1 and {launches['kalman_blocked_adjoint']} K2 launches")
    t36 = time.perf_counter()

    # phase 37: D = 4 ranks' stages in turn on the card, joined, against
    # the same stages on the CPU, with each rank's stage times
    stages = {}
    term = BrownianTerm(0.01, 20.0, 10.0, 0.3)

    def rank_ms(name, fns):
        stages[name] = [event_ms(fn, 1) for fn in fns]

    gls_d = {w: in_turn_gls(*(a if w == "cuda" else torch.from_numpy(b) for a, b in
                              ((tc, t), (yc, y), (ec, err))), df, fmin, NF, PAR_D,
                            "kernel" if w == "cuda" else "scatter") for w in ("cuda", "cpu")}
    ref_gls = in_turn_gls(*(torch.from_numpy(a).double() for a in (t, y, err)), df, fmin, NF,
                          PAR_D, "scatter")
    peak = float(ref_gls.max())
    k_nyq = int((0.5 / float(TSeries(tc, yc).median_dt) - fmin) / df) + 1
    dp = (gls_d["cuda"].cpu().double() - gls_d["cpu"].double()).abs() / peak
    d_band, d_all = float(dp[:k_nyq].max()), float(dp.max())
    d64 = float((gls_d["cuda"].cpu().double() - ref_gls).abs().max()) / peak
    check(d_band <= 1e-4 and d_all <= 5e-4 and d64 <= 5e-4,
          f"D=4 sharded_gls stages f32 card vs CPU: {d_band:.2e} below pseudo-Nyquist, {d_all:.2e} "
          f"overall, {d64:.2e} from the f64 CPU stages")
    rank_ms("gls_bench", [lambda i=i: _gls_stage(tc, yc, ec, df, fmin, NF // PAR_D, i, True,
                                                 False, "kernel") for i in range(PAR_D)])
    bls_d = {w: in_turn_bls(*(put(a) for a in (tb, yb, np.full(BLS_N, 1.0 / BLS_N, np.float32),
                                                np.linspace(0.5, 100.0, BLS_P))), PAR_D, **kw)
             for w, put in (("cuda", cuda), ("cpu", torch.from_numpy))}
    pk = float(bls_d["cpu"][0].max())
    d_bls = float((bls_d["cuda"][0].cpu() - bls_d["cpu"][0]).abs().max()) / pk
    check(d_bls <= 1e-4 and int(torch.argmax(bls_d["cuda"][0])) == int(torch.argmax(
        bls_d["cpu"][0])), f"D=4 sharded_bls stages card vs CPU: {d_bls:.2e} of the peak")
    rank_ms("bls_config11", [lambda i=i: _period_stage(bls_scan, (tbc, ybc, wb), pb, PAR_D, i,
                                                       **kw) for i in range(PAR_D)])
    fft_d = {}
    for dname, n in PAR_FFT_N.items():
        x = torch.randn(n, dtype=torch.float64, generator=torch.Generator().manual_seed(37)).to(
            getattr(torch, dname))
        Xc, Xh = in_turn_fft(x.to(dev), PAR_D).cpu(), in_turn_fft(x, PAR_D)
        scale = float(Xh.abs().max())
        d_cpu = float((Xc - Xh).abs().max()) / scale
        nat = torch.empty(n, dtype=torch.complex128)
        for r in range(PAR_D):
            nat[r::PAR_D] = Xc.reshape(PAR_D, n // PAR_D)[r].to(torch.complex128)
        X64 = torch.fft.fft(x.double())
        xd = x.to(dev)
        lib = float((torch.fft.fft(xd.to(Xc.dtype)).cpu().to(torch.complex128) - X64).abs().max())
        d64 = float((nat - X64).abs().max()) / float(X64.abs().max())
        back = float((in_turn_ifft(Xc.to(dev), PAR_D).real.cpu().double() - x.double())
                     .abs().max())
        limit = PAR_F64_CPU if dname == "float64" else PAR_F32_CPU
        bound64 = PAR_F64_FFT if dname == "float64" else PAR_F32_FFT_X * lib / float(
            X64.abs().max())
        check(d_cpu <= limit and d64 <= bound64 and back <= (1e-10 if dname == "float64"
                                                              else 1e-4),
              f"D=4 dfft {dname} N={n}: card vs CPU {d_cpu:.2e} (limit {limit}), natural order "
              f"vs the f64 FFT {d64:.2e} (limit {bound64:.2e}), round trip {back:.2e}")
        fft_d[dname] = {"card_vs_cpu": d_cpu, "rel_vs_f64_fft": d64, "round_trip_abs": back,
                        "cufft_rel_vs_f64_fft": lib / float(X64.abs().max())}
        el = n // PAR_D
        copies = [D._fwd_copies(xd[j * el:(j + 1) * el], j, PAR_D, Xc.dtype) for j in range(PAR_D)]
        recv = [torch.stack([c[r] for c in copies]) for r in range(PAR_D)]
        rank_ms(f"fft_{dname}_copies", [lambda j=j: D._fwd_copies(xd[j * el:(j + 1) * el], j,
                                                                  PAR_D, Xc.dtype)
                                        for j in range(PAR_D)])
        rank_ms(f"fft_{dname}_finish", [lambda r=r: D._fwd_finish(recv[r], r, n)
                                        for r in range(PAR_D)])
        del copies, recv
    t7, y7 = c7_series(np.random.default_rng(0), C7_SOLVER_NS[1])
    args64 = [a.double() for a in (torch.from_numpy(t7), torch.full((t7.size,), 0.01,
                                                                   dtype=torch.float32),
                                   torch.from_numpy(y7))]
    ll_d = {}
    for where, device in (("cuda", dev), ("cpu", "cpu")):
        total, _ = in_turn_ll(term, *(a.to(device) for a in args64), PAR_D)
        ll_d[where] = float(total)
    one = float(pscan.log_likelihood_sharded(term, *(a.to(dev) for a in args64), smesh))
    d_ll = abs(ll_d["cuda"] - ll_d["cpu"]) / abs(ll_d["cpu"])
    d_one = abs(ll_d["cuda"] - one) / abs(one)
    check(d_ll <= PAR_F64_CPU and d_one <= PAR_ONE_RANK,
          f"D=4 log_likelihood_sharded stages f64 N=1e5: card vs CPU {d_ll:.2e}, vs one rank "
          f"{d_one:.2e}")
    # the stages' gradient at N = 1e4 (f64): each rank's passes reversed by
    # K2, the summaries' cotangents summed where the join stacked them, card
    # against CPU and against the one-rank gradient
    gd = {}
    part = [a[:C7_SOLVER_NS[0]] for a in args64]
    for where, device, fn in (
            ("cuda", dev, lambda *a: in_turn_ll(*a, PAR_D)[0]),
            ("cpu", "cpu", lambda *a: in_turn_ll(*a, PAR_D)[0]),
            ("one", dev, lambda *a: pscan.log_likelihood_sharded(*a, smesh))):
        pg = torch.tensor([0.01, 20.0, 10.0, 0.3], dtype=torch.float64, device=device,
                          requires_grad=True)
        before = K.kalman_blocked_adjoint.launches
        ll = fn(BrownianTerm(pg[0], pg[1], pg[2], pg[3]), *(a.to(device) for a in part))
        (gd[where],) = torch.autograd.grad(ll, pg)
        gd[where] = gd[where].cpu()
        if where == "cuda":
            check(K.kalman_blocked_adjoint.launches - before == 2 * PAR_D - 1,
                  f"D=4 stages' gradient: {2 * PAR_D - 1} K2 launches, got "
                  f"{K.kalman_blocked_adjoint.launches - before}")
    d_g = float(((gd["cuda"] - gd["cpu"]) / gd["cpu"]).abs().max())
    d_g1 = float(((gd["cuda"] - gd["one"]) / gd["one"]).abs().max())
    check(d_g <= PAR_ONE_RANK and d_g1 <= PAR_ONE_RANK,
          f"D=4 log_likelihood_sharded stages' gradient f64 N=1e4: card vs CPU {d_g:.2e}, vs one "
          f"rank {d_g1:.2e}")
    out["d4"] = {"gls_f32_card_vs_cpu_band": d_band, "gls_f32_card_vs_cpu": d_all,
                 "gls_f32_vs_f64_cpu": d64, "bls_card_vs_cpu": d_bls, "dfft": fft_d,
                 "ll_f64_card_vs_cpu": d_ll, "ll_f64_vs_one_rank": d_one,
                 "grad_f64_N10000_card_vs_cpu": d_g, "grad_f64_N10000_vs_one_rank": d_g1,
                 "rank_stage_ms": stages}
    print(f"phase 37 D={PAR_D} ranks in turn, card vs CPU: sharded_gls f32 {d_band:.2e} / "
          f"{d_all:.2e} of the peak, sharded_bls {d_bls:.2e}, dfft f32 "
          f"{fft_d['float32']['card_vs_cpu']:.2e} / f64 {fft_d['float64']['card_vs_cpu']:.2e} of "
          f"max|X|, log_likelihood_sharded f64 {d_ll:.2e} (vs one rank {d_one:.2e}), its "
          f"gradient through K2 at N=1e4 {d_g:.2e} (vs one rank {d_g1:.2e})  ({card})")
    for name, ms in stages.items():
        print(f"phase 37 rank stage times {name}: " + ", ".join(f"{x:.4f}" for x in ms)
              + f" ms  ({card})")
    dist.destroy_process_group()
    t37 = time.perf_counter()
    out["wall_s"] = {"34": t34 - start, "35": t35 - t34, "36": t36 - t35, "37": t37 - t36}
    print(json_line({"parallel": out}))
    return launches


# phase 38: GP terms wider than 8 slots, on SpottedStar at config 5's shape
# (64 walkers, N = 2148) and at config 7's long points (one row)
GRANULATION_Q = 1 / math.sqrt(2)
WIDE_KINDS = ("rot_gran", "brown_rot", "rot_rot")


def wide_term(w, kind):
    """One of the phase's terms, its parameters from walker multipliers w
    [..., 10] (every parameter a tensor, so every SHO is masked): rot_gran,
    a RotationTerm plus an SHOTerm for granulation (Q = 1/sqrt(2)), R = 12;
    brown_rot, a BrownianTerm plus a RotationTerm, R = 14 (the Brownian
    background's Q = 0.01 is a number, live); rot_rot, two RotationTerms,
    R = 16."""
    import torch

    from periodicity_tpu_torch.models.gp.terms import BrownianTerm, RotationTerm, SHOTerm

    rot = RotationTerm(sigma=0.01 * w[..., 0], period=10.0 * w[..., 1], Q0=1.0 * w[..., 2],
                       dQ=1.0 * w[..., 3], f=0.5 * w[..., 4])
    if kind == "rot_gran":
        q = torch.full_like(w[..., 7], GRANULATION_Q)
        return rot + SHOTerm(sigma=0.003 * w[..., 5], rho=1.0 * w[..., 6], Q=q)
    if kind == "brown_rot":
        return BrownianTerm(0.01 * w[..., 5], 20.0 * w[..., 6], 10.0 * w[..., 7],
                            0.3 * w[..., 8]) + rot
    return rot + RotationTerm(sigma=0.005 * w[..., 5], period=3.0 * w[..., 6],
                              Q0=0.5 * w[..., 7], dQ=0.5 * w[..., 8], f=0.3 * w[..., 9])


def dense_gp_yardsticks(term, tt, diag, y, Y):
    """The celerite kernels' "one PyTorch call" on the walkers' systems, by
    CUDA events (ms): G1's, one batched ``cholesky_ex`` + ``solve_triangular``
    of the walkers' dense K [b, n, n] and y; G2's, autograd's backward
    through that log-likelihood, from K and y; G3's, one ``cholesky_solve``
    of walker 0's system (factored outside the call) at Y's columns and at
    one. Returns (g1, g2, g3, g3_k1, walkers the dense Cholesky could not
    factor)."""
    import torch

    tau = tt[:, None] - tt[None, :]
    with torch.no_grad():
        Kb = term.get_value(tau) + torch.diag(diag)

    def factor(K, yy):
        L, info = torch.linalg.cholesky_ex(K)
        return L, info, torch.linalg.solve_triangular(L, yy[..., None], upper=False)

    with torch.no_grad():
        factor(Kb, y)
        g1 = event_ms(lambda: factor(Kb, y), 3)
    Kg, yg = Kb.clone().requires_grad_(True), y.detach().clone().requires_grad_(True)
    L, info, z = factor(Kg, yg)
    ll = -0.5 * (z[..., 0].square().sum(-1)
                 + 2 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1))
    total = torch.where(info == 0, ll, 0).sum()
    g2 = event_ms(lambda: torch.autograd.grad(total, (Kg, yg), retain_graph=True), 3)
    failed = int((info != 0).sum())
    del Kg, yg, L, z, ll, total
    with torch.no_grad():
        L0, _ = torch.linalg.cholesky_ex(Kb[0])
        y1 = Y[:, :1].contiguous()
        g3 = event_ms(lambda: torch.cholesky_solve(Y, L0), 5)
        g3_k1 = event_ms(lambda: torch.cholesky_solve(y1, L0), 20)
    del Kb, L0
    torch.cuda.empty_cache()
    return g1, g2, g3, g3_k1, failed


def term_width(term):
    ar, _, ac = term.coefficients()[:3]
    return ar.shape[-1] + 2 * ac.shape[-1]


def k2_chain_ops(r):
    """Dependent operations of one composition's adjoint on the reversed
    chain, from the result's cotangent to the earlier operand's
    (csrc/kalman_adjoint.cuh::compose_vjp; the factorization it reads
    depends on the prefixes alone, off the chain): dT2 = dCn Aj and dm1t's
    R-deep sums and its two sums (2 R + 2); U^T's forward substitution, a
    product, a difference and a division a row (R (2 + DIV_OPS)); the
    transposed multipliers, a product and a difference a step (2 (R - 1));
    dM's (2 R + 1)-deep sum and its sign (2 R + 2); Jj^T dM and dCi's two
    sums (R + 2)."""
    return (2 * r + 2) + r * (2 + DIV_OPS) + 2 * (r - 1) + (2 * r + 2) + (r + 2)


# Phase 39 holds config 7's f32 gradients against the f64 scan's (the
# largest relative error over the four parameters) over C7_F32_SEEDS: at N
# = 1e4 within twice the f32 scan gradient's own error. Beyond it the
# blocked composition's f32 gradient is past that in both packages
# (tests/test_torch_gp_float32.py: on a stand-in for the 1e6 series, at its
# sampling density and float32 time resolution, jax.grad through the JAX
# package's float32 log_likelihood_chunked reads 2.6e-2 against its scan's
# 5.2e-4), most of it from the float32 process noise Q = Pinf - A Pinf A^T
# that both packages form ahead of the composition (with Q formed in
# float64 and rounded the port's reading falls more than tenfold), and one
# lost carry's gradient error overlaps the sound readings at 1e5, so no
# control separates a limit as for the likelihood (C5). A fixed limit,
# above the sound readings of both packages, with every solver's f64
# gradient within F64_LL_REL of the f64 scan's besides
F32_GRAD_REL_LONG = {100_000: 1e-2, 1_000_000: 5e-2}


def adjoint_slice(dev, card, cuda, kernels):
    """Phase 39: K2, the adjoint of the blocked Kalman composition. K2
    against its plain version bit for bit on the calls config 7's f32
    gradients make (recorded on the way: the blocked points at N = 1e4 and
    1e5 and a middle chunk, at the gradient's R = 6), and at R = 12 at N =
    1e4, with its events, device time by kernel, plain time, the bound of
    its reversed chain and, at N = 1e4, autograd's backward through the
    dense log-likelihood; then the slice's main path, counted from zero,
    each call's K2 launches held to its count: the gradients of config 7's
    points (one row, live BrownianTerm, f32; blocked at 1e4 and 1e5,
    chunked at 1e6) with their device time by kernel, launches, busy share and peak memory beside the
    scan gradient's (G1 and G2), each in f64 within F64_LL_REL of the f64
    scan's, and in f32 over C7_F32_SEEDS within twice the f32 scan
    gradient's own error at 1e4 and F32_GRAD_REL_LONG beyond (one lost
    carry's gradient printed beside them); and
    BrownianGP(SpottedStar, solver="blocked")'s nll gradient against
    solver="scan" at 3 draws of u (f64, 1e-10). Appends K2's record to
    ``kernels``; prints a ``{"adjoint": ...}`` line."""
    import torch

    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch import data as pdata
    from periodicity_tpu_torch.gp import (BrownianGP, log_likelihood, log_likelihood_blocked,
                                          log_likelihood_chunked)
    from periodicity_tpu_torch.models.gp import pscan
    from periodicity_tpu_torch.models.gp.terms import BrownianTerm
    from periodicity_tpu_torch.ops import celerite as C
    from periodicity_tpu_torch.ops import kalman as K
    from periodicity_tpu_torch.utils.dtypes import full_float32

    start = time.perf_counter()
    clock_hz = sm_clock_hz()
    out = {"card": card}
    rec = {"name": "kalman_blocked_adjoint", "route": "cuda",
           "source": "periodicity_tpu_torch/csrc/kalman_adjoint.cuh",
           "replaces": "periodicity_tpu/models/gp/pscan.py:279", "held": "bit-equal",
           "max_abs_err": 0.0}
    term = BrownianTerm(0.01, 20.0, 10.0, 0.3)
    attrs = {f"{'f64' if dt == torch.float64 else 'f32'}_r{r}": K.kernel_attributes(
        r, dt, adjoint=True) for r in range(1, K.MAX_R + 1) for dt in (torch.float32,
                                                                        torch.float64)}
    rec["local_bytes"] = {k: {st: a["local_bytes"] for st, a in v.items()}
                          for k, v in attrs.items()}
    print("phase 39 K2 local memory a thread (walk kernel): " + ", ".join(
        f"{k} {v['walk']['local_bytes']} B" for k, v in attrs.items()))

    solvers = {
        "scan": log_likelihood,
        "blocked": lambda term, t, d, y: log_likelihood_blocked(term, t, d, y,
                                                                n_blocks=c7_blocks(t.shape[0])),
        "chunked": lambda term, t, d, y: log_likelihood_chunked(term, t, d, y, chunk=C7_CHUNK,
                                                                inner_blocks=C7_INNER),
    }

    def grad(fn, tt, yy, dtype):
        p = torch.tensor([0.01, 20.0, 10.0, 0.3], dtype=dtype, device=dev, requires_grad=True)
        ll = fn(BrownianTerm(p[0], p[1], p[2], p[3]), tt.to(dtype), torch.full_like(
            tt, 0.01, dtype=dtype), yy.to(dtype))
        return torch.autograd.grad(ll, p)[0]

    def captured(n, chunked):
        """K2's call as config 7's f32 gradient makes it (the parameters a
        tensor that needs a gradient, the cotangents autograd hands K2),
        recorded on the way: the blocked point of n samples, or a middle
        chunk of the chunked shape (from the chunk before's carry, with the
        cotangent of its own carry from the chunk after)."""
        t7, y7 = c7_series(np.random.default_rng(0), n)
        calls, real = [], K.kalman_blocked_adjoint

        def record(*args):
            calls.append(args)
            return real(*args)

        record.launches = 0  # what real() counts while it stands in
        K.kalman_blocked_adjoint = record
        try:
            grad(solvers["chunked" if chunked else "blocked"], cuda(t7), cuda(y7), torch.float32)
        finally:
            K.kalman_blocked_adjoint = real
        return next(c for c in calls if (c[6] is not None and c[10] is not None) == chunked)

    def k2_timed(pre, call, label):
        """K2 at one call's operands (A, Q, H, diag, y, n_blocks, carry,
        the card's prefixes, bit-equal to K1's plain ones, and the
        cotangents): bit-equal to its plain version, its events, device
        time by kernel, the plain version's wall time and the bound of its
        reversed chain, or the bytes."""
        A, nb, carry = call[0], call[5], call[6]
        n, r = A.shape[1], A.shape[-1]
        fn = lambda: K.kalman_blocked_adjoint(*call)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = K.kalman_blocked_adjoint_plain(*call)
        rec[f"{pre}plain_ms"] = (time.perf_counter() - t0) * 1e3
        flat = lambda v: list(v[:4]) + list(v[4] or ())  # noqa: E731
        for name, a, w in zip(("dA", "dQ", "ddiag", "dy", "cA", "cb", "cC", "ceta", "cJ"),
                              flat(got), flat(want)):
            check(bit_equal(a, w), f"K2 vs plain at {label}: {name} not bit-equal")
        rec[f"{pre}ms"] = event_ms(fn, 5)
        work, _ = profiled(fn, reps=2)
        geo = K.kernel_geometry(A.shape[0], n, r, nb, carry is not None, A.dtype, adjoint=True)
        kern = {}
        for name, us in work:
            if "k2_" in name:
                k = name.split("k2_")[1].split("_kernel")[0]
                kern[k] = kern.get(k, 0.0) + us / 2 / 1e3
        check(sum(1 for w_ in work if "k2_" in w_[0]) == 2 * geo["launches"],
              f"K2's {geo['launches']} launches a call: {work}")
        rec[f"{pre}device_ms"] = sum(kern.values())
        rec[f"{pre}kernel_device_ms"] = kern
        esz = A.element_size()
        rec[f"{pre}bound_ms"], rec[f"{pre}bound_by"] = chain_bound(
            esz * n * (7 * r * r + 2 * r + 4),
            (geo["length"] + 2 * geo["levels"] + 1) * k2_chain_ops(r), str(A.dtype)[6:],
            clock_hz)
        rec[f"{pre}launches_a_call"] = geo["launches"]
        rec[f"{pre}n_blocks"] = nb
        print(f"phase 39 K2 at {label}: bit-equal to plain; events {rec[pre + 'ms']:.4f} ms, "
              f"device {rec[pre + 'device_ms']:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in kern.items())
              + f"), plain {rec[pre + 'plain_ms']:.1f} ms, bound {rec[pre + 'bound_ms']:.4f} ms "
              f"{rec[pre + 'bound_by']}  ({card})")

    # with parameters that need a gradient the term emits its SHO's masked
    # form (two real slots and a complex pair), R = 6 where the term of
    # Python floats has R = 4
    shapes = []
    for n in C7_SOLVER_NS:
        call = captured(n, False)
        r = call[0].shape[-1]
        k2_timed(f"N{n}_", call, f"config 7's gradient at N={n} (1 row, R={r}, {c7_blocks(n)} "
                 "blocks, f32)")
        shapes.append(f"R={r} N={n}")
    call = captured(3 * C7_CHUNK, True)
    r = call[0].shape[-1]
    k2_timed("chunk_", call, f"config 7's chunked gradient, a middle chunk (1 row, R={r}, "
             f"N={C7_CHUNK}, {C7_INNER} blocks, from a carry, f32)")
    shapes.append(f"R={r} chunk of {C7_CHUNK} from a carry")
    del call
    # R = 12 at N = 1e4 (the plain version takes ~40 s on the host at 1e5),
    # random cotangents
    _, _, A, Q, H, diag, y = k1_draw(np.random.default_rng(39), 12, 1, C7_SOLVER_NS[0],
                                     torch.float32)
    args, nb, g = [x.to(dev) for x in (A, Q, H, diag, y)], c7_blocks(C7_SOLVER_NS[0]), \
        torch.Generator().manual_seed(39)
    pref = K.kalman_blocked(*args, nb, None, prefixes=True)[3]
    dmu, ds = (torch.randn(y.shape, generator=g, dtype=y.dtype).to(dev) for _ in "ab")
    k2_timed(f"r12_N{C7_SOLVER_NS[0]}_", (*args, nb, None, pref, dmu, ds, None),
             f"R=12 N={C7_SOLVER_NS[0]} (1 row, f32, random cotangents)")
    shapes.append(f"R=12 N={C7_SOLVER_NS[0]}")
    del args, A, Q, H, diag, y, pref
    # the library yardstick at N = 1e4: autograd's backward through the
    # dense cholesky_ex + solve_triangular log-likelihood of the same K
    n = C7_SOLVER_NS[0]
    t7, y7 = c7_series(np.random.default_rng(0), n)
    tt, yy = cuda(t7), cuda(y7)
    with full_float32():
        Kd = (term.get_value(tt[:, None] - tt[None, :]) + torch.diag(torch.full_like(tt, 0.01))
              ).requires_grad_(True)
        yg = yy.clone().requires_grad_(True)
        L, info = torch.linalg.cholesky_ex(Kd)
        z = torch.linalg.solve_triangular(L, yg[:, None], upper=False)
        ll = -0.5 * (z.square().sum() + 2 * torch.log(torch.diagonal(L)).sum())
        rec[f"N{n}_library_ms"] = event_ms(
            lambda: torch.autograd.grad(ll, (Kd, yg), retain_graph=True), 3)
        rec[f"N{n}_library_info"] = int(info)
    del Kd, L, z, ll
    torch.cuda.empty_cache()
    rec[f"N{C7_SOLVER_NS[1]}_library_ms"] = None
    rec[f"N{C7_SOLVER_NS[1]}_library_note"] = "none (dense K does not fit: 40 GB in f32)"
    for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        rec[key] = rec[f"N{C7_SOLVER_NS[0]}_{key}"]
    rec["shape"] = ("K2's calls in config 7's f32 gradients, one row, live BrownianTerm "
                    "with parameters that need a gradient (its masked form, R = 6), "
                    "autograd's cotangents: "
                    "unprefixed N = 1e4 (39 blocks), also under N10000_; N100000_ N = 1e5 "
                    "(390 blocks); chunk_ a middle chunk of the chunked gradient (65536 samples "
                    "over 512 blocks, from a carry, with its own carry's cotangent); r12_N10000_ "
                    "R = 12 at 1e4, random operands and cotangents")
    print(f"phase 39 K2 at config 7 N={n}: autograd's backward through the dense "
          f"cholesky_ex + solve_triangular {rec['library_ms']:.3f} ms  ({card})")
    t_k2 = time.perf_counter()

    # the main path, counted from zero: config 7's gradients in f32, each
    # call's K2 launches held to its count (one a blocked gradient, one a
    # chunk a chunked one, none a scan's); the lost-carry control runs
    # outside the count
    def rel(g, ref):
        return float(((g.double() - ref) / ref).abs().max())

    def main_grad(which, tt, yy, dtype):
        n = tt.shape[0]
        want = {"scan": 0, "blocked": 1, "chunked": -(-n // C7_CHUNK)}[which]
        return counted(tally, K.kalman_blocked_adjoint, want,
                       lambda: grad(solvers[which], tt, yy, dtype),
                       f"config 7's {which} gradient at N={n} ({dtype})")

    def uncounted(fn):
        """fn() with every count of the main path put back after it."""
        kept = [(w, w.launches) for w in (K.kalman_blocked, K.kalman_blocked_adjoint,
                                          C.celerite_forward, C.celerite_adjoint)]
        try:
            return fn()
        finally:
            for w, launched in kept:
                w.launches = launched

    tally = {}
    K.kalman_blocked.launches = 0
    K.kalman_blocked_adjoint.launches = 0
    C.celerite_forward.launches = 0
    C.celerite_adjoint.launches = 0
    points = [(C7_SOLVER_NS[0], "blocked"), (C7_SOLVER_NS[1], "blocked"),
              (C7_CHUNKED_N, "chunked")]
    grads = {}
    for n, name in points:
        t7, y7 = c7_series(np.random.default_rng(0), n)
        tt, yy = cuda(t7), cuda(y7)
        cell = {}
        for which in (name, "scan"):
            fn = lambda which=which: main_grad(which, tt, yy, torch.float32)  # noqa: E731
            fn()
            ms = event_ms(fn, 2)
            work, wall = profiled(fn, pad=1)
            by, k2 = {}, {}
            for kname, us in work:
                key = ("K2" if "k2_" in kname else "K1" if "kalman_" in kname
                       else "G1" if "celerite_forward" in kname
                       else "G2" if "celerite_adjoint" in kname else "other")
                by[key] = by.get(key, 0.0) + us / 1e3
                if key == "K2":
                    k = kname.split("k2_")[1].split("_kernel")[0]
                    k2[k] = k2.get(k, 0.0) + us / 1e3
            mem = peak_bytes(fn)
            cell[which] = {"ms": ms, "device_ms": sum(by.values()), "device_ms_by": by,
                           "k2_device_ms_by_kernel": k2, "launches": len(work),
                           "busy_share": sum(by.values()) / 1e3 / wall, "peak_mib": mem / 2**20}
        g64 = rel(main_grad(name, tt, yy, torch.float64),
                  main_grad("scan", tt, yy, torch.float64))
        check(g64 <= F64_LL_REL, f"config 7 {name} N={n}: the f64 gradient {g64:.2e} from the f64 "
              f"scan's")
        cell["f64_grad_rel_vs_f64_scan"] = g64
        bound, nb = (n // 2, c7_blocks(n)) if name == "blocked" else (C7_CHUNK, C7_INNER)
        lost = lambda term, t, d, y: c7_lost_carry(term, t, d, y, bound, nb)  # noqa: E731
        errs = {name: [], "scan": [], "lost": []}
        for seed in C7_F32_SEEDS:
            t7, y7 = c7_series(np.random.default_rng(seed), n)
            ts_, ys_ = cuda(t7), cuda(y7)
            ref = main_grad("scan", ts_, ys_, torch.float64)
            for which in (name, "scan"):
                errs[which].append(rel(main_grad(which, ts_, ys_, torch.float32), ref))
            errs["lost"].append(rel(uncounted(lambda: grad(lost, ts_, ys_, torch.float32)), ref))
        worst, scan_worst = max(errs[name]), max(errs["scan"])
        if n == C7_SOLVER_NS[0]:
            check(worst <= 2 * scan_worst,
                  f"config 7 {name} N={n} f32 gradient over seeds {C7_F32_SEEDS}: {worst:.3e} "
                  f"from the f64 scan's, more than twice the f32 scan's {scan_worst:.3e}")
        else:
            check(worst <= F32_GRAD_REL_LONG[n],
                  f"config 7 {name} N={n} f32 gradient over seeds {C7_F32_SEEDS}: {worst:.3e} "
                  f"from the f64 scan's, past the limit {F32_GRAD_REL_LONG[n]}")
        cell["f32_grad_rel_vs_f64_scan"] = errs
        grads[f"{name}_N{n}"] = cell
        a, b = cell[name], cell["scan"]
        print(f"phase 39 config 7 {name} N={n} gradient (f32): {a['ms']:.3f} ms (K1 "
              f"{a['device_ms_by'].get('K1', 0):.3f} + K2 {a['device_ms_by'].get('K2', 0):.3f} "
              f"ms device, {a['launches']} launches, busy {a['busy_share']:.1%}, peak "
              f"{a['peak_mib']:.1f} MiB) vs the scan's {b['ms']:.3f} ms (G1 "
              f"{b['device_ms_by'].get('G1', 0):.3f} + G2 {b['device_ms_by'].get('G2', 0):.3f} "
              f"ms device, {b['launches']} launches, busy {b['busy_share']:.1%}, peak "
              f"{b['peak_mib']:.1f} MiB); rel to the f64 scan's over seeds {list(C7_F32_SEEDS)}: "
              + ", ".join(f"{x:.2e}" for x in errs[name]) + " (the f32 scan's "
              + ", ".join(f"{x:.2e}" for x in errs["scan"]) + "; one lost carry's "
              + ", ".join(f"{x:.2e}" for x in errs["lost"]) + "); K2 by kernel "
              + ", ".join(f"{k} {v:.3f}" for k, v in a["k2_device_ms_by_kernel"].items())
              + f" ms  ({card})")
    out["config7_gradients"] = grads

    ts, ys, dys = pdata.SpottedStar()
    sig = TSeries(cuda(ts), cuda(ys))
    models = {s_: BrownianGP(sig, err=cuda(dys), solver=s_) for s_ in ("scan", "blocked")}
    d_nll = d_grad = 0.0
    for u in np.random.default_rng(39).uniform(5, 95, (3, models["scan"].ndim)):
        vals = {}
        for s_, m in models.items():
            uu = cuda(u).requires_grad_(True)

            def nll_grad(m=m, uu=uu):
                f = m._nll_u(uu)
                return float(f.detach()), torch.autograd.grad(f, uu)[0]

            vals[s_] = counted(tally, K.kalman_blocked_adjoint, int(s_ == "blocked"), nll_grad,
                               f"BrownianGP(SpottedStar, solver={s_!r})'s nll gradient")
        d_nll = max(d_nll, abs(vals["blocked"][0] - vals["scan"][0]) / abs(vals["scan"][0]))
        d_grad = max(d_grad, float((vals["blocked"][1] - vals["scan"][1]).abs().max()
                                   / vals["scan"][1].abs().max()))
    check(d_nll <= F64_LL_REL and d_grad <= F64_LL_REL,
          f"BrownianGP(SpottedStar, solver='blocked') vs scan: nll {d_nll:.2e}, gradient "
          f"{d_grad:.2e}")
    out["modeler_blocked_vs_scan"] = {"nll_rel": d_nll, "grad_rel": d_grad}
    print(f"phase 39 BrownianGP(SpottedStar, solver='blocked'): nll within {d_nll:.1e} and its "
          f"gradient (K2) within {d_grad:.1e} of solver='scan' (f64, 3 draws of u)")
    launches = {"kalman_blocked": K.kalman_blocked.launches,
                "kalman_blocked_adjoint": K.kalman_blocked_adjoint.launches,
                "celerite_forward": C.celerite_forward.launches,
                "celerite_adjoint": C.celerite_adjoint.launches}
    check(launches["kalman_blocked_adjoint"] == tally["kalman_blocked_adjoint"] > 0
          and launches["kalman_blocked"] > 0,
          f"K1 and K2 launched on phase 39's main path, K2 as each call's count: {launches}, "
          f"{tally}")
    rec["launches"] = launches["kalman_blocked_adjoint"]
    out["main_path_launches"] = launches
    out["shapes_bit_equal"] = shapes
    out["wall_s"] = {"k2_vs_plain": t_k2 - start, "gradients": time.perf_counter() - t_k2}
    print(f"phase 39 main path: {launches['kalman_blocked']} K1, "
          f"{launches['kalman_blocked_adjoint']} K2, {launches['celerite_forward']} G1 and "
          f"{launches['celerite_adjoint']} G2 launches")
    print(json_line({"adjoint": out}))
    kernels.append(rec)


def wide_slice(dev, card, cuda, kernels):
    """Phase 38: the GP kernels at R = 9..16. Card against the CPU port on
    SpottedStar (likelihood, gradient, predict), the long solvers against
    the f64 scan, the rates beside config 5's and config 7's own terms, and
    G1-G3 and K1 timed at R = 12 and 16. Adds their times, bounds and
    compiled resources to the kernels' records; prints a ``{"wide": ...}``
    line."""
    import torch

    from periodicity_tpu_torch import data as pdata
    from periodicity_tpu_torch.gp import log_likelihood_blocked, log_likelihood_chunked
    from periodicity_tpu_torch.models.gp import pscan
    from periodicity_tpu_torch.models.gp.solver import (GaussianProcess, _rows,
                                                       celerite_matrices, log_likelihood)
    from periodicity_tpu_torch.models.gp.terms import BrownianTerm
    from periodicity_tpu_torch.ops import celerite as C
    from periodicity_tpu_torch.ops import kalman as K
    from periodicity_tpu_torch.utils.dtypes import full_float32

    clock_hz = sm_clock_hz()
    recs = {r["name"]: r for r in kernels}
    out = {"card": card}
    # every width's compiled resources, both dtypes: 0 bytes of local memory
    # up to R = 8 (held in phases 27 and 31), printed and recorded past it
    attrs = {}
    for r in range(1, C.MAX_R + 1):
        for dt in (torch.float64, torch.float32):
            key = f"{'f64' if dt == torch.float64 else 'f32'}_r{r}"
            attrs[key] = {"celerite": C.kernel_attributes(r, dt), "kalman": K.kernel_attributes(r, dt)}
            if r <= 8:
                # G3 in float64 at R = 5 has kept 8 bytes of stack since its
                # redesign (PR 12); every other stage none
                check(all(a["local_bytes"] == (8 if (name, key) == ("solve", "f64_r5") else 0)
                          for part in attrs[key].values() for name, a in part.items()),
                      f"no local memory at {key}: {attrs[key]}")
    out["attributes"] = attrs
    print("phase 38 local bytes / registers a thread past R = 8 (G1 with y and the saved "
          "state, G2, G3; K1's element, prefix, tree, innovation): " + "; ".join(
              f"{k} " + ", ".join(f"{a['local_bytes']}/{a['registers']}" for a in (
                  v["celerite"]["forward_y_save"], v["celerite"]["adjoint"],
                  v["celerite"]["solve"], *v["kalman"].values()))
              for k, v in attrs.items() if int(k.split("_r")[1]) > 8))

    t, y, dy = pdata.SpottedStar()
    w_np = np.random.default_rng(38).uniform(0.8, 1.2, (C5_WALKERS, 10))
    tn = np.linspace(t[0], t[-1], 300)
    for fn in (C.celerite_forward, C.celerite_adjoint, C.celerite_solve, K.kalman_blocked):
        fn.launches = 0
    # the likelihood and its gradient for the 64 walkers (G1, G2), and
    # predict (G1, G3) for walker 0, card against the CPU port in f64
    card_cpu = {}
    for kind in ("rot_gran", "brown_rot"):
        def run(device, kind=kind):
            w = torch.from_numpy(w_np).to(device, torch.float64).requires_grad_(True)
            tt, yy, diag = (torch.from_numpy(a).to(device) for a in (t, y - y.mean(), dy**2))
            term = wide_term(w, kind)
            ll = log_likelihood(term, tt, diag, yy)
            (g,) = torch.autograd.grad(ll.sum(), w)
            w0 = torch.from_numpy(w_np[0]).to(device).requires_grad_(True)
            gp = GaussianProcess(wide_term(w0, kind)).compute(tt, diag=diag)
            mu, var = gp.predict(yy, t=torch.from_numpy(tn).to(device), return_var=True)
            return term_width(term), [x.detach().cpu() for x in (ll, g, mu, var)]

        r, got = run(dev)
        _, want = run("cpu")
        rel = {name: float((a - b).abs().max() / b.abs().max())
               for name, a, b in zip(("ll", "grad", "predict_mean", "predict_var"), got, want)}
        card_cpu[kind] = {"R": r, "rel_vs_cpu": rel}
        check(r == {"rot_gran": 12, "brown_rot": 14}[kind], f"{kind}: R = {r}")
        check(max(rel.values()) <= F64_LL_REL, f"{kind} (R = {r}) card vs CPU: {rel}")
        print(f"phase 38 {kind} (R = {r}, SpottedStar, {C5_WALKERS} walkers, f64): card vs CPU "
              + ", ".join(f"{k} {v:.1e}" for k, v in rel.items()) + f" (limit {F64_LL_REL})")
    out["card_vs_cpu"] = card_cpu

    # one row of the R = 12 term at config 7's long points, f32 and f64,
    # against the f64 scan within phase 32's limits (a batch of one row keeps
    # every SHO masked under no_grad)
    w1 = {dt: torch.from_numpy(w_np[:1]).to(dev, dt) for dt in (torch.float32, torch.float64)}
    long_pts = {}
    rng7 = np.random.default_rng(38)
    for n, name in ((C7_SOLVER_NS[1], "blocked"), (C7_CHUNKED_N, "chunked")):
        def solve(term, tt, d, yy, n=n, name=name):
            if name == "blocked":
                return log_likelihood_blocked(term, tt, d, yy, n_blocks=c7_blocks(n))
            return log_likelihood_chunked(term, tt, d, yy, chunk=C7_CHUNK,
                                          inner_blocks=C7_INNER)

        t7, y7 = c7_series(rng7, n)
        tt, yy = cuda(t7), cuda(y7)
        diag = torch.full_like(tt, 0.01)
        with torch.no_grad():
            terms = {dt: wide_term(w, "rot_gran") for dt, w in w1.items()}
            ref = float(log_likelihood(terms[torch.float64], tt.double(), diag.double(),
                                       yy.double()))
            ll64 = float(solve(terms[torch.float64], tt.double(), diag.double(), yy.double()))
            with full_float32():
                ll32 = float(solve(terms[torch.float32], tt, diag, yy))
        rel64, rel32 = abs(ll64 - ref) / abs(ref), abs(ll32 - ref) / abs(ref)
        long_pts[f"{name}_N{n}"] = {"R": term_width(terms[torch.float64]), "ll_f64_scan": ref,
                                    "f64_rel": rel64, "f32_rel": rel32}
        check(term_width(terms[torch.float32]) == 12, "one row of rot_gran is R = 12")
        check(rel64 <= F64_LL_REL and rel32 <= F32_LL_REL_LONG[n],
              f"R = 12 {name} N={n}: f64 rel {rel64:.2e} (limit {F64_LL_REL}), f32 rel "
              f"{rel32:.2e} (limit {F32_LL_REL_LONG[n]}) to the f64 scan")
        print(f"phase 38 rot_gran (R = 12, one row) {name} N={n}: to the f64 scan, f64 "
              f"{rel64:.2e} (limit {F64_LL_REL}), f32 {rel32:.2e} (limit "
              f"{F32_LL_REL_LONG[n]})")
    out["long"] = long_pts
    path = {"celerite_forward": C.celerite_forward.launches,
            "celerite_adjoint": C.celerite_adjoint.launches,
            "celerite_solve": C.celerite_solve.launches, "kalman_blocked": K.kalman_blocked.launches}
    check(all(v > 0 for v in path.values()), f"phase 38 launched every GP kernel: {path}")
    out["launches"] = path
    print("phase 38 launches (counted from zero): " + ", ".join(f"{k} {v}" for k, v in path.items()))

    # rates: config 5's batched likelihood (k = 10 chained, 64 walkers) at
    # R = 6 (its BrownianTerm), 12 and 14; config 7's blocked point at N =
    # 1e5 (one row, f32) with its live BrownianTerm (R = 4) and at R = 12
    rates = {}
    tt64, yy64, dg64 = (torch.from_numpy(a).to(dev) for a in (t, y - y.mean(), dy**2))
    for dt, dname in ((torch.float32, "f32"), (torch.float64, "f64")):
        tt, yy, diag = (x.to(dt) for x in (tt64, yy64, dg64))
        w0 = torch.from_numpy(w_np).to(dev, dt)
        makes = {"config5_R6": lambda ws: BrownianTerm(0.01 * ws[:, 0], 20.0 * ws[:, 1],
                                                       10.0 * ws[:, 2], 0.3 * ws[:, 3]),
                 "rot_gran": lambda ws: wide_term(ws, "rot_gran"),
                 "brown_rot": lambda ws: wide_term(ws, "brown_rot")}
        for key, make in makes.items():
            def evaluate(ws, make=make, tt=tt, yy=yy, diag=diag):
                return log_likelihood(make(ws), tt, diag, yy)

            def chained(k=C5_K, w0=w0, evaluate=evaluate):
                ws, acc = w0, torch.zeros((), dtype=w0.dtype, device=dev)
                for _ in range(k):
                    lls = evaluate(ws)
                    ws = ws + lls[:, None] * 1e-12
                    acc = acc + lls[0]
                return acc

            with torch.no_grad():
                chained(1)
                ms = statistics.median(event_ms(chained, 1) for _ in range(3)) / C5_K
                work, wall = profiled(lambda: evaluate(w0), pad=2)
            g1 = sum(us for name, us in work if "celerite_forward" in name) / 1e3
            rates[f"{key}_{dname}"] = {
                "R": term_width(make(w0)), "ms_per_batch": ms,
                "evals_per_s": C5_WALKERS / (ms / 1e3), "launches_per_eval": len(work),
                "busy_share": sum(us for _, us in work) / 1e6 / wall, "g1_device_ms": g1}
    with torch.no_grad(), full_float32():
        t7, y7 = c7_series(np.random.default_rng(0), C7_SOLVER_NS[1])
        tt, yy = cuda(t7), cuda(y7)
        diag = torch.full_like(tt, 0.01)
        nb = c7_blocks(tt.shape[0])
        for key, term in (("config7_blocked_R4", BrownianTerm(0.01, 20.0, 10.0, 0.3)),
                          ("blocked_rot_gran", wide_term(w1[torch.float32], "rot_gran"))):
            def chained(term=term):
                y0, acc = yy, torch.zeros((), dtype=torch.float32, device=dev)
                for _ in range(C7_K):
                    ll = log_likelihood_blocked(term, tt, diag, y0, n_blocks=nb)
                    y0 = y0 + ll * 1e-12
                    acc = acc + ll
                return acc

            chained()
            ms = statistics.median(event_ms(chained, 1) for _ in range(2)) / C7_K
            work, wall = profiled(lambda term=term: log_likelihood_blocked(
                term, tt, diag, yy, n_blocks=nb), pad=1)
            rates[f"{key}_f32"] = {
                "R": term_width(term), "ms": ms, "evals_per_s": 1e3 / ms,
                "launches_per_eval": len(work), "busy_share": sum(us for _, us in work) / 1e6 / wall,
                "k1_device_ms": sum(us for name, us in work if "kalman" in name) / 1e3}
    out["rates"] = rates
    for key, v in rates.items():
        dev_ms = v.get("g1_device_ms", v.get("k1_device_ms"))
        print(f"phase 38 rate {key} (R = {v['R']}): {v['evals_per_s']:.4e} evals/s, "
              f"{v['launches_per_eval']} launches an evaluation, busy {v['busy_share']:.1%}, "
              f"{'G1' if 'g1_device_ms' in v else 'K1'} {dev_ms:.4f} ms device  ({card})")

    # G1, G2, G3 at R = 12 (rot_gran) and 16 (rot_rot) at config 5's shape,
    # f64 and f32: bit-equal to plain, events, device, plain, chain bound
    for kind in ("rot_gran", "rot_rot"):
        for dt in (torch.float64, torch.float32):
            dname = "float64" if dt == torch.float64 else "float32"
            w = torch.from_numpy(w_np).to(dev, dt)
            tt, yy, diag = (x.to(dt) for x in (tt64, yy64, dg64))
            term = wide_term(w, kind)
            (A, U, V, P, yb), _ = _rows(*celerite_matrices(term, tt, diag), yy)
            A, U, V, P, yb = (x.contiguous() for x in (A, U, V, P, yb))
            b, n, r = U.shape
            pre = f"r{r}_" if dt == torch.float64 else f"f32_r{r}_"
            elem = A.element_size()
            kk = r * (r + 1) // 2
            got = C.celerite_forward(A, U, V, P, yb, save=True)
            want = C.celerite_forward_plain(*(x.cpu() for x in (A, U, V, P, yb)), save=True)
            check(all(same_bits(a, w_) for a, w_ in zip(got, want)), f"G1 at R = {r} {dname}")
            D, W, z, S_saved, f_saved = got
            rng = np.random.default_rng(r)
            dD, dz = (torch.from_numpy(rng.standard_normal((b, n))).to(dev, dt) for _ in range(2))
            adj = (U, P, D, W, z, S_saved, f_saved, dD, dz)
            check(all(same_bits(a, w_) for a, w_ in zip(
                C.celerite_adjoint(*adj), C.celerite_adjoint_plain(*(x.cpu() for x in adj)))),
                f"G2 at R = {r} {dname}")
            Y = torch.from_numpy(rng.standard_normal((n, n))).to(dev, dt)
            solve_args = (U[0], P[0], D[0], W[0])
            check(same_bits(C.celerite_solve(*solve_args, Y),
                            C.celerite_solve_plain(*(x.cpu() for x in (*solve_args, Y)))),
                  f"G3 at R = {r} {dname}")
            g1 = lambda: C.celerite_forward(A, U, V, P, yb, want_w=False)  # noqa: E731
            g2 = lambda: C.celerite_adjoint(*adj)  # noqa: E731
            g3 = lambda: C.celerite_solve(*solve_args, Y)  # noqa: E731
            y1 = Y[:, :1].contiguous()
            g31 = lambda: C.celerite_solve(*solve_args, y1)  # noqa: E731
            a = attrs[f"{'f64' if dt == torch.float64 else 'f32'}_r{r}"]["celerite"]
            for name, fn, kname, reps, plain, nbytes, chain, att in (
                    ("celerite_forward", g1, "celerite_forward_kernel", 10,
                     lambda: C.celerite_forward_plain(A, U, V, P, yb),
                     elem * b * (n + 2 * n * r + (n - 1) * r + n + 2 * n),
                     n * g1_chain_ops(r), a["forward_y"]),
                    ("celerite_adjoint", g2, "celerite_adjoint_kernel", 5,
                     lambda: C.celerite_adjoint_plain(*adj),
                     elem * b * (n * r + (n - 1) * r + 3 * n + n * r + (n - 1) * (kk + r)
                                 + 2 * n + n + 2 * n * r + (n - 1) * r + n),
                     n * g2_chain_ops(r), a["adjoint"]),
                    ("celerite_solve", g3, "celerite_solve_kernel", 3,
                     lambda: C.celerite_solve_plain(*solve_args, Y),
                     elem * (3 * n * r + n + 2 * n * n), n * g3_chain_ops(r), a["solve"])):
                rec = recs[name]
                rec[f"{pre}ms"] = event_ms(fn, reps)
                rec[f"{pre}device_ms"] = device_us(fn, kname, 3) / 1e3
                rec[f"{pre}plain_ms"] = plain_wall_ms(plain)
                rec[f"{pre}bound_ms"], rec[f"{pre}bound_by"] = chain_bound(
                    nbytes, chain, dname, clock_hz)
                rec[f"{pre}local_bytes"], rec[f"{pre}registers"] = (att["local_bytes"],
                                                                   att["registers"])
            g1l, g2l, g3l, g3l1, failed = dense_gp_yardsticks(term, tt, diag,
                                                             yy.expand(b, n).contiguous(), Y)
            recs["celerite_forward"][f"{pre}library_ms"] = g1l
            recs["celerite_forward"][f"{pre}library_failed_rows"] = failed
            recs["celerite_adjoint"][f"{pre}library_ms"] = g2l
            recs["celerite_solve"][f"{pre}library_ms"] = g3l
            recs["celerite_solve"][f"{pre}k1_library_ms"] = g3l1
            rec = recs["celerite_solve"]
            rec[f"{pre}k1_ms"] = event_ms(g31, 10)
            rec[f"{pre}k1_device_ms"] = device_us(g31, "celerite_solve_kernel", 3) / 1e3
            rec[f"{pre}k1_bound_ms"], rec[f"{pre}k1_bound_by"] = chain_bound(
                elem * (3 * n * r + n + 2 * n), n * g3_chain_ops(r), dname, clock_hz)
            print(f"phase 38 {kind} (B={b}, N={n}, R={r}, {dname}), bit-equal to plain: "
                  + "; ".join(f"{nm} {recs[nm][pre + 'ms']:.4f} ms (device "
                              f"{recs[nm][pre + 'device_ms']:.4f}, plain "
                              f"{recs[nm][pre + 'plain_ms']:.1f}, bound "
                              f"{recs[nm][pre + 'bound_ms']:.4f} {recs[nm][pre + 'bound_by']}, "
                              f"local {recs[nm][pre + 'local_bytes']} B, "
                              f"{recs[nm][pre + 'registers']} registers)"
                              for nm in ("celerite_forward", "celerite_adjoint", "celerite_solve"))
                  + f"; G3 K=1 {recs['celerite_solve'][pre + 'k1_ms']:.4f} ms (device "
                  f"{recs['celerite_solve'][pre + 'k1_device_ms']:.4f}); dense yardsticks: "
                  f"batched cholesky_ex + solve_triangular {g1l:.4f} ms ({failed} walkers not "
                  f"factored), its autograd backward {g2l:.4f} ms, cholesky_solve K={n} "
                  f"{g3l:.4f} ms, K=1 {g3l1:.4f} ms  ({card})")

    # K1 at config 7's N = 1e5 blocked point (one row, 390 blocks, f32) at
    # R = 12 and 16: bit-equal to plain, events, device, plain, chain bound
    rec = recs["kalman_blocked"]
    t7, y7 = c7_series(np.random.default_rng(0), C7_SOLVER_NS[1])
    tt, yy = cuda(t7), cuda(y7)
    nb = c7_blocks(tt.shape[0])
    for kind in ("rot_gran", "rot_rot"):
        with torch.no_grad(), full_float32():
            coeffs, tc, dd, yc, batch = pscan._prepared(wide_term(w1[torch.float32], kind), tt,
                                                        torch.full_like(tt, 0.01), yy)
            dtc = torch.cat([tc.new_zeros(1), torch.diff(tc)])
            A, Q, H, d, yk = pscan._k1_inputs(coeffs, dtc, dd, yc, batch, True)
        n, r = A.shape[1], A.shape[-1]
        pre = f"r{r}_N{n}_"
        fn = lambda: K.kalman_blocked(A, Q, H, d, yk, nb)  # noqa: E731
        got = fn()
        t0 = time.perf_counter()
        want = K.kalman_blocked_plain(*(x.cpu() for x in (A, Q, H, d, yk)), nb)
        rec[f"{pre}plain_ms"] = (time.perf_counter() - t0) * 1e3
        check(all(same_bits(a, w_) for a, w_ in zip((got[0], got[1], *got[2]),
                                                    (want[0], want[1], *want[2]))),
              f"K1 at R = {r}, N = {n}: bit-equal to plain")
        rec[f"{pre}ms"] = event_ms(fn, 5)
        work, _ = profiled(fn, reps=2)
        rec[f"{pre}device_ms"] = sum(us for name, us in work if "kalman" in name) / 2 / 1e3
        geo = K.kernel_geometry(1, n, r, nb, False, A.dtype)
        rec[f"{pre}bound_ms"], rec[f"{pre}bound_by"] = chain_bound(
            A.element_size() * n * (2 * r * r + 4),
            (geo["length"] + K.tree_levels(geo["blocks"] + 1) + 1) * k1_chain_ops(r), "float32",
            clock_hz)
        stages = attrs[f"f32_r{r}"]["kalman"]
        rec[f"{pre}local_bytes"] = {k: v["local_bytes"] for k, v in stages.items()}
        rec[f"{pre}registers"] = {k: v["registers"] for k, v in stages.items()}
        print(f"phase 38 K1 {kind} (R = {r}, one row, N = {n}, {nb} blocks, f32), bit-equal to "
              f"plain: {rec[pre + 'ms']:.4f} ms (device {rec[pre + 'device_ms']:.4f}, plain "
              f"{rec[pre + 'plain_ms']:.1f}, bound {rec[pre + 'bound_ms']:.4f} "
              f"{rec[pre + 'bound_by']}; local bytes {rec[pre + 'local_bytes']}, registers "
              f"{rec[pre + 'registers']})  ({card})")
    for name in ("celerite_forward", "celerite_adjoint", "celerite_solve", "kalman_blocked"):
        recs[name]["widths"] = [1, C.MAX_R]
        recs[name]["wide_launches"] = path[name]
    print(json_line({"wide": out}))


if __name__ == "__main__":
    sys.exit(main())
