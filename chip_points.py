"""The kernel points a change to the fold or the GP kernels may move, from
the checkout it runs in.

Run from the root of a checkout on a machine with a card:

    python3 chip_points.py LABEL

With that checkout's package and ``chip_smoke.py`` helpers it times:
- B2 (``fold_onehot``) at config 11: one 512-period chunk as the scan
  launches it (the profiler's device time a launch over 50 launches, CUDA
  events over 200 back to back) and one launch of all 1e5 periods (events
  over 20);
- config 11's BLS scan through the kernel binner, 3 chained scans (events,
  the median of 3 runs), ms a scan;
- G1 (``celerite_forward``, without the saved state) and G2
  (``celerite_adjoint``) at config 5 (64 walkers, N = 2148, the masked
  BrownianTerm, R = 6) in float32 and float64: device time a launch over 5
  and events over 10;
- K1 (``kalman_blocked``, one row, the live BrownianTerm, R = 4, float32)
  at config 7's blocked points, N = 1e4 over 39 blocks and N = 1e5 over
  390, and at its chunked shape (the second chunk of the N = 1e6 series,
  65536 samples over 512 blocks, from the first chunk's carry): events over
  10 and the profiler's device time by stage over 3;
- R2 (``pentadiagonal_solve``) on SpottedStar's smoothing-spline system at
  lam = 1 (m = 2146) in float64 and float32, and R1 (``sosfilt``) over
  SpottedStar's float64 odd extension in the GP prior's band (5 sections,
  2214 steps) at 1 row and at 64: the profiler's device time a launch over
  10 and events over 20;
- one ``TSeries.interp(method="spline", s=...)`` on SpottedStar (float64):
  wall time (median of 3), R2 launches, and R2's share of a profiled call's
  wall time; one GP-prior ACF ladder (``acf_period_quality`` at every
  default cutoff, float64): wall time (median of 3) and R1 launches.

    python3 chip_points.py LABEL [GROUP ...]

runs the groups named (``fold``, ``celerite``, ``kalman``, ``recursions``,
``amfm``; all by default; ``amfm_split`` and ``amfm_sources`` only when
named: N1's stage split from a build with ``-DAMFM_SPLIT``, and copies of
``amfm.cu`` timed against each other, see their functions). It prints
one JSON line: LABEL, the card and each point's times. To compare two commits on one card, unpack the other with ``git
archive`` into a git-ignored directory and run this file from each root in
turns (parent, change, change, parent) in one call; it uses only entry
points both sides have.
"""

import json
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from periodicity_tpu_torch.models.gp import pscan  # noqa: E402
from periodicity_tpu_torch.models.gp.terms import BrownianTerm  # noqa: E402
from periodicity_tpu_torch.models.phase import bls_scan  # noqa: E402
from periodicity_tpu_torch.ops import celerite as C  # noqa: E402
from periodicity_tpu_torch.ops import kalman as K  # noqa: E402
from periodicity_tpu_torch.ops.fold import fold_onehot  # noqa: E402
from periodicity_tpu_torch.utils.dtypes import full_float32  # noqa: E402

CHUNK, INNER = 65536, 512


def k1_operands(term, t, y, lo, hi, first, dev):
    """K1's operands for samples [lo, hi) of the series (t, y)."""
    tt, yy = torch.from_numpy(t).to(dev), torch.from_numpy(y).to(dev)
    with full_float32():
        coeffs, tc, dd, yc, batch = pscan._prepared(term, tt, torch.full_like(tt, 0.01), yy)
        dtc = torch.cat([tc.new_zeros(1), torch.diff(tc)])
        return pscan._k1_inputs(coeffs, dtc[lo:hi], dd[..., lo:hi], yc[..., lo:hi], batch,
                                first)


def fold_points(dev, out):
    t, y = cs.bls_draw()
    w = np.full(cs.BLS_N, 1.0 / cs.BLS_N, np.float32)
    wyc = (w * (y - np.sum(w * y))).astype(np.float32)
    tc = torch.from_numpy(t).to(dev)
    vals = torch.from_numpy(np.stack([w, wyc])).to(dev)
    periods = np.linspace(0.5, 100.0, cs.BLS_P)
    freqs = 1.0 / torch.from_numpy(periods).to(dev)
    chunk = freqs[:cs.BLS_BATCH].contiguous()
    one = lambda: fold_onehot(tc, vals, chunk, cs.BLS_NBINS)  # noqa: E731
    whole = lambda: fold_onehot(tc, vals, freqs, cs.BLS_NBINS)  # noqa: E731
    one()
    whole()
    out["b2_chunk_device_us"] = cs.device_us(one, "fold_kernel", 50)
    out["b2_chunk_events_us"] = cs.event_ms(one, 200) * 1e3
    out["b2_all_periods_ms"] = cs.event_ms(whole, 20)
    yc, wc = torch.from_numpy(y).to(dev), torch.from_numpy(w).to(dev)
    pc = torch.from_numpy(periods.astype(np.float32)).to(dev)

    def chained(k=3):
        yk = yc
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(k):
            p, _, _, _ = bls_scan(tc, yk, wc, pc, widths=cs.BLS_WIDTHS, nbins=cs.BLS_NBINS,
                                  batch_size=cs.BLS_BATCH, binner="kernel")
            yk = yk + p[0] * 1e-9
            acc = acc + p[:8].sum()
        return acc

    chained(1)
    out["bls_scan_ms"] = statistics.median(cs.event_ms(chained, 1) / 3 for _ in range(3))


def celerite_points(dev, out):
    for dtype, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        (A, U, V, P, y), _ = cs.c5_inputs(dev, dtype)
        g1 = lambda: C.celerite_forward(A, U, V, P, y, want_w=False)  # noqa: E731
        D, W, z, S_saved, f_saved = C.celerite_forward(A, U, V, P, y, save=True)
        rng = np.random.default_rng(5)
        dD, dz = (torch.from_numpy(rng.standard_normal(A.shape)).to(dev, dtype) for _ in range(2))
        g2 = lambda: C.celerite_adjoint(U, P, D, W, z, S_saved, f_saved, dD, dz)  # noqa: E731
        for key, fn, kernel in (("g1", g1, "celerite_forward_kernel"),
                                ("g2", g2, "celerite_adjoint_kernel")):
            fn()
            out[f"{key}_{name}_device_ms"] = cs.device_us(fn, kernel, 5) / 1e3
            out[f"{key}_{name}_ms"] = cs.event_ms(fn, 10)


def kalman_points(dev, out):
    term = BrownianTerm(0.01, 20.0, 10.0, 0.3)
    points = []
    rng = np.random.default_rng(0)
    for n in (10_000, 100_000):
        t, y = cs.c7_series(rng, n)
        points.append((f"k1_N{n}", k1_operands(term, t, y, 0, n, True, dev), cs.c7_blocks(n),
                       None))
    t, y = cs.c7_series(np.random.default_rng(0), 2 * CHUNK)
    carry = K.kalman_blocked(*k1_operands(term, t, y, 0, CHUNK, True, dev), INNER)[2]
    points.append(("k1_chunk", k1_operands(term, t, y, CHUNK, 2 * CHUNK, False, dev), INNER,
                   carry))
    for label, (A, Q, H, d, yb), nb, c in points:
        fn = lambda: K.kalman_blocked(A, Q, H, d, yb, nb, c)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        ms = cs.event_ms(fn, 10)
        work, _ = cs.profiled(fn, reps=3)
        stages = {}
        for name, us in work:
            if "kalman" in name:
                stage = name.split("kalman_")[1].split("_kernel")[0]
                stages[stage] = stages.get(stage, 0.0) + us / 3 / 1e3
        out[label] = {"ms": ms, "device_ms": sum(stages.values()), "stages": stages}


def recursion_points(dev, out):
    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.data import SpottedStar
    from periodicity_tpu_torch.ops import filters, spline

    t, y, dy = SpottedStar()
    tt, yy = torch.from_numpy(t).to(dev), torch.from_numpy(y).to(dev)
    (main, off1, off2), (q0, q1, q2), _ = spline._reinsch_system(tt, 1.0)
    rhs = spline._qt_apply(q0, q1, q2, yy)
    for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        bands = [v.to(dtype) for v in (main, off1, off2, rhs)]
        fn = lambda: spline._pentadiagonal_solve(*bands)  # noqa: E731
        fn()
        out[f"r2_{name}_device_ms"] = cs.device_us(fn, "pentadiagonal_kernel", 10) / 1e3
        out[f"r2_{name}_ms"] = cs.event_ms(fn, 20)
    median_dt = float(np.median(np.diff(t)))
    p_min = max(cs.LADDER.min() / 10, 3 * median_dt)
    nyq = 0.5 / median_dt
    sos = filters.butter_sos(5, [(1 / 32) / nyq, (1 / p_min) / nyq], "bandpass")
    edge = filters._padlen(sos)
    ext = torch.cat([2 * yy[0] - torch.flip(yy[1:edge + 1], (0,)), yy,
                     2 * yy[-1] - torch.flip(yy[-(edge + 1):-1], (0,))])
    rows = ext + torch.from_numpy(np.random.default_rng(1).standard_normal((64, 1))).to(dev)
    for key, x in (("r1", ext), ("r1_b64", rows)):
        fn = lambda: filters.sosfilt(sos, x)  # noqa: E731
        fn()
        out[f"{key}_device_ms"] = cs.device_us(fn, "sosfilt_kernel", 10) / 1e3
        out[f"{key}_ms"] = cs.event_ms(fn, 20)

    def wall(fn):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    ts = TSeries(tt, yy)
    new_t = np.linspace(t[0] - 0.5, t[-1] + 0.5, 3001)
    interp = lambda: ts.interp(new_t, method="spline", s=float(np.sum(dy**2)))  # noqa: E731
    before = spline._pentadiagonal_solve.launches
    out["interp_s"] = wall(interp)
    out["interp_r2_launches"] = (spline._pentadiagonal_solve.launches - before) // 4
    work, one = cs.profiled(interp)
    out["interp_r2_share"] = sum(us for n, us in work if "pentadiagonal_kernel" in n) / 1e6 / one
    cutoffs = [p for p in cs.LADDER if p_min < p < (t[-1] - t[0]) / 2]
    ladder = lambda: [ts.acf_period_quality(p_min, p) for p in cutoffs]  # noqa: E731
    before = filters.sosfilt.launches
    out["ladder_s"] = wall(ladder)
    out["ladder_r1_launches"] = (filters.sosfilt.launches - before) // 4


def c9_rows(dev):
    """Config 9's normalization rows at B = 8, 32, 64 on the card, as
    ``hht_batch`` hands them to N1."""
    from periodicity_tpu_torch.models.timefrequency import _normalization_rows
    from periodicity_tpu_torch.ops import emd

    t9, c9 = cs.c9_series()
    tc = torch.from_numpy(t9).to(dev)
    rows = {}
    for b, ys in c9.items():
        modes, _, n_modes = emd.emd_pool(tc, torch.from_numpy(ys).to(dev), max_modes=cs.C9_MODES)
        rows[b] = _normalization_rows(tc, modes, n_modes)[0].contiguous()
    return tc, c9, rows


def f64_edge_rows(dev, n):
    """Normalization rows of n samples in float64, as ``hht_batch`` hands
    them to N1: eight of config 9's tones on its sample spacing."""
    from periodicity_tpu_torch.models.timefrequency import _normalization_rows
    from periodicity_tpu_torch.ops import emd

    t = np.linspace(0.0, 20.0 * (n - 1) / (cs.C9_N - 1), n)
    rng = np.random.default_rng(0)
    Y = np.stack([np.sin(2 * np.pi * t * f) + 0.4 * np.sin(2 * np.pi * t * f / 6.0)
                  + 0.05 * rng.standard_normal(n) for f in np.linspace(2.0, 4.0, 8)])
    tc, Yc = torch.from_numpy(t).to(dev), torch.from_numpy(Y).to(dev)
    modes, _, n_modes = emd.emd_pool(tc, Yc, max_modes=cs.C9_MODES)
    return tc, _normalization_rows(tc, modes, n_modes)[0].contiguous()


def c10_stage0(dev):
    """Config 10's first ensemble stage as chip_smoke.py's phase 21 builds
    it: the noise pre-decomposition's first modes, scaled, on the signal."""
    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.ops import emd

    base, _ = cs.c10_signal()
    t10 = torch.arange(float(cs.C10_N), dtype=torch.float64, device=dev)
    noise = torch.from_numpy(
        np.random.default_rng(cs.C10_SEED).standard_normal((cs.C10_E, cs.C10_N))).to(dev)
    pre = emd.sift_machine(t10, noise, max_modes=int(np.log2(cs.C10_N)) + 2)
    sig = TSeries(t10, torch.from_numpy(np.asarray(base)).to(dev))
    rv = (sig / float(np.std(sig))).values
    noise0 = pre[0][:, 0, :]
    has0 = (pre[2] > 0)[:, None]
    s0 = torch.std(noise0, dim=1, keepdim=True, correction=0)
    beta = 0.2 * torch.std(rv, correction=0) / torch.where(s0 > 0, s0, 1.0)
    return t10, (rv[None, :] + torch.where(has0, beta * noise0, 0.0)).contiguous()


def amfm_points(dev, out):
    from periodicity_tpu_torch.ops import _kernels, emd, hht
    from periodicity_tpu_torch.timefrequency import hht_batch

    tc, c9, rows = c9_rows(dev)
    shapes = [(f"n1_b{b}_f32", tc, X) for b, X in rows.items()]
    shapes.append(("n1_b8_f64", tc.double(), rows[8].double()))
    for key, t, X in shapes:
        fn = lambda: hht._am_fm_cuda(t, X, 10, 2, 1e-6)  # noqa: E731
        fn()
        out[f"{key}_device_ms"] = cs.device_us(fn, "amfm_kernel", 5, pad=16) / 1e3
        out[f"{key}_ms"] = cs.event_ms(fn, 10)
    # float64 rows of N = 3400: in global scratch where a row's arrays hold t
    # (from N ~ 3180), in shared memory where they do not (up to N ~ 3600)
    te, Xe = f64_edge_rows(dev, 3400)
    out["n1_f64_n3400_scratch_bytes"] = int(_kernels.load().amfm_scratch_bytes(3400, 2, 8))
    fn = lambda: hht._am_fm_cuda(te, Xe, 10, 2, 1e-6)  # noqa: E731
    fn()
    out["n1_f64_n3400_device_ms"] = cs.device_us(fn, "amfm_kernel", 5, pad=16) / 1e3
    out["n1_f64_n3400_ms"] = cs.event_ms(fn, 10)
    for b in (8, 64):
        Yb = torch.from_numpy(c9[b]).to(dev)
        s1 = lambda: emd.sift_machine(tc, Yb, max_modes=cs.C9_MODES)  # noqa: E731
        s1()
        out[f"s1_b{b}_device_ms"] = cs.device_us(s1, "emd_sift_kernel", 3) / 1e3
    t10, stage0 = c10_stage0(dev)
    s1 = lambda: emd.sift_machine(t10, stage0, max_modes=1)  # noqa: E731
    s1()
    out["s1_c10_stage0_device_ms"] = cs.device_us(s1, "emd_sift_kernel", 3) / 1e3
    grid = np.linspace(*cs.C9_GRID).astype(np.float32)
    for b in (8, 64):
        Y = torch.from_numpy(c9[b]).to(dev)
        hht_batch(tc, Y, grid, max_modes=cs.C9_MODES)
        secs = []
        for i in range(3):
            Yi = Y + np.float32(1e-4 * (i + 1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hht_batch(tc, Yi, grid, max_modes=cs.C9_MODES)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[f"hht_batch_b{b}_per_s"] = b / statistics.median(secs)


# csrc/amfm.cu's split slots (kSplitSlots): 0 |F| (fused into the
# division, 0), 1 extrema, 2 knots, 3 solve (Thomas), 4 Hermite and the
# division, 5 the stop test; 6 the knot count, 7 the path, 8 the PCR levels
# run, 9 whether the plateau pass ran, 10 the block solve's row build, 11
# its derivatives, 12-23 its levels one by one
SPLIT_SLOTS, SPLIT_PATHS = 24, ("flat", "thomas", "block")


def split_stages(recs):
    """The stages' cycles of each pass record (a row of SPLIT_SLOTS)."""
    return {"extrema": recs[:, 1], "knots": recs[:, 2],
            "solve": recs[:, 3] + recs[:, 10] + recs[:, 11] + recs[:, 12:].sum(1),
            "hermite_div": recs[:, 4], "stop": recs[:, 5]}


def build_amfm(src, name, *flags):
    """amfm.cu (or a copy of it) built alone into build/amfm_split/,
    with the package's csrc on the include path: (library, ptxas report)."""
    import ctypes
    import subprocess
    from pathlib import Path

    from periodicity_tpu_torch.ops import _kernels

    lib_dir = Path("build") / "amfm_split"
    lib_dir.mkdir(parents=True, exist_ok=True)
    so = lib_dir / f"lib{name}.so"
    proc = subprocess.run([_kernels._nvcc(), *_kernels._ARCH, "-shared", *flags, "-I",
                           str(_kernels.CSRC), "-Xptxas", "-v", "-o", str(so), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src} {flags} failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so.resolve()))
    for fn in ("amfm_normalize_f32", "amfm_normalize_f64", "amfm_scratch_bytes"):
        getattr(lib, fn).argtypes = _kernels.ENTRY_POINTS[fn]
    return lib, proc.stderr


def lib_launch(lib, t, X):
    """A launch of a library built by build_amfm on (t, X) at config 9's
    settings (10 passes, pad width 2, eps 1e-6), and its outputs (A, F,
    passes)."""
    n = X.shape[1]
    A, F = torch.empty_like(X), torch.empty_like(X)
    passes = torch.empty(X.shape[0], dtype=torch.int32, device=X.device)
    per_row = lib.amfm_scratch_bytes(n, 2, X.element_size())
    scratch = torch.empty(max(per_row, 0) * X.shape[0], dtype=torch.uint8, device=X.device)
    fn = lib.amfm_normalize_f64 if X.dtype == torch.float64 else lib.amfm_normalize_f32

    def run():
        err = fn(t.data_ptr(), X.data_ptr(), n, X.shape[0], 10, 2, 1e-6, A.data_ptr(),
                 F.data_ptr(), passes.data_ptr(), scratch.data_ptr() if per_row else None, None)
        if err != 0:
            raise RuntimeError(f"amfm launch failed: cudaError {err}")
    return run, (A, F, passes)


def lib_attributes(lib):
    """Local bytes and registers of each instance of a library built by
    build_amfm (its amfm_kernel_attributes), or None where it has none."""
    import ctypes

    if not hasattr(lib, "amfm_kernel_attributes"):
        return None
    out = {}
    for elem, key in ((4, "f32"), (8, "f64")):
        buf = (ctypes.c_int * 6)()
        if lib.amfm_kernel_attributes(elem, buf) != 0:
            raise RuntimeError("amfm_kernel_attributes failed")
        for i, inst in enumerate(("shared", "global")):
            out[f"{key}_{inst}"] = {"local_bytes": buf[3 * i], "registers": buf[3 * i + 1]}
    return out


def amfm_split_points(dev, out):
    import ctypes

    from periodicity_tpu_torch.ops import _kernels

    src = _kernels.CSRC / "amfm.cu"
    if "AMFM_SPLIT" not in src.read_text():
        out["amfm_split"] = None
        return
    lib, ptxas = build_amfm(src, "amfm_split", "-DAMFM_SPLIT")
    rows_, passes_ = 512, 16
    buf = (ctypes.c_longlong * (rows_ * passes_ * SPLIT_SLOTS))()
    tc, _, rows = c9_rows(dev)
    # the instrumented build's instances: whether a stamp costs registers
    # or spills (the default build is held at 0 B of local memory)
    split = {"ptxas": [line.strip() for line in ptxas.splitlines()
                       if "registers" in line or "spill" in line],
             "attributes": lib_attributes(lib)}
    for name, t, X in (("f32", tc, rows[8]), ("f64", tc.double(), rows[8].double())):
        run, (_, _, passes) = lib_launch(lib, t, X)
        for _ in range(2):
            run()
            torch.cuda.synchronize()
        if lib.amfm_split_read(buf) != 0:
            raise RuntimeError("amfm_split_read failed")
        a = np.frombuffer(buf, dtype=np.int64).reshape(rows_, passes_, SPLIT_SLOTS)
        p = passes.cpu().numpy()
        recs = np.concatenate([a[r, :p[r]] for r in range(X.shape[0])]).astype(float)
        stage = split_stages(recs)
        cycles = sum(stage.values())
        block = recs[:, 7] == SPLIT_PATHS.index("block")
        split[name] = {
            "passes": int(p.sum()), "passes_max": int(p.max()),
            "pass_cycles_mean": float(cycles.mean()),
            "stage_cycles_mean": {k: float(v.mean()) for k, v in stage.items()},
            "paths": {path: int((recs[:, 7] == i).sum()) for i, path in enumerate(SPLIT_PATHS)},
            "plateau_passes": int(recs[:, 9].sum()),
            "block": {"knots_median": float(np.median(recs[block, 6])),
                      "levels_run": int(recs[block, 8].sum()),
                      "levels_full": int(sum(cs.pcr_levels(c) for c in recs[block, 6])),
                      "build": float(recs[block, 10].mean()),
                      "level_by_level": [float(v) for v in recs[block, 12:].mean(0)],
                      "derivatives": float(recs[block, 11].mean()),
                      "solve": float(stage["solve"][block].mean())} if block.any() else None,
            "longest_row_cycles": max(
                float(sum(split_stages(a[r, :p[r]].astype(float)).values()).sum())
                for r in range(X.shape[0])),
        }
    out["amfm_split"] = split


def amfm_sources_points(dev, out):
    """Copies of amfm.cu (the paths in AMFM_SOURCES, separated by ':'),
    each built alone (build_amfm), held bit-equal to the plain version and
    timed in turns (first, second, ..., then in reverse, twice) at config
    9's rows at B = 8 and 64 in float32 and B = 8 in float64: the
    profiler's device time a launch over 5."""
    import os

    from periodicity_tpu_torch.ops import hht

    srcs = [p for p in os.environ.get("AMFM_SOURCES", "").split(":") if p]
    libs = [build_amfm(p, f"amfm_src{i}")[0] for i, p in enumerate(srcs)]
    tc, _, rows = c9_rows(dev)
    res = {p: {"attributes": lib_attributes(lib)} for p, lib in zip(srcs, libs)}
    for key, t, X in (("b8_f32", tc, rows[8]), ("b64_f32", tc, rows[64]),
                      ("b8_f64", tc.double(), rows[8].double())):
        want = hht.am_fm_normalize_plain(t, X, "spline", 10, 2, 1e-6)
        runs = []
        for p, lib in zip(srcs, libs):
            run, got = lib_launch(lib, t, X)
            run()
            torch.cuda.synchronize()
            if not all(cs.same_bits(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"{p}: not bit-equal to plain at {key}")
            runs.append(run)
        order = list(range(len(srcs)))
        for i in order + order[::-1] + order + order[::-1]:
            res[srcs[i]].setdefault(f"{key}_device_ms", []).append(
                cs.device_us(runs[i], "amfm_kernel", 5, pad=16) / 1e3)
    out["amfm_sources"] = res


GROUPS = {"fold": fold_points, "celerite": celerite_points, "kalman": kalman_points,
          "recursions": recursion_points, "amfm": amfm_points}
OPTIONAL = {"amfm_split": amfm_split_points, "amfm_sources": amfm_sources_points}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_points.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else "",
           "card": torch.cuda.get_device_name(0)}
    for name in sys.argv[2:] or GROUPS:
        {**GROUPS, **OPTIONAL}[name](dev, out)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
