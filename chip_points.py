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

runs the groups named (``fold``, ``celerite``, ``kalman``, ``recursions``;
all by default). It prints one JSON line: LABEL, the card and each point's
times. To compare two commits on one card, unpack the other with ``git
archive`` into a git-ignored directory and run this file from each root in
turns (parent, change, change, parent) in one call; it uses only entry
points both sides have.
"""

import json
import statistics
import sys

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
    import time

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


GROUPS = {"fold": fold_points, "celerite": celerite_points, "kalman": kalman_points,
          "recursions": recursion_points}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_points.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else "",
           "card": torch.cuda.get_device_name(0)}
    for name in sys.argv[2:] or GROUPS:
        GROUPS[name](dev, out)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
