"""Multi-card check of the parallel package: D ranks, one process a card,
through NCCL.

Run from the root of a checkout on a machine with several GPUs::

    python3 -c "from periodicity_tpu_torch.ops import _kernels; _kernels.build()"
    torchrun --nproc-per-node=4 chip_smoke_multi.py

Every rank drives the sharded paths at the one-card smoke's shapes and
holds each against the same D ranks' stages run in turn on its own card
(``chip_smoke.in_turn_*``, which ``chip_smoke.py`` phase 37 holds against
the CPU): the GLS bench shape through B1, config 11's BLS through B2, the
distributed FFT of 2^24 f32 and 2^22 f64 samples and the f64 ACF. The
checks that do not depend on the world size are ``chip_smoke.py``'s own,
called with this run's meshes: config 7's likelihood points through K1
(``sharded_ll_points``), the sampler's moment test (``sharded_moments``)
and the sharded modeler on SpottedStar (``sharded_modeler``). Each sharded
call's kernel launches are counted around it and held. Rank 0 prints the
times of the sharded calls beside the one-card calls and a ``{"multi":
...}`` line; any failed check exits non-zero.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np


def main():
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available() or "LOCAL_RANK" not in os.environ:
        print("chip_smoke_multi: run under torchrun on a machine with GPUs", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.models.phase import bls_scan
    from periodicity_tpu_torch.ops.fold import fold_onehot
    from periodicity_tpu_torch.ops.grid2 import extirpolate_grid_factored
    from periodicity_tpu_torch.parallel import (default_mesh, distributed_acf, distributed_fft,
                                                multihost_mesh, sharded_bls, sharded_gls)
    from periodicity_tpu_torch.spectral import gls_power

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = default_mesh(("grid",))
    rank, d = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    cs.check(dev.index == int(os.environ["LOCAL_RANK"]) and dist.get_backend() == "nccl",
             f"rank {rank} on card {dev.index} through NCCL")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "ranks": d}
    tally = {}
    start = time.perf_counter()

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def timed(name, sharded, one_card, reps=1):
        """Event times of the sharded call (every rank at once) and of the
        one-card call, in turns, a barrier before each."""
        out.setdefault("ms", {})[name] = cs.turns_ms(sharded, one_card, reps, dist.barrier)

    # the GLS bench shape: each rank's sub-band through B1
    t, y, err = cs.bench_draw()
    tc, yc, ec = cuda(t), cuda(y), cuda(err)
    df = float(np.float32(0.5 / cs.BASELINE))
    fmin = float(np.float32(df / 2))
    got = cs.counted(tally, extirpolate_grid_factored, 3,
                     lambda: sharded_gls(tc, yc, ec, df, fmin, cs.NF, mesh, gridder="kernel"),
                     "sharded_gls on each rank").full_tensor()
    cs.check(cs.bit_equal(got, cs.in_turn_gls(tc, yc, ec, df, fmin, cs.NF, d, "kernel")),
             "sharded_gls over the ranks bit-equal to their stages in turn")
    timed("sharded_gls_bench", lambda: sharded_gls(tc, yc, ec, df, fmin, cs.NF, mesh,
                                                   gridder="kernel"),
          lambda: gls_power(tc, yc, ec, df, fmin, cs.NF, gridder="kernel"), reps=3)

    # config 11's BLS: each rank's periods through B2 (float atomics: held
    # within 1e-5 of the peak, the same best period)
    tb, yb = cs.bls_draw()
    tbc, ybc = cuda(tb), cuda(yb)
    wb = torch.full_like(tbc, 1.0 / cs.BLS_N)
    pb = cuda(np.linspace(0.5, 100.0, cs.BLS_P))
    kw = dict(widths=tuple(max(1, int(round(q * cs.BLS_NBINS))) for q in cs.BLS_DURATIONS),
              nbins=cs.BLS_NBINS, batch_size=cs.BLS_BATCH, binner="kernel")
    got = cs.counted(tally, fold_onehot, -(-(cs.BLS_P // d) // cs.BLS_BATCH),
                     lambda: sharded_bls(tbc, ybc, wb, pb, mesh, **kw),
                     "sharded_bls: one a chunk of each rank's periods")[0].full_tensor()
    want = cs.in_turn_bls(tbc, ybc, wb, pb, d, **kw)[0]
    d_bls = float((got - want).abs().max() / want.abs().max())
    cs.check(d_bls <= 1e-5 and int(torch.argmax(got)) == int(torch.argmax(want)),
             f"sharded_bls over the ranks vs their stages in turn: {d_bls:.2e}")
    out["bls_rel"] = d_bls
    timed("sharded_bls_config11", lambda: sharded_bls(tbc, ybc, wb, pb, mesh, **kw),
          lambda: bls_scan(tbc, ybc, wb, pb, **kw))

    # the distributed FFT through NCCL's all_to_all, and the ACF
    smesh = default_mesh(("seq",))
    for dname, n in cs.PAR_FFT_N.items():
        x = torch.randn(n, dtype=torch.float64, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(38)).to(
            getattr(torch, dname))
        X = distributed_fft(x, smesh).full_tensor()
        ref = cs.in_turn_fft(x, d)
        d_fft = float((X - ref).abs().max() / ref.abs().max())
        cs.check(d_fft <= (1e-12 if dname == "float64" else 1e-6),
                 f"distributed_fft {dname} over the ranks vs their stages: {d_fft:.2e}")
        out[f"fft_{dname}"] = {"rel_vs_stages": d_fft, "bit_equal": cs.bit_equal(
            torch.view_as_real(X), torch.view_as_real(ref))}
        timed(f"distributed_fft_{dname}_N{n}", lambda x=x: distributed_fft(x, smesh),
              lambda x=x, cd=X.dtype: torch.fft.fft(x.to(cd)), reps=3)
        if dname == "float64":
            yv = torch.sin(2 * math.pi * torch.arange(n, device=dev, dtype=torch.float64) / 64) \
                + 0.2 * x
            acf = distributed_acf(yv, smesh, max_lag=n // 2)
            ref = TSeries(torch.arange(n, dtype=torch.float64, device=dev), yv).acf(
                max_lag=n // 2).values
            d_acf = float((acf - ref).abs().max())
            cs.check(d_acf <= cs.PAR_F64_ACF, f"distributed_acf f64: {d_acf:.2e}")
            out["acf_f64_abs"] = d_acf

    # the checks the one-card smoke makes, over this run's ranks
    out["config7"] = cs.sharded_ll_points(smesh, cuda, tally, timed)
    acc, m_err, s_rel = cs.sharded_moments(default_mesh(("walkers",)), dev)
    out["sampler"] = {"acceptance": acc, "mean_abs": m_err, "std_rel": s_rel}
    out["modeler_nll_rel"], out["modeler_grad_rel"] = cs.sharded_modeler(smesh, cuda, tally)
    out["launches"] = tally

    os.environ.setdefault("LOCAL_WORLD_SIZE", str(d))
    mh = multihost_mesh(device=None)
    cs.check(tuple(mh.mesh.shape) == (d // int(os.environ["LOCAL_WORLD_SIZE"]),
                                      int(os.environ["LOCAL_WORLD_SIZE"])),
             f"multihost_mesh: {tuple(mh.mesh.shape)}")
    out["wall_s"] = time.perf_counter() - start
    dist.barrier()
    if rank == 0:
        for name, v in out["ms"].items():
            print(f"{d} ranks {name}: sharded {v['sharded']:.4f} ms, one card "
                  f"{v['unsharded']:.4f} ms  ({card})")
        print(json.dumps({"multi": out}))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
