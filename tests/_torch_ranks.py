"""Rank worker for the port's multi-process CPU tests (not collected).

Run as ``python tests/_torch_ranks.py SUITE RANK WORLD WORKDIR``: the
process joins a gloo group through a FileStore in WORKDIR (with a timeout
on every collective), reads WORKDIR/inputs.npz, runs every case of SUITE
through the port's public functions and writes WORKDIR/rank<RANK>.npz.
It imports torch and the port only, never JAX: the parent test compares
the results with the JAX package's sharded functions at the same D.

:class:`Ranks` starts the processes from a test and joins them within a
time limit, killing every one on expiry, so a hung rank fails the tests
that read it instead of hanging the suite.
"""

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 60


def _raises(fn):
    """The message of the ValueError ``fn`` raises, or "" when it does not."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def _full(x):
    return x.full_tensor().numpy()


def suite_parallel(inp, out):
    from periodicity_tpu_torch.models.phase import aov_scan
    from periodicity_tpu_torch.parallel import (
        default_mesh,
        distributed_acf,
        distributed_fft,
        distributed_ifft,
        grid_sharding,
        multihost_mesh,
        sharded_acf,
        sharded_aov,
        sharded_bls,
        sharded_conditional_entropy,
        sharded_gls,
        sharded_gregory_loredo,
        sharded_pdm,
        sharded_string_length,
    )
    from torch.distributed.tensor import DTensor

    t, y, err, m, w, periods = (torch.from_numpy(inp[k])
                                for k in ("t", "y", "err", "m", "w", "periods"))
    mesh = default_mesh(("grid",), device="cpu")
    gls = sharded_gls(t, y, err, 0.001, 0.0005, 4096, mesh)
    out["gls"], out["gls_local"] = _full(gls), gls.to_local().numpy()
    t32, y32, err32 = (torch.from_numpy(inp[k]) for k in ("t32", "y32", "err32"))
    out["gls_f32"] = _full(sharded_gls(t32, y32, err32, 1.0 / 500.0, 1.0 / 1000.0, 1500, mesh))
    out["pdm"] = _full(sharded_pdm(t, y, periods, mesh))
    out["string_length"] = _full(sharded_string_length(t, m, periods, mesh))
    out["aov"] = _full(sharded_aov(t, y, periods, mesh))
    out["conditional_entropy"] = _full(sharded_conditional_entropy(t, y, periods, mesh))
    out["gregory_loredo"] = _full(sharded_gregory_loredo(t, periods, mesh))
    for name, v in zip(("power", "depth", "width_idx", "bin_start"),
                       sharded_bls(t, y, w, periods, mesh, widths=(3, 13, 26), nbins=128)):
        out[f"bls_{name}"] = _full(v)
    out["aov_kernel"] = _full(sharded_aov(t, y, periods, mesh, binner="kernel"))
    out["aov_kernel_unsharded"] = aov_scan(t, y, periods, binner="kernel").numpy()
    out["placements"] = np.array([str(p) for p in grid_sharding(mesh)])

    out["acf"] = _full(sharded_acf(torch.from_numpy(inp["y_batch"]),
                                   default_mesh(("batch",), device="cpu")))
    smesh = default_mesh(("seq",), device="cpu")
    x = torch.from_numpy(inp["x"])
    X = distributed_fft(x, smesh)
    out["fft"], out["ifft"] = _full(X), _full(distributed_ifft(X, smesh))
    d, idx = 4, dist.get_rank()
    el = x.shape[0] // d
    xs = DTensor.from_local(x[idx * el:(idx + 1) * el], smesh, grid_sharding(smesh, "seq"))
    out["fft_from_dtensor"] = _full(distributed_fft(xs, smesh))
    out["fft_f32"] = _full(distributed_fft(x.float(), smesh))
    y_acf = torch.from_numpy(inp["y_acf"])
    out["dacf"] = _full(distributed_acf(y_acf, smesh))
    out["dacf_max_lag"] = distributed_acf(y_acf, smesh, max_lag=100).numpy()

    out["err_gls"] = _raises(lambda: sharded_gls(t, y, err, 0.001, 0.0005, 4098, mesh))
    out["err_periods"] = _raises(lambda: sharded_pdm(t, y, periods[:-2], mesh))
    out["err_bls"] = _raises(lambda: sharded_bls(t, y, w, periods[:-2], mesh))
    out["err_fft"] = _raises(lambda: distributed_fft(x[:-2], smesh))
    out["err_acf"] = _raises(lambda: sharded_acf(torch.from_numpy(inp["y_batch"])[:6],
                                                 default_mesh(("batch",), device="cpu")))

    os.environ["LOCAL_WORLD_SIZE"] = "2"
    mh = multihost_mesh(ici_axes=("grid",), dcn_axes=("batch",), device="cpu")
    out["mh_names"] = np.array(mh.mesh_dim_names)
    out["mh_ranks"] = mh.mesh.numpy()
    out["mh_coord"] = np.array([mh.get_local_rank("batch"), mh.get_local_rank("grid")])
    p = sharded_gls(t, y, err, 0.001, 0.0005, 256, mh)
    out["mh_gls_local"], out["mh_gls"] = p.to_local().numpy(), _full(p)
    out["err_mh"] = _raises(lambda: multihost_mesh(ici_shape=(3,), device="cpu"))


def suite_gp(inp, out):
    from periodicity_tpu_torch import TSeries
    from periodicity_tpu_torch.gp import BrownianGP, log_likelihood_sharded
    from periodicity_tpu_torch.models.gp.mcmc import _sharded_chain, run_ensemble_sharded
    from periodicity_tpu_torch.models.gp.terms import RotationTerm, SHOTerm
    from periodicity_tpu_torch.parallel import default_mesh

    f64 = torch.float64
    t, y, diag = (torch.from_numpy(inp[k]) for k in ("t", "y", "diag"))
    terms = {
        "rotation": lambda p: RotationTerm(sigma=p[0], period=p[1], Q0=p[2], dQ=p[3], f=p[4]),
        "sho": lambda p: SHOTerm(sigma=p[0], rho=p[1], Q=p[2]),
    }
    params = {"rotation": [1.2, 7.7, 2.0, 1.0, 0.3], "sho": [0.8, 3.0, 4.0]}
    meshes = {4: default_mesh(("seq",), device="cpu"),
              2: default_mesh(("rep", "seq"), shape=(2, 2), device="cpu")}
    for d, mesh in meshes.items():
        for name, make in terms.items():
            term = make(torch.tensor(params[name], dtype=f64))
            out[f"ll_{name}_D{d}"] = float(log_likelihood_sharded(term, t, diag, y, mesh))
    p = torch.tensor(params["rotation"], dtype=f64, requires_grad=True)
    ll = log_likelihood_sharded(terms["rotation"](p), t, diag, y, meshes[4])
    (out["grad_rotation_D4"],) = (g.numpy() for g in torch.autograd.grad(ll, p))
    out["err_ll"] = _raises(lambda: log_likelihood_sharded(
        terms["sho"](torch.tensor(params["sho"], dtype=f64)), t[:-2], diag[:-2], y[:-2],
        meshes[4]))

    # the walker-sharded chain at D = 2 on JAX's per-device draws
    wmesh = default_mesh(("rep", "walkers"), shape=(2, 2), device="cpu")
    idx = wmesh.get_local_rank("walkers")
    group = wmesh.get_group("walkers")
    mu, sd = torch.tensor([1.0, -2.0], dtype=f64), torch.tensor([0.5, 2.0], dtype=f64)

    def log_prob(x):
        return -0.5 * torch.sum(((x - mu) / sd) ** 2, dim=-1)

    x0 = torch.from_numpy(inp["x0"])
    wl = x0.shape[0] // 2
    u, j, r = (torch.from_numpy(inp[k]) for k in ("draw_u", "draw_j", "draw_r"))

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    chain, lps, _ = _sharded_chain(log_prob, x0[idx * wl:(idx + 1) * wl], idx * wl,
                                   x0.shape[0] // 2, u.shape[1],
                                   lambda s, k: (u[idx, s, k], j[idx, s, k], r[idx, s, k]),
                                   gather, 2.0)
    out["chain_D2"], out["lps_D2"], out["chain_D2_index"] = chain.numpy(), lps.numpy(), idx

    # the public sampler on its own generator at D = 4: JAX's moment test
    x0m = torch.from_numpy(inp["x0_moments"])
    chain, lps, acc = run_ensemble_sharded(log_prob, x0m, 1, 1500, default_mesh(
        ("walkers",), device="cpu"))
    out["moments_chain"], out["moments_acc"] = _full(chain), acc
    again, _, _ = run_ensemble_sharded(log_prob, x0m, 1, 5, default_mesh(("walkers",),
                                                                         device="cpu"))
    out["moments_first5"] = _full(again)
    out["err_walkers"] = _raises(lambda: run_ensemble_sharded(log_prob, x0m[:60], 1, 2,
                                                              meshes[4], axis="seq"))

    tm, ym, dym = (inp[k] for k in ("t_model", "y_model", "dy_model"))
    sig = TSeries(torch.from_numpy(tm), torch.from_numpy(ym), device="cpu")
    u50 = np.full(6, 50.0)
    out["nll_sharded"] = BrownianGP(sig, err=torch.from_numpy(dym), solver="sharded",
                                    mesh=meshes[4]).nll(u50)
    out["nll_scan"] = BrownianGP(sig, err=torch.from_numpy(dym)).nll(u50)
    short = TSeries(torch.from_numpy(tm[:-2]), torch.from_numpy(ym[:-2]), device="cpu")
    out["err_modeler"] = _raises(lambda: BrownianGP(short, err=torch.from_numpy(dym[:-2]),
                                                    solver="sharded", mesh=meshes[4]))


SUITES = {"parallel": suite_parallel, "gp": suite_gp}
_LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
               "LOCAL_WORLD_SIZE")


class Ranks:
    """``world`` rank processes of ``suite`` over ``work`` (which must hold
    inputs.npz), started at once; :meth:`results` joins them within
    ``timeout`` seconds of the start and returns each rank's outputs."""

    def __init__(self, suite, work, world=4, timeout=240):
        self.work, self.world, self.timeout = str(work), world, timeout
        env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
        env["OMP_NUM_THREADS"] = "1"
        self.start = time.monotonic()
        self.logs = [open(os.path.join(self.work, f"rank{r}.log"), "w") for r in range(world)]
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(r),
                                        str(world), self.work], env=env, stdout=log,
                                       stderr=subprocess.STDOUT)
                      for r, log in enumerate(self.logs)]
        self._results = None

    def _log(self, r):
        with open(os.path.join(self.work, f"rank{r}.log")) as f:
            return f.read()[-4000:]

    def results(self):
        if self._results is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, self.start + self.timeout - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.close()
                raise RuntimeError(f"rank processes did not finish in {self.timeout} s; "
                                   f"rank 0's log:\n{self._log(0)}") from None
            bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
            if bad:
                raise RuntimeError(f"ranks {bad} failed; rank {bad[0]}'s log:\n{self._log(bad[0])}")
            self._results = [dict(np.load(os.path.join(self.work, f"rank{r}.npz")))
                             for r in range(self.world)]
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in self.logs:
            log.close()


def main(suite, rank, world, work):
    torch.set_num_threads(1)
    from periodicity_tpu_torch.parallel import initialize_distributed

    out = {"init_before": initialize_distributed(device="cpu")}
    store = dist.FileStore(os.path.join(work, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    out["init_after"] = initialize_distributed(device="cpu")
    SUITES[suite](dict(np.load(os.path.join(work, "inputs.npz"))), out)
    out["foreign_modules"] = np.array(sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.") or m == "periodicity_tpu"
        or m.startswith("periodicity_tpu.")) or [""])
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
