"""Signal decomposition estimators (EMD, LMD, CEEMDAN, VMD).

Port of ``periodicity_tpu/models/decomposition.py``, with its names,
constructor arguments and attributes:

- EMD: each mode is one call of the sift state machine (ops/emd.py), on
  the card one launch of the hand-written sift kernel and one host read of
  the monotonic flag.
- CEEMDAN: the noise realizations' pre-decomposition and each stage's
  ensemble are batches of that state machine, one launch each on the card;
  the noise is drawn on the host with ``np.random.default_rng``, as in the
  JAX package, so both packages sift the same noise.
- LMD: the sift and the demodulation loop of ops/lmd.py, plain PyTorch.
- VMD: the reference ships a stub (decomposition.py:206-207); the JAX
  package's fixed-iteration ADMM in the frequency domain, as a Python loop
  of elementwise passes over the [K, ne] mode spectra.
"""

import numpy as np
import torch

from ..core import TSeries
from ..ops.emd import emd_iter, emd_iter_pool, emd_pool
from ..ops.emd import sift as _sift
from ..ops.lmd import lmd_iter as _lmd_iter
from ..ops.lmd import lmd_sift as _lmd_sift
from ..utils.logging import log_event

__all__ = ["EMD", "CEEMDAN", "LMD", "VMD"]


class EMD:
    """Empirical Mode Decomposition (Rilling, Flandrin & Goncalves 2003;
    reference decomposition.py:12-117).

    Parameters mirror the reference: max_iter, pad_width, theta_1, theta_2,
    alpha. ``__call__`` decomposes into IMFs.
    """

    def __init__(self, max_iter=2000, pad_width=2, theta_1=0.05, theta_2=0.50, alpha=0.05):
        self.max_iter = max_iter
        self.pad_width = pad_width
        self.theta_1 = theta_1
        self.theta_2 = theta_2
        self.alpha = alpha

    def sift(self, sig):
        """One sifting evaluation; returns (mu: TSeries, sigma: TSeries,
        n_ext, n_zero) with the reference's semantics
        (decomposition.py:45-70), raising ValueError when the signal lacks
        extrema. Plain PyTorch on either device."""
        mu, sigma, n_ext, n_zero, ok = _sift(sig.time, sig.values, pad_width=self.pad_width)
        if not bool(ok):
            raise ValueError("Signal doesn't have enough extrema for padding.")
        return (
            TSeries(sig.time, mu, assume_sorted=True),
            TSeries(sig.time, sigma, assume_sorted=True),
            int(n_ext),
            int(n_zero),
        )

    def _iter_kernel(self, t, x):
        return emd_iter(t, x, max_iter=self.max_iter, pad_width=self.pad_width,
                        theta_1=self.theta_1, theta_2=self.theta_2, alpha=self.alpha)

    def iter(self, sig):
        """Extract the next mode; returns (mode: TSeries, is_monotonic)."""
        mode, mono = self._iter_kernel(sig.time, sig.values)
        return TSeries(sig.time, mode, assume_sorted=True), bool(mono)

    def __call__(self, signal, max_modes=None):
        if not isinstance(signal, TSeries):
            signal = TSeries(values=signal)
        if max_modes is None:
            max_modes = np.inf
        log_event("emd", n=signal.size, max_iter=self.max_iter, max_modes=max_modes)
        imfs = []
        is_monotonic = signal.size < 4
        residue = signal.copy()
        while not is_monotonic and len(imfs) < max_modes:
            mode, is_monotonic = self.iter(residue)
            if not is_monotonic:
                imfs.append(mode)
                residue = residue - mode
        log_event("emd_done", n_modes=len(imfs), monotonic=is_monotonic)
        self.signal = signal
        self.modes = imfs
        self.residue = residue
        self.n_modes = len(imfs)
        return self.modes


class LMD:
    """Local Mean Decomposition (reference decomposition.py:120-203).

    The sift (zero-order-hold local mean/envelope between consecutive
    extrema, data-dependent triangle smoothing) and the demodulation loop
    are ops/lmd.py; the ValueError-as-control-flow of the reference becomes
    a monotonic flag. Requires a uniformly sampled signal (like the
    reference, which reads ``signal.dt``).

    Numerics note: the smoothing loop's stop rule ("no zero first
    differences", reference decomposition.py:150-155) is a boolean on
    exact zeros; where a difference lands within one ulp of zero, another
    summation order can run one more smoothing pass. The demodulation loop
    renormalizes, so product functions still agree closely on such inputs.
    """

    def __init__(self, max_iter=10, pad_width=0, smooth_iter=12, eps=1e-6):
        self.max_iter = max_iter
        self.pad_width = pad_width
        self.smooth_iter = smooth_iter
        self.eps = eps

    def sift(self, sig):
        """One sifting evaluation; returns (mu: TSeries, env: TSeries),
        raising ValueError when the signal lacks extrema (reference
        decomposition.py:127-163)."""
        float(sig.dt)  # raises AttributeError on nonuniform grids
        mu, env, ok = _lmd_sift(sig.time, sig.values, pad_width=self.pad_width,
                                smooth_iter=self.smooth_iter)
        if not bool(ok):
            raise ValueError("Signal doesn't have enough extrema for padding.")
        return (
            TSeries(sig.time, mu, assume_sorted=True),
            TSeries(sig.time, env, assume_sorted=True),
        )

    def iter(self, sig):
        """Extract one product function; returns (A: TSeries, F: TSeries,
        is_monotonic) (reference decomposition.py:165-183)."""
        float(sig.dt)
        A, F, mono = _lmd_iter(sig.time, sig.values, max_iter=self.max_iter,
                               pad_width=self.pad_width, smooth_iter=self.smooth_iter,
                               eps=self.eps)
        return (
            TSeries(sig.time, A, assume_sorted=True),
            TSeries(sig.time, F, assume_sorted=True),
            bool(mono),
        )

    def __call__(self, signal, max_modes=None):
        if not isinstance(signal, TSeries):
            signal = TSeries(values=signal)
        if max_modes is None:
            max_modes = np.inf
        log_event("lmd", n=signal.size, max_iter=self.max_iter, max_modes=max_modes)
        pfs = []
        is_monotonic = signal.size < 4
        residue = signal.copy()
        while not is_monotonic and len(pfs) < max_modes:
            A, F, is_monotonic = self.iter(residue)
            if not is_monotonic:
                pfs.append([A, F])
                residue = residue - A * F
        log_event("lmd_done", n_modes=len(pfs), monotonic=is_monotonic)
        self.signal = signal
        self.modes = pfs
        self.residue = residue
        self.n_modes = len(pfs)
        return self.modes


class CEEMDAN:
    """Complete Ensemble EMD with Adaptive Noise (Torres et al. 2011;
    Colominas et al. 2014; reference decomposition.py:210-375).

    The noise-realization ensemble is a batch of the sift state machine:
    the white-noise pre-decomposition and each stage's realizations run as
    one launch of the sift kernel each on the card, every realization
    retiring when it is done. ``cores`` is accepted for compatibility with
    the reference's process fan-out and ignored.
    """

    def __init__(self, epsilon=0.2, ensemble_size=50, min_energy=0.0, random_seed=None,
                 cores=None, **kwargs):
        del cores
        self.epsilon = epsilon
        self.ensemble_size = ensemble_size
        self.min_energy = min_energy
        self.emd = EMD(**kwargs)
        self.rng = np.random.default_rng(random_seed)

    def _emd_kwargs(self):
        emd = self.emd
        return dict(max_iter=emd.max_iter, pad_width=emd.pad_width, theta_1=emd.theta_1,
                    theta_2=emd.theta_2, alpha=emd.alpha)

    def _batch_iter(self, t, X):
        """Single-mode extraction over the ensemble axis. The JAX package
        switches at 16 realizations between a vmapped emd_iter and its
        lane-retiring pool (models/decomposition.py:233-235), which give the
        same modes; here both are the same single launch of the sift
        kernel, so there is one path."""
        return emd_iter_pool(t, X, **self._emd_kwargs())

    def _noise_modes(self, t, noise, max_modes_cap):
        """Full EMD of each ensemble noise realization -> [E, M, N] modes
        (one batch; realizations retire as their decompositions end)."""
        modes, _, counts = emd_pool(t, noise, max_modes=max_modes_cap, **self._emd_kwargs())
        counts = counts.cpu().numpy()
        m_used = max(1, int(counts.max()))
        return modes[:, :m_used, :], counts

    def __call__(self, signal, max_modes=None, progress=False):
        if not isinstance(signal, TSeries):
            signal = TSeries(values=signal)
        if max_modes is None:
            max_modes = np.inf
        t = signal.time
        n = signal.size
        e = self.ensemble_size
        sigma_x = float(np.std(signal))

        log_event("ceemdan", n=n, ensemble_size=e, epsilon=self.epsilon, max_modes=max_modes)
        # The noise realizations are pre-decomposed into at most
        # log2(n) + 2 mode slots (white noise yields ~log2(n) IMFs; the
        # reference runs unbounded EMD per realization,
        # decomposition.py:274-294), as in the JAX package. Stages beyond
        # the cap add no noise. Override via ``self.noise_modes_cap``.
        max_modes_cap = getattr(self, "noise_modes_cap", int(np.log2(n)) + 2)
        noise = self.rng.standard_normal((e, n))
        dev, dtype = signal.values.device, signal.values.dtype
        noise = torch.from_numpy(noise).to(device=dev, dtype=dtype)
        noise_modes, noise_counts = self._noise_modes(t, noise, max_modes_cap)
        m_cap = noise_modes.shape[1]

        bar = None
        if progress:
            from tqdm.auto import tqdm

            bar = tqdm(total=None if np.isinf(max_modes) else int(max_modes),
                       desc="CEEMDAN modes")
        imfs = []
        residue = signal / sigma_x
        while len(imfs) < max_modes:
            k = len(imfs)
            rv = residue.values
            if k < m_cap:
                beta = self.epsilon * torch.std(rv, correction=0)
                noise_k = noise_modes[:, k, :]
                if k == 0:
                    # reference decomposition.py:256-259: realizations whose
                    # noise EMD produced no modes add no noise (a zero row
                    # would give std = 0 and NaN)
                    std0 = torch.std(noise_k, dim=1, keepdim=True, correction=0)
                    has0 = torch.from_numpy(noise_counts > 0).to(dev)[:, None]
                    beta = beta / torch.where(std0 > 0, std0, 1.0)
                    noisy = rv[None, :] + torch.where(has0, beta * noise_k, 0.0)
                else:
                    has = torch.from_numpy(noise_counts > k).to(dev)
                    noisy = rv[None, :] + torch.where(has[:, None], beta * noise_k, 0.0)
            else:
                noisy = rv[None, :].expand(e, n)
            modes1, mono = self._batch_iter(t, noisy)
            # monotonic noisy residue -> realization contributes zero
            # (reference decomposition.py:261-265)
            local_means = torch.where(mono[:, None], noisy * 0.0, noisy - modes1)
            mu = torch.mean(local_means, dim=0)
            imfs.append(residue - TSeries(t, mu, assume_sorted=True))
            residue = TSeries(t, mu, assume_sorted=True)
            if bar is not None:
                bar.update(1)

            if float(np.var(residue)) < self.min_energy:
                break
            residue_imfs = self.emd(residue)
            if len(residue_imfs) <= 1:
                if len(imfs) < max_modes and len(residue_imfs) == 1:
                    imfs.append(residue)
                break

        if bar is not None:
            bar.close()
        imfs = [imf * sigma_x for imf in imfs]
        self.signal = signal
        self.modes = imfs
        self.residue = signal - sum(imfs)
        self.n_modes = len(imfs)
        return self.modes

    def postprocessing(self):
        """Wu & Huang (2009) post-sift to reduce mode mixing
        (reference decomposition.py:344-359)."""
        ck = self.emd(self.modes[0], max_modes=1)[0]
        c_imfs = [ck]
        qk = self.modes[0] - ck
        for k in range(1, self.n_modes):
            Dk = qk + self.modes[k]
            modes = self.emd(Dk, max_modes=1)
            if len(modes) > 0:
                ck = modes[0]
            else:
                c_imfs.append(self.modes[k])
                break
            qk = Dk - ck
            c_imfs.append(ck)
        self.c_residue = sum(self.modes) + self.residue - sum(c_imfs)
        self.c_modes = c_imfs

    @property
    def orthogonality_matrix(self):
        orth = np.zeros((self.n_modes, self.n_modes), float)
        for i in range(self.n_modes):
            for j in range(self.n_modes):
                orth[i, j] = self.modes[i].corr(self.modes[j])
        return orth

    @property
    def c_orthogonality_matrix(self):
        k = len(self.c_modes)
        orth = np.zeros((k, k), float)
        for i in range(k):
            for j in range(k):
                orth[i, j] = self.c_modes[i].corr(self.c_modes[j])
        return orth


class VMD:
    """Variational Mode Decomposition (Dragomiretskiy & Zosso 2014).

    The reference ships an empty stub (decomposition.py:206-207, README
    "soon"); this is the JAX package's ADMM in the frequency domain:
    Wiener-filter mode updates, centre-of-gravity frequency updates and
    dual ascent, for ``max_iter`` iterations. The modes update one after
    another within an iteration (each sees the others' newest spectra), as
    in the JAX loop; each update is a handful of elementwise passes over
    the mirror-extended spectrum, the sums over modes passes over [K, ne].

    Parameters
    ----------
    n_modes: number of modes K.
    alpha: bandwidth penalty (default 2000).
    tau: dual ascent step (0 = noise-slack off).
    tol: convergence tolerance (kept for the reference's signature; the
        iteration always runs max_iter times).
    """

    def __init__(self, n_modes=3, alpha=2000.0, tau=0.0, max_iter=500, tol=1e-7,
                 init="uniform"):
        self.n_modes = n_modes
        self.alpha = alpha
        self.tau = tau
        self.max_iter = max_iter
        self.tol = tol
        self.init = init

    def __call__(self, signal, max_modes=None):
        if not isinstance(signal, TSeries):
            signal = TSeries(values=signal)
        K = self.n_modes if max_modes is None else min(self.n_modes, max_modes)
        x = signal.values
        dev = x.device
        n = x.shape[0]
        # mirror-extend to reduce boundary effects (standard VMD practice)
        half = n // 2
        ext = torch.cat([torch.flip(x[:half], (0,)), x, torch.flip(x[half:], (0,))])
        ne = ext.shape[0]
        # the grid and the centre frequencies in float64 whatever the
        # signal's dtype, and the spectra complex in the signal's width, as
        # in the JAX package (x64)
        freqs = torch.fft.fftfreq(ne, dtype=torch.float64, device=dev)
        f_hat = torch.fft.fft(ext)
        pos = freqs >= 0
        f_plus = torch.where(pos, f_hat, 0.0)
        if self.init == "uniform":
            omega = torch.arange(1, K + 1, dtype=torch.float64, device=dev) * 0.5 / (K + 1)
        else:
            omega = torch.linspace(0.0, 0.5, K, dtype=torch.float64, device=dev)
        ctype = torch.complex128 if x.dtype == torch.float64 else torch.complex64
        u_hat = torch.zeros((K, ne), dtype=ctype, device=dev)
        lam = torch.zeros(ne, dtype=ctype, device=dev)
        alpha = self.alpha
        tau = self.tau
        for _ in range(self.max_iter):
            for k in range(K):
                others = u_hat.sum(0) - u_hat[k]
                num = f_plus - others + lam / 2
                den = 1.0 + 2.0 * alpha * (freqs - omega[k]) ** 2
                uk = torch.where(pos, num / den, 0.0)
                p = torch.abs(uk) ** 2
                wk = torch.where(pos, freqs * p, 0.0).sum() / (torch.where(pos, p, 0.0).sum()
                                                                 + 1e-30)
                u_hat[k] = uk
                omega[k] = wk
            # dual ascent on the reconstruction constraint, paired with the
            # +lam/2 numerator above (the paper's sign convention; the
            # MATLAB release pairs -lam/2 with the opposite ascent, and
            # mixing the two makes ADMM diverge for any tau > 0)
            lam = lam + tau * (f_plus - u_hat.sum(0))
        # back to time domain: real part of the analytic modes
        u = torch.fft.ifft(2.0 * u_hat, dim=1).real[:, half: half + n]
        order = torch.argsort(omega).cpu().numpy()
        self.omegas = omega.cpu().numpy()[order]
        modes = [TSeries(signal.time, u[int(i)], assume_sorted=True) for i in order]
        self.signal = signal
        self.modes = modes
        self.residue = signal - sum(modes)
        self.n_modes = len(modes)
        return self.modes
