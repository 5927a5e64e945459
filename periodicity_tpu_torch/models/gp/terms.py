"""Celerite kernel terms (SHO / Rotation / Brownian / sums).

Port of ``periodicity_tpu/models/gp/terms.py``. Every term lowers to the
celerite coefficients

    k(tau) = sum_r a_r exp(-c_r tau)
           + sum_c exp(-c_c tau) (a_c cos(d_c tau) + b_c sin(d_c tau))

as six tensors ``(ar, cr, ac, bc, cc, dc)`` of shape ``[..., k]``: every
hyperparameter may carry leading batch axes (walkers), which then lead the
coefficients. That batch axis is the port's replacement for ``vmap``.

The JAX package emits only an SHO's live slots when its ``Q`` is concrete,
and both the overdamped (two real) and underdamped (one complex) slots,
select-masked, when ``Q`` is traced. The port emits the live slots when
``Q`` is a Python number, or a 0-d tensor that needs no gradient; otherwise
(a batch axis, or a gradient to carry) it emits the masked form. Dead slots
have zero ``U`` columns in the solver, so they add exact zeros, and both
forms give the same likelihood bit for bit.

A term's numbers are placed beside its tensors (their device and floating
dtype), or, in a term of numbers only, held as float64 on the CPU. Where
the coefficients meet times, lags or frequencies, they go to that tensor's
device and floating dtype, as JAX's weakly typed numbers take float32 data's
float32; an array there goes to the card (``core.as_tensor``), the term's
card when it is on one. Coefficients on the card never go to the host:
meeting a CPU tensor, they raise, as torch does on mixed devices.
"""

import math

import torch

from ...core import as_tensor

__all__ = ["Term", "TermSum", "SHOTerm", "RotationTerm", "BrownianTerm"]

_EPS = 1e-10
_SQRT_2_OVER_PI = math.sqrt(2 / math.pi)


def _tensor(x, like=None):
    """``x`` as a floating tensor: tensors as they are, numbers in the dtype
    and on the device of ``like`` when that is a floating tensor (as JAX's
    weakly typed numbers keep float32 float32), else float64 on the CPU."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.float64)
    if isinstance(like, torch.Tensor) and like.is_floating_point():
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x, dtype=torch.float64)


def _beside(values, x):
    """``values`` (tensors on one device) and ``x`` on ``x``'s device and in
    its floating dtype (see the module)."""
    device = values[0].device
    x = as_tensor(x, None if isinstance(x, torch.Tensor) or device.type == "cpu" else device)
    if device.type != "cpu" and x.device != device:
        raise ValueError(f"the term is on {device} and the tensor it meets on {x.device}: move "
                         f"one of them")
    dtype = x.dtype if x.is_floating_point() else values[0].dtype
    return [v.to(x.device, dtype) for v in values], x.to(dtype)


def _k0(ar, ac):
    """sum(ar) + sum(ac) over the last axis, left to right."""
    s = ar.new_zeros(ar.shape[:-1])
    for j in range(ar.shape[-1]):
        s = s + ar[..., j]
    for j in range(ac.shape[-1]):
        s = s + ac[..., j]
    return s


def _live(Q):
    """Whether an SHO with this ``Q`` emits only its live slots."""
    if not isinstance(Q, torch.Tensor):
        return True
    return Q.dim() == 0 and not Q.requires_grad


def _cols(*xs):
    """Stack 0-d or [...] tensors as the last axis [..., k]."""
    xs = torch.broadcast_tensors(*xs)
    return torch.stack(xs, dim=-1)


def _empty(like):
    return like.new_zeros(like.shape + (0,))


class Term:
    """Base: subclasses provide coefficients() -> (ar, cr, ac, bc, cc, dc),
    each [..., k]."""

    def coefficients(self):
        raise NotImplementedError

    def coefficients_beside(self, x):
        """The coefficients and ``x`` on ``x``'s device and in its floating
        dtype (see the module)."""
        coeffs, x = _beside(list(self.coefficients()), x)
        return tuple(coeffs), x

    def __add__(self, other):
        return TermSum(self, other)

    def get_value(self, tau):
        """k(tau) (stationary; tau may be any-sign array). With batched
        hyperparameters the result is [..., *tau.shape]."""
        (ar, cr, ac, bc, cc, dc), tau = self.coefficients_beside(tau)
        tau = torch.abs(tau)
        shape = tau.shape
        tf = tau.reshape(-1)
        k = torch.zeros(ar.shape[:-1] + tf.shape, dtype=torch.promote_types(ar.dtype, tf.dtype),
                        device=ar.device)
        for j in range(ar.shape[-1]):
            k = k + ar[..., j, None] * torch.exp(-cr[..., j, None] * tf)
        for j in range(ac.shape[-1]):
            arg = dc[..., j, None] * tf
            k = k + torch.exp(-cc[..., j, None] * tf) * (
                ac[..., j, None] * torch.cos(arg) + bc[..., j, None] * torch.sin(arg))
        return k.reshape(ar.shape[:-1] + shape)

    def get_psd(self, omega):
        """Power spectral density at angular frequency omega (celerite2
        normalization: sqrt(2/pi) x rational terms), [..., *omega.shape]."""
        (ar, cr, ac, bc, cc, dc), omega = self.coefficients_beside(omega)
        shape = omega.shape
        w2 = omega.reshape(-1) ** 2
        psd = torch.zeros(ar.shape[:-1] + w2.shape, dtype=torch.promote_types(ar.dtype, w2.dtype),
                          device=ar.device)
        for j in range(ar.shape[-1]):
            c = cr[..., j, None]
            psd = psd + ar[..., j, None] * c / (c**2 + w2)
        for j in range(ac.shape[-1]):
            a, b, c, d = (x[..., j, None] for x in (ac, bc, cc, dc))
            c2 = c**2
            d2 = d**2
            num = (a * c + b * d) * (c2 + d2) + (a * c - b * d) * w2
            den = w2**2 + 2 * (c2 - d2) * w2 + (c2 + d2) ** 2
            psd = psd + num / den
        return (_SQRT_2_OVER_PI * psd).reshape(ar.shape[:-1] + shape)

    def k0(self):
        """k(0) = sum(ar) + sum(ac), [...]; the sums left to right."""
        ar, _, ac, _, _, _ = self.coefficients()
        return _k0(ar, ac)


class TermSum(Term):
    def __init__(self, *terms):
        flat = []
        for t in terms:
            if isinstance(t, TermSum):
                flat.extend(t.terms)
            else:
                flat.append(t)
        self.terms = tuple(flat)

    def coefficients(self):
        parts = [t.coefficients() for t in self.terms]
        batch = torch.broadcast_shapes(*(p[0].shape[:-1] for p in parts))
        return tuple(
            torch.cat([p[i].expand(batch + p[i].shape[-1:]) for p in parts], dim=-1)
            for i in range(6)
        )


class SHOTerm(Term):
    """Stochastically-driven damped harmonic oscillator.

    Exactly one of (S0, sigma), one of (w0, rho), one of (Q, tau):
      rho = 2 pi / w0;  tau = 2 Q / w0;  sigma = sqrt(S0 w0 Q).
    Q >= 0.5 lowers to one complex celerite term; Q < 0.5 to two real
    terms. Which slots are emitted follows the module's live/masked rule.
    """

    def __init__(self, *, S0=None, sigma=None, w0=None, rho=None, Q=None, tau=None):
        if (w0 is None) == (rho is None):
            raise ValueError("provide exactly one of w0, rho")
        if w0 is None:
            w0 = 2 * math.pi / rho
        if (Q is None) == (tau is None):
            raise ValueError("provide exactly one of Q, tau")
        if Q is None:
            Q = 0.5 * w0 * tau
        if (S0 is None) == (sigma is None):
            raise ValueError("provide exactly one of S0, sigma")
        if S0 is None:
            S0 = sigma**2 / (w0 * Q)
        self._live = _live(Q)
        like = next((x for x in (S0, w0, Q) if isinstance(x, torch.Tensor)), None)
        self.S0 = _tensor(S0, like)
        self.w0 = _tensor(w0, like)
        self.Q = _tensor(Q, like)

    def coefficients(self):
        S0, w0, Q = self.S0, self.w0, self.Q
        if self._live:
            # the branch is known: only the live slots (a smaller solver state)
            qv = float(Q)
            batch = torch.broadcast_shapes(S0.shape, w0.shape)
            S0, w0 = S0.expand(batch), w0.expand(batch)
            if qv >= 0.5:
                fc = torch.sqrt(torch.clamp(4 * Q**2 - 1.0, min=_EPS))
                a_c = S0 * w0 * Q
                empty = _empty(a_c)
                return (
                    empty,
                    empty,
                    _cols(a_c),
                    _cols(a_c / fc),
                    _cols(0.5 * w0 / Q),
                    _cols(0.5 * w0 / Q * fc),
                )
            fr = torch.sqrt(torch.clamp(1.0 - 4 * Q**2, min=_EPS))
            ar = _cols(0.5 * S0 * w0 * Q * (1 + 1 / fr), 0.5 * S0 * w0 * Q * (1 - 1 / fr))
            empty = _empty(ar[..., 0])
            return (
                ar,
                _cols(0.5 * w0 / Q * (1 - fr), 0.5 * w0 / Q * (1 + fr)),
                empty,
                empty,
                empty,
                empty,
            )
        under = Q >= 0.5
        # underdamped (complex slot)
        fc = torch.sqrt(torch.clamp(4 * Q**2 - 1.0, min=_EPS))
        a_c = S0 * w0 * Q
        b_c = a_c / fc
        c_c = 0.5 * w0 / Q
        d_c = c_c * fc
        # overdamped (two real slots)
        fr = torch.sqrt(torch.clamp(1.0 - 4 * Q**2, min=_EPS))
        ar1 = 0.5 * S0 * w0 * Q * (1 + 1 / fr)
        ar2 = 0.5 * S0 * w0 * Q * (1 - 1 / fr)
        cr1 = 0.5 * w0 / Q * (1 - fr)
        cr2 = 0.5 * w0 / Q * (1 + fr)
        zero = torch.zeros_like(a_c)
        one = torch.ones_like(a_c)
        return (
            _cols(torch.where(under, zero, ar1), torch.where(under, zero, ar2)),
            _cols(torch.where(under, one, cr1), torch.where(under, one, cr2)),
            _cols(torch.where(under, a_c, zero)),
            _cols(torch.where(under, b_c, zero)),
            _cols(torch.where(under, c_c, one)),
            _cols(torch.where(under, d_c, zero)),
        )

    def get_psd(self, omega):
        values, omega = _beside(list(torch.broadcast_tensors(self.S0, self.w0, self.Q)), omega)
        shape = omega.shape
        w2 = omega.reshape(-1) ** 2
        S0, w0, Q = (x[..., None] for x in values)
        psd = _SQRT_2_OVER_PI * S0 * w0**4 / ((w2 - w0**2) ** 2 + w0**2 * w2 / Q**2)
        return psd.reshape(psd.shape[:-1] + shape)


class RotationTerm(TermSum):
    """Two-SHO starspot rotation kernel (celerite2 RotationTerm;
    reference usage gp.py:524)."""

    def __init__(self, *, sigma, period, Q0, dQ, f):
        like = next((x for x in (sigma, period, Q0, dQ, f) if isinstance(x, torch.Tensor)), None)
        self.sigma = _tensor(sigma, like)
        self.period = _tensor(period, like)
        self.Q0 = _tensor(Q0, like)
        self.dQ = _tensor(dQ, like)
        self.f = _tensor(f, like)
        sigma, period, Q0, dQ, f = self.sigma, self.period, self.Q0, self.dQ, self.f
        amp = sigma**2 / (1 + f)
        Q1 = 0.5 + Q0 + dQ
        w1 = 4 * math.pi * Q1 / (period * torch.sqrt(torch.clamp(4 * Q1**2 - 1, min=_EPS)))
        S1 = amp / (w1 * Q1)
        Q2 = 0.5 + Q0
        w2 = 8 * math.pi * Q2 / (period * torch.sqrt(torch.clamp(4 * Q2**2 - 1, min=_EPS)))
        S2 = f * amp / (w2 * Q2)
        super().__init__(
            SHOTerm(S0=S1, w0=w1, Q=Q1),
            SHOTerm(S0=S2, w0=w2, Q=Q2),
        )


class BrownianTerm(TermSum):
    """Quasi-periodic SHO + overdamped background SHO
    (reference gp.py:487-497)."""

    def __init__(self, sigma, tau, period, mix):
        Q = 0.01
        like = next((x for x in (sigma, tau, period, mix) if isinstance(x, torch.Tensor)), None)
        sigma, tau, period, mix = (_tensor(x, like) for x in (sigma, tau, period, mix))
        sigma_1 = sigma * torch.sqrt(mix)
        f = math.sqrt(1 - 4 * Q**2)
        w0 = 2 * Q / (tau * (1 - f))
        S0 = (1 - mix) * sigma**2 / (0.5 * w0 * Q * (1 + 1 / f))
        super().__init__(
            SHOTerm(sigma=sigma_1, tau=tau, rho=period),
            SHOTerm(S0=S0, w0=w0, Q=Q),
        )
