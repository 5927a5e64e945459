"""K1 at config 7's three points, from the checkout it runs in.

Run from the root of a checkout on a machine with a card:

    python3 chip_k1_points.py LABEL

It times ``kalman_blocked`` (one row, the live BrownianTerm, R = 4,
float32) at config 7's blocked points, N = 1e4 over 39 blocks and N = 1e5
over 390, and at its chunked shape, the second chunk of the N = 1e6 series
(65536 samples over 512 blocks, from the first chunk's carry), with the
helpers of that checkout's ``chip_smoke.py``: CUDA events over 10
back-to-back calls and the profiler's device time by kernel over 3. It
prints one JSON line, LABEL, the card and each point's ``ms``,
``device_ms`` and device ms by stage (the kernel's name between
``kalman_`` and ``_kernel``). To compare two commits on one card, unpack
the other with ``git archive`` into a git-ignored directory and run this
file from each root in turns (parent, change, change, parent) in one call.
"""

import json
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from periodicity_tpu_torch.models.gp import pscan  # noqa: E402
from periodicity_tpu_torch.models.gp.terms import BrownianTerm  # noqa: E402
from periodicity_tpu_torch.ops import kalman as K  # noqa: E402
from periodicity_tpu_torch.utils.dtypes import full_float32  # noqa: E402

CHUNK, INNER = 65536, 512


def operands(term, t, y, lo, hi, first, dev):
    """K1's operands for samples [lo, hi) of the series (t, y)."""
    tt, yy = torch.from_numpy(t).to(dev), torch.from_numpy(y).to(dev)
    with full_float32():
        coeffs, tc, dd, yc, batch = pscan._prepared(term, tt, torch.full_like(tt, 0.01), yy)
        dtc = torch.cat([tc.new_zeros(1), torch.diff(tc)])
        return pscan._k1_inputs(coeffs, dtc[lo:hi], dd[..., lo:hi], yc[..., lo:hi], batch,
                                first)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_k1_points.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    term = BrownianTerm(0.01, 20.0, 10.0, 0.3)
    points = []
    rng = np.random.default_rng(0)
    for n in (10_000, 100_000):
        t, y = cs.c7_series(rng, n)
        points.append((f"N{n}", operands(term, t, y, 0, n, True, dev), cs.c7_blocks(n), None))
    t, y = cs.c7_series(np.random.default_rng(0), 2 * CHUNK)
    carry = K.kalman_blocked(*operands(term, t, y, 0, CHUNK, True, dev), INNER)[2]
    points.append(("chunk", operands(term, t, y, CHUNK, 2 * CHUNK, False, dev), INNER, carry))
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else "", "card": torch.cuda.get_device_name(0)}
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
    print(json.dumps(out))


if __name__ == "__main__":
    main()
