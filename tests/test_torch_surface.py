"""Every public name of the JAX package has a counterpart in the port.

For each module of ``periodicity_tpu`` that declares ``__all__``, the port's
module at the same path has every name it lists. The three Pallas modules
live under other names in the port, with the same function names:
``ops.pallas_grid2 -> ops.grid2``, ``ops.pallas_grid -> ops.grid`` and
``ops.pallas_bls -> ops.fold``.
"""

import importlib
import pkgutil

import pytest

import periodicity_tpu

RENAMED = {"ops.pallas_grid2": "ops.grid2", "ops.pallas_grid": "ops.grid",
           "ops.pallas_bls": "ops.fold"}


def _modules():
    names = [""]
    for info in pkgutil.walk_packages(periodicity_tpu.__path__, prefix="periodicity_tpu."):
        names.append(info.name.split(".", 1)[1])
    return sorted(names)


@pytest.mark.parametrize("path", _modules(), ids=lambda p: p or "periodicity_tpu")
def test_port_has_every_public_name(path):
    ref = importlib.import_module("periodicity_tpu" + (f".{path}" if path else ""))
    names = getattr(ref, "__all__", None)
    if names is None:
        return  # a module without a declared surface
    ported = RENAMED.get(path, path)
    port = importlib.import_module("periodicity_tpu_torch" + (f".{ported}" if ported else ""))
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"periodicity_tpu_torch.{ported or ''} lacks {missing}"
    assert set(names) <= set(getattr(port, "__all__", names)), (
        f"periodicity_tpu_torch.{ported or ''}.__all__ lacks "
        f"{sorted(set(names) - set(port.__all__))}")
