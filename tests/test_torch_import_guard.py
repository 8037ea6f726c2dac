"""The port stands alone: ``repro_torch`` never loads jax or the JAX
package, and its entry points never fall back to the CPU on their own."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import compressor, dataplane
from repro_torch.core.dataplane import CascadePlan, LevelSpec

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|from\s+repro\."
    r"|from\s+repro\s+import\b|import\s+repro\s*$)", re.M)


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter (this worker has already imported jax)."""
    mods = _port_modules()
    assert "repro_torch.core.kvagg" in mods and len(mods) >= 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]))
def test_source_has_no_jax_or_repro_import(path):
    src = (REPO / path).read_text()
    assert not FORBIDDEN.findall(src), FORBIDDEN.findall(src)


def test_forbidden_pattern_catches_each_form():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import kvagg", "import repro.net.wire",
                 "from repro import core", "    import jax"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import kvagg",
                 "# the jax package"):
        assert not FORBIDDEN.search(line), line


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    plan = CascadePlan(op="sum", levels=(LevelSpec(capacity=8),))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dataplane.simulate_plan(plan, data_amount=64, key_variety=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dataplane.LevelState(LevelSpec(capacity=8), "sum")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dataplane.run_cascade_stream(
            iter([(np.zeros(4, np.int32), np.ones(4, np.float32))]), plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compressor.init_state((4, 4))
    # the same calls run where the caller asks for the CPU
    rep = dataplane.simulate_plan(plan, data_amount=64, key_variety=8,
                                  device="cpu")
    assert rep["n_in"] == 64
