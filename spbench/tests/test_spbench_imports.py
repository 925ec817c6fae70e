"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port. Each check runs in a fresh interpreter
and compares the top-level name of every loaded module (before the first
dot) whole."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent

LOADED = """
import importlib, importlib.util, json, sys
from pathlib import Path
for name in {mods!r}:
    importlib.import_module(name)
for path in sorted(Path({metrics!r}).glob("*.py")):
    spec = importlib.util.spec_from_file_location("m_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(mods, extra=""):
    code = LOADED.format(mods=mods, metrics=str(ROOT / "spbench" / "metrics"), extra=extra)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_no_module_of_spbench_loads_jax_or_respatpu():
    mods = sorted("spbench." + p.stem for p in (ROOT / "spbench").glob("*.py")
                  if p.stem != "__init__")
    # a whole run at a tiny size too: what the port loads while it works
    extra = """
import time
from spbench import run
for cell in ("2cubes_sphere.rhs", "dc1.rhs"):
    spec = run.cell_spec(cell)
    spec.config["matrix"].update(target_n=1500, target_nnz=15000)
    spec.config["matrix"].pop("n"), spec.config["matrix"].pop("nnz")
    run.run_cell(spec, seed=3, seconds=0.2, trace=False, device="cpu", t_start=time.perf_counter())
"""
    names = top_level_names(mods, extra)
    assert "spbench" in names and "respatpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "respatpu"}


def test_the_reference_loads_nothing_of_the_port():
    names = top_level_names(["spbench.reference", "spbench.standin"])
    assert "respatpu_torch" not in names
    assert not names & {"jax", "jaxlib", "flax", "respatpu"}
