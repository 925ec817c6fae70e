"""The port's host layer against respatpu's: Matrix Market loading, the
synthetic generators, the corpus stand-in seed, and the absence of JAX."""
import ast
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import respatpu.bench.synth as jsynth
import respatpu.io as jio

import respatpu_torch.bench.synth as tsynth
import respatpu_torch.io as tio
from respatpu_torch.io import _native_loader, native
from respatpu_torch.interop import csr_from_respatpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(REPO, "tests", "fixtures", "*.mtx")))


def _same(a, b):
    """Equal structure and bitwise-equal values; the port's row pointer is
    int64 where respatpu's is int32."""
    assert a.shape == b.shape
    assert b.indptr.dtype == np.int64
    np.testing.assert_array_equal(a.indptr, b.indptr)
    assert a.indices.tobytes() == b.indices.tobytes()
    assert a.data.tobytes() == b.data.tobytes()


@pytest.mark.parametrize("native_parser", [False, True])
@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_load_csr_matches_respatpu(path, native_parser):
    if native_parser and not native.available():
        pytest.skip("no host C++ compiler to build io/csrc/mtx_parse.cpp")
    _same(jio.load_csr(path, native=native_parser),
          tio.load_csr(path, native=native_parser))
    if native_parser:
        _same(jio.load_csr(path), _native_loader.load_csr(path))


GENERATORS = {
    "laplacian_3d": lambda m: m.laplacian_3d(9, 8, 7),
    "mesh_fem_3d": lambda m: m.mesh_fem_3d(3000, seed=11),
    "circuit_like": lambda m: m.circuit_like(3000, 5, seed=12),
    "powerlaw": lambda m: m.powerlaw(3000, 7, seed=13),
}


@pytest.mark.parametrize("gen", list(GENERATORS))
def test_synth_generators_match_respatpu(gen):
    _same(GENERATORS[gen](jsynth), GENERATORS[gen](tsynth))


def test_csr_from_respatpu_roundtrip():
    a = jsynth.powerlaw(500, 6, seed=2)
    _same(a, csr_from_respatpu(a))


def test_write_mtx_roundtrip(tmp_path):
    a = tsynth.circuit_like(800, 5, seed=3)
    p = str(tmp_path / "c.mtx")
    tio.write_mtx(p, a)
    _same(a, tio.load_csr(p, native=False))


_NNZ = ("from respatpu_torch.bench import corpus; "
        "print(corpus.load_matrix('dc1', max_synth_nnz=60000)[0].nnz)")


def test_corpus_standin_is_stable_across_processes():
    env = dict(os.environ, PYTHONHASHSEED="random")
    out = [subprocess.run([sys.executable, "-c", _NNZ], cwd=REPO, env=env, check=True,
                          capture_output=True, text=True, timeout=300).stdout.strip()
           for _ in range(2)]
    assert out[0] == out[1] and int(out[0]) > 0


_NO_JAX = """
import importlib, pkgutil, sys
import respatpu_torch
names = [m.name for m in pkgutil.walk_packages(respatpu_torch.__path__, "respatpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "respatpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300).stdout.split(None, 1)
    assert int(out[0]) >= 15
    assert out[1].strip() == "[]"


PORT_PY = sorted(glob.glob(os.path.join(REPO, "respatpu_torch", "**", "*.py"), recursive=True)
                 + [os.path.join(REPO, "chip_smoke.py")])
PORT_NATIVE = sorted(glob.glob(os.path.join(REPO, "respatpu_torch", "**", "csrc", "*"),
                               recursive=True))
_INTO_REFERENCE = re.compile(r"(^|[/\\])respatpu([/\\.]|$)")
_CITATION = re.compile(r"^respatpu/[\w/]+\.py:\d+$")  # file:line of the kernel a port replaces


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                out.add(id(first.value))
    return out


@pytest.mark.parametrize("path", PORT_PY, ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_stays_out_of_the_reference(path):
    """No import of jax or respatpu, and no string that names a path or a
    module of ``respatpu/`` outside docstrings, except a file:line citation."""
    with open(path) as f:
        tree = ast.parse(f.read())
    docs = _docstrings(tree)
    for node in ast.walk(tree):
        roots = []
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        assert not {"jax", "jaxlib", "respatpu"} & set(roots), (path, node.lineno)
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs and _INTO_REFERENCE.search(node.value)):
            assert _CITATION.match(node.value), (path, node.lineno, node.value)


def test_port_native_sources_include_nothing_of_the_reference():
    assert len(PORT_NATIVE) >= 2  # the CUDA kernel and the parser
    for path in PORT_NATIVE:
        with open(path) as f:
            includes = [ln for ln in f if ln.lstrip().startswith("#include")]
        assert includes and not any("respatpu" in ln for ln in includes), path


def test_native_parser_is_built_inside_the_ports_build_dir():
    if not native.available():
        pytest.skip("no host C++ compiler to build io/csrc/mtx_parse.cpp")
    lib = os.path.realpath(native._load()._name)
    assert lib.startswith(os.path.join(REPO, "build", "respatpu_torch") + os.sep)
    assert os.path.realpath(native._SOURCE).startswith(
        os.path.join(REPO, "respatpu_torch") + os.sep)
