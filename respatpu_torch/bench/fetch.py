"""SuiteSparse corpus fetcher (matrices/*/get*Matrices.sh equivalent); the
counterpart of ``respatpu/bench/fetch.py``.

Downloads and unpacks the 36-matrix corpus from sparse.tamu.edu into
``matrices/<group>/<name>/<name>.mtx``. Without network access the first
failure ends the attempt and the corpus registry substitutes synthetic
stand-ins (``respatpu_torch.bench.corpus.load_matrix``).

Usage: python -m respatpu_torch fetch [moderate|big|all]
       python -m respatpu_torch.bench.fetch [moderate|big|all] [--dest matrices]
"""
from __future__ import annotations

import os
import sys
import tarfile
import urllib.request

from .corpus import ALL, BIG, MODERATE

# SuiteSparse collection groups (README.md:110-155 tabulates the same URLs)
_GROUPS = {
    "2cubes_sphere": "Um", "ASIC_320ks": "Sandia", "Baumann": "Watson",
    "cfd2": "Rothberg", "crashbasis": "QLi", "ct20stif": "Boeing",
    "dc1": "IBM_EDA", "Dubcova3": "UTEP", "ecology2": "McRae",
    "FEM_3D_thermal2": "Botonakis", "G2_circuit": "AMD",
    "Goodwin_095": "Goodwin", "matrix-new_3": "Schenk_ISEI",
    "offshore": "Um", "para-10": "Schenk_ISEI", "parabolic_fem": "Wissgott",
    "ss1": "VLSI", "stomach": "Norris", "thermomech_TK": "Botonakis",
    "tmt_unsym": "CEMW", "xenon2": "Ronis",
    "af_shell10": "Schenk_AFE", "af_shell2": "Schenk_AFE",
    "atmosmodd": "Bourchtein", "atmosmodl": "Bourchtein",
    "cage13": "vanHeukelum", "CurlCurl_2": "Bodendiek",
    "dielFilterV2real": "Dziekonski", "Geo_1438": "Janna",
    "Hook_1498": "Janna", "ML_Laplace": "Janna", "nlpkkt80": "Schenk",
    "Serena": "Janna", "Si87H76": "PARSEC", "StocF-1465": "Janna",
    "Transport": "Janna",
}

BASE = "https://sparse.tamu.edu/MM"


def url_for(name: str) -> str:
    return f"{BASE}/{_GROUPS[name]}/{name}.tar.gz"


def fetch(name: str, group: str, dest: str = "matrices", timeout: int = 600) -> bool:
    out_dir = os.path.join(dest, group)
    mtx = os.path.join(out_dir, name, f"{name}.mtx")
    if os.path.exists(mtx):
        print(f"[fetch] {name}: already present")
        return True
    os.makedirs(out_dir, exist_ok=True)
    tgz = os.path.join(out_dir, f"{name}.tar.gz")
    try:
        print(f"[fetch] {name} <- {url_for(name)}")
        urllib.request.urlretrieve(url_for(name), tgz)
        with tarfile.open(tgz) as tf:
            tf.extractall(out_dir, filter="data")
        os.remove(tgz)
        return os.path.exists(mtx)
    except Exception as e:
        print(f"[fetch] {name}: FAILED ({e}); synthetic stand-in will be used")
        return False


def attempt_fetch(names=None, group: str = "moderate", per_file_timeout: int = 25) -> int:
    """Best-effort corpus fetch for the sweep and study entry points: where
    the network is reachable the real matrices land on disk and every later
    row reads ``synthetic=0``; where it is not, the first failure ends the
    attempt (every further one would pay the same timeout) and the synthetic
    stand-ins serve as before. Returns how many matrices are on disk."""
    import socket
    entries = {"moderate": MODERATE, "big": BIG, "all": ALL}[group]
    if names is not None:
        wanted = set(names)
        entries = [e for e in entries if e.name in wanted]
    got = 0
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(per_file_timeout)
    try:
        for e in entries:
            mtx = os.path.join("matrices", e.group, e.name, f"{e.name}.mtx")
            if os.path.exists(mtx):
                got += 1
                continue
            if not fetch(e.name, e.group):
                break
            got += 1
    except Exception as e:
        print(f"[fetch] attempt aborted: {e}", file=sys.stderr)
    finally:
        socket.setdefaulttimeout(old)
    return got


def main(argv=None):
    argv = argv or sys.argv[1:]
    which = argv[0] if argv else "moderate"
    dest = "matrices"
    if "--dest" in argv:
        dest = argv[argv.index("--dest") + 1]
    entries = {"moderate": MODERATE, "big": BIG, "all": ALL}[which]
    ok = sum(fetch(e.name, e.group, dest) for e in entries)
    print(f"[fetch] {ok}/{len(entries)} matrices available")


if __name__ == "__main__":
    main()
