"""Compile the port's native sources into shared libraries at first use.

A library goes to ``build/respatpu_torch/<key>/<name>`` at the root of the
checkout (``build/`` is ignored by git), where ``<key>`` hashes the sources
and the compiler command, so an edit to either gives a new build and an
unchanged checkout reuses the old one.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

_PACKAGE = os.path.dirname(os.path.abspath(__file__))
BUILD_ROOT = os.path.join(os.path.dirname(_PACKAGE), "build", "respatpu_torch")


class CompileError(RuntimeError):
    """The compiler could not be run, or failed; carries its stderr."""


def _run(cmd: Sequence[str]) -> None:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    except (OSError, subprocess.SubprocessError) as e:
        raise CompileError(f"could not run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise CompileError(f"{cmd[0]} failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")


def build_shared(name: str, sources: Sequence[str], command: Sequence[str],
                 per_source: bool = False, depends: Sequence[str] = ()) -> str:
    """Path of the shared library ``name`` built from ``sources`` (absolute
    paths) by ``command + ["-o", out, *sources]``; compiles only if that
    library is not there yet. With ``per_source`` each source is compiled to
    an object file by a compiler process of its own, all started together,
    and the objects are then linked by the same command. ``depends`` are
    the files the sources include: hashed with them, not compiled."""
    h = hashlib.sha256()
    for src in [*sources, *depends]:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    h.update("\0".join(command[1:]).encode())
    out = os.path.join(BUILD_ROOT, h.hexdigest()[:16], name)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    inputs = list(sources)
    if per_source and len(sources) > 1:
        inputs = [f"{tmp}.{i}.o" for i in range(len(sources))]
        with ThreadPoolExecutor(len(sources)) as pool:
            jobs = [pool.submit(_run, [*command, "-c", "-o", obj, src])
                    for obj, src in zip(inputs, sources)]
            for job in jobs:
                job.result()
    _run([*command, "-o", tmp, *inputs])
    for obj in inputs:
        if obj not in sources:
            os.remove(obj)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out
