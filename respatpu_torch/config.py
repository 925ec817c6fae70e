"""Runtime experiment configuration (SURVEY.md §5.6); the counterpart of
``respatpu/config.py``.

The reference switches precision by recompiling with ``#define FLOAT`` and
toggles FTZ by editing code (README.md:77-97); thread counts and matrix paths
come from env vars + argv. Here one dataclass covers the whole experiment
space at runtime, serializable to and from JSON for sweep manifests, with
respatpu's fields and one more, ``device`` (the card unless the caller asks
for the CPU). ``df64`` names fp64, in ``policy`` and ``reference_policy``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from .precision import Policy, get_policy

__all__ = ["ExperimentConfig"]


@dataclass
class ExperimentConfig:
    """One experiment = matrices x workload x precision x execution layout."""

    workload: str = "spmv"  # spmv | ilu0 | lu | study
    matrices: List[str] = field(default_factory=list)  # corpus names or paths
    group: Optional[str] = None  # moderate | big | all (overrides matrices)
    policy: str = "fp32"  # fp32 | fp32_ftz | bf16 | fp64 (df64 is an alias)
    reference_policy: str = "fp64"
    ftz: Optional[bool] = None  # explicit FTZ override
    reps: int = 5  # repetitions (run_pardiso.sh:41 uses 11)
    refine: bool = True  # fp64 iterative refinement after low-precision LU
    ordering: str = "rcm"
    ilu_sweeps: int = 8
    n_devices: int = 1  # row-partition width for distributed runs
    csv_path: Optional[str] = None
    max_synth_nnz: Optional[int] = None
    seed: int = 42
    device: str = "cuda"

    def resolved_policy(self) -> Policy:
        p = get_policy(self.policy)
        if self.ftz is not None and p.dtype != torch.float64:
            p = dataclasses.replace(p, flush_to_zero=self.ftz,
                                    name=p.name.replace("_ftz", "") + ("_ftz" if self.ftz else ""))
        return p

    def matrix_names(self) -> List[str]:
        if self.group:
            from .bench import corpus
            src = {"moderate": corpus.MODERATE, "big": corpus.BIG, "all": corpus.ALL}[self.group]
            return [e.name for e in src]
        return self.matrices

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        return cls(**json.loads(text))

    def run(self, verbose: bool = True):
        """Execute the configured experiment via the sweep runners."""
        if self.n_devices > 1:
            # respatpu's run ignores n_devices; a config that asks for more than
            # one device must not run on one without saying so (ROADMAP D8)
            raise NotImplementedError(
                f"n_devices={self.n_devices}: ExperimentConfig.run drives the single-card "
                "sweeps; run a distributed workload through its own entry points "
                "(runner.sweep_ilu0_dist, bench.scaling, dist_snlu_sub, dist_lu) with a mesh")
        from .bench import runner, study
        names = self.matrix_names()
        pol = self.resolved_policy()
        common = dict(csv_path=self.csv_path, max_synth_nnz=self.max_synth_nnz,
                      verbose=verbose, device=self.device)
        if self.workload == "spmv":
            return runner.sweep_spmv(names, policies=(self.reference_policy, pol),
                                     reps=self.reps, **common)
        if self.workload == "ilu0":
            return runner.sweep_ilu0(names, policy=pol, sweeps=self.ilu_sweeps, **common)
        if self.workload == "lu":
            return runner.sweep_lu(names, policy=pol, refine=self.refine, **common)
        if self.workload == "study":
            return study.run_study(names, **common)
        raise ValueError(f"unknown workload {self.workload!r}")
