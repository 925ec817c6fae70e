"""The experiment config, the precision study, the corpus fetcher and the
CLI's ``study`` and ``fetch`` on the CPU against respatpu on the same inputs.
Nothing here downloads: both packages' ``attempt_fetch`` (or
``urllib.request.urlretrieve``) is patched, and both packages'
``corpus.load_matrix`` hand the study the same matrix of at most 200 rows.

D5 and D6 (ROADMAP Queue 3) are shown on the multifrontal row: respatpu's
``df64`` row there is fp32 factors refined in double-float to 1e-14, not
timed warm; the port's is a native fp64 factorization and direct solve,
timed warm like every other row."""
import json
import urllib.request

import numpy as np
import pytest
import torch

import respatpu.bench.corpus as jcorpus
import respatpu.bench.fetch as jfetch
import respatpu.bench.study as jstudy
from respatpu.bench.synth import circuit_like, random_banded
from respatpu.config import ExperimentConfig as JConfig

import respatpu_torch.bench.corpus as tcorpus
import respatpu_torch.bench.fetch as tfetch
import respatpu_torch.bench.study as tstudy
from respatpu_torch import cli
from respatpu_torch.bench import runner
from respatpu_torch.config import ExperimentConfig
from respatpu_torch.interop import csr_from_respatpu

# a band matrix the band path serves, and a circuit that the multifrontal
# path serves with matching once the band is refused (max_band_bytes)
MATRICES = {"band": (lambda: random_banded(160, 6, 4, seed=21), 1 << 30),
            "circuit": (lambda: circuit_like(180, 5, seed=9, diag="dominant"), 1000)}


def test_config_round_trip_and_policy_match_respatpus():
    """respatpu's JSON loads into the port's config field for field (the
    port adds ``device``), ``df64`` names fp64, and ``resolved_policy``
    applies the FTZ override as respatpu's does."""
    for kw in ({}, {"policy": "fp32", "ftz": True}, {"policy": "fp32_ftz", "ftz": False},
               {"policy": "bf16", "workload": "lu", "matrices": ["dc1"], "max_synth_nnz": 5000},
               {"policy": "df64", "ftz": True, "group": "big"}):
        jc = JConfig(**kw)
        tc = ExperimentConfig.from_json(jc.to_json())
        assert {k: v for k, v in json.loads(tc.to_json()).items() if k != "device"} == \
            json.loads(jc.to_json())
        assert ExperimentConfig.from_json(tc.to_json()) == tc and tc.device == "cuda"
        jp, tp = jc.resolved_policy(), tc.resolved_policy()
        assert (tp.name.replace("fp64", "df64"), tp.flush_to_zero) == (jp.name, jp.flush_to_zero)
        assert tc.matrix_names() == jc.matrix_names()
    assert ExperimentConfig(reference_policy="df64").resolved_policy().name == "fp32"
    assert ExperimentConfig(policy="df64").resolved_policy().name == "fp64"


def test_config_run_dispatches_to_the_ports_runners(monkeypatch):
    calls = []
    for mod, name in ((runner, "sweep_spmv"), (runner, "sweep_ilu0"), (runner, "sweep_lu"),
                      (tstudy, "run_study")):
        monkeypatch.setattr(mod, name, lambda names, _n=name, **kw: calls.append((_n, names, kw)))
    for workload in ("spmv", "ilu0", "lu", "study"):
        ExperimentConfig(workload=workload, matrices=["dc1"], device="cpu", ftz=True,
                         max_synth_nnz=3000).run()
    assert [c[0] for c in calls] == ["sweep_spmv", "sweep_ilu0", "sweep_lu", "run_study"]
    assert all(c[1] == ["dc1"] and c[2]["device"] == "cpu" and c[2]["max_synth_nnz"] == 3000
               for c in calls)
    assert calls[0][2]["policies"][0] == "fp64" and calls[0][2]["policies"][1].name == "fp32_ftz"
    assert calls[1][2]["sweeps"] == 8 and calls[2][2]["refine"] is True
    with pytest.raises(NotImplementedError, match="distributed"):
        ExperimentConfig(n_devices=4).run()
    with pytest.raises(ValueError, match="unknown workload"):
        ExperimentConfig(workload="nope").run()


def _rows(config, status, t_factor, t_warm, resid, matrix="m"):
    return dict(matrix=matrix, config=config, status=status, t_factor_s=t_factor,
                t_factor_warm_s=t_warm, rel_residual=f"{resid:.3e}")


def test_summarize_matches_respatpus():
    rows = [_rows("df64", "ok", 2.0, float("nan"), 1e-15, "a"),
            _rows("fp32", "ok", 1.5, 0.5, 3e-6, "a"),
            _rows("fp32+ir", "ok", 1.5, float("nan"), 4e-14, "a"),
            _rows("df64", "ok", 3.0, 2.5, 2e-15, "b"),
            _rows("fp32", "ok", 1.0, 1.25, 5e-7, "b"),
            _rows("fp32+ir", "stagnated", 1.0, float("nan"), 1e-9, "b"),
            _rows("df64", "error", 0.0, float("nan"), float("nan"), "c"),
            _rows("fp32", "infeasible", 0.0, float("nan"), float("nan"), "c")]
    assert tstudy.summarize(rows) == jstudy.summarize(rows)
    assert tstudy.summarize([]) == jstudy.summarize([])


@pytest.fixture(scope="module")
def both_studies():
    """``run_study`` of both packages on the band and the circuit matrix,
    fetch and loading patched on both sides."""
    out = {}
    for name, (make, max_band) in MATRICES.items():
        a = make()
        rows = []
        for study, corpus, fetch, mat, kw in (
                (jstudy, jcorpus, jfetch, a, {}),
                (tstudy, tcorpus, tfetch, csr_from_respatpu(a), {"device": "cpu"})):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(fetch, "attempt_fetch", lambda *_a, **_k: 0)
                mp.setattr(corpus, "load_matrix",
                           lambda n, max_synth_nnz=None, m=mat: (m, True))
                rows.append(study.run_study([name], max_band_bytes=max_band, verbose=False,
                                            **kw))
        out[name] = rows
    return out


@pytest.mark.parametrize("name", list(MATRICES))
def test_run_study_matches_respatpus(both_studies, name):
    jrows, trows = both_studies[name]
    assert [r["config"] for r in trows] == list(tstudy.CONFIGS) == list(jstudy.CONFIGS)
    assert list(trows[0]) == tstudy.HEADER == list(jrows[0])
    assert [r["status"] for r in trows] == [r["status"] for r in jrows] == ["ok"] * 5
    by_t, by_j = {r["config"]: r for r in trows}, {r["config"]: r for r in jrows}
    for config in ("fp32+ir", "bf16+ir"):
        assert float(by_t[config]["rel_residual"]) <= 1e-12
        assert float(by_j[config]["rel_residual"]) <= 1e-12
    method = "method=band" if name == "band" else "method=snlu"
    assert all(r["method"].startswith(method) for r in trows + jrows)
    for config in ("fp32", "fp32_ftz"):
        assert by_t[config]["method"] == by_j[config]["method"]
        assert np.isfinite(by_t[config]["t_factor_warm_s"])
        assert float(by_t[config]["rel_residual"]) == pytest.approx(
            float(by_j[config]["rel_residual"]), rel=0.5)
    t64, j64 = by_t["df64"], by_j["df64"]
    # D6: the port's df64 row is timed warm, respatpu's is not
    assert np.isfinite(t64["t_factor_warm_s"]) and np.isnan(j64["t_factor_warm_s"])
    assert float(t64["rel_residual"]) <= 1e-12 and t64["iterations"] == 0
    if name == "circuit":
        # D5: respatpu's multifrontal df64 row is fp32 factors + refinement
        assert j64["method"].endswith(",df64_ref=fp32+ir") and j64["iterations"] > 0
        assert t64["method"].endswith("apply=frontal_fp64") and "df64_ref" not in t64["method"]
    else:
        assert t64["method"] == j64["method"] and j64["iterations"] == 0
    assert tstudy.summarize(trows)["fp32_ir_reaches_1e-10_frac"] == 1.0


def test_fetch_matches_respatpus_and_stops_at_the_first_failure(monkeypatch, tmp_path, capsys):
    names = [e.name for e in tcorpus.ALL]
    assert len(names) == 36 == len(jfetch._GROUPS) == len(tfetch._GROUPS)
    assert [tfetch.url_for(n) for n in names] == [jfetch.url_for(n) for n in names]
    tried = []

    def refuse(url, path):
        tried.append(url)
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.chdir(tmp_path)
    assert tfetch.attempt_fetch(["dc1", "2cubes_sphere", "offshore"]) == 0
    assert tried == [tfetch.url_for("2cubes_sphere")]  # the corpus order; then it stops
    cli.main(["fetch", "big"])
    assert len(tried) == 1 + 15 and "[fetch] 0/15 matrices available" in capsys.readouterr().out


def test_cli_study_on_the_cpu(monkeypatch, capsys):
    """``study`` without a card asks for ``--device cpu``; with it, the rows
    and the summary of a capped stand-in, and no download tried (D7)."""
    fetched = []
    monkeypatch.setattr(tfetch, "attempt_fetch", lambda names, **_k: fetched.append(names))
    monkeypatch.setattr(urllib.request, "urlretrieve",
                        lambda url, *_a, **_k: fetched.append(url))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(["study", "dc1"])
    argv = ["study", "G2_circuit", "--device", "cpu", "--max-synth-nnz", "3000"]
    cli.main(argv)
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary["n_matrices"] == 1 and summary["fp32_ir_reaches_1e-10_frac"] == 1.0
    assert out.count("[study] G2_circuit/") == 5 and fetched == []
