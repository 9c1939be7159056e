"""The port's tuning scripts (``pnp_svrg_tpu_torch/examples/``), each run in
process with ``--cpu`` at a tiny size, writing into ``tmp_path``.

Their outputs keep the JAX scripts' formats: the sweep CSVs have the columns
the JAX ``tuning/sweep.py`` writes (and ``tools/summarize_sweep.py`` reads
them unchanged), and the tuners' JSON records have the keys of the JAX
scripts' records (``examples/tune_*.py``, the lines cited below). No output
defaults to a committed path.
"""

from __future__ import annotations

import csv
import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from pnp_svrg_tpu.tuning import sweep as jax_sweep

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = ("sweep_sampratio", "sweep_snr", "tune_set12", "tune_csmri_nlm", "tune_deblur", "tune_pr")
# The JAX scripts' record keys.
RUN_KEYS = {"psnr_db", "eta", "lr_decay", "sigma_modifier", "n_outer", "t2", "mini_batch_size",
            "provenance"}
NLM_PROVENANCE = {"tuner", "etas", "decays", "mods", "n_outer", "t2", "mb", "size",
                  "image"}  # tune_csmri_nlm.py:103-109
DEBLUR_KEYS = RUN_KEYS | {"search_step", "matcher", "match_dtype"}  # tune_deblur.py:133-135
DEBLUR_PROVENANCE = {"tuner", "etas", "decays", "mods", "budgets", "mb", "size", "image", "kernel",
                     "scale", "snr"}  # tune_deblur.py:126-132
PR_KEYS = RUN_KEYS | {"replicas"}  # tune_pr.py:202-203
PR_PROVENANCE = {"tuner", "algo", "denoiser", "etas", "decays", "mods", "outers", "t2", "mb", "size",
                 "num_meas", "replicas"}  # tune_pr.py:194-201
SET12_CONFIG = {"size", "n_outer", "t2", "mini_batch_size", "search", "search_step", "matcher",
                "match_dtype", "keep_low_freq"}  # tune_set12.py:158-164


def _script(name):
    return importlib.import_module(f"pnp_svrg_tpu_torch.examples.{name}")


def _jax_columns(tmp_path):
    path = tmp_path / "jax_header.csv"
    jax_sweep._write_csv([], path)
    return next(csv.reader(open(path)))


def _summarize(csv_path, capsys):
    spec = importlib.util.spec_from_file_location("summarize_sweep", REPO / "tools" / "summarize_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main([str(csv_path)])
    return capsys.readouterr().out


@pytest.mark.parametrize("name", SCRIPTS)
def test_help_names_an_output_under_build_tuning(name, capsys):
    with pytest.raises(SystemExit) as exit_:
        _script(name).main(["--help"])
    assert exit_.value.code == 0
    text = " ".join(capsys.readouterr().out.split())
    assert "--cpu" in text and "build/tuning/" in text
    parser_default = str(_script(name).OUT_DIR)
    assert parser_default.endswith("build/tuning") and "/data" not in parser_default


def test_sweep_sampratio_all_problem_factories(tmp_path, capsys):
    """The three problem factories (CSMRI, Deblur-SR, PR) each run a tiny
    lockstep search and land in one CSV with the JAX columns, which
    ``tools/summarize_sweep.py`` reads."""
    out = tmp_path / "sweep.csv"
    res = _script("sweep_sampratio").main([
        "--cpu", "--problems", "csmri", "deblur", "pr", "--images", "1", "--size", "32",
        "--ratios", "0.5", "--algos", "svrg", "--denoisers", "tv", "--max-evals", "2",
        "--cand", "2", "--n-iters", "6", "--out", str(out)])
    assert len(res) == 3
    rows = list(csv.reader(open(out)))
    assert rows[0] == _jax_columns(tmp_path)
    assert [r[0] for r in rows[1:]] == ["csmri", "deblur", "pr"]
    for r in rows[1:]:
        assert np.isfinite(float(r[6])) and np.isfinite(float(r[7]))
    table = _summarize(out, capsys)
    assert "| csmri | tv | svrg |" in table and "| pr | tv | svrg |" in table


@pytest.mark.parametrize("mode", ["lockstep", "sequential"])
def test_sweep_sampratio_kernel_denoisers(tmp_path, mode):
    """NLM and BM3D cells (their plain kernel versions on the CPU): the
    lockstep path and the sequential one with batched trials."""
    out = tmp_path / "sweep.csv"
    extra = ["--sequential", "--trial-batch", "2"] if mode == "sequential" else []
    res = _script("sweep_sampratio").main([
        "--cpu", "--images", "2", "--size", "24", "--ratios", "0.5", "--algos", "svrg",
        "--denoisers", "nlm", "bm3d", "--search", "2", "--max-evals", "2", "--cand", "2",
        "--n-iters", "4", "--t2-opts", "2", "--out", str(out), *extra])
    assert [(r.denoiser_name, r.image) for r in res] == [
        ("nlm", "01.png"), ("bm3d", "01.png"), ("nlm", "02.png"), ("bm3d", "02.png")
    ] if mode == "sequential" else [
        ("nlm", "01.png"), ("nlm", "02.png"), ("bm3d", "01.png"), ("bm3d", "02.png")]
    for r in res:
        assert r.best_params["t2"] == 2 and np.isfinite(r.best_loss)
    assert len(list(csv.reader(open(out)))) == 5


def test_sweep_snr(tmp_path, capsys):
    out = tmp_path / "snr.csv"
    res = _script("sweep_snr").main([
        "--cpu", "--snrs", "10", "20", "--size", "40", "--max-evals", "2", "--n-iters", "4",
        "--trial-batch", "2", "--out", str(out)])
    assert [r.snr for r in res] == [10.0, 20.0]
    rows = list(csv.reader(open(out)))
    assert rows[0] == _jax_columns(tmp_path) and len(rows) == 3
    for r in res:
        assert r.best_params["mini_batch_size"] == 800 and 5 <= r.best_params["t2"] <= 20
    assert "| pr | bm3d | svrg |" in _summarize(out, capsys)


def test_tune_set12(tmp_path):
    out = tmp_path / "set12.json"
    rec = _script("tune_set12").main([
        "--cpu", "--size", "32", "--n-outer", "1", "--t2", "1", "--mb", "100", "--search", "2",
        "--etas", "3000", "--mods", "1.0", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved == rec
    assert set(saved) == {"config", "lanes", "eta", "sigma_modifier", "tuned_psnr"}
    assert set(saved["config"]) == SET12_CONFIG
    assert saved["lanes"] == [f"{i:02d}.png" for i in range(1, 13)] + ["13.png"]
    assert len(saved["eta"]) == len(saved["sigma_modifier"]) == 13
    assert np.isfinite(saved["tuned_psnr"]).all()
    with pytest.raises(SystemExit, match="128"):
        _script("tune_set12").main(["--cpu", "--size", "32", "--from-fixture", "--out", str(out)])


def test_tune_csmri_nlm(tmp_path):
    out = tmp_path / "nlm.json"
    rec = _script("tune_csmri_nlm").main([
        "--cpu", "--size", "32", "--n-outer", "1", "--t2", "2", "--mb", "100",
        "--etas", "400", "800", "--mods", "1.0", "--decays", "1.0", "0.9", "--chunk", "3",
        "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved == rec and set(saved) == RUN_KEYS
    assert set(saved["provenance"]) == NLM_PROVENANCE
    assert saved["eta"] in (400.0, 800.0) and saved["lr_decay"] in (1.0, 0.9)
    assert np.isfinite(saved["psnr_db"])


def test_tune_deblur(tmp_path):
    out = tmp_path / "deblur.json"
    rec = _script("tune_deblur").main([
        "--cpu", "--size", "32", "--etas", "1e9", "--decays", "0.9", "--mods", "1.0", "2.0",
        "--budgets", "1", "2", "--mb", "200", "--chunk", "2", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved == rec and set(saved) == DEBLUR_KEYS
    assert set(saved["provenance"]) == DEBLUR_PROVENANCE
    assert (saved["n_outer"], saved["t2"]) == (1, 2) and np.isfinite(saved["psnr_db"])


def test_tune_pr_replica_mean(tmp_path):
    """--replicas R: each config occupies R lanes (one A for all of them),
    scored by the replica mean, then certified alone in R lanes."""
    out = tmp_path / "pr.json"
    rec = _script("tune_pr").main([
        "--cpu", "--size", "32", "--num-meas", "128", "--etas", "0.05", "0.1", "--decays", "1.0",
        "--outers", "2", "--t2", "2", "--mb", "32", "--chunk", "4", "--replicas", "2",
        "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved == rec and set(saved) == PR_KEYS
    assert set(saved["provenance"]) == PR_PROVENANCE
    assert saved["replicas"] == saved["provenance"]["replicas"] == 2
    assert saved["eta"] in (0.05, 0.1) and np.isfinite(saved["psnr_db"])


def test_tune_pr_sarah_realsn_single_lane_certification(tmp_path):
    out = tmp_path / "pr_sarah.json"
    rec = _script("tune_pr").main([
        "--cpu", "--size", "32", "--num-meas", "128", "--etas", "0.05", "--decays", "1.0", "0.99",
        "--outers", "1", "--t2", "2", "--mb", "32", "--chunk", "2", "--algo", "sarah",
        "--denoiser", "realsn", "--out", str(out)])
    assert set(rec) == PR_KEYS | {"realsn_sigma", "variant"}
    assert set(rec["provenance"]) == PR_PROVENANCE | {"realsn_sigma", "sarah_variant"}
    assert rec["sigma_modifier"] == 1.0 and rec["variant"] == "sarah"


def test_tune_pr_chunk_not_multiple_of_replicas():
    with pytest.raises(SystemExit, match="multiple of"):
        _script("tune_pr").main(["--cpu", "--chunk", "3", "--replicas", "2"])


def test_compare_runs_holds_each_quality_field_bit_for_bit(tmp_path, capsys):
    """``examples/compare_runs.py`` matches two ``chip_smoke.py`` outputs'
    records by phase and occurrence and compares their PSNR, SSIM, trace
    and loss fields exactly, leaving profiler groups and times out."""
    from pnp_svrg_tpu_torch.examples import compare_runs

    def write(name, psnr, trace, ms):
        lines = ["NVIDIA H100 80GB HBM3, 700.00 W",
                 json.dumps({"phase": "profile", "groups_ms": {"elementwise (ReLU, scaling, loss)": ms}}),
                 json.dumps({"phase": "headline", "reference_minibatches": {"psnr_db": psnr, "trace": trace},
                             "steady_s": ms}),
                 json.dumps({"phase": "profile", "final_psnr_db": [psnr, 1.0]}),
                 json.dumps({"phase": "drivers", "utilities": {"trace": {"bytes": ms}}}),
                 json.dumps({"ok": True})]
        path = tmp_path / name
        path.write_text("\n".join(lines) + "\n")
        return str(path)

    a = write("a.txt", 26.5, [1.0, 2.0], 3.0)
    assert compare_runs.main([a, write("b.txt", 26.5, [1.0, 2.0], 4.0)]) == 0
    same = json.loads(capsys.readouterr().out)
    assert (same["fields"], same["equal"], same["differ"]) == (3, 3, [])
    assert compare_runs.main([a, write("c.txt", 26.5, [1.0, 2.5], 3.0)]) == 1
    assert json.loads(capsys.readouterr().out)["differ"] == ["headline#0/reference_minibatches/trace"]
