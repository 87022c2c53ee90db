"""BENCHMARK.json against the benchmark's contract, the files it names, and
the harness's lookups by name."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from mvs_bench import manifest as man

ROOT = man.ROOT
M = man.load_manifest()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _names():
    out = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        out += [e["name"] for e in M[kind]]
    out += [w["config"] for w in M["workloads"]]
    out += [w["traffic"] for w in M["workloads"]]
    out += [k for c in M["configs"] for k in c["reduced"]]
    return out


def test_top_level_keys_and_command():
    assert set(M) == TOP
    assert M["paths"] == ["mvs_bench"]
    assert M["command"][:2] == ["python3", "mvs_bench/run.py"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    cells = len(M["workloads"])
    # 2 + 14 x 24 runs of run_seconds + 60, 24 x 180 s of compiles and
    # 1200 s spare within 43200 s.
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert cells <= 24


def test_names_and_units_use_allowed_characters():
    for n in _names():
        assert man.NAME_RE.fullmatch(n), n
    for kind in ("end_to_end", "per_layer"):
        for m in M[kind]:
            assert man.UNIT_RE.fullmatch(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in M[kind]]
        assert len(names) == len(set(names)), kind


def test_entries_have_just_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in M["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}


def test_every_cell_finds_its_files_by_name():
    for w in M["workloads"]:
        entry = man.config_entry(M, w["config"])
        conf = man.load_config(M, w["config"])
        assert entry["file"].startswith("mvs_bench/")
        assert conf["name"] == w["config"]
        assert conf["reduced"] == entry["reduced"]
        traffic = man.load_traffic(w["traffic"])
        assert traffic["name"] == w["traffic"]
        assert traffic["pass"] in ("A", "B")
        assert max(traffic["problems"]) < conf["views"]
        limits = man.load_limits(w["name"])
        assert limits["kernel_mismatch"] == 0.0
        for kind in ("end_to_end", "per_layer"):
            assert man.metrics_for(M, kind, w["name"])
        assert {m["name"] for m in man.metrics_for(M, "end_to_end",
                                                   w["name"])} \
            >= {"setup_s"}


def test_every_metric_reader_is_found_and_agrees():
    assert set(man.metric_files()) == {m["name"] for m in M["per_layer"]}
    for m in M["per_layer"]:
        mod = man.load_metric(m["name"])
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        assert callable(mod.read)


def test_a_dropped_in_metric_is_picked_up(tmp_path):
    here = tmp_path / "bench"
    shutil.copytree(man.HERE / "metrics", here / "metrics")
    (here / "metrics" / "stage.support_s.py").write_text(
        'LAYER = "engine.stages support"\nMOVES = "mpix_per_s"\n\n\n'
        'def read(ctx):\n    s = ctx["spans"].get("support")\n'
        '    return None if s is None else s / ctx["sweeps"]\n')
    assert "stage.support_s" in man.metric_files(here)
    mod = man.load_metric("stage.support_s", here)
    assert mod.read({"spans": {"support": 6.0}, "sweeps": 3}) == 2.0
    assert mod.read({"spans": {}, "sweeps": 3}) is None


def test_a_new_cell_is_files_and_an_entry(tmp_path):
    here = tmp_path / "bench"
    for sub in ("traffic", "limits"):
        shutil.copytree(man.HERE / sub, here / sub)
    t = dict(man.load_traffic("r1.passB.2problems"), name="r1.passB.first3",
             problems=[0, 1, 2])
    (here / "traffic" / "r1.passB.first3.json").write_text(json.dumps(t))
    (here / "limits" / "eth3d-r1.passB.first3.json").write_text(
        (man.HERE / "limits" / "eth3d-r1.passB.json").read_text())
    m = json.loads(json.dumps(M))
    m["workloads"].append({"name": "eth3d-r1.passB.first3",
                           "config": "eth3d-dslr",
                           "traffic": "r1.passB.first3", "chips": 1,
                           "why": "three problems"})
    w = man.cell(m, "eth3d-r1.passB.first3")
    assert man.load_traffic(w["traffic"], here)["problems"] == [0, 1, 2]
    assert man.load_limits(w["name"], here)
    assert man.metrics_for(m, "end_to_end", w["name"])


def test_whole_name_import_check():
    assert man.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client",
                                  "flax", "dpe_mvs_tpu",
                                  "dpe_mvs_tpu.ops.rowgather"]) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "dpe_mvs_tpu",
         "dpe_mvs_tpu.ops.rowgather"])
    assert man.forbidden_modules(["dpe_mvs_tpu_torch",
                                  "dpe_mvs_tpu_torch.ops.gather2d",
                                  "jaxtyping", "mvs_bench", "torch"]) == []


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "mvs_bench/run.py", "--workload", "eth3d-r1.passB",
         "--seed", "3", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_run_exits_nonzero_without_a_card():
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(man.HERE, tmp_path / "mvs_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def _imports(path):
    return [ln.split()[1] for ln in path.read_text().splitlines()
            if re.match(r"\s*(import|from)\s", ln)]


def test_benchmark_sources_import_no_jax():
    for p in man.HERE.rglob("*.py"):
        if "tests" in p.parts:
            continue
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & man.FORBIDDEN_MODULES, p
    # The yardstick imports nothing of the program either.
    for p in ("reference.py", "scene.py", "roofline.py", "window.py",
              "manifest.py"):
        assert not any(m.startswith("dpe_mvs_tpu")
                       for m in _imports(man.HERE / p)), p
