"""The port stands alone: importing every module of ``repro_torch``,
serving on the CPU and importing ``chip_smoke`` load no JAX and nothing of
the reference package; the entry points refuse to run without a CUDA card
unless the caller asks for the CPU; ``chip_smoke.py`` fails without a card
and without the repository around it."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.launch import serve
serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--requests", "2", "--slots", "2", "--prompt-len", "24",
            "--steps", "4", "--prefill-chunk", "16"])
serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--requests", "2", "--slots", "2", "--prompt-len", "40",
            "--steps", "4", "--prefill-chunk", "16", "--paged", "--int8"])
serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--requests", "2", "--slots", "2", "--prompt-len", "24",
            "--steps", "6", "--spec-k", "3", "--spec-adaptive"])
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print("FOREIGN", bad)
"""


def test_port_imports_no_jax_and_nothing_of_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(SRC), root=str(ROOT))],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout[-2000:]
    assert out.stdout.count("[serve] stream: 2 requests") == 3
    assert "[serve] kernel launches:" in out.stdout
    assert "[serve] paged: prefix trie holds" in out.stdout
    assert "[serve] spec: accepted-draft histogram" in out.stdout
    assert "[serve] spec: adaptive proposal histogram" in out.stdout


def test_spec_module_is_numpy_only():
    """``serving/spec.py`` is a copy of the reference's numpy-only module:
    it imports neither torch nor jax nor anything of either package."""
    text = (SRC / "repro_torch" / "serving" / "spec.py").read_text()
    mods = re.findall(r"^\s*(?:import|from) ([\w.]+)", text, re.M)
    assert set(mods) <= {"__future__", "dataclasses", "typing", "numpy"}, \
        mods


@pytest.mark.parametrize("module,allowed", [
    ("serving/faults.py", {"numpy", "os"}),
    ("obs/__init__.py", {".metrics", ".prometheus", ".trace"}),
    ("obs/metrics.py", {"math", "random", "re", "threading", "bisect",
                        "collections"}),
    ("obs/prometheus.py", {"math", "threading", "http.server", ".metrics"}),
    ("obs/trace.py", {"json", "threading"}),
    ("serving/frontend.py", {"asyncio", "json", "threading", "collections",
                             ".sampling"})])
def test_lifecycle_and_telemetry_modules_are_stdlib_copies(module, allowed):
    """The fault plan (numpy only), the telemetry (stdlib only) and the
    frontend (stdlib and the port's sampling parameters) are copies of the
    reference's modules: none imports torch, jax or either package."""
    text = (SRC / "repro_torch" / module).read_text()
    mods = {a or b for a, b in re.findall(
        r"^\s*(?:import ([\w.]+)|from ([\w.]+) import)", text, re.M)}
    assert mods <= {"__future__", "dataclasses", "typing"} | allowed, mods


def test_no_import_of_jax_or_the_reference_in_the_sources():
    pat = re.compile(r"^\s*(import|from) (jax|repro)\b", re.M)
    files = [ROOT / "chip_smoke.py", ROOT / "tools" / "compare_trees.py",
             ROOT / "tools" / "int_reduction_probe.py",
             ROOT / "tools" / "attention_probe.py",
             ROOT / "tools" / "gemv_probe.py",
             *sorted((SRC / "repro_torch").rglob("*.py"))]
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               n_layers=1)


@pytest.mark.parametrize("entry", ["init_params", "convert_concrete",
                                   "convert_int8", "convert_int4", "engine",
                                   "engine_paged", "engine_spec", "pool",
                                   "pool_paged", "serve", "serve_paged_int8",
                                   "serve_spec"])
def test_entry_points_raise_without_a_card(no_card, entry):
    from repro_torch.core.convert import convert_concrete
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import ContinuousEngine, SpecConfig
    from repro_torch.serving.cache_pool import CachePool
    cfg = _tiny()
    params = lm.init_params(cfg, device="cpu")
    calls = {
        "init_params": lambda: lm.init_params(cfg),
        "convert_concrete": lambda: convert_concrete(
            params, lm.model_specs(cfg), cfg),
        "convert_int8": lambda: convert_concrete(
            params, lm.model_specs(cfg), cfg, mode="int8"),
        "convert_int4": lambda: convert_concrete(
            params, lm.model_specs(cfg), cfg, mode="int4"),
        "engine": lambda: ContinuousEngine(params, cfg, slots=1),
        "engine_paged": lambda: ContinuousEngine(params, cfg, slots=1,
                                                 paged=True),
        "engine_spec": lambda: ContinuousEngine(params, cfg, slots=1,
                                                spec=SpecConfig(k=2)),
        "pool": lambda: CachePool.build(cfg, 1, 64),
        "pool_paged": lambda: CachePool.build(cfg, 1, 64, paged=True),
        "serve": lambda: serve.main(["--reduced", "--requests", "1"]),
        "serve_paged_int8": lambda: serve.main(
            ["--reduced", "--requests", "1", "--paged", "--int8"]),
        "serve_spec": lambda: serve.main(
            ["--reduced", "--requests", "1", "--spec-k", "2"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_entry_points_run_on_the_cpu_when_asked(no_card):
    from repro_torch.core.convert import convert_concrete
    from repro_torch.models import lm
    from repro_torch.serving import ContinuousEngine, SamplingParams
    cfg = _tiny()
    params = convert_concrete(lm.init_params(cfg, device="cpu"),
                              lm.model_specs(cfg), cfg, device="cpu")
    eng = ContinuousEngine(params, cfg, slots=1, device="cpu")
    out = eng.generate_batch([[1, 2, 3]], SamplingParams(max_new_tokens=2))
    assert out.shape == (1, 2)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_paged_int_entry_points_run_on_the_cpu_when_asked(no_card, mode):
    from repro_torch.core.convert import convert_concrete
    from repro_torch.models import lm
    from repro_torch.serving import ContinuousEngine, SamplingParams
    cfg = _tiny()
    params = convert_concrete(lm.init_params(cfg, device="cpu"),
                              lm.model_specs(cfg), cfg, mode=mode,
                              device="cpu")
    eng = ContinuousEngine(params, cfg, slots=1, device="cpu", paged=True)
    out = eng.generate_batch([[1, 2, 3]], SamplingParams(max_new_tokens=2))
    assert out.shape == (1, 2)
    assert int(eng.state["refcount"].sum()) == 0     # released at the end


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_the_repository", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repository(tmp_path, alone):
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        script, cwd = ROOT / "chip_smoke.py", ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, even where one is
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, env=env, cwd=cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_compare_trees_fails_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, even where one is
    out = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "compare_trees.py"),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert "needs a CUDA card" in out.stderr
    assert "[compare]" not in out.stdout


def test_int_reduction_probe_fails_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, even where one is
    out = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "int_reduction_probe.py")],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert "needs a CUDA card" in out.stderr
    assert "[probe]" not in out.stdout


def test_int_reduction_probe_variants_apply_to_the_source():
    """Each variant of the probe is a substitution whose text the int
    kernel's source holds exactly once; the source itself is variant one."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import int_reduction_probe as probe
    finally:
        sys.path.remove(str(ROOT / "tools"))
    text = (SRC / "repro_torch" / "kernels" / "csrc" /
            probe.SOURCE).read_text()
    variants = {name: probe.variant_source(text, subs)
                for name, subs in probe.VARIANTS.items()}
    assert variants["partials"] == text
    assert "if (true)" in variants["partials, 8 lanes"]
    assert "if (false)" in variants["partials, 1 lane"]
    atomics = variants["atomics"]
    assert "atomicAdd(p, v0);" in atomics and "cudaMemsetAsync" in atomics
    assert len(set(variants.values())) == len(variants)


def test_attention_probe_fails_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, even where one is
    out = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "attention_probe.py")],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert "needs a CUDA card" in out.stderr
    assert "[probe]" not in out.stdout


def test_attention_probe_variants_apply_to_the_source():
    """Each variant of the attention probe is a substitution whose text the
    source holds as often as the variant says; the source itself is the
    first variant and every variant differs from every other."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import attention_probe as probe
    finally:
        sys.path.remove(str(ROOT / "tools"))
    text = (SRC / "repro_torch" / "kernels" / "csrc" /
            probe.SOURCE).read_text()
    variants = {name: probe.variant_source(text, subs)
                for name, subs in probe.VARIANTS.items()}
    assert variants["source"] == text
    assert variants["no PV"].count("if (false) pv_rows<RPT>(") == 1
    assert variants["staging only"].count("if (false) score_rows<RPT>(") \
        == 2
    assert len(set(variants.values())) == len(variants)


def test_gemv_probe_fails_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, even where one is
    out = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "gemv_probe.py")],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert "needs a CUDA card" in out.stderr
    assert "gemv probe" not in out.stdout


def test_gemv_probe_variants_apply_to_the_source():
    """Each variant of the gemv probe is a substitution whose text the
    source holds exactly once; the source itself is the first variant, the
    only one that keeps the arithmetic, and every variant differs from
    every other."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import gemv_probe as probe
    finally:
        sys.path.remove(str(ROOT / "tools"))
    text = (SRC / "repro_torch" / "kernels" / "csrc" /
            probe.SOURCE).read_text()
    variants = {name: probe.variant_source(text, subs)
                for name, (subs, _) in probe.VARIANTS.items()}
    assert variants["source"] == text
    assert [n for n, (_, exact) in probe.VARIANTS.items() if exact] == \
        ["source"]
    assert variants["no merge"].count("if (a.M > 0) return;") == 1
    assert "v[j] = 1.f;" in variants["no expansion"]
    assert len(set(variants.values())) == len(variants)
