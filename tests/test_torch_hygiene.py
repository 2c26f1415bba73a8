"""Boundaries of the port: it imports neither JAX nor ``repro`` nor the
reference's ``benchmarks`` package; its
verbatim copies of ``repro``'s framework-free modules cannot drift; its
entry points refuse to run without a device rather than fall back."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

COPIES = ["core/errors.py", "core/atomics.py", "core/table.py",
          "core/rwlocks.py", "core/bravo.py", "core/factory.py",
          "obs/__init__.py", "obs/trace.py", "obs/metrics.py",
          "obs/chrome.py", "obs/slo.py", "serving/scheduler.py",
          "serving/loadgen.py", "ft/straggler.py", "data/pipeline.py",
          "core/sim.py", "analysis/checker.py", "analysis/scenarios.py"]


# the reference and what only it may import; the port keeps its own copies
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_repro_import(path):
    for mod in _imported(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path}: {mod}"


def test_package_imports_without_jax_in_a_fresh_process():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module,argv", [
    ("repro_torch.analysis.check", ["--max-schedules", "50"]),
    ("repro_torch.benchmarks.run", ["--only", "fig2"]),
    ("repro_torch.benchmarks.smoke_locks", []),
    ("repro_torch.kernels.autotune", ["--device", "cpu"]),
], ids=lambda x: x if isinstance(x, str) else " ".join(x))
def test_host_entry_points_run_without_jax_in_a_fresh_process(module, argv):
    """The lock experiments, the checker and lint, and the autotune sweep
    run as modules and exit 0 without importing JAX or the reference."""
    code = ("import runpy, sys\n"
            f"sys.argv = [{module!r}] + {argv!r}\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]


# the copies differ from their originals only by the package name and by
# the originals' change-history tags, which the port's text leaves out
HISTORY_TAGS = [(r" \((?:PR|ISSUE) \d+(?:/\d+)?\)", ""),
                (r"(?: of| —) (?:PR|ISSUE) \d+(?: satellite)?", ""),
                (r"until (?:PR|ISSUE) \d+ ", "until recently "),
                (r"the pre-(?:PR|ISSUE)-\d+ ", "the earlier "),
                (r", (?:PR|ISSUE) \d+\)", ")"),
                (r"\b(?:PR|ISSUE)-\d+ ", "")]


@pytest.mark.parametrize("rel", COPIES)
def test_verbatim_copies_match_their_originals(rel):
    want = re.sub(r"\brepro\.", "repro_torch.", (REF / rel).read_text())
    for pat, rep in HISTORY_TAGS:
        want = re.sub(pat, rep, want)
    assert (PORT / rel).read_text() == want


CONFIG_COPIES = sorted(p.name for p in (PORT / "configs").glob("*.py")
                       if p.name != "__init__.py")


def _config_copy(text: str) -> str:
    """``repro``'s config module as the port copies it: the dtypes
    torch's; ``RULES`` and its ``MeshRules`` import (``dist.sharding``)
    as they are."""
    return text.replace("import jax.numpy as jnp",
                        "import torch").replace("jnp.", "torch.")


def test_every_config_but_audio_is_copied():
    """Every config module of ``repro`` has its copy, hubert-xlarge's
    (the audio family) included now."""
    want = sorted(p.name for p in (REF / "configs").glob("*.py")
                  if p.name != "__init__.py")
    assert CONFIG_COPIES == want


@pytest.mark.parametrize("name", CONFIG_COPIES)
def test_config_copies_match_their_originals(name):
    want = _config_copy((REF / "configs" / name).read_text())
    assert (PORT / "configs" / name).read_text() == want


def _defs(path: pathlib.Path):
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.get_source_segment(text, node)
    return out


# the parts of ``repro.dist.sharding`` the port keeps as they are; its spec
# functions read a ShapeMesh where ``repro``'s read a JAX Mesh
SHARDING_COPIES = ["MeshRules", "_REPLICATED", "_COL_PARALLEL",
                   "_ROW_PARALLEL", "_CACHE_CORE", "_core_spec"]


@pytest.mark.parametrize("name", SHARDING_COPIES)
def test_sharding_copies_match_their_originals(name):
    want = _defs(REF / "dist" / "sharding.py")[name]
    got = _defs(PORT / "dist" / "sharding.py")[name]
    if name == "_core_spec":
        want = want.replace("mesh: Mesh", "mesh: ShapeMesh")
    assert got == want


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_cuda(no_cuda):
    from repro_torch import configs
    from repro_torch.benchmarks import (device_bravo, obs, prefill, quant,
                                        registry, scheduler)
    from repro_torch.core import device_bravo as DB
    from repro_torch.core.registry import BravoRegistry
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_pool import KVPool
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = configs.get_smoke("llama3.2-1b")
    for make in (BravoRegistry, DB.DeviceLeaseTable, DB.init_state,
                 device_bravo.run, registry.run, obs.run, scheduler.run,
                 prefill.run, quant.run, lambda: KVPool(16),
                 lambda: M.init_params(0, cfg),
                 lambda: M.init_caches(cfg, 1, 8),
                 lambda: M.init_paged_caches(cfg, 8, 4),
                 lambda: M.init_paged_caches(cfg, 8, 4, quantized=True),
                 lambda: M.from_jax_params({}, cfg),
                 lambda: ServingEngine(cfg, {}),
                 lambda: ServingEngine(cfg, {}, scheduler=SchedulerConfig()),
                 lambda: ServingEngine(cfg, {}, scheduler=SchedulerConfig(),
                                       quant_kv=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_examples_are_checked_and_raise_without_cuda(no_cuda):
    """Every example module of the port, ``serve_bravo`` included, is
    among the files the import checks read, and without ``--device``
    refuses to run without a card."""
    import importlib

    names = sorted(p.stem for p in (PORT / "examples").glob("*.py")
                   if p.name != "__init__.py")
    assert names == ["elastic_restart", "quickstart", "serve_bravo"]
    files = _port_files()
    for name in names:
        assert PORT / "examples" / f"{name}.py" in files
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--locks", "ba"] if name == "serve_bravo" else [])


@pytest.mark.parametrize("name", ["obs", "scheduler", "prefill", "quant"])
def test_serving_benchmark_clis_raise_without_cuda(no_cuda, name):
    import importlib

    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--smoke"])


def test_cuda_sources_are_listed_for_the_build():
    from repro_torch.kernels import _build, paged_attn, table_publish

    assert "sm_90a" in " ".join(_build.ARCH_FLAGS)
    for mod in (table_publish, paged_attn):
        assert (_build.CSRC / mod.SOURCE).exists()
        text = (_build.CSRC / mod.SOURCE).read_text()
        for fn in mod.SIGNATURES:
            assert f"int {fn}(" in text, fn
