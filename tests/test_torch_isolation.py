"""The port stands alone: it imports neither jax nor the JAX package, and it
never moves to the CPU unless the caller asks.

Later slices must keep both: a module of ``repro_torch`` (or ``chip_smoke.py``)
that imports ``jax`` or anything of ``repro`` fails here, and so does a
cluster, a model or a server that quietly runs on the CPU when no card is
present.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as port  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"

_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)(?:\.|\s|$|,)"
    r"|from\s+(?:jax|repro)(?:\.\S*)?\s+import\b)", re.MULTILINE)


def test_importing_the_port_pulls_in_no_jax_and_no_reference():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(mods), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30, out.stdout           # every submodule was imported
    assert bad == "[]", bad


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_sources_import_no_jax_and_no_reference(path):
    src = (ROOT / path).read_text()
    assert not _IMPORT.findall(src), _IMPORT.findall(src)


def test_import_scan_catches_the_forms_it_must():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import x", "import repro.core",
                 "    from repro import kernels", "import repro"):
        assert _IMPORT.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "from .jaxplan import y", "# import jax later"):
        assert not _IMPORT.search(line), line


def test_cluster_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    topo = port.datacenter(2, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.TeShuCluster(topo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.TeShuService(topo, device="cuda:0")
    with pytest.raises(ValueError):
        port.TeShuCluster(topo, device="meta")
    assert port.TeShuCluster(topo, device="cpu").device == torch.device("cpu")
    assert port.TeShuCluster(topo, device="cpu").executor == "torch"


def test_serving_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    from repro_torch.models.convert import lm_params_from_reference
    for arch in ("qwen2.5-14b", "qwen3-moe-235b-a22b"):    # dense, MoE
        cfg = get_config(arch, smoke=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve(arch, batch=1, prompt_len=2, gen_len=1)
        for make in (lambda: lm.init_lm(cfg), lambda: lm.LM(cfg),
                     lambda: lm.init_cache(cfg, 1, 4),
                     lambda: lm_params_from_reference(cfg, {})):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        with pytest.raises(ValueError):
            lm.init_lm(cfg, device="meta")
        gen, _ = serve(arch, batch=1, prompt_len=2, gen_len=1, device="cpu")
        assert gen.shape == (1, 1)


def test_training_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from repro_torch.data import DataConfig, DataPipeline, make_global_batch
    from repro_torch.launch.train import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("qwen2.5-14b", steps=1, global_batch=2, seq_len=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataPipeline(DataConfig(vocab=8, seq_len=4, global_batch=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_global_batch({"x": __import__("numpy").zeros(2)}, "cuda")
    out = train("qwen2.5-14b", steps=1, global_batch=2, seq_len=4,
                device="cpu")
    assert out["params"].embed.device == torch.device("cpu")
    assert len(out["history"]) == 1
