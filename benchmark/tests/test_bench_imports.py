"""Nothing a run loads is jax, jaxlib, flax or the JAX package (top-level
names compared whole), and the references load nothing of the port."""

import json
import subprocess
import sys

from benchmark.lib import cell

FORBIDDEN = {"jax", "jaxlib", "flax", "similaritysearchbyrdf_tpu"}


def loaded(code: str) -> set:
    """Top-level names of the modules a fresh process has after `code`."""
    prog = (f"import sys; sys.path.insert(0, {str(cell.ROOT)!r})\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         cwd=str(cell.ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_nothing_forbidden():
    names = loaded(
        "import benchmark.run, benchmark.control\n"
        "from benchmark.lib import cell, runner\n"
        "b = cell.benchmark()\n"
        "for c in b['configs']: cell.engine(cell.config(b, c['name']))\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    r = cell.reader(m['name'])\n"
        "    for h in getattr(r, 'HOOKS', []):\n"
        "        import importlib\n"
        "        [importlib.import_module(mod) for mod, _ in h['targets']]\n"
        "import similaritysearchbyrdf_tpu_torch\n"
        "from similaritysearchbyrdf_tpu_torch.ops.kernels import build\n")
    assert "similaritysearchbyrdf_tpu_torch" in names and "torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_references_load_nothing_of_the_port():
    names = loaded("import benchmark.reference.forest, benchmark.reference.ivf")
    assert "similaritysearchbyrdf_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from benchmark import run

    before = run.forbidden_modules()
    for name in ("similaritysearchbyrdf_tpu_torch_extra", "jaxlib_helper", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, type(sys)(name))
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "similaritysearchbyrdf_tpu.ops", type(sys)("x"))
    assert "similaritysearchbyrdf_tpu" in run.forbidden_modules()
