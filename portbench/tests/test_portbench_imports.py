"""Nothing the command loads is JAX or the JAX package, and the reference
loads nothing of the program.  Names are compared by their whole top-level
part: the port's name begins with the JAX package's."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

from common import ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "helmholtz_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_command_loads_no_jax():
    metrics = sorted(p.stem for p in (BENCH / "metrics").glob("*.py"))
    code = ("import sys; sys.path[:0] = ['portbench', '.']\n"
            "import run, harness, entry, check, traffic, devtrace, spans, "
            "control\nimport counts.roofline, reference.helmholtz\n"
            f"for m in {metrics!r}:\n"
            "    import importlib.util as u\n"
            "    s = u.spec_from_file_location('m_' + m.replace('.', '_'), "
            "f'portbench/metrics/{m}.py')\n"
            "    s.loader.exec_module(u.module_from_spec(s))\n")
    loaded = loaded_after(code)
    assert "helmholtz_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = loaded_after("import sys; sys.path[:0] = ['portbench']\n"
                          "import reference.helmholtz, check")
    assert not loaded & (FORBIDDEN | {"helmholtz_tpu_torch", "torch"})


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(BENCH)) for p in BENCH.rglob("*.py")
    if "tests" not in p.parts))
def test_sources_import_no_jax(path):
    tree = ast.parse((BENCH / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN
    if path.startswith("reference"):
        assert not names & {"helmholtz_tpu_torch", "torch"}
