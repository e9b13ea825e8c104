"""What the benchmark imports: never JAX or the JAX package (top-level
names compared whole), the reference nothing of the port, and the entry
point no torch, so the port's worker processes that re-import it as their
main module stay host-only."""

import ast
import os
import subprocess
import sys

import pytest

from tiny import BENCH, REPO

BLOCKED = {"jax", "jaxlib", "flax", "hla_la_tpu"}


def modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path, top_level_only=False):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(imported(path)) & BLOCKED


def test_the_reference_and_the_check_import_nothing_of_the_port():
    for name in ("reference.py", "check.py"):
        names = set(imported(os.path.join(BENCH, "hlabench", name)))
        assert not names & (BLOCKED | {"hla_la_tpu_torch"})


def test_top_level_name_is_compared_whole():
    assert "hla_la_tpu_torch".split(".")[0] not in BLOCKED


def test_run_imports_no_torch_and_keeps_spawn_safe():
    code = (
        "import sys, importlib.util\n"
        "sys.modules['torch'] = None\n"
        f"sys.path[:0] = [{BENCH!r}, {REPO!r}]\n"
        # as a spawned worker loads it: under __mp_main__, then as the
        # main module of a script (no __spec__)
        "spec = importlib.util.spec_from_file_location('__mp_main__', "
        f"{os.path.join(BENCH, 'run.py')!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "m.__spec__ = None\n"
        "sys.modules['__main__'] = m\n"
        "from hla_la_tpu_torch.models.parallel_host import spawn_safe\n"
        "print(spawn_safe(), sys.modules.get('torch'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "None"]
    assert set(imported(os.path.join(BENCH, "run.py"),
                        top_level_only=True)) <= {"argparse", "json", "os",
                                                  "sys"}


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "imgt2-wgs30x-pool7", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 3 and out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr
